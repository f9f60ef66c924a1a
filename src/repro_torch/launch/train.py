"""End-to-end LM training launcher, on PyTorch.

Counterpart of ``repro.launch.train`` with the same options, plus
``--device`` (default ``cuda``; without a card it exits, there is no CPU
fallback).  The weights are random, drawn from a seeded generator on the
device; batches come from the seeded ``SyntheticSource``.  An
encoder-decoder config (whisper) also takes each step's ``[batch,
enc_seq, d_model]`` bf16 frame features, drawn from a ``torch.Generator``
seeded with the step's index (the reference folds the step into its key),
so a resumed run draws what an uninterrupted one does.

  python -m repro_torch.launch.train --arch qwen3-4b
  python -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 3 \
      --device cpu --ckpt-dir /tmp/ck --resume

A checkpoint (``--ckpt-dir``, every ``--ckpt-every`` steps, written on a
background thread, and at the end) holds the reference's ``TrainState``
tree and the pipeline offset, in the JAX package's format; ``--resume``
continues from the newest one at its pipeline offset.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline, SyntheticSource
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer as TR


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (e.g. ~100M model)")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    return ap


def step_features(cfg, step: int, batch: int,
                  device: torch.device) -> torch.Tensor:
    """The encoder's input of step ``step``: standard normal frame
    features [batch, enc_seq, d_model] in bf16."""
    gen = torch.Generator(device=device if device.type == "cuda" else "cpu")
    gen.manual_seed(step)
    return torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)


def main(argv=None) -> dict:
    """Runs the training; returns ``{"start", "step", "offset",
    "losses"}`` (``losses``: step -> loss of every step run)."""
    args = _parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card: say so instead of a traceback
        sys.exit(f"[train] {e}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    over = {}
    if args.layers:
        over["num_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
        over["head_dim"] = 0
    if over:
        cfg = dataclasses.replace(cfg, **over)
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.num_layers}L d={cfg.d_model} device={device}")

    state = TR.init_state(cfg, seed=0, device=device)
    schedule = opt_mod.cosine_schedule(args.lr, warmup=max(args.steps // 10, 1),
                                       total=args.steps)
    step_fn = TR.make_train_step(cfg, microbatches=args.microbatches,
                                 schedule=schedule)
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, args.seq), args.batch)

    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if cm and args.resume and cm.latest_step() is not None:
        tree, meta = cm.restore(device=device)
        state = TR.from_checkpoint(cfg, tree, device)
        pipe.restore(meta["pipeline"])
        print(f"[train] resumed from step {int(state.step)} "
              f"(pipeline offset {pipe.state.offset})")

    t0 = time.time()
    start = int(state.step)
    losses = {}
    for i in range(start, args.steps):
        batch = pipe.next_batch()
        if cfg.encdec:
            batch["features"] = step_features(cfg, i, args.batch, device)
        state, metrics = step_fn(state, batch)
        losses[i] = metrics["loss"]
        if i % 10 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])  # waits for the device
            tok_s = args.batch * args.seq * (i - start + 1) / (time.time() - t0)
            print(f"  step {i:4d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({tok_s:.0f} tok/s)")
        if cm and (i + 1) % args.ckpt_every == 0:
            cm.save(i + 1, TR.to_checkpoint(state),
                    metadata={"pipeline": pipe.snapshot()},
                    blocking=False)  # async, ASYMP-style
    if cm:
        cm.wait()
        cm.save(int(state.step), TR.to_checkpoint(state),
                metadata={"pipeline": pipe.snapshot()})
    losses = {i: float(v) for i, v in losses.items()}
    if losses:
        print(f"[train] done: final loss {losses[max(losses)]:.4f} "
              f"in {time.time() - t0:.0f}s")
    return {"start": start, "step": int(state.step),
            "offset": pipe.state.offset, "losses": losses}


if __name__ == "__main__":
    main()
