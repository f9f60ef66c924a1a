"""Serving driver: batched generation with the slot server, on PyTorch.

Counterpart of ``repro.launch.serve`` with the same options, plus
``--device`` (default ``cuda``).  ``--reduced`` is on by default, as
there; ``--no-reduced`` serves the config at full width.  The weights
are random, drawn from a seeded generator on the device.

  python -m repro_torch.launch.serve --arch qwen3-4b --no-reduced
  python -m repro_torch.launch.serve --device cpu --requests 6

An encoder-decoder config is refused, as the reference's launcher refuses
it: the slot server admits tokens only (``serve.engine.generate`` takes
an encoder's ``features``).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, SlotServer


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the config's tiny .reduced() variant "
                         "(--no-reduced: full width)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card: say so instead of a traceback
        sys.exit(f"[serve] {e}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    assert not cfg.encdec, "use generate(features=...) for enc-dec serving"
    model = T.init_lm(cfg, seed=0, device=device)

    print(f"[serve] {cfg.name}: {args.requests} requests, "
          f"{args.slots} slots (continuous batching) device={device}")
    server = SlotServer(model, cfg, num_slots=args.slots,
                        s_max=args.prompt_len + args.max_new + 8)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=args.prompt_len).astype(np.int32)
        server.submit(Request(rid, prompt, args.max_new))
    t0 = time.time()
    done = server.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in done.values())
    for rid in sorted(done):
        print(f"  req {rid}: {done[rid][:8]}... ({len(done[rid])} tokens)")
    print(f"[serve] {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()
