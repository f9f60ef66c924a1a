"""Training step factory: loss, gradient accumulation, clipping, optimizer
(the counterpart of ``repro.train.trainer``).

``make_train_step(cfg)`` returns ``train_step(state, batch) -> (state,
metrics)``, the reference's step run eagerly on one device:

  * microbatch gradient accumulation in fp32, ``a + g / microbatches`` in
    the reference's order;
  * optional int8 error-feedback gradient compression
    (``dist/compression.py``), the residual carried across the
    microbatches within the step;
  * clipping by the global norm and the optimizer, both in place
    (``train/optimizer.py``): the step reuses the parameter and moment
    tensors it is given, as the reference's donated buffers are.

A :class:`TrainState` holds the model (an ``LM`` module, or an
``EncDec`` for an encoder-decoder config: its ``param_dict`` is the
reference's parameter tree; the encoder-decoder's batches carry
``features``), the optimizer state
(moments keyed as ``param_dict``) and the step.  :func:`to_checkpoint`
and :func:`from_checkpoint` map it to and from the reference's
``TrainState`` tree, which ``ft/checkpoint.py`` writes in the JAX
package's format.  The reference's ``init_state`` also returns the
logical axes of the state; here :func:`state_axes` gives them, and
``init_state`` returns the state alone.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import compression as comp_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as transformer_mod
from repro_torch.models.layers import f32_recip
from repro_torch.train import optimizer as opt_mod


class TrainState(NamedTuple):
    params: Any  # transformer.LM
    opt_state: Any  # AdamWState | AdafactorState
    step: torch.Tensor  # int32, 0-d


def loss_fn_for(cfg: ModelConfig) -> Callable:
    if cfg.encdec:
        def loss_fn(params, batch):
            return encdec_mod.encdec_loss(params, cfg, batch["features"],
                                          batch["tokens"], batch["labels"])
        return loss_fn

    def loss_fn(params, batch):
        return transformer_mod.lm_loss(params, cfg, batch["tokens"],
                                       batch["labels"])
    return loss_fn


def init_state(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = None) -> TrainState:
    """Random weights from ``seed`` (``transformer.init_lm``, or
    ``encdec.init_encdec``) and the config's optimizer at step 0, on
    ``device`` (``None``: the card)."""
    init = encdec_mod.init_encdec if cfg.encdec else transformer_mod.init_lm
    model = init(cfg, seed, device)
    opt = opt_mod.get_optimizer(cfg.optimizer)
    opt_state = opt.init(transformer_mod.param_dict(model))
    return TrainState(model, opt_state, torch.zeros(
        (), dtype=torch.int32, device=model.embed.device))


def state_axes(cfg: ModelConfig) -> TrainState:
    """The logical-axes trees of a :class:`TrainState` of ``cfg`` (the
    second value of the reference's ``init_state``): the parameters'
    (``transformer.param_axes``), the optimizer state's, ``()`` for the
    step."""
    axes = (encdec_mod.param_axes(cfg) if cfg.encdec
            else transformer_mod.param_axes(cfg))
    opt = opt_mod.get_optimizer(cfg.optimizer)
    return TrainState(axes, opt.state_axes(axes), ())


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4,
                    microbatches: int = 1, clip_norm: float = 1.0,
                    schedule: Optional[Callable] = None,
                    grad_compression: Optional[str] = None) -> Callable:
    """``grad_compression="int8"`` routes each microbatch's gradients
    through the error-feedback int8 round trip, the wire format of the
    cross-pod data-parallel reduction.  The residual is carried across
    the microbatches within a step and dropped at the step boundary."""
    opt = opt_mod.get_optimizer(cfg.optimizer)
    loss_fn = loss_fn_for(cfg)
    assert grad_compression in (None, "int8"), grad_compression
    # EF needs somewhere to carry the residual; with a single microbatch
    # there is no in-step accumulation loop to carry it through, and a
    # silently-biased quantizer is worse than an error
    assert grad_compression is None or microbatches > 1, \
        "grad_compression requires microbatches > 1 (EF residual carrier)"

    def grads_of(model, named, batch):
        for p in named.values():
            p.grad = None
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        grads = {k: p.grad for k, p in named.items()}
        for p in named.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        model = state.params
        model.requires_grad_(True)
        named = transformer_mod.param_dict(model)
        dev = model.embed.device
        batch = _on(batch, dev)
        lr_t = (schedule(state.step) if schedule is not None
                else torch.tensor(lr, dtype=torch.float32, device=dev))
        if microbatches > 1:
            n = batch["tokens"].shape[0] // microbatches
            inv = f32_recip(microbatches)  # XLA's g / microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in named.items()}
            err = ({k: torch.zeros_like(g) for k, g in grads.items()}
                   if grad_compression else None)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i, _, g_i = grads_of(model, named, mb)
                g_i = {k: g.to(torch.float32) for k, g in g_i.items()}
                if grad_compression:
                    g_i, err = comp_mod.ef_compress_tree(g_i, err)
                for k, a in grads.items():
                    a.add_(g_i[k] * inv)
                del g_i
                loss = loss + l_i * inv
            metrics = {"loss": loss}
        else:
            loss, metrics, grads = grads_of(model, named, batch)
        grads, gnorm = opt_mod.clip_by_global_norm(grads, clip_norm)
        _, new_opt = opt.update(grads, state.opt_state, named, lr_t)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr_t
        return TrainState(model, new_opt, state.step + 1), metrics

    return train_step


# ----------------------------------------------------------------------
def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = loss_fn_for(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, _on(batch, params.embed.device))
        return metrics

    return eval_step


# ----------------------------------------------------------------------
def to_checkpoint(state: TrainState) -> TrainState:
    """``state`` as the reference's ``TrainState`` tree: params and every
    moment as the reference's value tree (``transformer.to_tree``), the
    step counters as they are.  ``ft/checkpoint.py`` writes it in the JAX
    package's format."""
    tree = transformer_mod.to_tree
    opt = state.opt_state
    moments = {f: tree(getattr(opt, f)) for f in opt._fields if f != "step"}
    return TrainState(tree(transformer_mod.param_dict(state.params)),
                      type(opt)(step=opt.step, **moments), state.step)


def from_checkpoint(cfg: ModelConfig, tree,
                    device: DeviceLike = None) -> TrainState:
    """A restored reference ``TrainState`` tree (written by either
    package) as the port's :class:`TrainState` on ``device``."""
    dev = resolve_device(device)
    opt = tree.opt_state
    moments = {f: {k: v.to(dev) for k, v in
                   transformer_mod.from_tree(getattr(opt, f)).items()}
               for f in opt._fields if f != "step"}
    from_numpy = (encdec_mod.params_from_numpy if cfg.encdec
                  else transformer_mod.params_from_numpy)
    return TrainState(
        from_numpy(cfg, tree.params, dev),
        type(opt)(step=opt.step.to(dev), **moments), tree.step.to(dev))
