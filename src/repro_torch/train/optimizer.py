"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second moment)
(the counterpart of ``repro.train.optimizer``).

Both keep the reference's functional triple:
    init(params) -> state
    update(grads, state, params, lr) -> (params, state)
    state_axes(param_axes) -> logical-axes tree for the state (sharding)

``params``, ``grads`` and every moment tree are dicts name -> tensor in
the reference's leaf layout (``transformer.param_dict``: a scan stack's
leaves are ``[L, ...]``), so the reference's per-leaf rules hold as they
are: weight decay on leaves with ``ndim >= 2``, Adafactor's factoring of
the last two dims and its update clipping over the whole leaf.

The reference's update is functional (``jax.tree.map`` builds new
moments and parameters, and the launcher donates the old buffers to
XLA).  Run eagerly, that would hold old and new moments at once: +32 GB
for AdamW at qwen3-4b.  Here ``update`` writes the moments and the
parameters in place, leaf by leaf, and AdamW and the clip walk each leaf
in pieces of at most ``PIECE`` elements (elementwise, so the pieces give
the reference's arithmetic), so only one piece's fp32 temporaries are
live at a time.  Adafactor walks a leaf of more than ``PIECE`` elements
in pieces too (:meth:`Adafactor._update_in_pieces`; a leaf of at most
``PIECE`` keeps the whole-leaf arithmetic): its whole-leaf fp32
temporaries on deepseek-v3's ``[256, 7168, 2048]`` expert leaf would be
15 GB each.  ``update`` returns the same ``params`` and a state
holding the same moment tensors with the step advanced.

``state_axes`` maps the reference's logical-axes tree of the parameters
(``transformer.param_axes``) to the state's, as the reference's does;
``dist/sharding.py::ShardingRules`` resolves it on a mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.layers import f32_recip

PIECE = 1 << 26  # elements of a leaf updated at once (256 MiB in fp32)


def is_axes(x) -> bool:
    """Leaf predicate for logical-axes trees (tuples of str|None)."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _map_axes(fn, tree):
    """``fn`` on every axes leaf of a tree of dicts and tuples."""
    if is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    return tuple(_map_axes(fn, v) for v in tree)


def _piece(t: torch.Tensor) -> int:
    """The elements ``t`` is cut into pieces of: ``PIECE``, or the whole
    of a ``"meta"`` tensor, which holds no data to bound (the dry run's
    and the roofline's shape-only steps run each leaf as one piece
    through the path its size selects, the same ops without the per-piece
    dispatch)."""
    return max(t.numel(), 1) if t.is_meta else PIECE


def _pieces(t: torch.Tensor):
    """Views of ``t`` along dim 0, each of at most ``_piece(t)`` elements
    (one row at least)."""
    if t.ndim == 0 or t.numel() <= _piece(t):
        return (t,)
    rows = max(1, _piece(t) // (t.numel() // t.shape[0]))
    return t.split(rows, 0)


# ======================================================================
# schedules / clipping
# ======================================================================
def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)``: a float32 0-d tensor on ``step``'s device, spelled as
    the reference computes it under ``jit`` (a division by a constant is
    a product with its float32 reciprocal)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step * f32_recip(max(warmup, 1))
        frac = torch.clamp((step - warmup) * f32_recip(max(total - warmup, 1)),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    total = None
    for x in tree.values():
        for piece in _pieces(x):
            s = torch.sum(torch.square(piece.to(torch.float32)))
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm`` (each leaf through fp32, back to its dtype); returns
    ``(grads, norm before the clip)``."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        for piece in _pieces(g):
            piece.copy_(piece.to(torch.float32) * scale)
    return grads, gn


# ======================================================================
# AdamW
# ======================================================================
class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: dict
    v: dict


def _device_of(params: dict) -> torch.device:
    return next(iter(params.values())).device


class AdamW:
    def __init__(self, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params: dict) -> AdamWState:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
        return AdamWState(torch.zeros((), dtype=torch.int32,
                                      device=_device_of(params)),
                          zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict, lr):
        step = state.step + 1
        t = step.to(torch.float32)
        b1, b2 = self.b1, self.b2
        f32 = torch.float32
        # the reference's float32 power (a float64 b1 ** t is an ulp off)
        bc1 = 1 - torch.tensor(b1, dtype=f32, device=t.device) ** t
        bc2 = 1 - torch.tensor(b2, dtype=f32, device=t.device) ** t
        for k, p in params.items():
            decay = p.ndim >= 2  # decoupled weight decay on matrices only
            for pp, gp, mp, vp in zip(_pieces(p), _pieces(grads[k]),
                                      _pieces(state.m[k]),
                                      _pieces(state.v[k])):
                g32 = gp.to(f32)
                mp.mul_(b1).add_(g32 * (1 - b1))
                vp.mul_(b2).add_(torch.square(g32) * (1 - b2))
                u = (mp / bc1).div_(torch.sqrt(vp / bc2).add_(self.eps))
                p32 = pp.to(f32)
                if decay:
                    u.add_(self.wd * p32)
                pp.copy_(p32 - lr * u)
        return params, AdamWState(step, state.m, state.v)

    def state_axes(self, param_axes) -> AdamWState:
        return AdamWState((), param_axes, param_axes)


# ======================================================================
# Adafactor (Shazeer & Stern 2018), beta1=0 variant
# ======================================================================
class AdafactorState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    vr: dict  # row moments (last dim reduced)
    vc: dict  # col moments (second-to-last dim reduced)
    v: dict  # full moments for unfactored leaves


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2


def _mean(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean`` under jit: the sum times the float32 reciprocal of
    the count."""
    return torch.sum(x, dim=dim, keepdim=keepdim) * f32_recip(x.shape[dim])


class Adafactor:
    def __init__(self, eps=1e-30, clip_threshold=1.0, weight_decay=0.0):
        self.eps, self.clip, self.wd = eps, clip_threshold, weight_decay

    def init(self, params: dict) -> AdafactorState:
        def z(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        one = (1,)
        vr = {k: z(p.shape[:-1] if _factored(p) else one, p)
              for k, p in params.items()}
        vc = {k: z(p.shape[:-2] + p.shape[-1:] if _factored(p) else one, p)
              for k, p in params.items()}
        v = {k: z(one if _factored(p) else p.shape, p)
             for k, p in params.items()}
        return AdafactorState(torch.zeros((), dtype=torch.int32,
                                          device=_device_of(params)),
                              vr, vc, v)

    @torch.no_grad()
    def update(self, grads: dict, state: AdafactorState, params: dict, lr):
        step = state.step + 1
        t = step.to(torch.float32)
        beta2 = 1.0 - t ** -0.8  # Shazeer decay schedule
        eps = self.eps
        for k, p in params.items():
            if p.numel() > PIECE:
                self._update_in_pieces(p, grads[k], state, k, beta2, lr)
                continue
            gf = grads[k].to(torch.float32)
            sq = torch.square(gf) + eps
            if _factored(p):
                vr, vc = state.vr[k], state.vc[k]
                vr.copy_(beta2 * vr + (1 - beta2) * _mean(sq, -1))
                vc.copy_(beta2 * vc + (1 - beta2) * _mean(sq, -2))
                denom = ((vr[..., None] / _mean(vr, -1, True)[..., None])
                         * vc[..., None, :])
                u = gf / torch.sqrt(denom + eps)
            else:
                v = state.v[k]
                v.copy_(beta2 * v + (1 - beta2) * sq)
                u = gf / torch.sqrt(v + eps)
            del sq
            rms = torch.sqrt(torch.sum(u * u) * f32_recip(u.numel()) + 1e-30)
            u = u / torch.clamp(rms / self.clip, min=1.0)
            p32 = p.to(torch.float32)
            if self.wd and p.ndim >= 2:
                u = u + self.wd * p32
            p.copy_(p32 - lr * u)
        return params, AdafactorState(step, state.vr, state.vc, state.v)

    def _update_in_pieces(self, p: torch.Tensor, g: torch.Tensor,
                          state: AdafactorState, k: str, beta2, lr) -> None:
        """The update of one leaf of more than ``PIECE`` elements, in
        pieces: the moments, then the sum of ``u * u`` over the pieces
        (the update's RMS is the whole leaf's), then the parameters (``u``
        recomputed a piece at a time).  A factored leaf of three or more
        dims is a stack of ``[R, C]`` matrices, each factored alone, so
        its pieces are whole matrices and its moments exact; a two-dim
        leaf is cut into rows, which its row moment ``vr`` follows exactly
        and its column moment ``vc`` (a mean over the rows) gathers as a
        sum over the pieces."""
        eps, f32 = self.eps, torch.float32
        if not _factored(p):
            v = state.v[k]
            for gi, vi in zip(_pieces(g), _pieces(v)):
                vi.copy_(beta2 * vi + (1 - beta2)
                         * (torch.square(gi.to(f32)) + eps))

            def updates():
                for gi, vi in zip(_pieces(g), _pieces(v)):
                    yield gi.to(f32) / torch.sqrt(vi + eps)
            self._apply(p, _pieces(p), updates, lr)
            return
        R, C = p.shape[-2:]
        vr, vc = state.vr[k], state.vc[k]
        if p.ndim == 2:  # row blocks; vc is a mean over every block
            n = max(1, _piece(p) // C)
            spans = [slice(i, i + n) for i in range(0, R, n)]
            col = torch.zeros_like(vc)
            for sl in spans:
                sq = torch.square(g[sl].to(f32)) + eps
                vr[sl].copy_(beta2 * vr[sl] + (1 - beta2) * _mean(sq, -1))
                col.add_(torch.sum(sq, dim=-2))
            vc.copy_(beta2 * vc + (1 - beta2) * (col * f32_recip(R)))
            r_mean = _mean(vr, -1, True)

            def denoms():
                for sl in spans:
                    yield sl, (vr[sl][..., None] / r_mean[..., None]
                               ) * vc[..., None, :]
            ps = [p[sl] for sl in spans]
        else:  # whole [R, C] matrices of the flattened leading dims
            p, g = p.view(-1, R, C), g.reshape(-1, R, C)
            vr, vc = vr.view(-1, R), vc.view(-1, C)  # written in place
            n = max(1, _piece(p) // (R * C))
            spans = [slice(i, i + n) for i in range(0, p.shape[0], n)]
            for sl in spans:
                sq = torch.square(g[sl].to(f32)) + eps
                vr[sl].copy_(beta2 * vr[sl] + (1 - beta2) * _mean(sq, -1))
                vc[sl].copy_(beta2 * vc[sl] + (1 - beta2) * _mean(sq, -2))
            r_mean = _mean(vr, -1, True)

            def denoms():
                for sl in spans:
                    yield sl, (vr[sl][..., None] / r_mean[sl][..., None]
                               ) * vc[sl][..., None, :]
            ps = [p[sl] for sl in spans]

        def updates():
            for sl, denom in denoms():
                yield g[sl].to(f32) / torch.sqrt(denom + eps)
        self._apply(p, ps, updates, lr)

    def _apply(self, p: torch.Tensor, pieces, updates, lr) -> None:
        """Clip the update by its RMS over the whole leaf (a first pass
        over ``updates()``), then write each piece of ``p``."""
        ss = None
        for u in updates():
            s = torch.sum(u * u)
            ss = s if ss is None else ss + s
        rms = torch.sqrt(ss * f32_recip(p.numel()) + 1e-30)
        scale = torch.clamp(rms / self.clip, min=1.0)
        for pi, u in zip(pieces, updates()):
            u = u / scale
            p32 = pi.to(torch.float32)
            if self.wd and p.ndim >= 2:
                u = u + self.wd * p32
            pi.copy_(p32 - lr * u)

    def state_axes(self, param_axes) -> AdafactorState:
        def vr_ax(ax):
            return tuple(ax[:-1]) if len(ax) >= 2 else (None,)

        def vc_ax(ax):
            return tuple(ax[:-2]) + tuple(ax[-1:]) if len(ax) >= 2 else (None,)

        def v_ax(ax):
            return (None,) if len(ax) >= 2 else tuple(ax)

        return AdafactorState((), _map_axes(vr_ax, param_axes),
                              _map_axes(vc_ax, param_axes),
                              _map_axes(v_ax, param_axes))


def get_optimizer(name: str, **kw):
    return {"adamw": AdamW, "adafactor": Adafactor}[name](**kw)
