"""Expert-parallel MoE: capacity-bucketed all-to-all over a rank mesh (the
counterpart of ``repro.models.moe_a2a``).

The ASYMP message-routing pattern applied to token -> expert dispatch:
each rank buckets its local (token, slot) pairs by *destination rank*
(the model-axis rank owning that expert) into a fixed-capacity
``[tp, cap]`` buffer (overflow drops, the paper's bounded message
queues), exchanges the buffers with one all-to-all over the ``model``
axis, runs its local experts as one batched product, and reverses the
route for the combine.

The reference runs :func:`_local_moe` under ``shard_map``, whose specs cut
the global arrays into each device's block.  Here each rank of a
``dist/sharding.py::Mesh`` is handed its block already: the tokens laid
out as the reference's ``x_spec`` (batch over the data axes when the
batch divides, seq over ``model`` when the sequence divides;
:func:`rank_block` cuts them) and the expert weights as its ``w_spec``
(experts over ``model``, and with FSDP dim 1 over the data axes;
:func:`rank_weights` cuts them from the global arrays).  The collectives
are ``dist/exchange.py``'s (``all_gather``, ``all_to_all``), which carry
gradients as ``shard_map``'s do, so the layer trains expert-parallel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import exchange as ex_mod
from repro_torch.dist.sharding import current_mesh


def _pair_ranks_by(owner_flat: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """rank of each pair within its bucket (stable, index-only)."""
    n = owner_flat.shape[0]
    order = torch.argsort(owner_flat, stable=True)
    so = owner_flat[order]
    starts = torch.searchsorted(so, torch.arange(
        n_buckets, dtype=so.dtype, device=so.device))
    pos = torch.arange(n, device=owner_flat.device)
    rank_sorted = pos - starts[so]
    inv = torch.empty_like(order).scatter_(0, order, pos)
    return rank_sorted[inv]


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def token_spec(mesh, B: int, S: int) -> tuple:
    """The reference's ``x_spec`` entries for a global ``[B, S, ...]``:
    (batch axes or None, ``"model"`` or None)."""
    dp_axes = _dp_axes(mesh)
    dp_total = math.prod(mesh.shape[a] for a in dp_axes)
    bs = dp_axes if (dp_axes and B % dp_total == 0) else None
    ss = "model" if S % mesh.shape.get("model", 1) == 0 else None
    return bs, ss


def fsdp_axes(mesh, cfg: ModelConfig, D: int) -> tuple:
    """The data axes the expert weights' dim 1 is split over (the
    reference's ``fsdp``), or ``()``."""
    dp_axes = _dp_axes(mesh)
    dp_total = math.prod(mesh.shape[a] for a in dp_axes)
    if (cfg.fsdp and dp_axes and D % dp_total == 0
            and cfg.d_ff % dp_total == 0):
        return dp_axes
    return ()


def _cut(a, dim: int, parts: int, index: int):
    n = a.shape[dim] // parts
    return a[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]


def rank_block(x, mesh):
    """This rank's block of a global ``[B, S, ...]`` token array (numpy
    or tensor), as the reference's ``x_spec`` cuts it."""
    bs, ss = token_spec(mesh, x.shape[0], x.shape[1])
    if bs:
        x = _cut(x, 0, math.prod(mesh.shape[a] for a in bs), mesh.index(bs))
    if ss:
        x = _cut(x, 1, mesh.shape["model"], mesh.coords["model"])
    return x


def rank_weights(p: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's slices of a global MoE parameter dict (numpy arrays or
    tensors): ``w_in``/``w_gate``/``w_out`` as the reference's ``w_spec``
    (experts over ``model``; dim 1 over the data axes under FSDP), every
    other leaf (the router, the shared experts) whole.  An expert count
    the model axis does not divide takes ``moe.apply_moe``'s grouped
    local dispatch, which holds every expert: the dict comes back
    whole."""
    tp = mesh.shape.get("model", 1)
    fsdp = fsdp_axes(mesh, cfg, cfg.d_model)
    out = dict(p)
    if cfg.num_experts % tp:
        return out
    for name in ("w_in", "w_gate", "w_out"):
        w = _cut(p[name], 0, tp, mesh.coords.get("model", 0))
        if fsdp:
            w = _cut(w, 1, math.prod(mesh.shape[a] for a in fsdp),
                     mesh.index(fsdp))
        out[name] = np.ascontiguousarray(w) if isinstance(
            w, np.ndarray) else w.contiguous()
    return out


def _local_moe(w_in, w_gate, w_out, x_l, gate_l, sel_l, *,
               cfg: ModelConfig, mesh, dp_axes: tuple):
    """One rank's body.  x_l [B_l, S_l, D]; w_* local expert slices
    [E_loc, D/dp, F] (FSDP: gathered over the data axes just-in-time);
    sel/gate [B_l, S_l, k]."""
    from repro_torch.models.moe import experts_forward

    tp = mesh.shape["model"]
    group = mesh.group("model")
    if dp_axes:  # FSDP all-gather of this layer's expert weights
        dp = mesh.group(dp_axes)
        w_in = ex_mod.all_gather(w_in, dp, dim=1)
        w_gate = ex_mod.all_gather(w_gate, dp, dim=1)
        w_out = ex_mod.all_gather(w_out, dp, dim=1)

    E, k = cfg.num_experts, cfg.experts_per_token
    E_loc = E // tp
    B_l, S_l, D = x_l.shape
    T_l = B_l * S_l
    xt = x_l.reshape(T_l, D)
    sel_f = sel_l.reshape(T_l, k).long()
    gate_f = gate_l.reshape(T_l, k)
    owner = sel_f // E_loc  # destination rank per pair

    # ---- outbound bucketing (ASYMP: bounded per-destination queues) ----
    cap = max(int(math.ceil(cfg.capacity_factor * T_l * k / tp)), 8)
    rank = _pair_ranks_by(owner.reshape(-1), tp).reshape(T_l, k)
    kept = rank < cap
    spare = tp * cap
    send = xt.new_zeros((spare + 1, D))
    send_eid = torch.full((spare + 1,), E_loc, dtype=torch.int32,
                          device=xt.device)  # E_loc = invalid slot
    for j in range(k):
        slot = torch.where(kept[:, j], owner[:, j] * cap + rank[:, j], spare)
        send.index_put_((slot,), xt)
        send_eid.index_put_((slot,), (sel_f[:, j] % E_loc).to(torch.int32))
    send, send_eid = send[:spare], send_eid[:spare]

    # ---- the MoE all-to-all (route messages to expert owners) ----
    recv = ex_mod.all_to_all(send, group)
    eids = ex_mod.all_to_all(send_eid, group).long()

    # ---- local expert bucketing + batched products ----
    n_pairs = tp * cap
    C_loc = max(int(math.ceil(n_pairs / max(E_loc, 1))), 8)
    rank2 = _pair_ranks_by(eids, E_loc + 1)
    valid = (rank2 < C_loc) & (eids < E_loc)
    e2 = torch.clamp(eids, max=E_loc - 1)
    r2 = torch.clamp(rank2, max=C_loc - 1)
    buf = recv.new_zeros((E_loc * C_loc + 1, D))  # the last row: drops
    buf.index_put_((torch.where(valid, e2 * C_loc + r2, E_loc * C_loc),),
                   recv)
    buf = buf[:E_loc * C_loc].view(E_loc, C_loc, D)
    out_b = experts_forward(w_in, w_gate, w_out, cfg.act, buf)

    # ---- inverse route ----
    back_flat = torch.where(valid[:, None],
                            out_b.reshape(E_loc * C_loc, D)[e2 * C_loc + r2],
                            0.0).to(x_l.dtype)
    back = ex_mod.all_to_all(back_flat, group)

    # ---- combine at source (k gathers, fp32 accumulation) ----
    y = torch.zeros((T_l, D), dtype=torch.float32, device=x_l.device)
    for j in range(k):
        vals = back[owner[:, j] * cap + torch.clamp(rank[:, j], max=cap - 1)]
        y = y + torch.where(kept[:, j, None],
                            vals.float() * gate_f[:, j, None], 0.0)
    return y.reshape(B_l, S_l, D).to(x_l.dtype)


def apply_moe_a2a(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  gate: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """x [B_l, S_l, D], gate/sel [B_l, S_l, k]: this rank's blocks (laid
    out as the reference's ``x_spec``); ``p``'s experts this rank's
    slices (``w_spec``).  Returns this rank's block of the output."""
    mesh = current_mesh()
    assert mesh is not None, "apply_moe_a2a requires a mesh context"
    fsdp = fsdp_axes(mesh, cfg, x.shape[-1])
    return _local_moe(p["w_in"], p["w_gate"], p["w_out"], x, gate, sel,
                      cfg=cfg, mesh=mesh, dp_axes=fsdp)
