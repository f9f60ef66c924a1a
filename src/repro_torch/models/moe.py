"""Mixture-of-Experts with capacity-bucketed sort-based dispatch (the
counterpart of ``repro.models.moe``).

The dispatch is the ASYMP engine's message routing applied to tokens:
(token, expert) pairs are bucketed into a fixed-capacity ``[E, C]``
buffer (overflow drops, as the engine's bounded queues do), a batched
per-expert product runs on the buckets, and the results are gathered
back to their tokens and summed in fp32 with the gate.

The arithmetic is the reference's: fp32 router logits of a bf16 product,
softmax and top-k (ties to the lower expert: a stable descending sort,
as ``lax.top_k``), the gate renormalized by ``max(sum, 1e-9)``, the
switch aux loss, bf16 expert products, ``act_fn(g) * h``, the fp32
combine, the shared-expert branch, the cast back to ``x.dtype``.

Layout.  The reference buckets into ``[G, E, C, D]`` and contracts with
an einsum over the group axis; the port buckets expert-major into one
flat buffer (``[E, G, C, D]`` plus a spare row that takes every
overflow pair, sliced off, as the port's semirings drop out-of-range
scatters), so each expert's rows are one ``[G * C, D]`` block and the
three products are ``torch.bmm`` over the expert axis (the weights are
read once, never broadcast over the groups).  The scatters are
``index_put_`` and the gathers index the same flat buffer, so autograd
differentiates both.

Under a mesh (``dist/sharding.py::use_mesh_rules``) ``x`` is this rank's
block of the tokens and ``p`` its weight slices
(``moe_a2a.rank_weights``): the reference's own condition
(``mesh.shape["model"] > 1 and E % tp == 0``) sends the tokens to their
experts' ranks through ``moe_a2a.apply_moe_a2a``, and the aux loss's
density and mean probability are summed over every rank and divided by
the global token count, as GSPMD computes them over the global tokens.
An expert count the model axis does not divide takes the grouped local
dispatch, as the reference's does: each rank all-gathers the blocks of
its groups, dispatches whole groups over every expert
(``moe_a2a.rank_weights`` leaves them whole) and keeps its own block, as
GSPMD gathers each group.  The
collectives carry gradients, so both mesh paths train.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import exchange as ex_mod
from repro_torch.dist.sharding import current_mesh
from repro_torch.models.layers import act_fn, f32_recip, mk


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """The reference's leaves and shapes: ``router [D, E]`` (scale 0.02),
    ``w_in``/``w_gate [E, D, F]``, ``w_out [E, F, D]`` (``mk``'s default
    scale, ``1/sqrt(E)``: its fan-in is the leading dim, as there) and
    the ``shared_*`` leaves when ``num_shared_experts > 0``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": mk(gen, (d, e), scale=0.02, device=device),
         "w_in": mk(gen, (e, d, f), device=device),
         "w_gate": mk(gen, (e, d, f), device=device),
         "w_out": mk(gen, (e, f, d), device=device)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_w_in"] = mk(gen, (d, fs), device=device)
        p["shared_w_gate"] = mk(gen, (d, fs), device=device)
        p["shared_w_out"] = mk(gen, (fs, d), device=device)
    return p


def _pair_ranks(sel: torch.Tensor, E: int) -> torch.Tensor:
    """sel [..., T, k] -> rank [..., T, k]: the position of each (token,
    slot) pair within its expert's bucket, batched over the leading dims.
    A stable argsort of the ``T * k`` expert ids, so the lower (token,
    slot) wins a bucket, as ``jnp.argsort`` orders them."""
    *lead, T, k = sel.shape
    pair_expert = sel.reshape(*lead, T * k)
    order = torch.argsort(pair_expert, dim=-1, stable=True)
    se = torch.gather(pair_expert, -1, order)
    experts = torch.arange(E, dtype=se.dtype, device=se.device)
    starts = torch.searchsorted(se, experts.expand(*lead, E).contiguous())
    pos = torch.arange(T * k, device=sel.device).expand_as(pair_expert)
    rank_sorted = pos - torch.gather(starts, -1, se)
    inv = torch.empty_like(order).scatter_(-1, order, pos)
    return torch.gather(rank_sorted, -1, inv).reshape(sel.shape)


def _flat_slots(sel, rank, C: int) -> torch.Tensor:
    """sel/rank [G, Tg] of one slot -> each pair's row in the flat
    ``[E, G, C]`` buffer, clamped to the last slot of its bucket."""
    G = sel.shape[0]
    g = torch.arange(G, device=sel.device)[:, None]
    return (sel * G + g) * C + torch.clamp(rank, max=C - 1)


def _group_dispatch(xg: torch.Tensor, sel: torch.Tensor, rank: torch.Tensor,
                    E: int, C: int) -> torch.Tensor:
    """xg [G, Tg, D]; sel/rank [G, Tg, k] -> buf [E, G, C, D] (row ``g`` of
    expert ``e`` is the reference's ``buf[g, e]``).

    k scatters whose update operand is xg itself (no pair expansion);
    a pair of rank >= C goes to the spare row past the buffer, which is
    sliced off (the reference's ``mode="drop"``)."""
    G, Tg, D = xg.shape
    spare = E * G * C
    flat = xg.new_zeros((spare + 1, D))
    rows = xg.reshape(G * Tg, D)
    for j in range(sel.shape[-1]):
        idx = torch.where(rank[..., j] < C,
                          _flat_slots(sel[..., j], rank[..., j], C), spare)
        flat.index_put_((idx.reshape(-1),), rows)
    return flat[:spare].view(E, G, C, D)


def _group_combine(out_e: torch.Tensor, sel: torch.Tensor,
                   rank: torch.Tensor, gate: torch.Tensor,
                   C: int) -> torch.Tensor:
    """out_e [E, G, C, D] -> y [G, Tg, D]: k gathers, fp32 accumulation."""
    E, G, _, D = out_e.shape
    flat = out_e.reshape(E * G * C, D)
    y = torch.zeros(sel.shape[:2] + (D,), dtype=torch.float32,
                    device=out_e.device)
    for j in range(sel.shape[-1]):
        keep = rank[..., j] < C
        vals = flat[_flat_slots(sel[..., j], rank[..., j], C)]
        y = y + torch.where(keep[..., None],
                            vals.float() * gate[..., j, None], 0.0)
    return y


def capacity(cfg: ModelConfig, Tg: int) -> int:
    """The bucket size of a group of ``Tg`` tokens (the reference's Python
    float arithmetic, floored by ``int``)."""
    return max(int(cfg.capacity_factor * Tg * cfg.experts_per_token
                   / cfg.num_experts), 1)


def groups_of(x: torch.Tensor) -> tuple[int, int]:
    """(G, Tg): the batch rows for train/prefill, one group for decode."""
    B, S, _ = x.shape
    return (B, S) if S > 1 else (1, B * S)


def route(p: dict, cfg: ModelConfig, xg: torch.Tensor):
    """xg [G, Tg, D] -> (probs [G, Tg, E] fp32, gate [G, Tg, k] fp32, sel
    [G, Tg, k] int64).  Top-k by a stable descending sort: equal
    probabilities (equal bf16 logits) go to the lower expert first, as
    ``lax.top_k`` takes them."""
    logits = (xg @ p["router"]).to(torch.float32)
    e = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    probs = e / e.sum(-1, keepdim=True)  # jax.nn.softmax
    k = cfg.experts_per_token
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = vals[..., :k], idx[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, sel


def aux_loss(cfg: ModelConfig, probs: torch.Tensor, sel: torch.Tensor,
             mesh=None) -> torch.Tensor:
    """The switch load-balance loss: the density of each expert's pairs
    (a scatter-add) times its mean probability.  Under a mesh the counts,
    the probability sums and the token count are summed over every rank
    first (each rank holds a block of the tokens)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device)
    counts = counts.index_add(0, sel.reshape(-1),
                              torch.ones(sel.numel(), dtype=torch.float32,
                                         device=probs.device))
    psum = probs.reshape(-1, E).sum(0)
    T = probs.numel() // E
    if mesh is not None:
        packed = torch.cat([counts, psum, torch.tensor(
            [T], dtype=torch.float32, device=probs.device)])
        packed = ex_mod.all_reduce_sum(packed, mesh.group(tuple(mesh.shape)))
        counts, psum, T = packed[:E], packed[E:2 * E], int(packed[-1])
    density = counts * f32_recip(T * k)
    mean_prob = psum * f32_recip(T)
    return cfg.router_aux_coef * E * torch.sum(density * mean_prob) * k


def experts_forward(w_in, w_gate, w_out, act: str,
                    buf: torch.Tensor) -> torch.Tensor:
    """buf [E, N, D] -> [E, N, D]: each expert's gated MLP on its rows
    (the reference's three grouped einsums)."""
    h = torch.bmm(buf, w_in)
    g = torch.bmm(buf, w_gate)
    return torch.bmm(act_fn(act)(g) * h, w_out)


def _local_dispatch(p: dict, cfg: ModelConfig, xg, gate, sel):
    """The grouped local dispatch: xg [G, Tg, D], gate/sel [G, Tg, k] ->
    y [G, Tg, D] fp32 (every expert on this process)."""
    G, Tg, D = xg.shape
    E = cfg.num_experts
    C = capacity(cfg, Tg)
    rank = _pair_ranks(sel, E)
    buf = _group_dispatch(xg, sel, rank, E, C)
    out_e = experts_forward(p["w_in"], p["w_gate"], p["w_out"], cfg.act,
                            buf.view(E, G * C, D))
    return _group_combine(out_e.view(E, G, C, D), sel, rank, gate, C)


def _gathered_dispatch(p: dict, cfg: ModelConfig, mesh, x, gate, sel):
    """The reference's indivisible case under a mesh: this rank's block x
    [B_l, S_l, D] of global tokens that ``moe_a2a.rank_block`` cut on
    every axis it cuts (B_l times the data axes; S_l times the model axis
    when S_l > 1, else one token a row).  A group (a row when S > 1, every
    token when S == 1) is gathered from the ranks holding its blocks,
    dispatched whole, and this rank's block of the result kept."""
    from repro_torch.models.moe_a2a import token_spec
    B_l, S_l = x.shape[:2]
    dp = math.prod(mesh.shape[a] for a in ("pod", "data") if a in mesh.shape)
    tokens = (B_l * dp, S_l * mesh.shape["model"] if S_l > 1 else 1)
    bs, ss = token_spec(mesh, *tokens)
    dim, axes = (1, ss) if tokens[1] > 1 else (0, bs)
    if axes:
        group = mesh.group(axes)
        x, gate, sel = (ex_mod.all_gather(t, group, dim=dim)
                        for t in (x, gate, sel))
    B, S, D = x.shape
    G, Tg = (B, S) if S > 1 else (1, B * S)
    y = _local_dispatch(p, cfg, x.reshape(G, Tg, D),
                        gate.reshape(G, Tg, -1), sel.reshape(G, Tg, -1))
    y = y.reshape(B, S, D)
    if axes:
        n = y.shape[dim] // ex_mod.group_size(group)
        i = mesh.index(axes)
        y = y.narrow(dim, i * n, n)
    return y


def apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux_loss scalar).

    GShard-style grouped dispatch: tokens are bucketed within groups (the
    batch rows for train/prefill; one group for decode)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    G, Tg = groups_of(x)
    xg = x.reshape(G, Tg, D)
    probs, gate, sel = route(p, cfg, xg)
    mesh = current_mesh()
    aux = aux_loss(cfg, probs, sel, mesh)

    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    if mesh is not None and tp > 1 and E % tp == 0:
        # expert parallel: the all-to-all to the experts' ranks
        from repro_torch.models.moe_a2a import apply_moe_a2a
        y = apply_moe_a2a(p, cfg, x, gate.reshape(B, S, k).float(),
                          sel.reshape(B, S, k).to(torch.int32))
        y = y.reshape(G, Tg, D).to(torch.float32)
    elif mesh is not None and tp > 1:
        y = _gathered_dispatch(p, cfg, mesh, x, gate.reshape(B, S, k),
                               sel.reshape(B, S, k))
    else:
        y = _local_dispatch(p, cfg, xg, gate, sel)

    if cfg.num_shared_experts:
        xt = x.reshape(T, D)
        hs = xt @ p["shared_w_in"]
        gs = act_fn(cfg.act)(xt @ p["shared_w_gate"])
        y = y.reshape(T, D) + ((gs * hs) @ p["shared_w_out"]).to(
            torch.float32)

    return y.reshape(B, S, D).to(x.dtype), aux
