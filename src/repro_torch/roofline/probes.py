"""Per-layer cost probes: the roofline's FLOPs and bytes, counted op by op
(the counterpart of ``repro.roofline.probes``).

The reference compiles one probe per distinct layer type (plus the
embed+loss head, the decode logits and the optimizer) on the production
mesh and reads XLA's ``cost_analysis``, then composes

    cost(cell) = sum_layer_types count * cost(probe) + head + optimizer.

The port has no compiler.  Each probe runs the port's own code once on
``"meta"`` tensors (shapes only: nothing is allocated or computed) inside
:class:`CostMode`, a ``TorchDispatchMode`` that sees every aten op the
forward and the autograd backward run and counts:

  * **products**: ``torch.utils.flop_counter``'s formulas (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``, ...; einsums and matmuls lower to
    them), kept apart as ``product_flops`` so the tensor-core share reads
    on its own;
  * **elementwise work**: one FLOP per output element of each pointwise op
    (dtype conversions included) and one per input element of each
    reduction, as XLA's ``HloCostAnalysis`` counts them; the
    transcendental ops (``exp``, ``log``, ``rsqrt``, ...) are
    ``transcendentals``, outside ``flops``, as there.  Trap:
    ``FlopCounterMode`` counts products only, and the optimizer's FLOPs
    are all elementwise, which is why this mode counts both;
  * **bytes**: each op's inputs read and outputs written (a broadcast
    input counted once; a view moves nothing; a gather reads what it
    writes; a scatter or ``copy_`` writes its source's bytes).  That is
    what the eager port moves; XLA's fused ``bytes accessed`` is lower,
    and the two are not held equal.

Trap: the reference unrolls its inner scans for cost analysis
(``_unrolled``, ``models/flags.py``): XLA counts a while loop's body
once.  The port's flash loop, chunked loss and SSD chunks are Python
loops, so every trip is counted as it runs, and ``_unrolled`` has no
counterpart.  Trap: a meta tensor has no value, so a probe may not read
one on the host (``.item()``, ``.cpu()``, ``nonzero``).  The probes call
the layers, the loss head and the update directly: the MoE dispatch
inside a layer is index arithmetic on the device, and the serving
engine's host reads (``serve/engine.py``'s sampling and slot loop) stay
outside them.

Per rank: the reference probes under the 16 x 16 mesh's shardings, so its
numbers are per device.  The port has no GSPMD: its probes count the
whole layer at the cell's global batch and sequence on one rank, and
:func:`cell_costs` divides each piece's products, elementwise work and
bytes by the mesh's share of that work: the axes the batch dimension's
``"batch"`` resolves to, times the ``model`` axis weighted over the
piece's parameters by how much of each leaf ``resolve`` cuts on it (a
layer whose heads replicate, like hymba's 25, keeps that part whole).  A
parameter cut only on ``fsdp`` (the data axes) is gathered before use and
divides no work.  The optimizer's piece is divided by the parameters'
per-rank share, which FSDP and the model axis both cut.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import ShardingRules, block_shape
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as transformer_mod
from repro_torch.models.layers import chunked_softmax_xent, rms_norm
from repro_torch.train import optimizer as opt_mod

META = torch.device("meta")
_BF16 = torch.bfloat16
aten = torch.ops.aten

_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.argmax, aten.argmin, aten.prod, aten.cumsum,
               aten.logsumexp, aten._softmax, aten._log_softmax,
               aten._softmax_backward_data, aten._log_softmax_backward_data,
               aten.var, aten.linalg_vector_norm, aten.sort, aten.topk}
# XLA counts these as transcendentals, outside its flops
_TRANSCENDENTAL = {aten.exp, aten.exp2, aten.expm1, aten.log, aten.log2,
                   aten.log1p, aten.tanh, aten.sigmoid, aten.rsqrt,
                   aten.sqrt, aten.sin, aten.cos, aten.tan, aten.erf,
                   aten.atan2}
_CONVERTS = {aten._to_copy}
# read what they write (the gathered rows, not the whole table)
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index}
# write their source's bytes into the first argument, which they do not read
_SCATTERS = {aten.index_copy_, aten.index_copy, aten.index_put_,
             aten.index_put, aten.scatter_, aten.scatter, aten.copy_,
             aten.slice_scatter, aten.select_scatter}
# produce an uninitialised buffer
_NO_WRITE = {aten.empty, aten.empty_strided, aten.new_empty,
             aten.empty_like, aten.new_empty_strided}
_ALIASES = {aten._unsafe_view, aten.detach, aten.alias, aten.lift_fresh}


def _bytes(t: torch.Tensor) -> int:
    """Bytes ``t`` spans: a broadcast (stride 0) dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Counts the aten ops run inside it (see the module docstring);
    :meth:`cost` returns the record.  ``collectives`` is the log a
    ``ShapeOnlyGroup`` appends to when a traced tick runs inside it."""

    def __init__(self):
        super().__init__()
        self.product_flops = 0
        self.elementwise_flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.collectives: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.product_flops += int(flop_registry[packet](
                *args, **kwargs, out_val=out))
        elif packet in _REDUCTIONS:
            self.elementwise_flops += _tensors(args)[0].numel()
        elif packet in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        elif torch.Tag.pointwise in func.tags or packet in _CONVERTS:
            self.elementwise_flops += sum(t.numel() for t in _tensors(out))
        if func.is_view or packet in _ALIASES or packet in _NO_WRITE:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if packet in _GATHERS:
            self.bytes += 2 * sum(_bytes(t) for t in outs) + sum(
                _bytes(t) for t in ins[1:] if not t.is_floating_point())
        elif packet in _SCATTERS:
            src = ins[1:]
            self.bytes += sum(_bytes(t) for t in src) + _bytes(src[-1])
        else:
            self.bytes += sum(_bytes(t) for t in ins + outs)
        return out

    def cost(self) -> dict:
        return {"flops": float(self.product_flops + self.elementwise_flops),
                "product_flops": float(self.product_flops),
                "transcendentals": float(self.transcendentals),
                "bytes": float(self.bytes)}


def _tokens(B: int, S: int) -> torch.Tensor:
    return torch.empty((B, S), dtype=torch.long, device=META)


def _hidden(B: int, S: int, D: int, grad: bool = False) -> torch.Tensor:
    return torch.empty((B, S, D), dtype=_BF16, device=META,
                       requires_grad=grad)


def _positions(B: int, S: int) -> torch.Tensor:
    return torch.arange(S, device=META)[None, :].expand(B, S)


# ======================================================================
def _layer_types(cfg: ModelConfig) -> list[dict]:
    """Distinct (kind, window, d_ff) layer types with their counts."""
    plan = transformer_mod.build_plan(cfg)
    types: dict[tuple, int] = {}
    for sp in plan.stacks:
        for w in sp.windows:
            key = (sp.kind, w, sp.d_ff)
            types[key] = types.get(key, 0) + 1
    out = [{"kind": k, "window": w, "d_ff": f, "count": c}
           for (k, w, f), c in types.items()]
    if cfg.mtp_depth:  # MTP adds ~1 dense layer + 1 extra loss head per depth
        out.append({"kind": "dense", "window": 0,
                    "d_ff": cfg.dense_d_ff or cfg.d_ff, "count": cfg.mtp_depth})
    return out


def _named_axes(tree, prefix: str = "") -> dict:
    """An axes tree's leaves by dotted name, as ``param_dict`` names the
    parameters."""
    if opt_mod.is_axes(tree):
        return {prefix[:-1]: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_named_axes(v, f"{prefix}{k}."))
    return out


def _block_param_specs(cfg: ModelConfig, kind: str, d_ff: int):
    """One layer of ``kind`` on meta, and its leaves' logical axes by
    parameter name."""
    blk = transformer_mod.init_block(cfg, kind, d_ff, device=META)
    return blk, _named_axes(transformer_mod._block_axes(cfg, kind))


def probe_train_layer(cfg: ModelConfig, B: int, S: int, kind: str,
                      window: int, d_ff: int) -> dict:
    """fwd+bwd cost of one layer at [B, S, D] (gradients of the weights and
    the input, as the reference's ``jax.grad(argnums=(0, 1))``)."""
    blk, _ = _block_param_specs(cfg, kind, d_ff)
    blk.requires_grad_(True)
    x = _hidden(B, S, cfg.d_model, grad=True)
    with CostMode() as m:
        out, _, aux = transformer_mod.apply_block(
            blk, cfg, x, _positions(B, S), "train",
            transformer_mod.LayerCache(None, None), window)
        (out.float().sum() + aux).backward()
    return m.cost()


@torch.no_grad()
def probe_serve_layer(cfg: ModelConfig, B: int, S_ctx: int, kind: str,
                      window: int, d_ff: int, q_len: int) -> dict:
    """fwd-only cost of one layer in decode (q_len=1, cache S_ctx) or
    prefill (q_len=S_ctx, fresh cache)."""
    mode = "decode" if q_len == 1 else "prefill"
    blk, _ = _block_param_specs(cfg, kind, d_ff)
    cache = transformer_mod.init_layer_cache(cfg, kind, B, S_ctx, window,
                                             META)
    positions = (_positions(B, q_len) if mode == "prefill"
                 else torch.zeros((B, 1), dtype=torch.long, device=META))
    with CostMode() as m:
        transformer_mod.apply_block(blk, cfg, _hidden(B, q_len, cfg.d_model),
                                    positions, mode, cache, window)
    return m.cost()


def _head_leaves(cfg: ModelConfig) -> dict:
    """The embedding, final norm and (untied) head on meta, by name."""
    V, D = cfg.vocab_size, cfg.d_model
    leaves = {"embed": torch.empty((V, D), dtype=_BF16, device=META),
              "final_norm": torch.empty((D,), dtype=_BF16, device=META)}
    if not cfg.tie_embeddings and not cfg.encdec:
        leaves["head"] = torch.empty((D, V), dtype=_BF16, device=META)
    return leaves


HEAD_AXES = {"embed": ("vocab", "fsdp"), "final_norm": (None,),
             "head": ("fsdp", "vocab")}


def probe_embed_loss(cfg: ModelConfig, B: int, S: int, *,
                     with_grad: bool) -> dict:
    """Embedding lookup + final norm + (chunked) loss head, fwd(+bwd of the
    weights)."""
    p = _head_leaves(cfg)
    for t in p.values():
        t.requires_grad_(with_grad)
    tokens = _tokens(B, S)
    with CostMode() as m, torch.set_grad_enabled(with_grad):
        h = torch.nn.functional.embedding(tokens, p["embed"])
        hn = rms_norm(h, p["final_norm"], cfg.norm_eps)
        head = p["head"] if "head" in p else p["embed"].T
        loss = chunked_softmax_xent(hn, head, tokens)
        if with_grad:
            loss.backward()
    return m.cost()


@torch.no_grad()
def probe_logits(cfg: ModelConfig, B: int) -> dict:
    """Decode logits head: [B,1,D] @ [D,V]."""
    h = _hidden(B, 1, cfg.d_model)
    head = torch.empty((cfg.d_model, cfg.vocab_size), dtype=_BF16,
                       device=META)
    with CostMode() as m:
        (h @ head).float()
    return m.cost()


def probe_optimizer(cfg: ModelConfig, state=None) -> dict:
    """One clip + optimizer update over the full parameter tree.

    Trap: the updates walk each leaf in ``optimizer.PIECE``-element
    pieces, and deepseek-v3's 671 B parameters are some ten thousand of
    them, each a few dozen ops at ~0.1 ms an op on meta.  Every piece of
    a leaf is the same ops on its rows, so the count is linear in them:
    on meta a leaf is cut once (``optimizer._piece``), through the path
    its size selects on the card, which counts one piece the size of the
    leaf (held to the pieced update of a small leaf on real tensors in
    ``tests/test_torch_roofline.py``)."""
    from repro_torch.train import trainer as trainer_mod
    if state is None:
        state = trainer_mod.init_state(cfg, device=META)
    named = transformer_mod.param_dict(state.params)
    grads = {k: torch.empty_like(p) for k, p in named.items()}
    opt = opt_mod.get_optimizer(cfg.optimizer)
    lr = torch.tensor(1e-4, dtype=torch.float32, device=META)
    with CostMode() as m:
        grads, _ = opt_mod.clip_by_global_norm(grads, 1.0)
        opt.update(grads, state.opt_state, named, lr)
    return m.cost()


# ======================================================================
def _probe_dec_layer_train(cfg: ModelConfig, B: int, S: int) -> dict:
    """Whisper decoder layer (self-attn + cross-attn + mlp), fwd+bwd of the
    weights, the input and the encoder's states."""
    gen = torch.Generator().manual_seed(0)
    pl = encdec_mod._init_dec_layer(gen, cfg, META)
    for t in tree_flatten(pl)[0]:
        t.requires_grad_(True)
    x = _hidden(B, S, cfg.d_model, grad=True)
    enc = _hidden(B, cfg.enc_seq, cfg.d_model, grad=True)
    with CostMode() as m:
        out, _ = encdec_mod._dec_layer(pl, cfg, x, _positions(B, S), enc,
                                       None, "train")
        out.float().sum().backward()
    return m.cost()


def _enc_dec_probes(cfg: ModelConfig, B: int, S: int) -> list[dict]:
    """Whisper train probes: encoder layer + decoder layer (incl. cross)."""
    enc = probe_train_layer(cfg, B, cfg.enc_seq, "dense", 0, cfg.d_ff)
    dec = _probe_dec_layer_train(cfg, B, S)
    return [{"name": "enc_layer", "count": cfg.enc_layers, **enc},
            {"name": "dec_layer", "count": cfg.num_layers, **dec}]


# ======================================================================
def _model_share(mesh, rules: ShardingRules, named_axes: dict,
                 shapes: dict) -> float:
    """The ``model`` axis' share of a piece's work: each leaf weighted by
    its elements, divided by how much of it ``resolve`` cuts on
    ``model``."""
    tp = mesh.shape.get("model", 1)
    total = whole = 0.0
    for name, shape in shapes.items():
        spec = rules.resolve(mesh, named_axes[name], shape, "probe")
        cut = any(s == "model" or (isinstance(s, tuple) and "model" in s)
                  for s in spec)
        n = math.prod(shape)
        total += n
        whole += n / (tp if cut else 1)
    return total / whole if whole else 1.0


def _batch_share(mesh, rules: ShardingRules, B: int) -> int:
    spec = rules.resolve(mesh, ("batch",), (B,), "probe_batch")
    return B // block_shape(mesh, spec, (B,))[0]


def cell_costs(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rules: ShardingRules, state=None) -> dict:
    """Per-chip cost terms for one (arch x shape) cell: each piece's whole
    count (``flops``, ``product_flops``, ``bytes``), its ``share`` (what
    the mesh divides it by, see the module docstring) and the per-chip
    totals ``sum(count * cost / share)``.  ``wire`` is ``None``: the LM
    step's collectives are GSPMD's in the reference, and the port has no
    GSPMD to count them from."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    b_share = _batch_share(mesh, rules, B)

    def layer_share(kind_, d_ff):
        blk, axes = _block_param_specs(cfg, kind_, d_ff)
        shapes = {k: tuple(v.shape) for k, v in
                  transformer_mod.param_dict(blk).items()}
        return b_share * _model_share(mesh, rules, axes, shapes)

    def dec_share():
        axes = _named_axes(encdec_mod.param_axes(cfg)["decoder"])
        gen = torch.Generator().manual_seed(0)
        leaves = transformer_mod.from_tree(
            encdec_mod._init_dec_layer(gen, cfg, META))
        shapes = {k: tuple(v.shape) for k, v in leaves.items()}
        axes = {k: a[1:] for k, a in axes.items()}  # the layer dim
        return b_share * _model_share(mesh, rules, axes, shapes)

    head = {k: tuple(v.shape) for k, v in _head_leaves(cfg).items()}
    head_share = b_share * _model_share(mesh, rules, HEAD_AXES, head)
    logits_share = b_share * _model_share(
        mesh, rules, {"head": HEAD_AXES["head"]},
        {"head": (cfg.d_model, cfg.vocab_size)})
    pieces = []
    if cfg.encdec:
        if kind == "train":
            enc, dec = _enc_dec_probes(cfg, B, S)
            pieces += [dict(enc, share=layer_share("dense", cfg.d_ff)),
                       dict(dec, share=dec_share())]
            pieces.append({"name": "embed+loss", "count": 1,
                           "share": head_share,
                           **probe_embed_loss(cfg, B, S, with_grad=True)})
        else:
            q_len = S if kind == "prefill" else 1
            share = layer_share("dense", cfg.d_ff)
            if kind == "prefill":  # encoder runs once at prefill
                pieces.append({"name": "enc_layer", "count": cfg.enc_layers,
                               "share": share, **probe_train_layer(
                                   cfg, B, cfg.enc_seq, "dense", 0,
                                   cfg.d_ff)})
            pieces.append({"name": "dec_layer", "count": cfg.num_layers,
                           "share": share, **probe_serve_layer(
                               cfg, B, S, "dense", 0, cfg.d_ff, q_len)})
            pieces.append({"name": "logits", "count": 1,
                           "share": logits_share, **probe_logits(cfg, B)})
    else:
        for lt in _layer_types(cfg):
            if kind == "train":
                c = probe_train_layer(cfg, B, S, lt["kind"], lt["window"],
                                      lt["d_ff"])
            else:
                q_len = S if kind == "prefill" else 1
                c = probe_serve_layer(cfg, B, S, lt["kind"], lt["window"],
                                      lt["d_ff"], q_len)
            pieces.append({"name": f"{lt['kind']}(w={lt['window']})",
                           "count": lt["count"],
                           "share": layer_share(lt["kind"], lt["d_ff"]),
                           **c})
        if kind == "train":
            pieces.append({"name": "embed+loss", "count": 1,
                           "share": head_share,
                           **probe_embed_loss(cfg, B, S, with_grad=True)})
        else:
            pieces.append({"name": "logits", "count": 1,
                           "share": logits_share, **probe_logits(cfg, B)})
    if kind == "train":
        from repro_torch.launch.dryrun import state_shapes_and_axes
        shapes, axes = state_shapes_and_axes(cfg, state)
        params = transformer_mod.from_tree(shapes.params)
        p_axes = _named_axes(axes.params)
        whole = sum(t.numel() for t in params.values())
        mine = sum(math.prod(block_shape(mesh, rules.resolve(
            mesh, p_axes[k], t.shape, "probe_opt"), t.shape))
            for k, t in params.items())
        pieces.append({"name": "optimizer", "count": 1,
                       "share": whole / mine,
                       **probe_optimizer(cfg, state)})

    total = {"flops": 0.0, "product_flops": 0.0, "bytes": 0.0}
    for p in pieces:
        for k in total:
            total[k] += p["count"] * p[k] / p["share"]
    return {"pieces": pieces, **total, "wire": None}
