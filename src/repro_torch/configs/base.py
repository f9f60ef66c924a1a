"""Config dataclasses (the counterpart of ``repro.configs.base``).

  * ModelConfig  — LM-family architectures; every arch file under
    ``configs/`` exports ``CONFIG`` and ``configs/__init__`` exposes
    ``get_config(name)`` / ``list_archs()``.  ``ModelConfig.reduced()``
    returns a tiny same-family config for CPU tests.
  * GraphConfig  — ASYMP graph-mining workloads (the paper's own).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per-arch shapes)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shapes (shared by all 10 archs).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour ---
    attn_type: str = "full"  # "full" | "swa"
    sliding_window: int = 0
    global_attn_every: int = 0  # hybrid/swa: every Nth layer uses full attn
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # chatglm/glm "2d rope": rotate half the dims

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0  # d_ff of the dense (non-MoE) layers, if different
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128  # SSD chunk length

    # --- encoder-decoder (whisper) ---
    encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0  # encoder positions (whisper: 1500 frames)
    frontend: str = "none"  # "none" | "audio_stub" | "vq_stub"

    # --- extras ---
    mtp_depth: int = 0  # deepseek multi-token-prediction heads
    tie_embeddings: bool = False
    act: str = "silu"
    norm_eps: float = 1e-5
    max_position: int = 131072

    # --- training/sharding policy hints (resolved by dist/sharding.py) ---
    fsdp: bool = False  # shard params over the data axis too (ZeRO-3 style)
    optimizer: str = "adamw"  # "adamw" | "adafactor"
    remat: str = "none"  # "none" | "dots" | "full"
    source: str = ""  # provenance note

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def gated_mlp(self) -> bool:
        return self.act == "silu"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def supports_long_context(self) -> bool:
        """True iff decode over 500k positions is sub-quadratic / bounded-state."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.attn_type == "swa":
            return True
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, h = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads

        def attn_params() -> int:
            if self.use_mla:
                p = d * self.q_lora_rank + self.q_lora_rank * n_q * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim
                )
                p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                p += self.kv_lora_rank * n_q * (self.qk_nope_head_dim + self.v_head_dim)
                p += n_q * self.v_head_dim * d
                return p
            if n_q == 0:
                return 0
            return d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d

        def mlp_params(ff: int) -> int:
            # silu family -> gated (3 mats); gelu family -> classic 2-mat MLP
            return (3 if self.gated_mlp else 2) * d * ff

        def ssm_params() -> int:
            if not self.ssm_state:
                return 0
            di = self.d_inner
            p = d * (2 * di + 2 * self.ssm_state + self.ssm_heads)  # in_proj (x,z,B,C,dt)
            p += di * self.ssm_conv_width  # depthwise conv
            p += 2 * self.ssm_heads  # A, D
            p += di * d  # out_proj
            return p

        per_layer_dense = attn_params() + mlp_params(self.d_ff)
        total = 0
        if self.family == "ssm":
            total = self.num_layers * ssm_params()
        elif self.family == "hybrid":
            total = self.num_layers * (attn_params() + ssm_params() + mlp_params(self.d_ff))
        elif self.is_moe:
            moe_layers = self.num_layers - self.first_k_dense
            dense_ff = self.dense_d_ff or self.d_ff
            total += self.first_k_dense * (attn_params() + mlp_params(dense_ff))
            experts = self.num_experts + self.num_shared_experts
            total += moe_layers * (
                attn_params() + experts * mlp_params(self.d_ff) + d * self.num_experts
            )
        else:
            total = self.num_layers * per_layer_dense
        if self.encdec:
            # encoder layers: self-attn + mlp; decoder layers add cross-attn
            total = self.enc_layers * (attn_params() + mlp_params(self.d_ff))
            total += self.num_layers * (2 * attn_params() + mlp_params(self.d_ff))
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        if self.mtp_depth:
            total += self.mtp_depth * (per_layer_dense + 2 * d * d)
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: routed top-k only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        experts = self.num_experts + self.num_shared_experts
        moe_layers = self.num_layers - self.first_k_dense
        nm = 3 if self.gated_mlp else 2
        all_expert = moe_layers * experts * nm * self.d_model * self.d_ff
        active_expert = moe_layers * (
            (self.experts_per_token + self.num_shared_experts) * nm * self.d_model * self.d_ff
        )
        return full - all_expert + active_expert

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=2,
            d_model=64,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            max_position=512,
        )
        if self.num_heads:
            changes["num_heads"] = 4
            changes["num_kv_heads"] = max(1, min(self.num_kv_heads, 2))
        if self.use_mla:
            changes.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16)
        if self.is_moe:
            changes.update(num_experts=4, experts_per_token=2,
                           first_k_dense=min(self.first_k_dense, 1),
                           dense_d_ff=128 if self.dense_d_ff else 0)
        if self.ssm_state:
            changes.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=16)
        if self.encdec:
            changes.update(enc_layers=2, enc_seq=16)
        if self.sliding_window:
            changes.update(sliding_window=32)
        if self.mtp_depth:
            changes.update(mtp_depth=1)
        return dataclasses.replace(self, name=self.name + "-smoke", **changes)

    def shapes(self) -> dict[str, ShapeConfig]:
        """The shape cells applicable to this arch (long_500k gated)."""
        out = dict(SHAPES)
        if not self.supports_long_context:
            out.pop("long_500k")
        return out


@dataclass(frozen=True)
class GraphConfig:
    """ASYMP graph workload config (the paper's own configs).  Every field
    but ``weight_rule`` and ``weight_seed`` is the JAX package's; their
    defaults are that package's rule."""

    name: str
    # any program registered in core/programs.py:
    # "cc" | "sssp" | "bfs" | "reachability" | "widest_path" | "labelprop"
    algorithm: str
    num_vertices: int
    avg_degree: int
    generator: str = "rmat"  # rmat | er | grid | chain | star | file
    rmat_abcd: Tuple[float, float, float, float] = (0.47, 0.19, 0.19, 0.05)
    num_shards: int = 8
    # ASYMP engine knobs (paper §3.5 / §5.6)
    priority: str = "log"  # disabled | linear | log
    enforce_fraction: float = 0.1  # fraction of active frontier propagated/tick
    edge_budget: int = 0  # 0 -> auto (per-shard edges per tick)
    route_capacity: int = 0  # 0 -> auto (per dst-shard message slots)
    # wire format for the exchange substrate (dist/exchange.py):
    # "none" | "int16" | "int8" — gated down to a safe mode per program
    wire_compression: str = "none"
    # fault tolerance
    checkpoint_every: int = 8  # ticks
    replay_log_ticks: int = 8
    max_ticks: int = 100000
    seed: int = 0
    weighted: bool = False
    # how a weighted build draws its weights (core/graph.py):
    # "directed" — one uniform(0.1, 1.0) a directed edge (the JAX
    # package's rule); "undirected" — Graph500 kernel 3's, one draw from
    # [0, 1) an undirected edge, carried by both directions
    weight_rule: str = "directed"
    # the seed of the weights' draw; None draws them from ``seed``, as the
    # JAX package does.  Set, it holds one weight set whatever graph
    # ``seed`` makes or is given: a fixed dataset
    weight_seed: Optional[int] = None
    # crowded-cluster emulation (paper §5.4; dist/latency.py):
    # "none" | "uniform" | "stragglers" | "heavy_tail"
    latency_profile: str = "none"
    slow_fraction: float = 0.5  # fraction of shards crowded (stragglers)
    link_delay: int = 2  # wire delay (ticks) on a crowded shard's links
    slow_intensity: int = 4  # work-budget divisor for crowded shards
    latency_seed: int = 0
    # straggler-aware scheduling: bucket penalty demoting frontier work
    # that was activated over a slow link (0 = plain priority queue)
    straggler_demote: int = 8
    # execution schedule: "sync" = BSP-style global tick barrier;
    # "async" = barrier-free per-shard progress under a deterministic
    # seeded interleaving (dist/latency.py AsyncInterleaving) — throttle
    # is consumed as a firing rate instead of a budget divisor
    schedule: str = "sync"
    async_seed: int = 0
    # jitter: seeded stateless skips for rate-1 shards (never twice in a
    # row), decorrelating "healthy" shards' steps while staying replayable
    async_jitter: bool = False
    # source vertex for single-source programs (sssp/bfs/reachability/
    # widest_path); ignored by the others
    source: int = 0
    # damping factor for pagerank; ignored by the others
    damping: float = 0.85

    @property
    def num_edges(self) -> int:
        return self.num_vertices * self.avg_degree

    def reduced(self) -> "GraphConfig":
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_vertices=256, avg_degree=4,
            num_shards=4, max_ticks=4096)
