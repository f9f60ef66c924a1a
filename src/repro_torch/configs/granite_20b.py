"""granite-20b — code model, MQA (kv=1) [arXiv:2405.04324].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
MQA means the KV cache cannot shard over heads under TP — the sharding
resolver falls back to sequence-sharding the cache (see dist/sharding.py),
making this the canonical memory/collective-bound decode cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",  # GPT-BigCode style classic MLP (2 matrices)
    rope_theta=10000.0,
    fsdp=True,
    remat="full",
    source="arXiv:2405.04324; hf:ibm-granite/granite-20b-code-base",
)
