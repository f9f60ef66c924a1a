"""qwen3-4b — qk-norm, GQA kv=8 [hf:Qwen/Qwen3-4B; config family per Qwen3-8B].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    fsdp=True,
    remat="full",
    source="hf:Qwen/Qwen3-4B",
)
