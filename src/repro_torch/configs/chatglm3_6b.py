"""chatglm3-6b — GQA kv=2, 2d (half-dim) RoPE [arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,  # ChatGLM rotates only half of each head dim ("2d" RoPE)
    rope_theta=10000.0,
    fsdp=True,
    remat="full",
    source="arXiv:2406.12793; hf:THUDM/chatglm3-6b",
)
