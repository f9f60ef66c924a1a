"""hymba-1.5b — hybrid parallel attention + Mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba fuses attention and SSM heads *in parallel* within each block and uses
sliding-window attention in all but three global layers (first / middle /
last), which is what makes `long_500k` decode sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_type="swa",
    sliding_window=1024,
    global_attn_every=16,  # layers 0, 16, 31 resolve to global (see models)
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_theta=10000.0,
    tie_embeddings=True,
    fsdp=True,
    remat="full",
    source="arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base",
)
