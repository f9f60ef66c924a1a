"""mamba2-780m — attention-free SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536 d_inner=3072 ssm_state=128 headdim=64 vocab=50280.
Constant-size recurrent state makes every decode shape (incl. long_500k) O(1)
per token.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=128,
    tie_embeddings=True,
    fsdp=True,
    remat="full",
    source="arXiv:2405.21060; hf:state-spaces/mamba2-780m",
)
