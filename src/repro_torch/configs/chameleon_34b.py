"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion means image patches are VQ-quantized into ordinary token ids
drawn from the shared 65536 vocab — the backbone is a plain decoder LM and the
modality frontend is a stub (``input_specs`` provides token ids / precomputed
patch embeddings).  Chameleon uses qk-norm for training stability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    rope_theta=10000.0,
    frontend="vq_stub",
    fsdp=True,
    remat="full",
    source="arXiv:2405.09818",
)
