"""deepseek-v3-671b — MLA + 1 shared + 256 routed top-8 experts + MTP [arXiv:2412.19437].

61L d_model=7168 128H d_ff=2048(routed experts) vocab=129280, MoE 256e top-8.
First 3 layers are dense (d_ff=18432).  MLA: q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v=128.  MTP depth 1.

At 671B params this is the memory-extreme cell: full FSDP over the whole mesh
plus Adafactor (factored second moment) are required to fit 512 x 16 GB.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,  # MLA: effectively all heads share the compressed cache
    head_dim=128,
    d_ff=2048,  # routed expert width
    vocab_size=129280,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_shared_experts=1,
    experts_per_token=8,
    first_k_dense=3,
    dense_d_ff=18432,
    mtp_depth=1,
    rope_theta=10000.0,
    fsdp=True,
    optimizer="adafactor",
    remat="full",
    source="arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3",
)
