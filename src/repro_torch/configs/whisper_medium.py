"""whisper-medium — encoder-decoder ASR backbone [arXiv:2212.04356].

24L(enc)+24L(dec) d_model=1024 16H d_ff=4096 vocab=51865, enc_seq=1500.
The conv mel frontend is a STUB: ``input_specs`` provides 1500 precomputed
frame embeddings.  Decoder shapes (decode_32k / prefill_32k) are lowered
architecturally even though the shipped model caps decoder positions at 448 —
noted in DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    encdec=True,
    enc_layers=24,
    enc_seq=1500,
    frontend="audio_stub",
    act="gelu",
    rope_theta=0.0,  # whisper uses learned/sinusoidal absolute positions
    fsdp=True,
    remat="full",
    source="arXiv:2212.04356; hf:openai/whisper-medium",
)
