"""whisper-base [audio] — enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]  6L(dec)+6L(enc) d_model=512 8H (kv=8)
d_ff=2048 vocab=51865."""

from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    rope_style="none",          # sinusoidal positions (see DESIGN.md)
    norm="layernorm",
    mlp_act="gelu",
    tie_embeddings=True,
    encoder_layers=6,
    encoder_len=1500,           # 30 s audio → 1500 frames post-conv (stub)
    optimizer="adamw",
)
