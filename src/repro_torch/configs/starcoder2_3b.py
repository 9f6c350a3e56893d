"""starcoder2-3b [dense] — GQA, RoPE.
[arXiv:2402.19173; hf]  30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152."""

from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_style="full",
    rope_theta=1e6,
    norm="layernorm",
    mlp_act="gelu",
    qkv_bias=True,
    optimizer="adamw",
)
