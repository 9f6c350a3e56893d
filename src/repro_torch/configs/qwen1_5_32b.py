"""qwen1.5-32b [dense] — QKV bias, near-MHA (kv=40).
[hf:Qwen/Qwen1.5-0.5B scaled family config; hf]
64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064."""

from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    rope_style="full",
    rope_theta=1e6,
    norm="rmsnorm",
    mlp_act="swiglu",
    qkv_bias=True,
    kv_cache_dtype="int8",
    optimizer="adamw",
)
