"""chatglm3-6b [dense] — 2-d RoPE (half rotary), GQA kv=2.
[arXiv:2406.12793; hf]  28L d_model=4096 32H (kv=2) d_ff=13696 vocab=65024."""

from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_style="half",          # ChatGLM 2-d RoPE: rotate half the head dim
    norm="rmsnorm",
    mlp_act="swiglu",
    qkv_bias=True,              # chatglm uses qkv bias
    optimizer="adamw",
)
