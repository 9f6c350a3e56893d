"""granite-moe-1b-a400m [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (kv=8) d_ff=512 vocab=49155, MoE 32e top-8."""

from repro_torch.config.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    rope_style="full",
    norm="rmsnorm",
    mlp_act="swiglu",
    moe=MoEConfig(num_experts=32, top_k=8, expert_ff=512, layout="all"),
    optimizer="adamw",
)
