"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 384 experts top-8.
[arXiv:2501.kimi2 paper-table; unverified]
61L d_model=7168 64H (kv=8) d_ff=2048 vocab=163840, MoE 384e top-8."""

from repro_torch.config.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    rope_style="full",
    rope_theta=5e6,
    norm="rmsnorm",
    mlp_act="swiglu",
    moe=MoEConfig(num_experts=384, top_k=8, expert_ff=2048, layout="all"),
    optimizer="adafactor",      # 1T params: factored states, bf16 params
    dtype="bfloat16",
)
