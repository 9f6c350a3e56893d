"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 on every other layer. [arXiv:2403.19887; hf]
72L d_model=8192 64H (kv=8) d_ff=24576 vocab=65536."""

from repro_torch.config.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    rope_style="none",          # Jamba uses no positional encoding
    norm="rmsnorm",
    mlp_act="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=24576,
                  layout="every_other"),
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                      chunk=128),
    attn_period=8,              # 1 attention : 7 mamba
    attn_offset=3,
    optimizer="adafactor",      # 398B: factored states, bf16 params
    dtype="bfloat16",
    sub_quadratic=True,         # runs long_500k
)
