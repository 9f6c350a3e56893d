"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]
48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128."""

from repro_torch.config.base import ArchConfig, MambaConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,                # attention-free
    num_kv_heads=0,
    d_ff=0,                     # no separate MLP (mamba block only)
    vocab_size=50280,
    rope_style="none",
    norm="rmsnorm",
    tie_embeddings=True,
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                      chunk=128),
    optimizer="adamw",
    sub_quadratic=True,         # runs long_500k
)
