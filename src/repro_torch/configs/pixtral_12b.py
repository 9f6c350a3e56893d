"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB) + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072."""

from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_style="full",
    rope_theta=1e6,
    norm="rmsnorm",
    mlp_act="swiglu",
    num_patches=256,            # stubbed patch embeddings per sample
    optimizer="adamw",
)
