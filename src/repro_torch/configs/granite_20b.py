"""granite-20b [dense] — llama-arch code model, MQA (kv=1).
[arXiv:2405.04324; hf]  52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152."""

from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,             # MQA
    d_ff=24576,
    vocab_size=49152,
    rope_style="none",          # gpt-bigcode uses learned abs pos; we use
                                # none+sinusoidal-free (documented deviation)
    norm="layernorm",
    mlp_act="gelu",
    optimizer="adamw",
)
