"""Config system: architecture definitions and their registry.

Every architecture is a frozen ``ArchConfig`` registered under its public
id.  Reduced variants (for CPU smoke tests) come from
``ArchConfig.reduced()``.  The port's own copy of ``repro.config.base``:
same fields, same defaults, same derived values.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int                 # d_ff per expert
    capacity_factor: float = 1.25
    # Which layers carry the MoE ffn ('all', 'every_other' — Jamba style).
    layout: str = "all"
    # DySkew adaptive dispatch on by default (the paper's technique).
    adaptive: bool = True


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # Positional / attention flavors.
    rope_style: str = "full"       # full | half (chatglm 2d) | none
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp_act: str = "swiglu"        # swiglu | geglu | gelu | relu2
    # Optional sub-configs.
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # hybrid: attention every `attn_period` layers (Jamba 1:7 → period 8,
    # attention at layer index `attn_offset` within each period).
    attn_period: int = 1
    attn_offset: int = 0
    # encoder-decoder (whisper): encoder layer count + fixed source length.
    encoder_layers: int = 0
    encoder_len: int = 0
    # vlm (pixtral): number of stub patch-embedding positions.
    num_patches: int = 0
    # KV cache storage dtype: 'model' (= activation dtype) or 'int8'
    # (symmetric per-(position, head) quantization — halves cache bytes;
    # required for qwen1.5-32b's 40-head MHA cache at decode_32k).
    kv_cache_dtype: str = "model"
    # Training defaults.
    optimizer: str = "adamw"       # adamw | adafactor
    remat: bool = True
    dtype: str = "bfloat16"
    # Sub-quadratic? (controls whether long_500k is lowered)
    sub_quadratic: bool = False

    # -- derived ------------------------------------------------------- #
    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, 128)

    def is_attention_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period == 1:
            return True
        return i % self.attn_period == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.layout == "all":
            return True
        if self.moe.layout == "every_other":
            return i % 2 == 1
        raise ValueError(self.moe.layout)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim_
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(L):
            if self.is_attention_layer(i) and n_q > 0:
                total += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
            elif self.mamba is not None:
                mc = self.mamba
                di = mc.d_inner(d)
                nh = mc.num_heads(d)
                g = max(nh // 8, 1)
                total += d * (2 * di + 2 * g * mc.d_state + nh) + di * d
            if self.is_moe_layer(i):
                total += self.moe.num_experts * 3 * d * self.moe.expert_ff
            elif f > 0:
                mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
                total += mats * d * f
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                total += d * hd * (n_q + 2 * n_kv) + n_q * hd * d + 2 * d * f
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        for i in range(self.num_layers):
            if self.is_moe_layer(i):
                total -= (self.moe.num_experts - self.moe.top_k) * 3 * d * self.moe.expert_ff
        return total

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests."""
        kw: Dict = {}
        kw["num_layers"] = min(self.num_layers, 4 if self.attn_period > 1 else 2)
        if self.attn_period > 1:
            kw["num_layers"] = min(self.num_layers, self.attn_period)
            kw["attn_period"] = max(self.attn_period // 2, 2)
            kw["attn_offset"] = min(self.attn_offset, kw["attn_period"] - 1)
        d = 64
        kw["d_model"] = d
        kw["num_heads"] = 4 if self.num_heads else 0
        kw["num_kv_heads"] = (
            max(1, min(self.num_kv_heads, 2)) if self.num_heads else 0
        )
        kw["head_dim"] = 16 if self.num_heads else None
        kw["d_ff"] = 128 if self.d_ff else 0
        kw["vocab_size"] = 256
        if self.moe is not None:
            ne = min(self.moe.num_experts, 8)
            tk = min(self.moe.top_k, 2)
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=ne, top_k=tk, expert_ff=64,
                # Dropless for smoke tests: capacity covers the worst case,
                # so decode logits match the full forward exactly.
                capacity_factor=float(ne) / tk,
            )
        if self.mamba is not None:
            kw["mamba"] = dataclasses.replace(
                self.mamba, d_state=16, head_dim=16, chunk=32,
            )
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_len"] = 16
        if self.num_patches:
            kw["num_patches"] = 4
        return dataclasses.replace(self, **kw)


#: Registry of architecture ids → config module names.
ARCH_MODULES = {
    "whisper-base": "whisper_base",
    "granite-20b": "granite_20b",
    "chatglm3-6b": "chatglm3_6b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen1.5-32b": "qwen1_5_32b",
    "pixtral-12b": "pixtral_12b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "mamba2-1.3b": "mamba2_1_3b",
}

_CACHE: Dict[str, ArchConfig] = {}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _CACHE:
        if arch_id not in ARCH_MODULES:
            raise KeyError(
                f"unknown arch {arch_id!r}; known: {sorted(ARCH_MODULES)}"
            )
        mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch_id]}")
        _CACHE[arch_id] = mod.CONFIG
    return _CACHE[arch_id]


def all_arch_ids() -> Tuple[str, ...]:
    return tuple(ARCH_MODULES)
