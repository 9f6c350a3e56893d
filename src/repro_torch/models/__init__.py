"""Model zoo: unified decoder-only transformer (attention + MoE/ffn layers)."""
