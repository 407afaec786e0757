"""Config for --arch mixtral-8x7b (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="mixtral-8x7b", family="moe", source="arXiv:2401.04088; hf",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, act="silu", attn_parallel="heads",
    attn_kind="swa", window=4096,
    n_experts=8, top_k=2, moe_d_ff=14336, moe_mode="tp",
    rope_theta=1e6))
