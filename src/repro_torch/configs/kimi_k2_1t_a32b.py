"""Config for --arch kimi-k2-1t-a32b (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="kimi-k2-1t-a32b", family="moe",
    source="arXiv:2501.kimi2 (paper-table); unverified",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163840, act="silu", attn_parallel="heads",
    n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    moe_mode="ep", optimizer="adafactor", loss_chunks=4,
    rope_theta=5e6))
