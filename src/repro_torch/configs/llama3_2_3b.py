"""Config for --arch llama3.2-3b (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="llama3.2-3b", family="dense",
    source="hf:meta-llama/Llama-3.2-3B; unverified",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, act="silu", attn_parallel="cp",
    rope_theta=5e5, loss_chunks=4, kv_block=512))
