"""Config for --arch yi-34b (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="yi-34b", family="dense", source="arXiv:2403.04652; hf",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, act="silu", attn_parallel="cp",
    rope_theta=5e6, loss_chunks=2, kv_block=512))
