"""Config for --arch ff-tiny (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="ff-tiny", family="dense", source="demo",
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=1024, vocab=4096, act="silu", attn_parallel="heads", n_kv_eff=2,
    q_block=2048, kv_block=2048))
