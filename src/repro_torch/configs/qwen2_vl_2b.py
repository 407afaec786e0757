"""Config for --arch qwen2-vl-2b (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="qwen2-vl-2b", family="vlm", source="arXiv:2409.12191; hf",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, act="silu", attn_parallel="cp",
    mrope=True, rope_theta=1e6, loss_chunks=4, kv_block=512))
