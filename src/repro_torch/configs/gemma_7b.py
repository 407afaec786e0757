"""Config for --arch gemma-7b (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="gemma-7b", family="dense", source="arXiv:2403.08295; hf",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="gelu", attn_parallel="heads",
    rope_theta=1e4, tie_embeddings=True, loss_chunks=8))
