"""Config for --arch xlstm-125m (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="xlstm-125m", family="ssm", source="arXiv:2405.04517; unverified",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304, act="gelu", attn_parallel="heads",
    ssm_expand=2, ssm_conv=4, gla_chunk=256, tie_embeddings=True,
    use_rope=False,
    segments_spec=[("mlstm", 3), ("slstm", 1)] * 3))
