"""Config for --arch zamba2-1.2b (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="zamba2-1.2b", family="hybrid", source="arXiv:2411.15242; hf",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, act="gelu", attn_parallel="heads",
    attn_kind="swa", window=4096, shared_attn_window=4096,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_groups=1, ssm_conv=4,
    segments_spec=([("mamba2", 6), ("shared_attn", 1)] * 5
                   + [("mamba2", 8)])))
