"""Config for --arch mistral-large-123b (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="mistral-large-123b", family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768, act="silu", attn_parallel="heads",
    rope_theta=1e6, optimizer="adafactor", n_microbatches=1))
