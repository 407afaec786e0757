"""Config for --arch whisper-medium (see assignment table; source tier noted)."""

from .base import Config
from .registry import register

CONFIG = register(Config(
    name="whisper-medium", family="encdec",
    source="arXiv:2212.04356; unverified",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51872,            # padded from 51865 to %16
    act="gelu", norm="ln", use_rope=False, attn_parallel="heads",
    enc_layers=24, dec_layers=24, enc_len=4096, tie_embeddings=True))
