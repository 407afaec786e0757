from .optimizers import (AdamW, Adafactor, Optimizer, make_optimizer,
                         clip_by_global_norm)
from .schedules import cosine_warmup, linear_warmup
from .compression import int8_compress, int8_decompress, ef_compress_grads

__all__ = ["AdamW", "Adafactor", "Optimizer", "make_optimizer",
           "clip_by_global_norm", "cosine_warmup", "linear_warmup",
           "int8_compress", "int8_decompress", "ef_compress_grads"]
