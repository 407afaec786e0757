"""Token sources with deterministic, checkpointable iteration state.

A copy of ``src/repro/data/sources.py`` (numpy only).

``state()``/``restore()`` return/consume a plain dict that the checkpoint
subsystem persists, so a restarted job resumes the stream exactly where it
left off (fault-tolerance requirement, DESIGN.md §8).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLMSource:
    """Deterministic synthetic LM data: Zipf-ish token draws from a counter-
    seeded PhiloxRNG — reproducible at any offset without replay."""

    def __init__(self, vocab: int, seq_len: int, batch_size: int,
                 seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self._index = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=self._index))
        self._index += 1
        # zipf-flavored distribution clipped to vocab
        toks = rng.zipf(1.3, size=(self.batch_size, self.seq_len))
        toks = (toks - 1) % self.vocab
        return {"tokens": toks.astype(np.int32)}

    def state(self) -> dict:
        return {"index": self._index, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self._index = int(state["index"])
        self.seed = int(state["seed"])


class MemmapTokenSource:
    """Flat binary token file (np.memmap) chopped into (batch, seq)
    windows — the standard pre-tokenized corpus layout."""

    def __init__(self, path, seq_len: int, batch_size: int,
                 dtype=np.int32, shard_id: int = 0, num_shards: int = 1):
        self.path = str(path)
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.dtype = np.dtype(dtype)
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        n_tokens = self._data.shape[0]
        self.n_windows = n_tokens // seq_len
        self._cursor = shard_id  # window index; strided by num_shards

    def next_batch(self) -> Dict[str, np.ndarray]:
        rows = []
        for _ in range(self.batch_size):
            w = self._cursor % self.n_windows
            rows.append(np.asarray(
                self._data[w * self.seq_len:(w + 1) * self.seq_len]))
            self._cursor += self.num_shards
        return {"tokens": np.stack(rows).astype(np.int32)}

    def state(self) -> dict:
        return {"cursor": self._cursor, "shard_id": self.shard_id,
                "num_shards": self.num_shards}

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])
        self.shard_id = int(state["shard_id"])
        self.num_shards = int(state["num_shards"])


def write_token_file(path, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(str(path))
