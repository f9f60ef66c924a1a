"""Sharded, checkpointable token data pipeline (the counterpart of
``repro.data.pipeline``: the same numpy code, so a batch is byte-identical
to the JAX package's for the same source, seed and offset).

Two sources behind one interface:
  * SyntheticSource — deterministic zipf-ish token stream derived from
    (seed, global_offset): reproducible anywhere, no files needed.  This is
    what lets a restored job replay exactly the batches it would have seen
    (offsets are part of the checkpoint manifest).
  * FileSource — memory-mapped flat token .bin (uint16/uint32) with the same
    offset discipline.

Each data-parallel shard reads its own slice of every global batch.
Batches are numpy arrays; the train step moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PipelineState:
    offset: int  # global sample offset (checkpointed)


class SyntheticSource:
    """Deterministic pseudo-text: per-sample PRNG from (seed, index)."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab, self.seq, self.seed = vocab_size, seq_len, seed

    def sample(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) | (index & 0xFFFFFFFF))
        # zipf-flavoured marginal + short-range repetition structure
        base = rng.zipf(1.3, size=self.seq + 1) % self.vocab
        rep = rng.random(self.seq + 1) < 0.2
        shifted = np.roll(base, 3)
        out = np.where(rep, shifted, base)
        return out.astype(np.int32)


class FileSource:
    def __init__(self, path: str, vocab_size: int, seq_len: int,
                 dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab, self.seq = vocab_size, seq_len
        self.n_samples = (len(self.tokens) - 1) // seq_len

    def sample(self, index: int) -> np.ndarray:
        i = (index % self.n_samples) * self.seq
        return np.asarray(self.tokens[i: i + self.seq + 1]).astype(np.int32)


class DataPipeline:
    """Yields {tokens, labels} batches for one data-parallel shard."""

    def __init__(self, source, global_batch: int, shard_index: int = 0,
                 num_shards: int = 1, state: Optional[PipelineState] = None):
        if global_batch % num_shards:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {num_shards} shards")
        self.source = source
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.shard_index, self.num_shards = shard_index, num_shards
        self.state = state or PipelineState(offset=0)

    def next_batch(self) -> dict:
        base = self.state.offset
        idx = [base + self.shard_index * self.local_batch + j
               for j in range(self.local_batch)]
        rows = np.stack([self.source.sample(i) for i in idx])
        self.state.offset = base + self.global_batch
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    # --- checkpoint interface (offsets ride in the ft manifest) ---
    def snapshot(self) -> dict:
        return {"offset": self.state.offset}

    def restore(self, snap: dict) -> None:
        self.state.offset = int(snap["offset"])
