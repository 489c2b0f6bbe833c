"""Deterministic synthetic token pipeline (sharding-aware, resumable).

A copy of the reference package's ``data/pipeline.py`` (numpy only): the
port imports nothing of that package, and batch ``i`` here is bitwise the
reference's batch ``i``.

Produces reproducible LM batches from a counter-based PRNG: batch ``i`` is a
pure function of (seed, i), so data order is identical across restarts and
host counts — the property checkpoint/restart tests rely on.  In multi-host
deployments each host materializes only its addressable shard
(``host_slice``); here (single host) that is the whole batch.

A tiny zipf-ish token distribution plus a deterministic "copy task" span
gives the loss something learnable for the end-to-end example.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    copy_span: int = 8   # learnable structure: spans repeat after copy_span


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, index: int, *, host_slice: slice | None = None) -> dict[str, np.ndarray]:
        """Batch ``index`` (deterministic).  tokens/labels: (B, T) int32."""
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, index]))
        B = c.global_batch if host_slice is None else (host_slice.stop - host_slice.start)
        # zipf-ish marginal over the vocab
        u = rng.random((B, c.seq_len))
        toks = np.floor((c.vocab - 1) * u ** 2.2).astype(np.int32)
        # inject copyable structure: every copy_span tokens repeat
        span = c.copy_span
        if span > 1 and c.seq_len >= 2 * span:
            toks[:, span:2 * span] = toks[:, :span]
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        return {"tokens": toks, "labels": labels}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


@dataclasses.dataclass
class DataCursor:
    """Resumable position, stored inside checkpoints."""

    next_index: int = 0

    def advance(self) -> int:
        i = self.next_index
        self.next_index += 1
        return i
