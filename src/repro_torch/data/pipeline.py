"""Deterministic synthetic LM data pipeline: the port's own copy of
``repro/data/pipeline.py`` (numpy only), which gives the same batches for
the same seed.

Design constraints for the 1000+-node posture:

  - **Deterministic & restart-safe**: batch ``i`` is a pure function of
    ``(seed, i)`` — resuming from step N regenerates exactly the batches a
    non-failed run would have seen; no data-loader state needs
    checkpointing beyond the step counter.
  - **Per-host sharding**: each host materializes only its slice of the
    global batch (``host_shard_slice``), so host memory is independent of
    the global batch size. The slice is by *global example index*, so any
    (pod × data) re-partition after an elastic resize reads the same global
    stream.
  - **Prefetch**: a double-buffered background thread overlaps host-side
    batch synthesis with device compute (the synthetic generator is cheap,
    but the structure is what a real tokenized-shard reader plugs into).

The synthetic stream is a Zipf-ish unigram mix with a deterministic
"grammar" (bigram shift) so the loss actually decreases during example
training runs — pure-uniform tokens have irreducible loss == log V and
make convergence checks (paper §5.9 analogue) meaningless.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # Zipf exponent for the unigram backbone; 0 = uniform.
    zipf_a: float = 1.1
    # Fraction of positions forced to the deterministic bigram successor —
    # the learnable structure of the stream.
    structure_p: float = 0.75


def host_shard_slice(global_batch: int, process_index: int,
                     process_count: int) -> slice:
    """Contiguous per-host slice of the global batch (by example index)."""
    if global_batch % process_count != 0:
        raise ValueError(
            f"global_batch {global_batch} not divisible by "
            f"process_count {process_count}")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


class SyntheticLMDataset:
    """Batch ``i`` is a pure function of (seed, i): restart-safe by design."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        # Deterministic unigram distribution (Zipf over a seed-shuffled rank
        # order) and a fixed bigram successor table tok -> (a*tok+b) % V.
        rng = np.random.default_rng(cfg.seed)
        ranks = rng.permutation(v)
        with np.errstate(divide="ignore"):
            p = 1.0 / np.power(np.arange(1, v + 1, dtype=np.float64),
                               cfg.zipf_a)
        self._probs = (p / p.sum())[ranks]
        self._bigram_a = int(rng.integers(1, v)) | 1   # odd → full cycle
        self._bigram_b = int(rng.integers(0, v))

    def global_batch_np(self, step: int) -> dict[str, np.ndarray]:
        """The full [global_batch, seq_len] batch for ``step`` (all hosts)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # Structured positions follow the bigram successor of the *final*
        # previous token: next = (a * prev + b) mod V — generated
        # sequentially so chains survive substitution.
        noise = rng.choice(V, size=(B, S + 1), p=self._probs) \
            .astype(np.int64)
        struct = rng.random((B, S)) < cfg.structure_p
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = noise[:, 0]
        for t in range(1, S + 1):
            succ = (self._bigram_a * toks[:, t - 1] + self._bigram_b) % V
            toks[:, t] = np.where(struct[:, t - 1], succ, noise[:, t])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_batch_np(self, step: int, process_index: int = 0,
                      process_count: int = 1) -> dict[str, np.ndarray]:
        sl = host_shard_slice(self.cfg.global_batch, process_index,
                              process_count)
        g = self.global_batch_np(step)
        return {k: v[sl] for k, v in g.items()}


def make_train_iterator(cfg: DataConfig, *, start_step: int = 0,
                        process_index: int = 0, process_count: int = 1):
    """Infinite iterator of host-local numpy batches starting at
    ``start_step`` (resume point)."""
    ds = SyntheticLMDataset(cfg)
    step = start_step
    while True:
        yield ds.host_batch_np(step, process_index, process_count)
        step += 1


def prefetch(iterator, depth: int = 2):
    """Double-buffered background prefetch: overlaps batch synthesis /
    host-to-device transfer with device compute."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
