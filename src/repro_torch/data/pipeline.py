"""Training data pipelines: deterministic, seekable synthetic streams for
LM and DLRM training, with background host prefetch.

The counterpart of ``repro/data/pipeline.py``: numpy and one thread, no
torch.  ``batch_at(step)`` is a pure function of ``(seed, step)`` and
gives the reference's arrays bit for bit, so any step is reproducible and
restartable from a checkpointed step counter.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.core import features as F


class LMBatchStream:
    """Synthetic token batches with a zipf unigram distribution.

    Yields dicts matching ``configs.shapes.input_specs`` for train shapes.
    """

    def __init__(self, vocab: int, batch: int, seq: int,
                 n_frontend_tokens: int = 0, d_model: int = 0,
                 seed: int = 0, zipf_a: float = 1.3):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.nf = n_frontend_tokens
        self.d_model = d_model
        self.seed = seed
        self.zipf_a = zipf_a

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        n_text = self.seq - self.nf
        tokens = rng.zipf(self.zipf_a, size=(self.batch, n_text + 1))
        tokens = (tokens % self.vocab).astype(np.int32)
        out = {
            "tokens": tokens[:, :-1],
            # next-token labels over the full stream (frontend positions
            # are masked out)
            "labels": np.concatenate(
                [np.zeros((self.batch, self.nf), np.int32),
                 tokens[:, 1:]], axis=1),
            "loss_mask": np.concatenate(
                [np.zeros((self.batch, self.nf), np.float32),
                 np.ones((self.batch, n_text), np.float32)], axis=1),
        }
        if self.nf:
            out["embeds"] = rng.normal(
                0, 0.02, (self.batch, self.nf, self.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class DLRMBatchStream:
    """Synthetic CTR batches for a table pool (indices + dense + label).

    ``indices`` is ``(batch, M, pool_slots)`` int32 per-table rows, -1 in
    the padded slots; each table fills ``min(pooling + 1, pool_slots)``
    slots with zipf(1.5) draws modulo its hash size."""

    def __init__(self, raw_features: np.ndarray, batch: int,
                 n_dense: int = 13, pool_slots: int = 16, seed: int = 0):
        self.raw = raw_features
        self.batch = batch
        self.n_dense = n_dense
        self.pool_slots = pool_slots
        self.seed = seed
        self.hashes = raw_features[:, F.HASH_SIZE].astype(np.int64)
        self.pools = np.minimum(
            raw_features[:, F.POOLING].astype(np.int64) + 1, pool_slots)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        M = self.raw.shape[0]
        idx = np.full((self.batch, M, self.pool_slots), -1, np.int32)
        for t in range(M):
            draws = rng.zipf(1.5, size=(self.batch, self.pools[t]))
            idx[:, t, :self.pools[t]] = (draws % self.hashes[t]).astype(
                np.int32)
        return {
            "indices": idx,
            "dense": rng.normal(size=(self.batch, self.n_dense)).astype(
                np.float32),
            "labels": (rng.random(self.batch) < 0.3).astype(np.float32),
        }


class Prefetcher:
    """Background-thread host prefetch over any `batch_at(step)` stream.

    The thread starts in the constructor; ``close`` stops and joins it.
    Unlike the reference, a batch that meets a full queue is kept, not
    drawn again: the batches and their order are the same."""

    def __init__(self, stream, depth: int = 2, start_step: int = 0):
        self.stream = stream
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step, batch = self._step, None
        while not self._stop.is_set():
            if batch is None:            # a full queue keeps the batch made
                batch = self.stream.batch_at(step)
            try:
                self._q.put(batch, timeout=0.2)
                step, batch = step + 1, None
            except queue.Full:
                continue

    def next(self):
        return self._q.get()

    def close(self):
        """Stop the thread and wait for it (it ends within one
        ``batch_at``)."""
        self._stop.set()
        self._thread.join()
