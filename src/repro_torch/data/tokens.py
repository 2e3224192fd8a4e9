"""Deterministic, checkpointable LM token stream: the counterpart of
``repro.data.tokens`` (numpy only, kept as the port's own copy, so that the
port imports nothing of the JAX package).

A counter-based PRNG stream: batch ``i`` is a pure function of (seed, i), so
* any worker can regenerate any batch (no coordination),
* the iterator state is ONE integer: it rides in the checkpoint manifest
  and restore resumes the exact position,
* straggler mitigation / elastic restarts never skew the data order.

``shard`` slices the global batch for a data-parallel worker. The batches
are bitwise the reference's for every (seed, batch index, shard).
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, global_batch: int, seq_len: int, seed: int = 0,
                 start_batch: int = 0):
        self.vocab = vocab
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.batch_idx = start_batch

    # -- checkpointing --------------------------------------------------
    def state_dict(self) -> dict:
        return {"batch_idx": self.batch_idx, "seed": self.seed}

    def load_state_dict(self, s: dict):
        self.batch_idx = int(s["batch_idx"])
        self.seed = int(s["seed"])

    # -- iteration -------------------------------------------------------
    def _gen(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, idx))
        return rng.integers(
            0, self.vocab, size=(self.global_batch, self.seq_len + 1), dtype=np.int64
        ).astype(np.int32)

    def next(self, shard: tuple[int, int] = (0, 1)):
        """Returns (tokens, labels) for this worker's slice of the batch."""
        wid, nw = shard
        assert self.global_batch % nw == 0
        per = self.global_batch // nw
        full = self._gen(self.batch_idx)
        self.batch_idx += 1
        mine = full[wid * per : (wid + 1) * per]
        return mine[:, :-1], mine[:, 1:]

    def __iter__(self):
        while True:
            yield self.next()
