"""Batched, host-sharded, deterministic input pipeline of the streaming
train path, in numpy only (the counterpart of
``recsys_tpu/data/pipeline.py``; the same batches, bit for bit).

* **static shapes**: every batch is exactly ``batch_size`` rows (the
  tail is dropped for train, padded and masked for eval);
* **full-permutation shuffle** per epoch from
  ``np.random.default_rng((seed, epoch))``, so every process sees the
  same global batch order;
* **per-process slicing**: each process materializes only its
  ``1/process_count`` slice of every global batch.

The row gather, the streaming path's host hot op (one per step), runs
through the threaded C++ ``gather_batch`` (``utils/native.py``, without
the interpreter lock) when the native library loads, one thread per MiB
of batch, and through numpy fancy indexing, which gives the same arrays,
when it does not.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import os

import numpy as np

from recsys_tpu_torch.utils.native import gather_batch, native_available

TRAIN_COLS = ("user_id", "movie_id", "rating", "y_implicit")
# one gather thread per MiB of batch: starting a thread costs more than
# gathering a train batch of 8,192 rows (128 KiB) takes on one
# (chip_smoke.py phase 24 (f) times 1 to 8 threads against numpy at two
# batch sizes; PERF.md §6)
GATHER_BYTES_PER_THREAD = 1 << 20


class Batcher:
    """Deterministic epoch iterator over a preprocessing-bundle split."""

    def __init__(
        self,
        bundle: Dict[str, np.ndarray],
        split: str = "train",
        batch_size: int = 2048,
        seed: int = 42,
        columns: Sequence[str] = TRAIN_COLS,
        shuffle: bool = True,
        drop_remainder: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.columns = tuple(columns)
        self.data = {c: np.ascontiguousarray(bundle[f"{split}/{c}"]) for c in self.columns}
        self.n = len(next(iter(self.data.values())))
        self.row_bytes = sum(v.itemsize * int(np.prod(v.shape[1:])) for v in self.data.values())
        if batch_size % process_count:
            raise ValueError("batch_size must divide by process_count")
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.process_index = process_index
        self.process_count = process_count

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield this process's slice of each global batch. Without
        ``drop_remainder`` every batch carries a ``mask`` column (1 for
        real rows, 0 for the padding of the tail), so all batches have one
        structure."""
        use_native = native_available()
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch_idx)).permutation(self.n)
        else:
            order = np.arange(self.n)
        local = self.batch_size // self.process_count
        lo_off = self.process_index * local
        threads = max(1, min(os.cpu_count() or 1,
                             local * self.row_bytes // GATHER_BYTES_PER_THREAD))
        for step in range(self.steps_per_epoch):
            idx = order[step * self.batch_size:(step + 1) * self.batch_size]
            mask = None
            if not self.drop_remainder:
                pad = self.batch_size - len(idx)
                mask = np.concatenate(
                    [np.ones(len(idx), np.float32), np.zeros(pad, np.float32)])
                if pad:
                    idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
            sl_idx = idx[lo_off:lo_off + local]
            if use_native:
                batch = gather_batch(self.data, sl_idx, n_threads=threads)
            else:
                batch = {c: self.data[c][sl_idx] for c in self.columns}
            if mask is not None:
                batch["mask"] = mask[lo_off:lo_off + local]
            yield batch

    def __iter__(self):
        return self.epoch(0)
