"""Threaded batching loader.

The port's own copy of ``hplflownet_tpu/data/loader.py``.  Its worker
threads touch numpy only; the driver copies each batch to the device on
the main thread.  Replaces the reference's torch DataLoader with 16
worker processes (main.py:67-74): since lattice construction moved
on-device, host work per item is just .npy loading + numpy augmentation,
which a small thread pool overlaps with device compute comfortably.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["BatchLoader"]


def _stack(items):
    keys = [k for k in items[0] if k != "path"]
    batch = {k: np.stack([it[k] for it in items]) for k in keys}
    batch["path"] = [it["path"] for it in items]
    return batch


def _pad_batch(batch, batch_size):
    """Pad a partial batch to ``batch_size`` by repeating the last sample
    with all-False valid masks — every batch keeps one shape (the JAX
    step compiles once per epoch for it) while the masks keep metrics and
    loss exact.
    ``num_real`` records how many leading samples are genuine."""
    real = len(batch["path"])
    pad = batch_size - real
    out = {}
    for k, v in batch.items():
        if k == "path":
            out[k] = list(v) + [v[-1]] * pad
        elif k.startswith("valid"):
            out[k] = np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
        else:
            out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
    out["num_real"] = real
    return out


class BatchLoader:
    """Iterate a dataset in batches with background prefetch.

    Drops the trailing partial batch when ``drop_last`` (one batch shape);
    shuffles per epoch with the given seed.
    """

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 num_threads=4, prefetch=4, drop_last=None, pad_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, int(num_threads))
        self.prefetch = prefetch
        self.drop_last = shuffle if drop_last is None else drop_last
        # pad (instead of emit ragged) the trailing partial batch: one
        # batch shape per eval epoch (e.g. KITTI's 142 samples at batch 4)
        self.pad_last = pad_last and not self.drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        batches = [order[i: i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        idx_q: "queue.Queue" = queue.Queue()
        slots = {}
        for i, b in enumerate(batches):
            idx_q.put((i, b))
        epoch = self._epoch - 1

        def fetch(j):
            # per-(seed, epoch, sample) RNG: identical batches across runs
            # and thread schedules (the reference's per-worker reseed,
            # main.py:85-92, is not replayable)
            if hasattr(self.dataset, "load"):
                mix = (self.seed * 1000003 + epoch * 10007 + int(j)) \
                    % (2 ** 32)
                return self.dataset.load(int(j),
                                         np.random.RandomState(mix))
            return self.dataset[j]

        def worker():
            while True:
                try:
                    i, b = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    stacked = _stack([fetch(j) for j in b])
                    if self.pad_last and len(b) < self.batch_size:
                        stacked = _pad_batch(stacked, self.batch_size)
                    out_q.put((i, stacked))
                except Exception as e:  # surface loader errors to the consumer
                    out_q.put((i, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()

        next_i = 0
        received = 0
        while received < len(batches):
            i, item = out_q.get()
            received += 1
            slots[i] = item
            while next_i in slots:
                val = slots.pop(next_i)
                next_i += 1
                if isinstance(val, Exception):
                    raise val
                yield val
