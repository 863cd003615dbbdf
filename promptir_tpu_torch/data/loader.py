"""Host-side batch loader: a threaded producer of pinned tensors.

Counterpart of promptir_tpu/data/loader.py, which double-buffers batches
onto the TPU. Here worker threads decode and degrade the samples, a
producer thread stacks them into CPU tensors (in pinned memory when the
caller trains on the card, so the copy to the card can run asynchronously)
and keeps PREFETCH batches ahead of the training loop.

Determinism: the sample order of an epoch is a shuffle seeded by
(seed, epoch) and every noise draw derives from (seed, epoch, index), as in
the JAX loader, so the same seed gives the same batches in both packages.

Data parallelism: with `world` ranks, a global batch is `batch_size *
world` samples of the epoch's order and rank `rank` yields (and decodes)
only its rows (`rank_rows`): [rank b, (rank + 1) b), or, when the step
splits each batch into `microbatches` (train/step.py's grad_accum), its
share of each global microbatch, so that every rank's microbatch i holds
its rows of the global batch's i-th slice, the JAX step's microbatch i. A
sample's draws depend on its index alone, so those rows are exactly the
rows the one-process loader yields there at the global batch size, as the
JAX loader's sharded batch (loader.py:64) holds them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

PREFETCH = 2  # batches made ahead of the training loop


def rank_rows(batch_size: int, rank: int = 0, world: int = 1,
              microbatches: int = 1) -> np.ndarray:
    """The positions in a global batch of `batch_size * world` rows of rank
    `rank`'s `batch_size` rows, in its order: its `batch_size //
    microbatches` rows of each global microbatch, microbatch after
    microbatch."""
    if batch_size % microbatches:
        raise ValueError(f"batch {batch_size} is not divisible by "
                         f"{microbatches} microbatches")
    m = batch_size // microbatches
    return np.concatenate([i * m * world + rank * m + np.arange(m)
                           for i in range(microbatches)])


class TrainLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        num_workers: int = 4,
        pin_memory: bool = False,
        rank: int = 0,
        world: int = 1,
        microbatches: int = 1,
    ):
        """`batch_size` is a rank's; the global batch is batch_size * world,
        split by the step into `microbatches` (rank_rows)."""
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        self.rows = rank_rows(batch_size, rank, world, microbatches)
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.world = world
        self.seed = seed
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.pin_memory = pin_memory

    def __len__(self) -> int:
        """Full global batches of an epoch; the last partial one is dropped."""
        return len(self.dataset) // (self.batch_size * self.world)

    def order(self, epoch: int) -> np.ndarray:
        """The sample order of `epoch` (loader.py:52)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Yield batches {de_type (B,) int32, degraded and clean (B, H, W, 3)
        float32} of CPU tensors for one epoch."""
        order = self.order(epoch)
        nb = len(self)

        def make_batch(b: int) -> dict:
            idxs = order[b * self.world * self.batch_size + self.rows]
            de, deg, cln = [], [], []
            for i in idxs:
                rng = np.random.default_rng((self.seed, epoch, int(i)))
                d, x, y = self.dataset.get(int(i), rng)
                de.append(d)
                deg.append(x)
                cln.append(y)
            batch = {
                "de_type": torch.from_numpy(np.asarray(de, np.int32)),
                "degraded": torch.from_numpy(np.stack(deg)),
                "clean": torch.from_numpy(np.stack(cln)),
            }
            if self.pin_memory:
                batch = {k: v.pin_memory() for k, v in batch.items()}
            return batch

        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            # gives up once the consumer has stopped, so the thread ends
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    futures = [pool.submit(make_batch, b) for b in range(nb)]
                    for f in futures:
                        if not put(f.result()):
                            for g in futures:
                                g.cancel()
                            return
                put(None)
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
