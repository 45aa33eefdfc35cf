"""Batched episode loading with background workers, pinned host buffers and
copies to the card ahead of use.

The port's counterpart of ``few_shot_seg_cwt_tpu.data.loader`` (reference:
src/dataset/dataset.py:61-68, workers + pin_memory): a thread pool decodes
and transforms episodes (zlib, the host C++ core and numpy release the
interpreter lock), a producer thread collates each batch, and up to
``prefetch`` batches wait in a bounded queue.

On a CUDA device each batch is collated straight into one slot of a ring of
``prefetch + 1`` sets of pinned host buffers, allocated once at the first
batch, and copied with ``non_blocking=True`` on a copy stream of the
loader's own; an event recorded after the copy is what the consumer's
stream waits on, and each tensor handed over is recorded on the consumer's
stream, so the caching allocator does not reuse its memory while the
consumer's work may still read it. A slot is written again only after its
last copy's event has completed. Labels cross as int32; the engines cast
them on the card.

Episode order: training shuffles indices each epoch with a per-epoch seed;
validation iterates sequentially and wraps around through ``infinite``
(the reference restarts an exhausted iterator mid-run, src/test.py:149-153).
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


def collate(records: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = records[0].keys()
    return {k: np.stack([r[k] for r in records], axis=0) for k in keys}


class _PinnedRing:
    """``slots`` sets of pinned host buffers of one batch's shapes, and the
    event of each slot's last copy to the card."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = slots
        self.buffers: List[Dict[str, torch.Tensor]] = []
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.stream = torch.cuda.Stream(device)
        self.next = 0
        self.lock = threading.Lock()  # iterators of one loader share the ring

    def _allocate(self, records) -> None:
        for _ in range(self.slots):
            self.buffers.append({
                k: torch.from_numpy(np.empty((len(records), *np.shape(v)),
                                             np.asarray(v).dtype)).pin_memory()
                for k, v in records[0].items()})

    def copy(self, records) -> Dict[str, Any]:
        """Collate ``records`` into the next free slot and start its copy;
        returns the device tensors and the event that ends the copy. A
        short tail batch (``drop_last=False``) fills the slot's first rows."""
        with self.lock:
            if not self.buffers:
                self._allocate(records)
            k = self.next
            self.next = (k + 1) % self.slots
            if self.events[k] is not None:
                self.events[k].synchronize()  # the slot's last copy has landed
            host = {name: buf[:len(records)] for name, buf in self.buffers[k].items()}
            for name, buf in host.items():
                np.stack([r[name] for r in records], axis=0, out=buf.numpy())
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                out = {name: buf.to(self.device, non_blocking=True)
                       for name, buf in host.items()}
                event = torch.cuda.Event()
                event.record(self.stream)
            self.events[k] = event
        return {"tensors": out, "event": event}

    def hand_over(self, item: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The consumer's side of a copy: its stream waits for the copy, and
        the allocator learns that the tensors are used on that stream."""
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(item["event"])
        for t in item["tensors"].values():
            t.record_stream(consumer)
        return item["tensors"]


class EpisodeLoader:
    """Iterable over collated episode batches.

    Args:
      dataset: index-addressable record source (EpisodicDataset, ...).
      batch_size: episodes per batch (static shape; short tails dropped with
        ``drop_last``).
      shuffle: reshuffle each epoch (seeded by ``seed + epoch``).
      num_workers: decode threads; 0 = synchronous.
      device: where batches are delivered: ``"cuda"`` (pinned ring, copies
        ahead; raises without a card) or ``"cpu"`` (plain tensors).
      prefetch: batches prepared ahead.
      rank, world: this process covers indices rank, rank + world, ...
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: int = 2021, device="cuda",
                 prefetch: int = 2, drop_last: bool = True, rank: int = 0,
                 world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EpisodeLoader: no CUDA device; pass device='cpu'")
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.epoch = 0
        # DistributedSampler analog (reference src/dataset/dataset.py:57-68):
        # every rank is padded (by cyclic wrap) to the same per-rank count
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside world {world}")
        self.rank = rank
        self.world = world
        self._ring: Optional[_PinnedRing] = None

    def _per_rank(self) -> int:
        return -(-len(self.dataset) // self.world)  # ceil

    def __len__(self) -> int:
        n = self._per_rank()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _index_stream(self) -> Iterator[int]:
        # at most world - 1 indices repeat a pass (the wrap padding); replay
        # evaluation refuses world > 1 for that reason (train.common)
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n).tolist()
        else:
            order = list(range(n))
        for k in range(self._per_rank()):
            yield order[(self.rank + self.world * k) % n]

    def _batches_of_indices(self) -> Iterator[List[int]]:
        idx_stream = self._index_stream()
        while True:
            chunk = list(itertools.islice(idx_stream, self.batch_size))
            if len(chunk) < self.batch_size:
                if chunk and not self.drop_last:
                    yield chunk
                return
            yield chunk

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.device.type == "cuda" and self._ring is None:
            self._ring = _PinnedRing(self.device, self.prefetch + 1)
        ring = self._ring

        def finalize(records):
            if ring is not None:
                return ring.copy(records)
            return {k: torch.from_numpy(v) for k, v in collate(records).items()}

        def deliver(item):
            return ring.hand_over(item) if ring is not None else item

        if self.num_workers <= 0:
            for chunk in self._batches_of_indices():
                yield deliver(finalize([self.dataset[i] for i in chunk]))
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_abort(item) -> bool:
            """Queue.put that gives up when the consumer abandoned the iterator
            (otherwise the producer thread and its batches leak forever)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in self._batches_of_indices():
                        if stop.is_set():
                            return
                        records = list(pool.map(self.dataset.__getitem__, chunk))
                        if not put_or_abort(finalize(records)):
                            return
            except Exception as e:  # surface worker errors to the consumer
                put_or_abort(e)
            finally:
                put_or_abort(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield deliver(item)
        finally:
            # the producer stops within a batch; joining it here means no
            # thread of this iterator is still inside a torch call when the
            # interpreter exits (which aborts the process)
            stop.set()
            thread.join()


def infinite(loader: EpisodeLoader) -> Iterator[Dict[str, Any]]:
    """Wrap-around iteration (validation semantics of the reference)."""
    while True:
        produced = False
        for batch in loader:
            produced = True
            yield batch
        if not produced:
            raise RuntimeError(
                f"loader yields no batches (dataset of {len(loader.dataset)} "
                f"items < batch_size {loader.batch_size} with drop_last)"
            )
