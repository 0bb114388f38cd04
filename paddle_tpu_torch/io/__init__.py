"""paddle.io: Dataset/DataLoader (`paddle_tpu/io/__init__.py`; reference
`python/paddle/io/`).

`num_workers>0` forks real worker processes (reference
`io/dataloader/dataloader_iter.py` `_DataLoaderIterMultiProcess` +
`worker.py`): index batches are dispatched over per-worker queues, workers
collate numpy batches onto a shared result queue with ticketed reordering
and exception propagation, and a buffer-reader thread in the main process
converts finished batches to Tensors on the creation place (the card)
ahead of consumption, so host batch prep overlaps the device step. Workers
never touch CUDA (see `_default_mp_ctx`); no memory is pinned, as in the
JAX package.
"""

import itertools
import math
import multiprocessing
import os
import queue
import threading
import traceback

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        lengths = [int(math.floor(n * l)) for l in lengths]
        lengths[-1] += n - sum(lengths)
    idx = np.random.permutation(sum(lengths))
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, idx[offset:offset + l].tolist()))
        offset += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """Sample WITHOUT replacement from a fixed index subset (reference
    `io/sampler.py` SubsetRandomSampler)."""

    def __init__(self, indices, generator=None):
        self.indices = list(indices)

    def __iter__(self):
        return iter(self.indices[i]
                    for i in np.random.permutation(len(self.indices)))

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """reference: `python/paddle/io/dataloader/batch_sampler.py`"""

    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharded sampler (reference: `batch_sampler.py` DistributedBatchSampler).
    Each rank feeds its local shard; rank/nranks default from an
    initialised torch.distributed process group, else one rank."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                num_replicas = num_replicas or dist.get_world_size()
                rank = rank if rank is not None else dist.get_rank()
            else:
                num_replicas, rank = 1, 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - n)]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn([b[i] for b in batch]) for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


_PREFETCH_DONE = object()


def _put_until_stop(out_queue, item, stop):
    """Blocking put that aborts when the consumer abandoned us; True if
    delivered."""
    while not stop.is_set():
        try:
            out_queue.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _prefetch_worker(base, convert, out_queue, stop):
    """Module-level so the thread does NOT hold a reference to the
    _PrefetchIter — abandoning iteration lets the iterator be GC'd, which
    stops this thread and (via the base iterator's __del__) joins any
    worker processes instead of leaking them. The done/exception sentinels
    use the same stop-aware put as batches: a full queue must never drop
    them (the consumer would block forever)."""
    try:
        for batch in base:
            if not _put_until_stop(out_queue, convert(batch), stop):
                shutdown = getattr(base, "shutdown", None)
                if shutdown is not None:
                    shutdown()
                return
    except BaseException as e:  # propagate into the consumer
        _put_until_stop(out_queue, _ExcInfo(e, traceback.format_exc()), stop)
    _put_until_stop(out_queue, _PREFETCH_DONE, stop)


class _PrefetchIter:
    """Buffer-reader thread: pulls batches from a base iterator and converts
    them to device tensors ahead of consumption, overlapping host batch prep
    + H2D with the device step (the reference's buffer reader,
    `use_buffer_reader`)."""

    def __init__(self, base_iter, convert, num_prefetch=2):
        self._queue = queue.Queue(maxsize=num_prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_prefetch_worker,
            args=(base_iter, convert, self._queue, self._stop), daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _PREFETCH_DONE:
            raise StopIteration
        if isinstance(item, _ExcInfo):
            item.reraise()
        return item

    def close(self):
        self._stop.set()

    def __del__(self):
        self.close()


# -- multiprocess workers (reference io/dataloader/worker.py) ---------------


class _ExcInfo:
    """Carries a worker exception as STRINGS only (reference worker.py):
    live exception objects may not round-trip pickle through the mp queue
    — a failed pickle would silently drop the item (hang) or crash the
    parent-side unpickle."""

    def __init__(self, exc, tb):
        self.exc_type = type(exc).__name__
        self.exc_msg = str(exc)
        self.tb = tb

    def reraise(self):
        raise RuntimeError(
            f"DataLoader worker raised {self.exc_type}: "
            f"{self.exc_msg}\nworker traceback:\n{self.tb}")


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = None


def get_worker_info():
    """Inside a worker process: (id, num_workers, dataset, seed); None in
    the main process (reference worker.py:get_worker_info)."""
    return _worker_info


def _worker_loop(dataset, index_queue, data_queue, collate_fn,
                 worker_init_fn, worker_id, num_workers, seed):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset, seed)
    np.random.seed((seed + worker_id) % (2 ** 31))
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        msg = index_queue.get()
        if msg is None:
            return
        ticket, indices = msg
        try:
            batch = collate_fn([dataset[i] for i in indices])
            data_queue.put((ticket, batch))
        except BaseException as e:
            data_queue.put((ticket, _ExcInfo(e, traceback.format_exc())))


def _iterable_worker_loop(dataset, data_queue, worker_init_fn, worker_id,
                          num_workers, seed):
    """IterableDataset worker: consumes every num_workers-th ITEM of its
    own dataset iterator (round-robin item sharding). Items — not batches —
    go to the parent, which reassembles the exact single-process item order
    and batches globally, so batch boundaries and drop_last semantics do
    not depend on num_workers. The bounded data queue provides
    backpressure (blocking put) against a slow consumer."""
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset, seed)
    np.random.seed((seed + worker_id) % (2 ** 31))
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    try:
        it = itertools.islice(iter(dataset), worker_id, None, num_workers)
        for local, item in enumerate(it):
            data_queue.put(((worker_id, local), item))
    except BaseException as e:
        data_queue.put(((worker_id, -1), _ExcInfo(e, traceback.format_exc())))
    finally:
        data_queue.put(((worker_id, None), None))  # exhausted sentinel


def _default_mp_ctx():
    """'fork' on posix (the reference's default). Workers run dataset code
    and numpy only and never touch CUDA, so a fork after the card is up
    is safe; batches become device Tensors in the main process
    (`DataLoader._to_tensors`). PADDLE_LOADER_MP_CTX=spawn trades startup
    cost for isolation; 'spawn' elsewhere (Windows has no fork)."""
    env = os.environ.get("PADDLE_LOADER_MP_CTX")
    if env:
        return env
    import sys

    if os.name != "posix" or sys.platform == "darwin":
        return "spawn"  # no fork on Windows; fork is unsafe on macOS
    return "fork"


class _MultiprocessIter:
    """Reference `_DataLoaderIterMultiProcess` (dataloader_iter.py): worker
    processes + index/data queues + ordered reassembly + worker-death
    detection."""

    def __init__(self, loader):
        self._loader = loader
        self._num_workers = loader.num_workers
        self._timeout = loader.timeout or 0
        ctx = multiprocessing.get_context(_default_mp_ctx())
        self._data_queue = ctx.Queue()
        self._workers = []
        self._index_queues = []
        seed = int(np.random.randint(0, 2 ** 31))
        self._batches = list(loader.batch_sampler)
        self._send_idx = 0
        self._rcvd_idx = 0
        self._reorder = {}
        for w in range(self._num_workers):
            iq = ctx.Queue()
            p = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, iq, self._data_queue,
                      loader.collate_fn, loader.worker_init_fn, w,
                      self._num_workers, seed),
                daemon=True)
            p.start()
            self._index_queues.append(iq)
            self._workers.append(p)
        # prime the pipeline: prefetch_factor outstanding batches per worker
        for _ in range(self._num_workers * loader.prefetch_factor):
            self._dispatch()

    def _dispatch(self):
        if self._send_idx < len(self._batches):
            w = self._send_idx % self._num_workers
            self._index_queues[w].put(
                (self._send_idx, self._batches[self._send_idx]))
            self._send_idx += 1

    def _get(self):
        timeout = self._timeout if self._timeout > 0 else 5.0
        while True:
            try:
                return self._data_queue.get(timeout=timeout)
            except queue.Empty:
                dead = [w for w, p in enumerate(self._workers)
                        if not p.is_alive()]
                if dead:
                    self.shutdown()
                    raise RuntimeError(
                        f"DataLoader worker(s) {dead} exited unexpectedly "
                        f"(killed/OOM?) — reference worker-death handling, "
                        f"dataloader_iter.py")
                if self._timeout > 0:
                    self.shutdown()
                    raise RuntimeError(
                        f"DataLoader timed out after {self._timeout}s")

    def __iter__(self):
        return self

    def __next__(self):
        if self._rcvd_idx >= len(self._batches):
            self.shutdown()
            raise StopIteration
        while self._rcvd_idx not in self._reorder:
            ticket, data = self._get()
            self._reorder[ticket] = data
        data = self._reorder.pop(self._rcvd_idx)
        self._rcvd_idx += 1
        self._dispatch()
        if isinstance(data, _ExcInfo):
            self.shutdown()
            data.reraise()
        return data

    def shutdown(self):
        for iq in self._index_queues:
            try:
                iq.put(None)
            except Exception:
                pass
        for p in self._workers:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        self._workers = []

    def __del__(self):
        self.shutdown()


class _MultiprocessIterableIter:
    """IterableDataset over workers: items stream back over a BOUNDED
    queue (backpressure) and are reassembled into the exact single-process
    item order, then batched globally — batch boundaries and drop_last do
    not depend on num_workers."""

    def __init__(self, loader):
        self._num_workers = loader.num_workers
        self._timeout = loader.timeout or 0
        self._collate = loader.collate_fn
        self._batch_size = loader.batch_size or 1
        self._drop_last = getattr(loader, "drop_last", False)
        ctx = multiprocessing.get_context(_default_mp_ctx())
        self._data_queue = ctx.Queue(
            maxsize=self._num_workers * loader.prefetch_factor
            * self._batch_size)
        self._workers = []
        seed = int(np.random.randint(0, 2 ** 31))
        for w in range(self._num_workers):
            p = ctx.Process(
                target=_iterable_worker_loop,
                args=(loader.dataset, self._data_queue,
                      loader.worker_init_fn, w, self._num_workers, seed),
                daemon=True)
            p.start()
            self._workers.append(p)
        self._buffers = {w: {} for w in range(self._num_workers)}
        self._next_local = {w: 0 for w in range(self._num_workers)}
        self._exhausted = set()
        self._turn = 0

    def __iter__(self):
        return self

    def _pump(self):
        timeout = self._timeout if self._timeout > 0 else 5.0
        try:
            (w, local), data = self._data_queue.get(timeout=timeout)
        except queue.Empty:
            dead = [w for w, p in enumerate(self._workers)
                    if not p.is_alive() and w not in self._exhausted]
            if dead:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker(s) {dead} exited unexpectedly")
            if self._timeout > 0:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader timed out after {self._timeout}s")
            return
        if local is None:
            self._exhausted.add(w)
        elif local == -1:
            self.shutdown()
            data.reraise()
        else:
            self._buffers[w][local] = data

    def _next_item(self):
        """Items in global order: item i came from worker i % num_workers."""
        while True:
            if len(self._exhausted) == self._num_workers and all(
                    not b for b in self._buffers.values()):
                return None
            w = self._turn % self._num_workers
            want = self._next_local[w]
            if want in self._buffers[w]:
                data = self._buffers[w].pop(want)
                self._next_local[w] += 1
                self._turn += 1
                return data
            if w in self._exhausted:
                # shard done; if every shard is done the check above ends it
                if all(r in self._exhausted
                       for r in range(self._num_workers)):
                    continue
                self._turn += 1
                continue
            self._pump()

    def __next__(self):
        batch = []
        while len(batch) < self._batch_size:
            item = self._next_item()
            if item is None:
                break
            batch.append(item)
        if not batch or (len(batch) < self._batch_size and self._drop_last):
            self.shutdown()
            raise StopIteration
        return self._collate(batch)

    def shutdown(self):
        for p in self._workers:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        self._workers = []

    def __del__(self):
        self.shutdown()


class DataLoader:
    """reference: `python/paddle/io/dataloader/dataloader_iter.py`.
    `num_workers>0` forks real worker processes (index queues -> collate ->
    shared data queue, ordered reassembly, exception propagation and
    worker-death detection); `use_buffer_reader` additionally runs a
    device-prefetch thread so host batch prep overlaps the device step."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.return_list = return_list
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._is_iterable = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif not self._is_iterable:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size or 1,
                                              drop_last=drop_last)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last

    def _to_tensors(self, collated):
        if isinstance(collated, np.ndarray):
            return Tensor(collated)
        if isinstance(collated, (list, tuple)):
            return [self._to_tensors(c) for c in collated]
        if isinstance(collated, dict):
            return {k: self._to_tensors(v) for k, v in collated.items()}
        return collated

    def _iter_batches(self):
        """Raw collated (host numpy) batches, single-process."""
        if self._is_iterable:
            it = iter(self.dataset)
            if self.batch_size is None:
                for item in it:
                    yield self.collate_fn([item])
                return
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and getattr(self, "drop_last", False):
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                batch = [self.dataset[i] for i in indices]
                yield self.collate_fn(batch)

    def __iter__(self):
        if self.num_workers and self.num_workers > 0:
            base = (_MultiprocessIterableIter(self) if self._is_iterable
                    else _MultiprocessIter(self))
        else:
            base = self._iter_batches()
        if self.use_buffer_reader:
            return _PrefetchIter(base, convert=self._to_tensors,
                                 num_prefetch=self.prefetch_factor)
        return (self._to_tensors(b) for b in base)

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("IterableDataset DataLoader has no len()")
