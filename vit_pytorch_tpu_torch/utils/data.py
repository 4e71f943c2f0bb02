"""Host-to-device input pipeline, port of ``vit_pytorch_tpu/utils/data.py``
(:174-349).

A training step on the card should never wait on the host: while step k
computes, batch k+1 should already be crossing the host-to-device link.
Two overlap mechanisms compose, as in the JAX package:

- :func:`prefetch_to_device` keeps up to ``depth`` upcoming batches in
  flight.  On a CUDA device each host leaf is staged in pinned memory and
  copied with ``non_blocking=True`` on a copy stream of its own; the
  consumer's stream waits on the copy's event before the batch is yielded.
- ``host_workers=True`` additionally pulls the wrapped iterator on a daemon
  thread, so host-side batch construction (decode, augmentation,
  collation) and the pinned staging copy overlap the copies and the
  compute.

Batches are pytrees (``torch.utils._pytree``) of numpy arrays or CPU
tensors, e.g. ``{"images": x, "labels": y}``.

Over a mesh (``parallel/mesh.py``) each process holds its own rows of
every global batch (:func:`process_local_slice`), and
``prefetch_to_device(..., mesh=mesh)`` yields DTensors of the global shape,
sharded over 'data': the JAX package's multi-process branch, the only one
a port of one process a device has.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Iterable, Iterator

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from .helpers import default_device

__all__ = ["minibatches", "prefetch_to_device", "process_local_slice"]

def _is_array(a) -> bool:
    return isinstance(a, (np.ndarray, torch.Tensor))


def process_local_slice(data, process_index=None, process_count=None, *, mesh=None):
    """This process's contiguous row-slice of a global row-aligned pytree
    (data parallelism across processes: each keeps 1/Nth of every global
    batch).  With ``mesh`` the slice is that of this rank's 'data'
    coordinate among the 'data' axis's size, so that ranks which differ only
    in 'model' hold the same rows; without it the defaults are
    ``torch.distributed``'s rank and world size when a process group is
    initialised, else 0 and 1.

    Every process must hold the SAME logical global data (or an identically
    shuffled view: seed per-epoch rngs identically across processes, as
    ``minibatches`` callers do) so the slices tile the global batch.
    """
    if mesh is not None:
        rank, size = mesh.get_local_rank("data"), mesh["data"].size()
    elif torch.distributed.is_available() and torch.distributed.is_initialized():
        rank, size = torch.distributed.get_rank(), torch.distributed.get_world_size()
    else:
        rank, size = 0, 1
    idx = rank if process_index is None else process_index
    cnt = size if process_count is None else process_count
    leaves = tree_leaves(data)
    if not leaves or cnt == 1:
        return data
    n = leaves[0].shape[0]
    if n % cnt:
        raise ValueError(f"process_local_slice: leading dim {n} must divide by process_count {cnt}")
    per = n // cnt
    return tree_map(lambda a: a[idx * per : (idx + 1) * per], data)


def _take(a, sel: np.ndarray):
    return a[torch.from_numpy(sel)] if isinstance(a, torch.Tensor) else a[sel]


def minibatches(data, batch_size: int, *, rng=None, drop_last: bool = True):
    """Yield minibatch pytrees sliced from row-aligned host arrays.

    ``data`` is any pytree of numpy arrays or CPU tensors sharing the same
    leading dimension (e.g. ``{"images": x, "labels": y}``).  When ``rng``
    (a ``numpy.random.Generator``) is given, rows are visited in a fresh
    shuffled order, the JAX function's for the same generator state; pass a
    fresh ``rng`` (or reuse one statefully) per epoch.  ``drop_last`` drops
    the ragged tail batch so every yielded batch has one shape.  Unshuffled,
    the batches are views of ``data``.
    """
    leaves = tree_leaves(data)
    if not leaves:
        return
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError(f"minibatches: leading dims disagree ({leaf.shape[0]} vs {n})")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    end = n - (n % batch_size) if drop_last else n
    if rng is None:
        for start in range(0, end, batch_size):
            stop = start + batch_size
            yield tree_map(lambda a: a[start:stop], data)
        return
    order = np.arange(n)
    rng.shuffle(order)
    for start in range(0, end, batch_size):
        sel = order[start : start + batch_size]
        yield tree_map(lambda a: _take(a, sel), data)


def _host_thread_iter(it: Iterator, size: int) -> Iterator:
    """Run ``it`` on a daemon thread with a bounded handoff queue.

    Exceptions raised by the producer are re-raised in the consumer at the
    point they interrupt the stream.  If the consumer abandons the
    generator early (break / exception / GC), its ``finally`` signals the
    producer to stop, so the thread exits instead of blocking forever on a
    full queue while pinning batches in memory.
    """
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, size))
    end = object()
    stop = threading.Event()
    errs: list = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
            errs.append(e)
        finally:
            _put(end)

    threading.Thread(target=run, daemon=True, name="vit-torch-host-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is end:
                if errs:
                    raise errs[0]
                return
            yield item
    finally:
        stop.set()


class _CudaPlacer:
    """Copies host batches to one CUDA device on a stream of its own.

    ``stage`` copies each leaf into a pinned buffer (on the producer thread
    when there is one), reusing the buffers whose copies have completed;
    ``put`` starts the non-blocking copies of a staged batch on the copy
    stream and records their event; ``take`` makes the consumer's current
    stream wait for that event, marks the device tensors as used on that
    stream (``record_stream``, so the caching allocator does not hand their
    memory out while the consumer's work may still read it) and returns the
    batch.  A pinned source is kept, and reused, only once its copy's event
    has completed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.retiring: collections.deque = collections.deque()  # (event, pinned sources)
        # pinned buffers whose copies have completed, by (shape, dtype), for
        # the next batches: a fresh pinned allocation of a 154 MB batch took
        # 20-50 ms on an H100 host (PERF.md §6); stage may run on the producer
        # thread
        self.pool: dict = collections.defaultdict(list)
        self.lock = threading.Lock()

    def stage(self, batch):
        def pin(a):
            if not _is_array(a):
                return a
            a = torch.as_tensor(a)
            with self.lock:
                free = self.pool[(a.shape, a.dtype)]
                src = free.pop() if free else None
            if src is None:
                src = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            src.copy_(a)
            return src

        return tree_map(pin, batch)

    def put(self, staged):
        while self.retiring and self.retiring[0][0].query():
            _, done = self.retiring.popleft()
            with self.lock:
                for t in done:
                    self.pool[(t.shape, t.dtype)].append(t)
        pinned = [t for t in tree_leaves(staged) if isinstance(t, torch.Tensor)]
        with torch.cuda.stream(self.stream):
            out = tree_map(lambda t: t.to(self.device, non_blocking=True) if isinstance(t, torch.Tensor) else t,
                           staged)
        done = torch.cuda.Event()
        done.record(self.stream)
        self.retiring.append((done, pinned))
        return out, done

    def take(self, placed):
        batch, done = placed
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        for t in tree_leaves(batch):
            if isinstance(t, torch.Tensor):
                t.record_stream(consumer)
        return batch


def _cpu_place(batch):
    return tree_map(lambda a: torch.as_tensor(a) if _is_array(a) else a, batch)


def _sharded(take, sharding):
    """``take`` followed by the DTensor assembly of each leaf over its
    sharding's mesh."""
    from ..parallel.mesh import Sharding, global_array_from_process_local

    def place(a, s):
        return global_array_from_process_local(a, s.mesh, s.spec) if isinstance(a, torch.Tensor) else a

    if isinstance(sharding, Sharding):
        return lambda placed: tree_map(lambda a: place(a, sharding), take(placed))
    return lambda placed: tree_map(place, take(placed), sharding)


def prefetch_to_device(iterator: Iterable, *, depth: int = 2, device=None, sharding=None, mesh=None,
                       host_workers: bool = False) -> Iterator:
    """Wrap an iterator of host pytrees; yield device-tensor pytrees with up
    to ``depth`` batches already transferred ahead of the consumer.

    ``device``: the CUDA card unless the caller names another
    (``utils/helpers.py::default_device``); on ``device="cpu"`` leaves are
    converted to tensors, not pinned.

    ``sharding`` places every leaf over a mesh (a
    ``parallel.mesh.Sharding``, or a pytree of them matching the batch
    structure): each leaf is this process's shard, and becomes a DTensor of
    the global shape (``parallel.mesh.global_array_from_process_local``),
    on the mesh's device.  ``mesh`` is the common shortcut: leading axis
    sharded over the mesh's 'data' axis (``parallel.mesh.batch_sharding``),
    matching what ``make_sharded_train_step`` expects; feed it
    ``process_local_slice(..., mesh=mesh)``'s rows.

    ``host_workers=True`` pulls ``iterator`` on a background thread (see the
    module docstring).  Lookahead bound: without ``host_workers`` the
    wrapped iterator is consumed at most ``depth + 1`` batches ahead of what
    has been yielded; with it, the producer thread buffers up to ``depth``
    more host batches in its handoff queue.

    Argument validation happens at call time (this returns a started
    generator), so a bad ``depth`` or a ``mesh`` + ``sharding`` conflict
    raises here, not at the first ``next()`` deep inside a training loop.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if mesh is not None and sharding is not None:
        raise ValueError("pass sharding or mesh, not both")
    if mesh is not None:
        from ..parallel.mesh import batch_sharding

        sharding = batch_sharding(mesh)
    if sharding is not None:
        from ..parallel.mesh import Sharding, mesh_device

        first = sharding if isinstance(sharding, Sharding) else tree_leaves(
            sharding, is_leaf=lambda s: isinstance(s, Sharding))[0]
        device = mesh_device(first.mesh)
    device = default_device(device)
    it = iter(iterator)
    if device.type == "cuda":
        placer = _CudaPlacer(device)
        # the pinned staging copy runs where the batch is made: on the
        # producer thread with host_workers, else on the consumer's
        it = map(placer.stage, it)
        put, take = placer.put, placer.take
    else:
        put, take = _cpu_place, lambda batch: batch
    if host_workers:
        it = _host_thread_iter(it, size=depth)
    if sharding is not None:
        take = _sharded(take, sharding)

    def _stream() -> Iterator:
        in_flight: collections.deque = collections.deque()
        for batch in it:
            in_flight.append(put(batch))
            if len(in_flight) > depth:
                yield take(in_flight.popleft())
        while in_flight:
            yield take(in_flight.popleft())

    return _stream()
