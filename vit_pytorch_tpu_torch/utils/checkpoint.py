"""Checkpoints with resume, port of ``vit_pytorch_tpu/utils/checkpoint.py``
(:30-141).

The JAX package saves pytrees through orbax.  Here a checkpoint is a
directory holding one ``torch.save`` file of a nested dict/list of tensors
and Python scalars, loaded back with ``weights_only=True``.  A port
``TrainState`` is saved as ``{"model": model.state_dict(), "optimizer":
optimizer.state_dict(), "step": step}`` and restored in place.

Two tiers, as in the JAX package:

- :func:`save_checkpoint` / :func:`restore_checkpoint`: one-shot round trips
  (synchronous, no bookkeeping).
- :class:`CheckpointManager`: step discovery (``latest_step``), keep-N
  retention, async save with ``wait_until_finished`` at close and at exit,
  and latest-step restore for resuming a run.

A save is atomic: it writes into a temporary sibling directory and renames
it onto ``<directory>/<step>``, as orbax commits by a rename, so a torn save
is never visible as a step.

States laid out over a mesh (``parallel/train.py::shard_train_state``:
DTensor parameters and moments) save and restore as orbax's sharded arrays
do (JAX checkpoint.py:1-3, :42-52): a save gathers every DTensor whole (a
collective: every rank calls it) and rank 0 alone writes; a restore
distributes each saved tensor into the target's placements, so a checkpoint
restores across layouts (sharded into one device, one device into sharded).
The optimizer's state is saved with its parameters named, not numbered, so
that it restores into any grouping of the same parameters (the sharded
optimizer splits each group in two).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
import uuid
from typing import Any, Optional, Sequence

import torch

from ..parallel.train import TrainState
from .helpers import is_dtensor

_STATE_FILE = "state.pt"
_METRICS_FILE = "metrics.json"
_TMP_PREFIX = ".tmp-"


def _param_names(state: TrainState) -> list:
    """The names of the optimizer's parameters, in its numbering."""
    names = {p: name for name, p in state.model.named_parameters()}
    return [names[p] for group in state.optimizer.param_groups for p in group["params"]]


def _tree(state: Any) -> Any:
    """The nested dict a checkpoint holds for ``state``; a ``TrainState``'s
    optimizer state dict is keyed by parameter name."""
    if isinstance(state, TrainState):
        names = _param_names(state)
        saved = state.optimizer.state_dict()
        optimizer = {
            "state": {names[i]: moments for i, moments in saved["state"].items()},
            "param_groups": [{**g, "params": [names[i] for i in g["params"]]} for g in saved["param_groups"]],
        }
        return {"model": state.model.state_dict(), "optimizer": optimizer, "step": state.step}
    return state


def _writes() -> bool:
    """Whether this process writes: rank 0 of a process group, or a process
    without one."""
    return not (torch.distributed.is_available() and torch.distributed.is_initialized()) \
        or torch.distributed.get_rank() == 0


def _barrier(tree_was_distributed: bool) -> None:
    if tree_was_distributed and torch.distributed.is_initialized():
        torch.distributed.barrier()


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def snapshot(state: Any) -> Any:
    """A host copy of ``state``'s tree that later updates of the live
    tensors cannot reach.

    ``optimizer.state_dict()`` holds the live ``exp_avg``/``exp_avg_sq`` and
    ``step`` tensors, which the next ``optimizer.step()`` updates in place.
    Each device tensor is copied into pinned host memory with a non-blocking
    copy on the current stream, and one event waited on at the end covers
    them all; a CPU tensor is cloned.  A DTensor is gathered whole first
    (``full_tensor``, a collective every rank of its mesh must reach)."""
    return _host_copy(_tree(state))[0]


def _host_copy(tree: Any):
    """:func:`snapshot` of a tree, and whether it held a DTensor."""
    devices = set()
    distributed = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        distributed.append(is_dtensor(t))
        if distributed[-1]:
            t = t.full_tensor()
        if t.device.type == "cpu":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        devices.add(t.device)
        return host

    tree = _map_tensors(copy, tree)
    for device in devices:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return tree, any(distributed)


def _write(final: str, tree: Any, metrics: Optional[dict] = None) -> None:
    """Write ``tree`` to ``final`` through a temporary sibling directory and
    one rename; an existing ``final`` is replaced."""
    parent = os.path.dirname(final)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"{_TMP_PREFIX}{os.path.basename(final)}-{uuid.uuid4().hex}")
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, _STATE_FILE), "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        if metrics is not None:
            with open(os.path.join(tmp, _METRICS_FILE), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        if os.path.exists(final):
            old = f"{tmp}-old"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read(path: str, mmap: bool = False) -> Any:
    file = os.path.join(path, _STATE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(file, map_location="cpu", weights_only=True, mmap=mmap)


def _check_leaf(where: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"checkpoint {where}: saved {tuple(got.shape)} {got.dtype}, target {tuple(want.shape)} "
                         f"{want.dtype}")


def _placed_like(saved: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``saved`` (whole, on the CPU) on ``target``'s device, distributed into
    its placements where it is a DTensor."""
    if is_dtensor(target):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(saved.to(target.device), target.device_mesh, target.placements)
    return saved.to(target.device)


def _restore_like(saved: Any, target: Any, where: str = "") -> Any:
    """``saved`` in ``target``'s structure: tensors of the target's shape and
    dtype (else ``ValueError``), placed like the target's (its device; its
    placements for a DTensor)."""
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"checkpoint {where}: saved {type(saved).__name__}, target a tensor")
        _check_leaf(where, saved, target)
        return _placed_like(saved, target)
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f"checkpoint {where}: saved keys {sorted(saved) if isinstance(saved, dict) else saved!r}, "
                             f"target keys {sorted(target)}")
        return {k: _restore_like(saved[k], v, f"{where}/{k}") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f"checkpoint {where}: saved {saved!r} does not match the target's {len(target)} items")
        return type(target)(_restore_like(s, t, f"{where}/{i}") for i, (s, t) in enumerate(zip(saved, target)))
    return saved


def _restore_train_state(saved: dict, state: TrainState) -> TrainState:
    """Load ``saved`` into ``state`` in place: the model's tensors must match
    its state dict, each optimizer moment its parameter; each is placed like
    the target's tensor."""
    if not isinstance(saved, dict) or set(saved) != {"model", "optimizer", "step"}:
        raise ValueError(f"checkpoint: not a TrainState (keys {sorted(saved) if isinstance(saved, dict) else saved!r})")
    own = state.model.state_dict()
    if set(saved["model"]) != set(own):
        raise ValueError(f"checkpoint: model keys differ: missing {sorted(set(own) - set(saved['model']))}, "
                         f"unexpected {sorted(set(saved['model']) - set(own))}")
    for name, t in own.items():
        _check_leaf(f"model/{name}", saved["model"][name], t)
    params = dict(state.model.named_parameters())
    names = _param_names(state)
    unknown = set(saved["optimizer"]["state"]) - set(names)
    if unknown:
        raise ValueError(f"checkpoint: optimizer state of parameters the target lacks: {sorted(unknown)}")
    for name, moments in saved["optimizer"]["state"].items():
        for key, t in moments.items():
            if key != "step" and isinstance(t, torch.Tensor):
                _check_leaf(f"optimizer/state/{name}/{key}", t, params[name])
    state.model.load_state_dict({name: _placed_like(saved["model"][name], t) for name, t in own.items()})
    index = {name: i for i, name in enumerate(names)}
    group_of = {name: g for g in saved["optimizer"]["param_groups"] for name in g["params"]}
    name_of = {id(p): name for name, p in params.items()}
    groups = []
    for g in state.optimizer.param_groups:
        members = [name_of[id(p)] for p in g["params"]]
        groups.append({**group_of[members[0]], "params": [index[n] for n in members]})
    state.optimizer.load_state_dict({
        "state": {index[name]: {k: _placed_like(t, params[name]) if k != "step" and isinstance(t, torch.Tensor)
                                and t.shape == params[name].shape else t for k, t in moments.items()}
                  for name, moments in saved["optimizer"]["state"].items()},
        "param_groups": groups,
    })
    state.step = int(saved["step"])
    return state


def _restore(path: str, target: Any) -> Any:
    saved = _read(path)
    if isinstance(target, TrainState):
        return _restore_train_state(saved, target)
    return _restore_like(saved, target)


def _step_path(path: str, step: Optional[int]) -> str:
    path = os.path.abspath(path)
    return path if step is None else os.path.join(path, str(int(step)))


def save_checkpoint(path: str, state: Any, step: Optional[int] = None) -> None:
    """Save a ``TrainState`` or a nested dict/list of tensors and scalars
    atomically to ``path`` (``path/<step>`` with ``step``).  A state holding
    DTensors is saved by every rank of its mesh together: each gathers, rank
    0 writes, and all return once the step is committed."""
    host, distributed = _host_copy(_tree(state))
    if _writes():
        _write(_step_path(path, step), host)
    _barrier(distributed)


def load_checkpoint(path: str, step: Optional[int] = None) -> Any:
    """The saved tree as it is, its tensors on the CPU and memory-mapped
    from the file (read as they are used, so a load does not hold a second
    copy of the weights in memory)."""
    return _read(_step_path(path, step), mmap=True)


def restore_checkpoint(path: str, target: Any, step: Optional[int] = None) -> Any:
    """Restore into ``target``'s structure.  A ``TrainState`` is loaded in
    place and returned; for a dict the result holds tensors placed like
    ``target``'s.  A shape or dtype that disagrees with the target raises
    ``ValueError``."""
    return _restore(_step_path(path, step), target)


class CheckpointManager:
    """Training checkpoints with retention and resume.

    >>> mgr = CheckpointManager(dir, max_to_keep=3)
    >>> mgr.save(step, state)                 # async by default
    >>> state = mgr.restore(state)            # latest step
    >>> mgr.latest_step()                     # None when no checkpoint yet
    >>> mgr.close()                           # flush pending async saves

    An async ``save`` snapshots ``state`` on the caller's thread
    (:func:`snapshot`), so the caller may update it as soon as ``save``
    returns; a background thread writes the snapshot, renames it into place
    and then removes the oldest steps past ``max_to_keep``.  A second
    ``save`` waits for the first.  ``latest_step`` and ``all_steps`` see
    committed steps only.  Context-manager friendly; an ``atexit`` hook also
    flushes a pending save.
    """

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = None, async_save: bool = True,
                 save_interval_steps: int = 1):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 or None, got {max_to_keep}")
        if save_interval_steps < 1:
            raise ValueError(f"save_interval_steps must be >= 1, got {save_interval_steps}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep, self.async_save, self.save_interval_steps = max_to_keep, async_save, save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._collective = False  # the pending save is of DTensors: every rank waits for rank 0's commit
        self._closed = False
        atexit.register(self._atexit)

    # -- saving ----------------------------------------------------------
    def should_save(self, step: int) -> bool:
        """orbax's rule: a step after the latest committed one, on the
        interval."""
        latest = self.latest_step()
        return (latest is None or step > latest) and step % self.save_interval_steps == 0

    def save(self, step: int, state: Any, *, metrics: Optional[dict] = None, force: bool = False) -> bool:
        """Save ``state`` as ``step`` (async by default); returns True if a
        save was made, False when the interval skips the step and ``force``
        is not set."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        step = int(step)
        self.wait_until_finished()
        if not force and not self.should_save(step):
            return False
        tree, self._collective = _host_copy(_tree(state))
        if not _writes():
            tree = None  # rank 0 writes; the next wait is this rank's barrier
        elif not self.async_save:
            self._commit(step, tree, metrics)
        else:
            self._writer = threading.Thread(target=self._background, args=(step, tree, metrics), daemon=True,
                                            name="vit-torch-checkpoint")
            self._writer.start()
        if not self.async_save:
            self.wait_until_finished()
        return True

    def _commit(self, step: int, tree: Any, metrics: Optional[dict]) -> None:
        _write(os.path.join(self.directory, str(step)), tree, metrics)
        if self.max_to_keep is not None:
            for old in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def _background(self, step: int, tree: Any, metrics: Optional[dict]) -> None:
        try:
            self._commit(step, tree, metrics)
        except BaseException as e:  # noqa: BLE001 — raised in the caller's next wait
            self._error = e

    def wait_until_finished(self) -> None:
        """Block until the pending save has committed; re-raise its error.
        After a save of DTensors every rank waits here for rank 0's commit
        (a barrier), so that each then sees the step."""
        self._wait(barrier=True)

    def _wait(self, barrier: bool) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._collective and barrier:
            _barrier(True)
        self._collective = False
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    # -- discovery -------------------------------------------------------
    def all_steps(self) -> Sequence[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, _STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restoring -------------------------------------------------------
    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Restore into ``target``'s structure from ``step`` (default: the
        latest), as :func:`restore_checkpoint`.  Raises FileNotFoundError
        when no checkpoint exists."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        return _restore(os.path.join(self.directory, str(step)), target)

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self._close(barrier=True)

    def _close(self, barrier: bool) -> None:
        if not self._closed:
            self._closed = True
            atexit.unregister(self._atexit)
            self._wait(barrier)

    def _atexit(self) -> None:
        try:
            self._close(barrier=False)  # the other ranks may be gone
        except Exception:  # noqa: BLE001 — nothing is left to report to at exit
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
