"""Small shared helpers (reference vit.py:10-11; JAX package utils/helpers.py)."""

from __future__ import annotations

import sys

import torch


def exists(v):
    return v is not None


def default(v, d):
    return v if exists(v) else d


def pair(t):
    """reference vit.py:10-11"""
    return t if isinstance(t, (tuple, list)) else (t, t)


def cast_tuple(t, length: int = 1) -> tuple:
    """``t`` as a tuple: its items, or ``length`` copies of it."""
    return tuple(t) if isinstance(t, (tuple, list)) else ((t,) * length)


def default_device(device=None) -> torch.device:
    """The device an entry point of the port builds on: ``device`` when the
    caller names one, else the current CUDA card.  The port's kernels run on
    the card, so a caller who names no device gets the card, and on a
    machine without one an error instead of the plain CPU path: the CPU is
    taken only when asked for (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def table_device(device) -> torch.device:
    """The device a module builds a constant table on (a non-persistent
    buffer: a position table, an index map): its own, or the CPU for a
    module built on ``meta`` to take a checkpoint's tensors
    (``serving.Predictor.from_checkpoint``), whose tables are outside the
    checkpoint and must stay real."""
    device = torch.device(device)
    return torch.device("cpu") if device.type == "meta" else device


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor of ``torch.distributed.tensor`` (a tensor
    laid out over a mesh by ``parallel/``; none can exist before that module
    is loaded)."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)
