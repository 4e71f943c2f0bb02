"""What the example scripts share: their command line (``--device``,
``--set``), seeds derived from a key, and the card's clock."""

from __future__ import annotations

import argparse
import ast
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.helpers import default_device


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the options every example takes: ``--device``
    (the CUDA card unless it names another) and ``--set key=value``, which
    overrides one entry of the script's ``CONFIG`` (repeatable; the value is
    a Python literal, e.g. ``--set dim=64 --set flash=False``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="where to run (default: the CUDA card)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override an entry of the script's CONFIG (repeatable)")
    return ap


def parse(ap: argparse.ArgumentParser, argv: Optional[Sequence[str]], config: dict):
    """``(args, cfg, device)``: the parsed options, ``config`` with the
    ``--set`` overrides, and the device (``utils/helpers.py::default_device``:
    no card raises unless ``--device`` names one)."""
    args = ap.parse_args(argv)
    cfg = dict(config)
    for item in args.set:
        key, sep, value = item.partition("=")
        if not sep or key not in cfg:
            ap.error(f"--set {item!r}: expected KEY=VALUE with KEY one of {sorted(cfg)}")
        try:
            cfg[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            cfg[key] = value
    return args, cfg, default_device(args.device)


def derived_seed(*keys: int) -> int:
    """A seed derived from ``keys`` (numpy's ``SeedSequence``), as
    ``jax.random.fold_in`` derives a key: the same keys give the same seed,
    and a run never carries a generator from one epoch or step to the
    next."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> 1)


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ms_since(t0: float, device: torch.device) -> float:
    """Milliseconds from ``t0`` (``time.perf_counter()``) to the end of the
    work queued on ``device``."""
    sync(device)
    return (time.perf_counter() - t0) * 1e3
