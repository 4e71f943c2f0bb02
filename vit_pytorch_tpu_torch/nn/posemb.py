"""Fixed sincos positional embeddings, port of ``vit_pytorch_tpu/nn/posemb.py``.

Each table is built in float64 numpy exactly as the JAX package builds it,
then cast to ``dtype`` (and placed on ``device``) once, so the two packages'
tables are equal bit for bit:

  - posemb_sincos_2d: reference simple_vit.py:12-21
  - posemb_sincos_1d: reference simple_vit_1d.py:9-20
  - posemb_sincos_3d: reference simple_vit_3d.py:13-31
"""

from __future__ import annotations

import numpy as np
import torch


def _table(pe: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def posemb_sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0, dtype=torch.float32, device=None):
    """2-D sincos positional embedding, (h*w, dim)."""
    assert dim % 4 == 0, "feature dimension must be multiple of 4 for sincos emb"
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    omega = np.arange(dim // 4) / (dim // 4 - 1)
    omega = 1.0 / (temperature**omega)

    y = y.flatten()[:, None] * omega[None, :]
    x = x.flatten()[:, None] * omega[None, :]
    pe = np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1)
    return _table(pe, dtype, device)


def posemb_sincos_1d(n: int, dim: int, temperature: float = 10000.0, dtype=torch.float32, device=None):
    """1-D sincos positional embedding, (n, dim)."""
    assert dim % 2 == 0, "feature dimension must be multiple of 2 for sincos emb"
    pos = np.arange(n)
    omega = np.arange(dim // 2) / (dim // 2 - 1)
    omega = 1.0 / (temperature**omega)
    out = pos[:, None] * omega[None, :]
    pe = np.concatenate([np.sin(out), np.cos(out)], axis=1)
    return _table(pe, dtype, device)


def posemb_sincos_3d(f: int, h: int, w: int, dim: int, temperature: float = 10000.0, dtype=torch.float32,
                     device=None):
    """3-D (frame, height, width) sincos embedding, (f*h*w, dim); dim is
    padded up to a multiple of 6 internally, then truncated."""
    z, y, x = np.meshgrid(np.arange(f), np.arange(h), np.arange(w), indexing="ij")
    fourier_dim = dim // 6
    omega = np.arange(fourier_dim) / max(fourier_dim - 1, 1)
    omega = 1.0 / (temperature**omega)

    z = z.flatten()[:, None] * omega[None, :]
    y = y.flatten()[:, None] * omega[None, :]
    x = x.flatten()[:, None] * omega[None, :]

    pe = np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y), np.sin(z), np.cos(z)], axis=1)
    pe = np.pad(pe, ((0, 0), (0, dim - pe.shape[1])))
    return _table(pe, dtype, device)
