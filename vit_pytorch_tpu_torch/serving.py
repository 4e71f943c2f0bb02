"""Serving layer: bucket-batched inference, port of
``vit_pytorch_tpu/serving.py::Predictor`` (:60-240).

``Predictor`` casts the model's floating parameters and persistent buffers
(BatchNorm statistics: the JAX ``batch_stats``) to the serving dtype once,
pads every request up to the smallest batch-size bucket that fits and
chunks requests larger than the biggest bucket.  Fixed buckets bound the set
of shapes the kernels see; ``warmup()`` runs each bucket once, which builds
the CUDA kernels on first use.  CUDA graphs per bucket, ``export_model`` and
``load_model`` are later work (ROADMAP: modules to port, item 11).

Example::

    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=768,
                depth=12, heads=12, mlp_dim=3072)
    p = Predictor(model, example_shape=(3, 224, 224), device="cuda").warmup()
    logits = p(images)          # images: (k, 3, 224, 224), any k
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
from torch import nn
from torch.utils._pytree import tree_map


class Predictor:
    """Bucket-batched inference wrapper for a model of the port.

    Args:
        model: an ``nn.Module``; it is copied, so the caller's module keeps
            its device and dtype.
        example_shape: per-example input shape, e.g. ``(3, 224, 224)``.
        batch_sizes: bucket sizes.  Requests are padded up to the smallest
            bucket that fits and chunked by the largest when bigger.
        param_dtype: serving dtype of the floating parameters, of the
            floating persistent buffers and of the input batch (bf16 by
            default, the dtype the kernels take).  The JAX ``Predictor``
            casts every floating leaf of the variables, ``batch_stats``
            included (serving.py:40-46); a non-persistent buffer is outside
            them (SimpleViT's sincos table) and keeps its dtype.
        device: where the model runs.
    """

    def __init__(
        self,
        model: nn.Module,
        *,
        example_shape: Sequence[int],
        batch_sizes: Sequence[int] = (1, 8, 32, 128),
        param_dtype: torch.dtype = torch.bfloat16,
        device,
    ):
        if not batch_sizes:
            raise ValueError("need at least one batch-size bucket")
        self.batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
        self.example_shape = tuple(example_shape)
        self.param_dtype = param_dtype
        self.device = torch.device(device)
        model = copy.deepcopy(model).to(device=self.device)
        for p in model.parameters():
            p.requires_grad_(False)
            if p.is_floating_point():
                p.data = p.data.to(param_dtype)
        persistent = model.state_dict(keep_vars=True)
        for name, buf in model.named_buffers():
            if name in persistent and buf.is_floating_point():
                buf.data = buf.data.to(param_dtype)
        self.model = model.eval()

    def warmup(self):
        """Run every bucket once (blocking)."""
        for b in self.batch_sizes:
            self._run_padded(torch.zeros((b, *self.example_shape), dtype=self.param_dtype, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _bucket_for(self, k: int) -> int:
        for b in self.batch_sizes:
            if b >= k:
                return b
        return self.batch_sizes[-1]

    def _run_padded(self, x):
        """x.shape[0] <= largest bucket: pad up, run, slice back each tensor
        of the output (a tensor, or a tuple, list or dict of them; ``None``
        passes through), as the JAX ``jax.tree.map`` does."""
        k = x.shape[0]
        b = self._bucket_for(k)
        if k != b:
            pad = x.new_zeros((b - k, *self.example_shape))
            x = torch.cat([x, pad], dim=0)
        with torch.inference_mode():
            out = self.model(x)
        return tree_map(lambda o: None if o is None else o[:k], out)

    def __call__(self, x):
        """Run inference on ``x`` of shape ``(k, *example_shape)``, any k;
        the chunks of a request above the largest bucket are joined tensor by
        tensor of the output."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.param_dtype)
        if tuple(x.shape[1:]) != self.example_shape:
            raise ValueError(f"expected (k, {self.example_shape}), got {tuple(x.shape)}")
        big = self.batch_sizes[-1]
        if x.shape[0] <= big:
            return self._run_padded(x)
        outs = [self._run_padded(x[i : i + big]) for i in range(0, x.shape[0], big)]
        return tree_map(lambda *os: None if os[0] is None else torch.cat(os, dim=0), *outs)
