"""Recorder: the post-softmax attention map of every layer (reference
recorder.py:10-59), port of ``vit_pytorch_tpu/wrappers/recorder.py``.

The reference hooks every ``Attention``'s softmax; the JAX package makes
its ``attn_maps`` collection mutable, which sends each ``Attention`` to the
materialized composite and sows its map.  Here the Recorder hands each
``nn/blocks.py::Attention`` of the model one list (``Attention.recorded``) for
the length of its call: the attention then takes the composite, whose
``return_attn`` gives the map, and appends it with its ``sow_index``, and the
kernel predicates (``fused_block_eligible``,
``Transformer.whole_layer_eligible``) refuse the attention-block and
whole-layer kernels, as JAX's do (blocks.py:368, :631).
The maps are stacked in the order of their ``sow_index`` where the
``Attention`` has one (the ``Transformer`` numbers its layers), as the JAX
Recorder stacks ``attn_{index:04d}``, else in the order of the calls, which
is depth order.
After the call, and after :meth:`Recorder.eject`, the model takes the
kernels again.

Usage (the reference's)::

    v = Recorder(ViT(...))
    preds, attns = v(img)        # attns: (b, depth, heads, n, n)
    vit = v.eject()
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.blocks import Attention


class Recorder(nn.Module):
    """reference recorder.py:10 — wraps a model; returns (preds, attns),
    ``attns`` None when the model has no ``Attention``."""

    def __init__(self, vit: nn.Module):
        super().__init__()
        self.vit = vit
        self.ejected = False

    def eject(self) -> nn.Module:
        """reference recorder.py:32-37: the unwrapped model."""
        self.ejected = True
        return self.vit

    def forward(self, img, **kwargs):
        assert not self.ejected, "recorder has been ejected, cannot be used anymore"
        attns = [m for m in self.vit.modules() if isinstance(m, Attention)]
        maps = []  # one list for all: (sow_index, map) in the order of the calls
        for m in attns:
            m.recorded = maps
        try:
            preds = self.vit(img, **kwargs)
        finally:
            for m in attns:
                m.recorded = None
        order = sorted(range(len(maps)), key=lambda i: i if maps[i][0] is None else maps[i][0])
        return preds, (torch.stack([maps[i][1] for i in order], dim=1) if maps else None)
