"""Extractor: a named layer's output beside the model's (reference
extractor.py:18-90), port of ``vit_pytorch_tpu/wrappers/extractor.py``.

A forward hook on the submodule (default ``transformer``) keeps its output,
the tensor itself, during the wrapper's call; a hook changes no route, so
the model runs its kernels as it would unwrapped.

Usage (the reference's)::

    ex = Extractor(ViT(...))
    logits, embeddings = ex(img)
"""

from __future__ import annotations

from typing import Optional, Union

from torch import nn


class Extractor(nn.Module):
    """reference extractor.py:18 — ``layer`` is the submodule or its name
    (``layer_name``, default ``transformer``); ``return_embeddings_only``
    returns the embeddings alone.  A layer the model does not have, or one
    its call never reaches, raises ``ValueError``."""

    def __init__(self, vit: nn.Module, layer_name: str = "transformer", layer: Optional[Union[nn.Module, str]] = None,
                 return_embeddings_only: bool = False):
        super().__init__()
        self.vit = vit
        self.layer = layer_name if layer is None else layer
        self.return_embeddings_only = return_embeddings_only
        self.ejected = False

    def eject(self) -> nn.Module:
        self.ejected = True
        return self.vit

    def _module(self) -> nn.Module:
        if isinstance(self.layer, nn.Module):
            if any(m is self.layer for m in self.vit.modules()):
                return self.layer
        else:
            for name, m in self.vit.named_modules():
                if name == self.layer or name.rsplit(".", 1)[-1] == self.layer:
                    return m
        raise ValueError(f"layer {self.layer!r} whose output to take as embedding not found in the model")

    def forward(self, img, **kwargs):
        assert not self.ejected, "extractor has been ejected, cannot be used anymore"
        captured = []
        handle = self._module().register_forward_hook(lambda _m, _args, out: captured.append(out))
        try:
            preds = self.vit(img, **kwargs)
        finally:
            handle.remove()
        if not captured:
            raise ValueError(f"layer {self.layer!r} whose output to take as embedding was not called")
        embeddings = captured[0][0] if isinstance(captured[0], tuple) else captured[0]
        return embeddings if self.return_embeddings_only else (preds, embeddings)
