"""SimMIM, masked image modelling with a linear pixel head (reference
simmim.py:6-87), port of ``vit_pytorch_tpu/ssl/simmim.py``.

The encoder is the port's :class:`~..models.vit.ViT`, read through its
encoder protocol (as ``ssl/mae.py`` reads it).  The masked tokens become the
mask token plus their position embedding (rows 1..n for a cls-pooled
encoder, 0..n-1 for a mean-pooled one, the JAX package's reading of the
reference's intent), and the whole (b, n, dim) sequence runs the encoder's
transformer: on the card in bf16, the whole-layer kernels.  The loss is the
L1 of the predicted pixels of the masked patches over ``num_masked``.

``state_dict()``: ``encoder.*``, ``mask_token``, ``to_pixels``: the layout
``utils/convert.py::convert_simmim`` reads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.vit import init_modules_like_jax
from ..utils.helpers import default_device, pair
from .mae import _take


class SimMIM(nn.Module):
    """reference simmim.py:6 — same keyword constructor (``encoder`` a port
    ``ViT``); ``device``, ``dtype`` and ``generator`` place and seed the
    mask token (unit normal) and ``to_pixels`` (the JAX Dense init), as
    :class:`~.mae.MAE`'s."""

    def __init__(self, *, encoder: nn.Module, masking_ratio: float = 0.5, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0 < masking_ratio < 1:
            raise ValueError("masking ratio must be kept between 0 and 1")
        kw = {"device": default_device(device), "dtype": dtype}
        self.encoder, self.masking_ratio = encoder, masking_ratio
        p1, p2 = pair(encoder.patch_size)
        self.mask_token = nn.Parameter(torch.empty(encoder.dim, **kw))
        self.to_pixels = nn.Linear(encoder.dim, encoder.channels * p1 * p2, **kw)
        with torch.no_grad():
            self.mask_token.normal_(generator=generator)
        init_modules_like_jax(self.to_pixels, generator)

    def forward(self, img, *, masked_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The loss (JAX :39-83).  ``masked_indices`` (b, num_masked): the
        masked patches of each image; without it, the first ``int(
        masking_ratio * n)`` of a descending ``argsort`` of uniforms drawn
        from ``generator`` (on its device)."""
        enc = self.encoder
        patches = enc.patchify(img)
        b, n, _ = patches.shape
        pos_emb = enc.pos_embedding[1 : n + 1] if enc.pool == "cls" else enc.pos_embedding[:n]
        tokens = enc.patch_embedding(patches) + pos_emb
        mask_tokens = self.mask_token[None, None, :] + pos_emb[None]

        num_masked = int(self.masking_ratio * n)
        if masked_indices is None:
            device = img.device if generator is None else generator.device
            scores = torch.rand((b, n), generator=generator, device=device)
            masked_indices = scores.argsort(dim=-1, descending=True)[:, :num_masked]
        masked_indices = masked_indices.to(device=img.device, dtype=torch.long)
        masked = torch.zeros((b, n), dtype=torch.bool, device=img.device).scatter(1, masked_indices, True)
        tokens = torch.where(masked[..., None], mask_tokens.to(tokens.dtype), tokens)

        encoded = enc.transformer(tokens)
        pred = self.to_pixels(_take(encoded, masked_indices))
        return (pred - _take(patches, masked_indices)).abs().mean() / num_masked
