"""MAE, the masked autoencoder pretraining wrapper (reference mae.py:8-104),
port of ``vit_pytorch_tpu/ssl/mae.py``.

The encoder is the port's :class:`~..models.vit.ViT`, read through its encoder
protocol (``patchify``, ``patch_embedding``, ``pos_embedding``,
``transformer``, ``pool``, ``dim``, ``patch_size``, ``image_size``,
``channels``).  The permutation that picks the masked patches is an
argument (``rand_indices``) or is drawn from an explicit
``torch.Generator``.  The unmasked tokens are gathered into a contiguous
(b, n_unmasked, dim) tensor, so on the card in bf16 the encoder's
transformer runs the whole-layer kernels, as the decoder's does on the full
sequence; the indices are a permutation, so the gathers' and scatters'
backward adds one term to each element and is deterministic.

Parameters: ``encoder.*`` (the ViT's), ``enc_to_dec`` (only when the
encoder and decoder widths differ), ``mask_token``, ``decoder.*`` (a
:class:`~..nn.blocks.Transformer`), ``decoder_pos_emb.weight``,
``to_pixels``: the layout the JAX package's ``utils/convert.py::convert_mae``
reads, and ``utils/from_jax.py::mae_state_dict_from_jax`` writes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..models.vit import init_modules_like_jax
from ..nn.blocks import Transformer
from ..utils.helpers import default_device, pair


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[batch_range, idx]``: (b, n, d) rows at (b, k) indices -> (b, k, d)."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


class MAE(nn.Module):
    """reference mae.py:8 — same keyword constructor (``encoder`` a port
    ``ViT``).  ``device`` (the CUDA card unless it names another) and
    ``dtype`` place the wrapper's own parameters; ``generator`` seeds their
    initialisation (the JAX package's: truncated lecun-normal Linear weights,
    zero biases, unit LayerNorms, a unit normal mask token, a normal
    position table of std ``decoder_dim ** -0.5``)."""

    def __init__(
        self,
        *,
        encoder: nn.Module,
        decoder_dim: int,
        masking_ratio: float = 0.75,
        decoder_depth: int = 1,
        decoder_heads: int = 8,
        decoder_dim_head: int = 64,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not 0 < masking_ratio < 1:
            raise ValueError("masking ratio must be kept between 0 and 1")
        kw = {"device": default_device(device), "dtype": dtype}
        self.encoder = encoder
        self.masking_ratio, self.decoder_dim = masking_ratio, decoder_dim
        self.enc_to_dec = nn.Linear(encoder.dim, decoder_dim, **kw) if encoder.dim != decoder_dim else None
        self.mask_token = nn.Parameter(torch.empty(decoder_dim, **kw))
        self.decoder = Transformer(decoder_dim, decoder_depth, decoder_heads, decoder_dim_head, decoder_dim * 4, **kw)
        p1, p2 = pair(encoder.patch_size)
        num_patches = math.prod(s // p for s, p in zip(pair(encoder.image_size), (p1, p2)))
        self.decoder_pos_emb = nn.Embedding(num_patches, decoder_dim, **kw)
        self.to_pixels = nn.Linear(decoder_dim, encoder.channels * p1 * p2, **kw)  # pixel values per patch
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The wrapper's own parameters; the encoder keeps its weights."""
        for module in (self.enc_to_dec, self.decoder, self.to_pixels):
            if module is not None:
                init_modules_like_jax(module, generator)
        self.mask_token.normal_(generator=generator)
        self.decoder_pos_emb.weight.normal_(std=self.decoder_dim**-0.5, generator=generator)

    def forward(self, img, *, rand_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The mean squared error of the predicted pixels of the masked
        patches (JAX :64-126).  ``rand_indices`` (b, num_patches): a
        permutation of the patches a row, the first ``int(masking_ratio *
        num_patches)`` masked; without it, ``argsort`` of uniforms drawn from
        ``generator`` (on its device)."""
        enc = self.encoder
        patches = enc.patchify(img)
        b, n, _ = patches.shape
        tokens = enc.patch_embedding(patches)
        # cls models skip position 0 (mae.py:52-55)
        tokens = tokens + (enc.pos_embedding[1 : n + 1] if enc.pool == "cls" else enc.pos_embedding[:n])

        num_masked = int(self.masking_ratio * n)
        if rand_indices is None:
            device = img.device if generator is None else generator.device
            rand_indices = torch.rand((b, n), generator=generator, device=device).argsort(dim=-1)
        rand_indices = rand_indices.to(device=img.device, dtype=torch.long)
        masked, unmasked = rand_indices[:, :num_masked], rand_indices[:, num_masked:]

        encoded = enc.transformer(_take(tokens, unmasked))
        decoder_tokens = encoded if self.enc_to_dec is None else self.enc_to_dec(encoded)
        unmasked_tokens = decoder_tokens + self.decoder_pos_emb(unmasked)
        mask_tokens = self.mask_token.expand(b, num_masked, -1) + self.decoder_pos_emb(masked)

        # the full-length sequence (mae.py:91-93)
        index = lambda idx: idx[..., None].expand(-1, -1, self.decoder_dim)
        full = decoder_tokens.new_zeros((b, n, self.decoder_dim))
        full = full.scatter(1, index(unmasked), unmasked_tokens.to(full.dtype))
        full = full.scatter(1, index(masked), mask_tokens.to(full.dtype))

        pred = self.to_pixels(_take(self.decoder(full), masked))
        return (pred - _take(patches, masked)).square().mean()
