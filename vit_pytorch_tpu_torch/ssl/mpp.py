"""MPP, masked patch prediction (reference mpp.py:79-175), port of
``vit_pytorch_tpu/ssl/mpp.py``.

Predicts the discretised mean colour of the masked patches (2^bits bins a
channel, mpp.py:52-73) from the encoder's tokens.  Of the masked patches,
some are replaced by other patches of the same image and some by the mask
token, with the reference's probabilities (mpp.py:128-154).  The encoder is
the port's :class:`~..models.vit.ViT` (positional ``transformer``, as in the
reference), read through its encoder protocol, its ``dropout`` the
embedding dropout (JAX ``emb_drop``); on the card in bf16 its layers run the
whole-layer kernels at dropout 0 and, in training at dropout > 0, the
attention-block kernels.

The draws come from ``generator`` (on its device) in JAX's order: the mask
(unless ``masked_positions`` is given), then the random-patch gate and
indices (when ``random_patch_prob`` > 0), then the replace gate, which are
drawn even with ``masked_positions``, as JAX draws them.

``state_dict()``: ``transformer.*``, ``mask_token``, ``to_bits``: the layout
``utils/convert.py::convert_mpp`` reads.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..models.vit import init_modules_like_jax
from ..utils.helpers import default_device, exists


def _rand(generator, shape, device):
    return torch.rand(shape, generator=generator, device=device if generator is None else generator.device)


def get_mask_subset_with_prob(batch: int, seq_len: int, prob: float, *, generator=None, device=None):
    """reference mpp.py:18-27: the ceil(prob * seq_len) positions of largest
    uniform noise, (batch, seq_len) bool."""
    max_masked = math.ceil(prob * seq_len)
    sampled = _rand(generator, (batch, seq_len), device).argsort(dim=-1, descending=True)[:, :max_masked]
    return torch.zeros((batch, seq_len), dtype=torch.bool, device=sampled.device).scatter(1, sampled, True)


class MPP(nn.Module):
    """reference mpp.py:79 — same constructor (positional ``transformer``,
    a port ``ViT``); ``device``, ``dtype`` and ``generator`` place and seed
    ``to_bits`` (the JAX Dense init) and the mask token (unit normal)."""

    def __init__(
        self, transformer: nn.Module, patch_size: int, dim: int, output_channel_bits: int = 3, channels: int = 3,
        max_pixel_val: float = 1.0, mask_prob: float = 0.15, replace_prob: float = 0.5,
        random_patch_prob: float = 0.5, mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None, *, device=None, dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        self.transformer = transformer
        self.patch_size, self.dim, self.channels = patch_size, dim, channels
        self.output_channel_bits = output_channel_bits
        self.max_pixel_val, self.mask_prob = max_pixel_val, mask_prob
        self.replace_prob, self.random_patch_prob = replace_prob, random_patch_prob
        self.mean, self.std = mean, std
        self.to_bits = nn.Linear(dim, 2 ** (output_channel_bits * channels), **kw)
        self.mask_token = nn.Parameter(torch.empty(1, 1, channels * patch_size**2, **kw))
        init_modules_like_jax(self.to_bits, generator)
        with torch.no_grad():
            self.mask_token.normal_(generator=generator)

    def _loss(self, logits, target_img, mask):
        """reference MPPLoss (mpp.py:33-73): cross-entropy against each
        patch's binned mean colour, averaged over the masked patches."""
        p, c = self.patch_size, self.channels
        mpv, bits = self.max_pixel_val, self.output_channel_bits
        bin_size = mpv / (2**bits)
        target = target_img
        if exists(self.mean) and exists(self.std):
            mean = torch.tensor(self.mean).to(target.device, non_blocking=True).reshape(-1, 1, 1)
            std = torch.tensor(self.std).to(target.device, non_blocking=True).reshape(-1, 1, 1)
            target = target * std + mean
        target = target.clamp(max=mpv)
        b, _, H, W = target.shape
        avg = target.reshape(b, c, H // p, p, W // p, p).mean(dim=(3, 5))  # (b, c, h, w)
        avg = avg.permute(0, 2, 3, 1).reshape(b, -1, c)
        bins = torch.arange(bin_size, mpv, bin_size, device=target.device, dtype=avg.dtype)
        discretized = torch.searchsorted(bins, avg.contiguous(), right=False)
        label = (discretized * (2**bits) ** torch.arange(c, device=target.device)).sum(dim=-1)
        ce = -logits.log_softmax(dim=-1).gather(-1, label[..., None])[..., 0]
        return (ce * mask).sum() / mask.sum().clamp_min(1)

    def forward(self, img, *, masked_positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The loss (JAX :92-145).  ``masked_positions`` (b, n) bool: the
        masked patches, in place of the drawn mask."""
        enc = self.transformer
        patches = enc.patchify(img)
        b, n, _ = patches.shape
        dev = img.device
        if masked_positions is not None:
            mask = masked_positions.to(device=dev, dtype=torch.bool)
        else:
            mask = get_mask_subset_with_prob(b, n, self.mask_prob, generator=generator, device=dev).to(dev)

        masked_input = patches
        if self.random_patch_prob > 0:
            sampling_prob = self.random_patch_prob / (1 - self.replace_prob)
            random_gate = _rand(generator, (b, n), dev).to(dev) < sampling_prob
            device = dev if generator is None else generator.device
            random_index = torch.randint(0, n, (b, n), generator=generator, device=device).to(dev)
            randomized = torch.gather(masked_input, 1, random_index[..., None].expand(-1, -1, patches.shape[-1]))
            masked_input = torch.where((mask & random_gate)[..., None], randomized, masked_input)
        replace_gate = _rand(generator, (b, n), dev).to(dev) < self.replace_prob
        masked_input = torch.where((mask & replace_gate)[..., None], self.mask_token.to(masked_input.dtype),
                                   masked_input)

        tokens = enc.patch_embedding(masked_input)
        cls = enc.cls_token.to(tokens.dtype).expand(b, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = enc.dropout(tokens + enc.pos_embedding[: tokens.shape[1]].to(tokens.dtype))
        logits = self.to_bits(enc.transformer(tokens))[:, enc.num_cls_tokens :, :]
        return self._loss(logits, img, mask)
