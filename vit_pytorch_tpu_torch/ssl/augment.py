"""Batched image augmentations of the SSL trainers, port of
``vit_pytorch_tpu/ssl/augment.py``.

Images are (b, c, h, w) float tensors in [0, 1] unless noted.  As in the JAX
package (and torchvision on batched tensors), the random parameters are drawn
once per call for the whole batch, and ``random_apply`` gates a whole
transform.

The random parameters (a crop box, the jitter factors and their order, the
gates, a blur's sigma) are drawn on the host from ``generator``, a CPU
``torch.Generator`` (``None``: torch's default CPU generator), as
torchvision draws them; the image work runs on the images' device.  A draw
is a handful of scalars a call, so no draw reads the card and no call waits
for it; a CUDA generator is refused.  The resampling weights are built on
the images' device from float32 scalars computed on the host; the few
small constants (blur taps, channel statistics) are built on the host and
copied with ``non_blocking=True``, which does not wait for the stream.

``random_resized_crop`` computes what JAX's ``jax.image.scale_and_translate(
..., method="linear", antialias=True)`` computes on the whole image: the
triangle kernel of ``compute_weight_mat`` (jax/_src/image/scale.py), widened
by 1/scale when it downsamples, its weights renormalised over the samples
that fall inside the image, applied as one product over H and one over W.
It is not torchvision's crop-then-resize: rows within a kernel radius of the
box's edge may read pixels outside the box.  ``resized_crop`` is
``jax.image.resize`` (the same weights, no translation) of the cropped box.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# torchvision's rgb_to_grayscale weights (0.2989, not 0.299)
_GRAY = (0.2989, 0.587, 0.114)
_F32_EPS = torch.finfo(torch.float32).eps


def _uniforms(generator: Optional[torch.Generator], n: int) -> list[float]:
    """``n`` uniforms in [0, 1) drawn on the host."""
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("the augmentations draw their parameters on the host: pass a CPU torch.Generator")
    return torch.rand(n, generator=generator, dtype=torch.float64).tolist()


def _uniform(generator, low: float, high: float) -> float:
    return low + (high - low) * _uniforms(generator, 1)[0]


def _to(t: torch.Tensor, img: torch.Tensor, dtype) -> torch.Tensor:
    """A host constant on ``img``'s device without waiting for its stream."""
    return t.to(device=img.device, dtype=dtype, non_blocking=True)


def _weight_mat(in_size: int, out_size: int, scale: np.float32, translation: np.float32, device) -> torch.Tensor:
    """JAX ``compute_weight_mat`` for the triangle kernel with antialias:
    the (in_size, out_size) weights of one axis, in float32 on ``device``;
    the scalars are float32 on the host, each rounded where JAX rounds it."""
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    shift = translation * inv_scale
    arange = lambda n: torch.arange(n, dtype=torch.float32, device=device)
    sample = (arange(out_size) + 0.5) * float(inv_scale) - float(shift) - 0.5
    x = (sample[None, :] - arange(in_size)[:, None]).abs() / float(kernel_scale)
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS, weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _scale_and_translate(img, out_size, scale: np.ndarray, translation: np.ndarray):
    """``jax.image.scale_and_translate(img, (b, c, *out_size), (2, 3), scale,
    translation, method="linear", antialias=True)``; ``scale`` and
    ``translation`` are float32 (y, x) pairs."""
    h, w = img.shape[-2:]
    wy = _weight_mat(h, out_size[0], scale[0], translation[0], img.device).to(img.dtype)
    wx = _weight_mat(w, out_size[1], scale[1], translation[1], img.device).to(img.dtype)
    return torch.matmul(torch.matmul(wy.t(), img), wx)


def resized_crop(img, i: int, j: int, h: int, w: int, out_size: Tuple[int, int]):
    """torchvision ``F.resized_crop`` with a static integer box: crop
    ``img[..., i:i+h, j:j+w]``, then the antialiased bilinear resize of
    ``jax.image.resize``."""
    crop = img[..., i : i + h, j : j + w]
    scale = np.array(out_size, dtype=np.float32) / np.array((h, w), dtype=np.float32)
    return _scale_and_translate(crop, out_size, scale, np.zeros(2, np.float32))


def box_resample(img, y0: float, x0: float, ch: float, cw: float, out_size: Tuple[int, int]):
    """The box (y0, x0, ch, cw) of the whole image resampled to ``out_size``:
    output pixel o samples the image at y0 + (o + 0.5) ch / oh - 0.5 (JAX
    ``random_resized_crop`` :75-87, in float32)."""
    box = np.array((y0, x0, ch, cw), dtype=np.float32)
    scale = np.array(out_size, dtype=np.float32) / box[2:]
    return _scale_and_translate(img, out_size, scale, -box[:2] * scale)


def crop_box(h: int, w: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), *, generator=None):
    """The integer crop box (y0, x0, ch, cw) of JAX ``random_resized_crop``
    (:56-66): an area share in ``scale`` and a log-uniform aspect in
    ``ratio``, the sides rounded and clipped to [1, side], the corner uniform
    over the positions that keep the box inside (no retries)."""
    u_area, u_ratio, u_x, u_y = _uniforms(generator, 4)
    target_area = (scale[0] + (scale[1] - scale[0]) * u_area) * h * w
    log_lo, log_hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = math.exp(log_lo + (log_hi - log_lo) * u_ratio)
    cw = min(max(round(math.sqrt(target_area * aspect)), 1), w)
    ch = min(max(round(math.sqrt(target_area / aspect)), 1), h)
    x0 = math.floor(u_x * (w - cw + 1))
    y0 = math.floor(u_y * (h - ch + 1))
    return y0, x0, ch, cw


def random_resized_crop(img, out_size: Tuple[int, int], scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), *,
                        generator: Optional[torch.Generator] = None):
    """torchvision RandomResizedCrop on a batched (b, c, h, w) tensor, as the
    JAX package computes it: :func:`crop_box`, then :func:`box_resample`."""
    y0, x0, ch, cw = crop_box(*img.shape[-2:], scale, ratio, generator=generator)
    return box_resample(img, y0, x0, ch, cw, out_size)


def _gray_weights(img):
    """The grayscale weights in the dtype JAX's numpy float32 constant
    promotes ``img`` to."""
    dtype = torch.promote_types(img.dtype, torch.float32)
    return img.to(dtype), _to(torch.tensor(_GRAY), img, dtype)


def _blend(img1, img2, ratio):
    """torchvision ``_blend``: lerp, then clamp to [0, 1]."""
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def adjust_brightness(img, factor):
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img, factor):
    """Blend toward the per-image grayscale mean, shared by the channels
    (torchvision ``adjust_contrast``)."""
    x, gray = _gray_weights(img)
    mean = torch.einsum("bchw,c->b", x, gray) / (img.shape[-2] * img.shape[-1])
    return _blend(img, mean.reshape(-1, 1, 1, 1), factor)


def to_grayscale(img):
    x, gray = _gray_weights(img)
    return torch.einsum("bchw,c->bhw", x, gray)[:, None].expand(x.shape)


def adjust_saturation(img, factor):
    return _blend(img, to_grayscale(img), factor)


def _rgb_to_hsv(img):
    """torchvision ``_rgb2hsv``, branchless."""
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    maxc = img.amax(dim=1)
    minc = img.amin(dim=1)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    cr_div = torch.where(eqc, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = torch.remainder(hr + hg + hb, 6.0) / 6.0
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    """torchvision ``_hsv2rgb``, branchless."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.to(torch.int32) % 6
    p = torch.clamp(v * (1.0 - s), 0.0, 1.0)
    q = torch.clamp(v * (1.0 - s * f), 0.0, 1.0)
    t = torch.clamp(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    mask = i[:, None] == torch.arange(6, device=h.device).reshape(-1, 1, 1)  # (b, 6, h, w)
    a1 = torch.stack([v, q, p, p, t, v], dim=1)
    a2 = torch.stack([t, v, v, q, p, p], dim=1)
    a3 = torch.stack([p, p, t, v, v, q], dim=1)
    a4 = torch.stack([a1, a2, a3], dim=1)  # (b, 3, 6, h, w)
    return torch.einsum("bkhw,bckhw->bchw", mask.to(v.dtype), a4)


def adjust_hue(img, delta):
    """torchvision ``adjust_hue``: RGB -> HSV, the hue shifted by ``delta``
    turns (in [-0.5, 0.5]), HSV -> RGB."""
    h, s, v = _rgb_to_hsv(img)
    return _hsv_to_rgb(torch.remainder(h + delta, 1.0), s, v)


def solarize(img, threshold):
    """torchvision ``solarize`` for float tensors (bound 1.0)."""
    return torch.where(img >= threshold, 1.0 - img, img)


def color_jitter(img, brightness=0.8, contrast=0.8, saturation=0.8, hue=0.2, *,
                 generator: Optional[torch.Generator] = None):
    """torchvision ColorJitter: uniform factors, and the four ops applied in
    a random permutation drawn each call."""
    fb = _uniform(generator, max(0, 1 - brightness), 1 + brightness)
    fc = _uniform(generator, max(0, 1 - contrast), 1 + contrast)
    fs = _uniform(generator, max(0, 1 - saturation), 1 + saturation)
    fh = _uniform(generator, -hue, hue)
    ops = (
        lambda im: adjust_brightness(im, fb),
        lambda im: adjust_contrast(im, fc),
        lambda im: adjust_saturation(im, fs),
        lambda im: adjust_hue(im, fh),
    )
    for k in torch.randperm(4, generator=generator).tolist():
        img = ops[k](img)
    return img


def random_hflip(img, p=0.5, *, generator: Optional[torch.Generator] = None):
    return img.flip(-1) if _uniforms(generator, 1)[0] < p else img


def _blur(img, kernel_size: int, sigma: float):
    """Separable Gaussian blur at ``sigma``, reflect padding (torchvision
    GaussianBlur)."""
    r = kernel_size // 2
    coords = torch.arange(-r, r + 1, dtype=torch.float32)
    kern = torch.exp(-0.5 * (coords / torch.tensor(sigma, dtype=torch.float32)) ** 2)
    kern = _to(kern / kern.sum(), img, img.dtype)
    b, c, h, w = img.shape
    x = F.pad(img.reshape(b * c, 1, h, w), (r, r, r, r), mode="reflect")
    x = F.conv2d(x, kern.reshape(1, 1, kernel_size, 1))
    x = F.conv2d(x, kern.reshape(1, 1, 1, kernel_size))
    return x.reshape(b, c, h, w)


def gaussian_blur(img, kernel_size=3, sigma_range=(1.0, 2.0), *, generator: Optional[torch.Generator] = None):
    return _blur(img, kernel_size, _uniform(generator, *sigma_range))


def normalize(img, mean, std):
    """(img - mean) / std per channel, the constants float32 as JAX's
    ``jnp.asarray`` makes them (a bf16 image comes out float32)."""
    mean = _to(torch.as_tensor(mean, dtype=torch.float32), img, torch.float32).reshape(1, -1, 1, 1)
    std = _to(torch.as_tensor(std, dtype=torch.float32), img, torch.float32).reshape(1, -1, 1, 1)
    return (img - mean) / std


def random_apply(fn: Callable, img, p, *, generator: Optional[torch.Generator] = None):
    """``fn(img, generator=generator)`` on the whole batch with probability
    ``p`` (the reference dino.py:57-66 gate)."""
    return fn(img, generator=generator) if _uniforms(generator, 1)[0] < p else img


def byol_augment(img, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), *,
                 generator: Optional[torch.Generator] = None):
    """The DEFAULT_AUG pipeline of the reference dino.py:207-221: jitter
    (p 0.3), grayscale (p 0.2), a horizontal flip, blur (p 0.2), normalise."""
    img = random_apply(color_jitter, img, 0.3, generator=generator)
    img = random_apply(lambda im, generator: to_grayscale(im), img, 0.2, generator=generator)
    img = random_hflip(img, generator=generator)
    img = random_apply(gaussian_blur, img, 0.2, generator=generator)
    return normalize(img, mean, std)
