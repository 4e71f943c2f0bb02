"""The port's augmentations (vit_pytorch_tpu_torch/ssl/augment.py) against
the JAX package's (vit_pytorch_tpu/ssl/augment.py) on the same seeded numpy
images, and against tests/goldens/augment_goldens.npz (torchvision's
numerics, tools/gen_augment_goldens.py), on the CPU in fp32.

Tolerances: every deterministic function within 1e-5 absolute of its JAX
counterpart, the box resample of ``random_resized_crop`` within 1e-5 of
``jax.image.scale_and_translate``; against the goldens the tolerances of
tests/test_augment_golden.py (1e-6, 1e-5 for hue and blur, 2e-5 for the
resized crops).  The random draws are held by their properties: a seed
repeats, another seed differs, the boxes stay within JAX's ranges."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ssl import augment as J
from vit_pytorch_tpu_torch.ssl import augment as A

ATOL = 1e-5
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "augment_goldens.npz")


def _img(shape=(2, 3, 32, 40), seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDENS)


@pytest.mark.parametrize("name,arg", [
    ("adjust_brightness", 0.5), ("adjust_brightness", 1.3), ("adjust_contrast", 0.5), ("adjust_contrast", 1.4),
    ("adjust_saturation", 0.3), ("adjust_saturation", 1.6), ("adjust_hue", -0.2), ("adjust_hue", 0.1),
    ("adjust_hue", 0.25), ("adjust_hue", 0.5), ("solarize", 0.3), ("solarize", 0.7),
])
def test_color_ops_match_jax(name, arg):
    x = _img()
    _close(getattr(A, name)(torch.from_numpy(x), arg), getattr(J, name)(jnp.asarray(x), arg))


def test_grayscale_and_normalize_match_jax():
    x = _img()
    _close(A.to_grayscale(torch.from_numpy(x)), J.to_grayscale(jnp.asarray(x)))
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    _close(A.normalize(torch.from_numpy(x), mean, std), J.normalize(jnp.asarray(x), mean, std))


def test_hsv_round_trip_matches_jax():
    """``_rgb_to_hsv`` and ``_hsv_to_rgb`` apart, on images with gray pixels
    (max == min) and each channel the maximum somewhere."""
    x = _img()
    x[:, :, :4] = x[:, :1, :4]  # gray rows: zero saturation, the eqc branch
    got, want = A._rgb_to_hsv(torch.from_numpy(x)), J._rgb_to_hsv(jnp.asarray(x))
    for g, w in zip(got, want):
        _close(g, w)
    h, s, v = (np.array(t) for t in want)
    _close(A._hsv_to_rgb(*map(torch.from_numpy, (h, s, v))), J._hsv_to_rgb(jnp.asarray(h), jnp.asarray(s),
                                                                           jnp.asarray(v)))


@pytest.mark.parametrize("ks,sigma", [(3, 1.0), (3, 1.7), (5, 1.2), (7, 2.0)])
def test_blur_at_a_given_sigma_matches_jax(ks, sigma):
    x = _img()
    got = A.gaussian_blur(torch.from_numpy(x), kernel_size=ks, sigma_range=(sigma, sigma))
    _close(got, J.gaussian_blur(jax.random.PRNGKey(0), jnp.asarray(x), kernel_size=ks, sigma_range=(sigma, sigma)))


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 2, 1, 0), (2, 0, 3, 1)])
def test_jitter_ops_in_a_fixed_order_match_jax(order):
    """``color_jitter``'s four ops chained in a fixed order, with factors
    inside its ranges."""
    x = _img()
    factors = (1.2, 0.6, 1.3, -0.15)
    names = ("adjust_brightness", "adjust_contrast", "adjust_saturation", "adjust_hue")
    got, want = torch.from_numpy(x), jnp.asarray(x)
    for k in order:
        got, want = getattr(A, names[k])(got, factors[k]), getattr(J, names[k])(want, factors[k])
    _close(got, want)


@pytest.mark.parametrize("box", [(4, 6, 20, 24, (32, 32)), (0, 0, 32, 40, (16, 16)), (8, 2, 10, 10, (24, 24)),
                                 (5, 9, 1, 1, (8, 8)), (0, 13, 32, 27, (32, 40))])
def test_resized_crop_matches_jax(box):
    i, j, h, w, out = box
    x = _img()
    _close(A.resized_crop(torch.from_numpy(x), i, j, h, w, out), J.resized_crop(jnp.asarray(x), i, j, h, w, out))


@pytest.mark.parametrize("box,out", [
    ((8, 4, 24, 28), (16, 16)),   # downsampling: the kernel widened by 1/scale
    ((2, 3, 10, 12), (32, 32)),   # upsampling
    ((0, 0, 32, 40), (32, 40)),   # the whole image, scale 1
    ((0, 0, 7, 9), (24, 24)),     # at the top-left edge
    ((25, 31, 7, 9), (20, 20)),   # at the bottom-right edge
    ((13, 17, 1, 1), (16, 16)),   # a 1-pixel box
    ((0, 30, 32, 10), (16, 48)),  # down in H, up in W
])
def test_box_resample_matches_scale_and_translate(box, out):
    """The box resample of ``random_resized_crop`` against JAX's
    ``scale_and_translate`` with the JAX function's float32 scale and
    translation (its :75-87)."""
    y0, x0, ch, cw = box
    x = _img()
    scale = jnp.stack([out[0] / jnp.float32(ch), out[1] / jnp.float32(cw)])
    translate = jnp.stack([-jnp.float32(y0) * scale[0], -jnp.float32(x0) * scale[1]])
    want = jax.image.scale_and_translate(jnp.asarray(x), (2, 3, *out), (2, 3), scale, translate, method="linear",
                                         antialias=True)
    _close(A.box_resample(torch.from_numpy(x), y0, x0, ch, cw, out), want)


def test_goldens(golden):
    """Each function against torchvision's numerics, at
    tests/test_augment_golden.py's tolerances."""
    x = torch.from_numpy(golden["input"])
    for f in (0.5, 1.3):
        _close(A.adjust_brightness(x, f), golden[f"brightness_{f}"], 1e-6)
    for f in (0.5, 1.4):
        _close(A.adjust_contrast(x, f), golden[f"contrast_{f}"], 1e-6)
    for f in (0.3, 1.6):
        _close(A.adjust_saturation(x, f), golden[f"saturation_{f}"], 1e-6)
    for f in (-0.2, 0.1, 0.25):
        _close(A.adjust_hue(x, f), golden[f"hue_{f}"], 1e-5)
    _close(A.to_grayscale(x), golden["grayscale"], 1e-6)
    for t in (0.3, 0.7):
        _close(A.solarize(x, t), golden[f"solarize_{t}"], 1e-6)
    for key, ks, sigma in (("blur_k3_s1.0", 3, 1.0), ("blur_k3_s1.7", 3, 1.7), ("blur_k5_s1.2", 5, 1.2)):
        _close(A.gaussian_blur(x, kernel_size=ks, sigma_range=(sigma, sigma)), golden[key], 1e-5)
    _close(A.normalize(x, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)), golden["normalize"], 1e-6)
    for i, j, h, w, o in ((4, 6, 20, 24, 32), (0, 0, 32, 32, 16), (8, 2, 10, 10, 24)):
        _close(A.resized_crop(x, i, j, h, w, (o, o)), golden[f"resized_crop_{i}_{j}_{h}_{w}_{o}"], 2e-5)
    chain = A.adjust_contrast(A.adjust_saturation(A.adjust_brightness(x, 1.2), 1.3), 0.6)
    _close(chain, golden["composite_b1.2_s1.3_c0.6"], 1e-6)


RANDOM = {
    "random_resized_crop": lambda x, g: A.random_resized_crop(x, (24, 24), scale=(0.05, 0.4), generator=g),
    "color_jitter": lambda x, g: A.color_jitter(x, generator=g),
    "random_hflip": lambda x, g: A.random_hflip(x, generator=g),
    "gaussian_blur": lambda x, g: A.gaussian_blur(x, generator=g),
    "byol_augment": lambda x, g: A.byol_augment(x, generator=g),
}


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_draws_repeat_with_a_seed_and_differ_across_seeds(name):
    """The same generator seed gives the same output; among eight other
    seeds some output differs (a gate or a flip may repeat a seed's)."""
    x, fn = torch.from_numpy(_img()), RANDOM[name]
    a, b = fn(x, torch.Generator().manual_seed(0)), fn(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert any(not torch.equal(a, fn(x, torch.Generator().manual_seed(s))) for s in range(1, 9))


@pytest.mark.parametrize("scale", [(0.05, 0.4), (0.5, 1.0), (0.08, 1.0)])
def test_crop_boxes_stay_within_jax_ranges(scale):
    """JAX's box (:56-66): sides rounded and clipped to [1, side], the box
    inside the image, the area share within ``scale`` up to the rounding
    and the clip, the aspect within the ratio range up to the rounding."""
    h, w = 32, 40
    g = torch.Generator().manual_seed(0)
    for _ in range(200):
        y0, x0, ch, cw = A.crop_box(h, w, scale, generator=g)
        assert all(isinstance(v, int) for v in (y0, x0, ch, cw))
        assert 1 <= ch <= h and 1 <= cw <= w and 0 <= y0 <= h - ch and 0 <= x0 <= w - cw
        assert (ch * cw) / (h * w) <= scale[1] * 1.2 + 0.05
        assert min(cw / ch, ch / cw) >= 0.5 or ch in (1, h) or cw in (1, w)


def test_the_gates_apply_the_whole_batch_or_nothing():
    """``random_apply`` and the flip act on every image or on none."""
    x = torch.from_numpy(_img())
    for seed in range(10):
        out = A.random_hflip(x, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(out, x) or torch.equal(out, x.flip(-1))
        out = A.random_apply(lambda im, generator: 1 - im, x, 0.5, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(out, x) or torch.equal(out, 1 - x)
    always = A.random_apply(lambda im, generator: 1 - im, x, 1.0)
    never = A.random_apply(lambda im, generator: 1 - im, x, 0.0)
    assert torch.equal(always, 1 - x) and torch.equal(never, x)


def test_color_jitter_is_one_of_the_orders():
    """``color_jitter`` equals its four ops, at the drawn factors, in one of
    the 24 orders (the permutation drawn each call)."""
    import itertools

    x = torch.from_numpy(_img())
    g = torch.Generator().manual_seed(4)
    got = A.color_jitter(x, generator=torch.Generator().manual_seed(4))
    fb, fc, fs = (lo + (hi - lo) * u for (lo, hi), u in zip(((0.2, 1.8),) * 3, A._uniforms(g, 3)))
    fh = -0.2 + 0.4 * A._uniforms(g, 1)[0]
    ops = (lambda i: A.adjust_brightness(i, fb), lambda i: A.adjust_contrast(i, fc),
           lambda i: A.adjust_saturation(i, fs), lambda i: A.adjust_hue(i, fh))
    matches = []
    for order in itertools.permutations(range(4)):
        y = x
        for k in order:
            y = ops[k](y)
        matches.append(torch.equal(y, got))
    assert any(matches)


def test_byol_augment_and_a_cuda_generator():
    """The pipeline keeps the shape and normalises; a generator on the card
    (a stand-in with its ``device``: this box has none) is refused."""
    x = torch.from_numpy(_img())
    out = A.byol_augment(x, generator=torch.Generator().manual_seed(0))
    assert out.shape == x.shape and out.dtype == torch.float32 and out.min() < 0
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        A.random_hflip(x, generator=types.SimpleNamespace(device=torch.device("cuda", 0)))
