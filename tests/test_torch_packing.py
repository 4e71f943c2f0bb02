"""The port's NaViT packing (vit_pytorch_tpu_torch/ops/packing.py) against the
JAX package's ``ops/packing.py`` on the CPU: the same images and the same
numpy seed give identical arrays (exact equality: the host code is the same
numpy, the port only hands its arrays to torch), with and without token
dropout, grouped greedily, pre-grouped or as one group, padded to a group
count and a query count."""

import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import packing as jax_packing
from vit_pytorch_tpu_torch.ops import packing

SIZES = [(64, 64), (32, 64), (64, 32), (32, 32), (64, 64), (16, 48)]


def _images(seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, h, w)).astype(np.float32) for h, w in sizes]


def _assert_same(got, want):
    for field in ("patches", "pos_hw", "image_ids", "num_images"):
        g, w = getattr(got, field), np.array(getattr(want, field))
        assert g.dtype == torch.from_numpy(w).dtype, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    assert got.max_images == want.max_images
    np.testing.assert_array_equal(got.is_image.numpy(), np.asarray(want.is_image))


@pytest.mark.parametrize("dropout", [None, 0.25, "by_size"])
def test_grouping_matches_jax(dropout):
    calc = (lambda h, w: 0.5 if h * w > 2048 else 0.0) if dropout == "by_size" else dropout
    imgs = _images()
    got = packing.group_images_by_max_seq_len(imgs, 16, calc_token_dropout=calc, max_seq_len=20)
    want = jax_packing.group_images_by_max_seq_len(imgs, 16, calc_token_dropout=calc, max_seq_len=20)
    assert [[id(i) for i in g] for g in got] == [[id(i) for i in g] for g in want]


@pytest.mark.parametrize(
    "kw",
    [
        dict(max_seq_len=32),
        dict(max_seq_len=32, train=True, token_dropout_prob=0.25),
        dict(max_seq_len=48, train=True, token_dropout_prob=lambda h, w: 0.5 if h == w else 0.1),
        dict(max_seq_len=32, pad_groups_to=7, max_images=5),
        dict(max_seq_len=64, group_images=False),
        dict(max_seq_len=32, token_dropout_prob=0.25),  # dropout only in training
    ],
    ids=["plain", "dropout", "dropout_fn", "padded", "one_group", "eval_ignores_dropout"],
)
def test_pack_images_matches_jax(kw):
    """Identical arrays from the same numpy seed; the token dropout draws
    ``rng.permutation`` in the same order on both sides."""
    imgs = _images()
    got = packing.pack_images(imgs, 16, rng=np.random.default_rng(3), device="cpu", **kw)
    want = jax_packing.pack_images(imgs, 16, rng=np.random.default_rng(3), **kw)
    _assert_same(got, want)


def test_pre_grouped_and_tensor_images():
    """A list of lists is packed as given; torch images pack as numpy ones."""
    imgs = _images()
    groups = [imgs[:2], imgs[2:3], imgs[3:]]
    got = packing.pack_images([[torch.from_numpy(i) for i in g] for g in groups], 16, max_seq_len=64, device="cpu")
    _assert_same(got, jax_packing.pack_images(groups, 16, max_seq_len=64))
    assert got.patches.shape[0] == 3


def test_dtype_and_device():
    imgs = _images()
    packed = packing.pack_images(imgs, 16, max_seq_len=32, dtype=torch.bfloat16, device="cpu")
    assert packed.patches.dtype == torch.bfloat16 and packed.device == torch.device("cpu")
    want = jax_packing.pack_images(imgs, 16, max_seq_len=32)
    torch.testing.assert_close(packed.patches, torch.from_numpy(np.array(want.patches)).bfloat16(), rtol=0, atol=0)
    moved = packed.to(dtype=torch.float32)
    assert moved.patches.dtype == torch.float32 and moved.max_images == packed.max_images


def test_packing_refuses_what_jax_refuses():
    imgs = _images(sizes=[(64, 64)])
    with pytest.raises(AssertionError):
        packing.pack_images(imgs, 16, max_seq_len=8, device="cpu")  # 16 tokens > 8
    with pytest.raises(AssertionError):
        packing.pack_images(_images(sizes=[(40, 32)]), 16, max_seq_len=32, device="cpu")  # not divisible
