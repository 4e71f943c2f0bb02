"""The port's dropout masks (vit_pytorch_tpu_torch/ops/fused_block.py) on the
CPU: the plain twin of the kernels' Philox4x32-10 against the Random123
known-answer vectors, the keep threshold against the JAX package's, the
mask layout, statistics and determinism (mirroring
tests/test_fused_dropout.py:133-146, which needs a TPU), and the
independence of each image's masks from the batch size.

The bits are not the TPU PRNG's and are not compared with JAX; the port's
CUDA kernels draw them from the same function (csrc/common.cuh), which
chip_smoke.py holds bitwise against this twin on the card."""

import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu_torch.ops import fused_block as port

# Random123's known-answer vectors for philox4x32 with 10 rounds (kat_vectors)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = port.philox4x32_reference(torch.tensor(ctr, dtype=torch.int64), torch.tensor(key, dtype=torch.int64))
    assert [int(v) for v in got] == list(want)


def test_philox_broadcasts_over_counters():
    """A batch of counters gives, row for row, what each counter gives alone."""
    ctr = torch.tensor([c for c, _, _ in KAT], dtype=torch.int64)
    key = torch.tensor([k for _, k, _ in KAT], dtype=torch.int64)
    assert port.philox4x32_reference(ctr, key).tolist() == [list(w) for _, _, w in KAT]


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.1, 0.25, 0.5, 0.9, 1.0 - 2.0**-40, 1.0])
def test_dropout_threshold_matches_jax(rate):
    assert port.dropout_threshold(rate) == int(jax_fb._dropout_threshold(rate))


def test_mask_layout():
    """Element (row, col) of (img, head)'s mask is word col % 4 of
    Philox(ctr = (row, col // 4, 0, 0), key = (seed, img * 1024 + head)),
    kept iff >= the threshold; the output dropout is head ``heads``; a
    negative int32 seed keys with its bit pattern."""
    seed, b, n, dim, heads, rate = -5, 2, 9, 16, 3, 0.3
    attn, out = port.dropout_masks(seed, b, n, dim, heads, rate, device="cpu")
    t = port.dropout_threshold(rate)

    def bit(img, head, row, col):
        ctr = torch.tensor([row, col // 4, 0, 0])
        key = torch.tensor([seed & 0xFFFFFFFF, img * 1024 + head])
        return int(port.philox4x32_reference(ctr, key)[col % 4] >= t)

    for img, head, row, col in ((0, 0, 0, 0), (1, 2, 8, 8), (0, 1, 3, 5), (1, 0, 7, 2)):
        assert attn[img, head, row, col] == bit(img, head, row, col)
    for img, row, col in ((0, 0, 15), (1, 8, 9), (1, 4, 0)):
        assert out[img, row, col] == bit(img, heads, row, col)


def test_mask_statistics_and_determinism():
    attn, out = port.dropout_masks(7, 4, 128, 256, 4, 0.25, device="cpu")
    assert attn.shape == (4, 4, 128, 128) and out.shape == (4, 128, 256)
    assert attn.dtype == out.dtype == torch.int32
    assert abs(attn.float().mean().item() - 0.75) < 0.01
    assert abs(out.float().mean().item() - 0.75) < 0.01
    a2, o2 = port.dropout_masks(7, 4, 128, 256, 4, 0.25, device="cpu")
    assert torch.equal(attn, a2) and torch.equal(out, o2)
    a3, _ = port.dropout_masks(8, 4, 128, 256, 4, 0.25, device="cpu")
    assert not torch.equal(attn, a3)
    # per-(img, head) streams differ
    assert not torch.equal(attn[0, 0], attn[0, 1])
    assert not torch.equal(attn[0, 0], attn[1, 0])


def test_masks_do_not_depend_on_the_batch():
    """An image's masks are a function of (seed, img, head) alone: a b=3
    call gives the leading images of a b=5 call."""
    a3, o3 = port.dropout_masks(11, 3, 50, 64, 2, 0.1, device="cpu")
    a5, o5 = port.dropout_masks(11, 5, 50, 64, 2, 0.1, device="cpu")
    assert torch.equal(a3, a5[:3]) and torch.equal(o3, o5[:3])


def test_rate_zero_keeps_everything_and_rate_edges():
    attn, out = port.dropout_masks(3, 2, 10, 8, 2, 0.0, device="cpu")
    assert bool(attn.all()) and bool(out.all())
    assert port._dropout_args("x", 0.0, None) == (0, 0, 0, 1.0)
    assert port._dropout_args("x", 0.5, -1) == (1, 0xFFFFFFFF, 2**31, 2.0)
    with pytest.raises(ValueError, match="requires a seed"):
        port._dropout_args("x", 0.1, None)
    with pytest.raises(ValueError, match="not in"):
        port._dropout_args("x", 1.0, 0)


def test_twin_masks_apply_where_they_say():
    """The attention twin with dropout zeroes exactly the dropped entries of
    P and scales the kept ones by 1/(1 - rate): with v the identity, the
    output is P itself."""
    rng = np.random.default_rng(0)
    b, n, heads, dh = 2, 16, 1, 16
    q = k = torch.from_numpy(rng.standard_normal((b, n, dh)).astype(np.float32))
    v = torch.eye(n, dh).expand(b, n, dh)
    qkv = torch.cat([q, k, v], -1)
    rate, seed = 0.3, 9
    got = port.attention_rows_reference(qkv, heads=heads, dim_head=dh, scale=dh**-0.5, dropout_rate=rate, seed=seed)
    p = port.attention_rows_reference(qkv, heads=heads, dim_head=dh, scale=dh**-0.5)
    keep = port.dropout_masks(seed, b, n, dh, heads, rate, device="cpu")[0][:, 0].bool()
    want = torch.where(keep, p, 0.0) / (1 - rate)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
