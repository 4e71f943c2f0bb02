"""Attention dropout on the port's flash route (vit_pytorch_tpu_torch/ops/
flash_attention.py) against the JAX package on the CPU.

The JAX kernels draw their keep bits from the TPU's PRNG per tile, which has
no interpreter lowering (tests/test_flash_dropout.py runs them on the chip
only); the port keys its bits by element with Philox4x32-10.  So, as that
JAX test does, the comparison feeds one mask to both sides: the port's
``flash_dropout_masks`` goes, as numpy, into a JAX composite written here
(softmax under the JAX ``build_segment_mask``, then ``where(keep, p, 0) /
(1 - rate)``, then the value product, run in f64), and the port's flash
Function on its plain twins at fp32 must give its output and, against
``jax.vjp``, dq, dk and dv within atol = rtol = 2e-5 (readings <= 1.3e-6;
JAX's own f32 composite reads up to 2.1e-5 from the f64 one on the CPU).
The masks themselves are held bit for bit to the attention block's
(``fused_block.dropout_masks_reference``), which tests/test_torch_dropout.py
holds to Random123's known answers.  Also held: the dispatcher's seed (drawn on the
host, repeatable under ``torch.manual_seed``), its routes with dropout, the
refusals, and one ``make_train_step`` step of each NaViT with dropout 0.1 on
the flash route forced on the CPU."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.ops import attention as jax_attention
from vit_pytorch_tpu_torch.models import na_vit, na_vit_nested_tensor
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.ops import flash_attention as flash
from vit_pytorch_tpu_torch.ops import fused_block as fb
from vit_pytorch_tpu_torch.ops.packing import pack_images
from vit_pytorch_tpu_torch.parallel import train as port_train

ATOL = RTOL = 2e-5
RATE, SEED = 0.15, 77
B, H, D = 2, 2, 64
TWO_SEGMENTS = np.array([0] * 140 + [1] * 120 + [-1] * 40, np.int32)  # 300 tokens, 40 pads


def _ids(kind, n, m):
    if kind is None:
        return None, None
    ks = np.tile(TWO_SEGMENTS[:m], (B, 1))
    if kind == "segments":
        return ks.copy(), ks
    slots = np.where(np.arange(n) < 2, np.arange(n), -2).astype(np.int32)  # attn_pool: 2 images, empty slots
    return np.tile(slots, (B, 1)), ks


CASES = {  # name: n, m, ids
    "plain": (300, 300, None),
    "segments": (300, 300, "segments"),
    "attn_pool": (16, 300, "pool"),
}


def _case(name, seed=0):
    n, m, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, H, n, D), (B, H, m, D), (B, H, m, D)))
    g = rng.standard_normal((B, H, n, D)).astype(np.float32)
    return q, k, v, g, *_ids(kind, n, m)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_composite(q, k, v, keep, qs, ks, rate, scale):
    """The materialized JAX attention with the dropout of
    tests/test_flash_dropout.py:79-83 under the segment mask; rows with no
    key give zeros, as the JAX ``xla_attention`` gives them."""
    s = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
    if qs is None:
        p = jax.nn.softmax(s, axis=-1)
    else:
        mask = jax_attention.build_segment_mask(jnp.asarray(qs), jnp.asarray(ks), q.shape[2], k.shape[2])
        p = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
        p = jnp.where(mask.any(-1, keepdims=True), p, 0.0)
    p = jnp.where(jnp.asarray(keep, bool), p, 0.0) / (1.0 - rate)
    return jnp.einsum("bhnm,bhmd->bhnd", p, v)


def _port(q, k, v, g, qs, ks, **kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash.flash_attention(*leaves, q_segment_ids=_t(qs), kv_segment_ids=_t(ks), **kw)
    return [out, *torch.autograd.grad(out, leaves, torch.from_numpy(g))]


# -- the masks -------------------------------------------------------------


@pytest.mark.parametrize("n,heads", [(50, 3), (197, 12)])
def test_flash_masks_equal_the_attention_block_masks(n, heads):
    """Keyed by element, the flash mask at n = m is the attention block's
    attention mask, bit for bit (one Philox function for every kernel)."""
    got = flash.flash_dropout_masks(SEED, 2, heads, n, n, 0.1, device="cpu")
    want = fb.dropout_masks_reference(SEED, 2, n, 32, heads, 0.1)[0]
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, heads, n, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,m", [(16, 300), (300, 70), (5, 7)])
def test_rectangular_masks(n, m):
    """An (n, m) mask is the (n, m) corner of the square one (a bit depends
    on its row and column only), and element (i, j) is word j % 4 of
    Philox4x32-10 at counter (i, j // 4, 0, 0), key (seed, img * 1024 + head)."""
    side = max(n, m)
    got = flash.flash_dropout_masks(SEED, 2, 3, n, m, RATE, device="cpu")
    assert tuple(got.shape) == (2, 3, n, m)
    assert torch.equal(got, flash.flash_dropout_masks(SEED, 2, 3, side, side, RATE, device="cpu")[:, :, :n, :m])
    rng = np.random.default_rng(8)
    for img, head, i, j in zip(rng.integers(0, 2, 8), rng.integers(0, 3, 8), rng.integers(0, n, 8),
                               rng.integers(0, m, 8)):
        bits = fb.philox4x32_reference(torch.tensor([int(i), int(j) // 4, 0, 0]),
                                       torch.tensor([SEED, int(img) * 1024 + int(head)]))
        assert int(got[img, head, i, j]) == int(bits[int(j) % 4] >= fb.dropout_threshold(RATE))


def test_mask_determinism_and_rate():
    """tests/test_flash_dropout.py:156-163: the same seed gives the same
    mask, another seed another, and rate 0.25 keeps 0.75 +- 0.01."""
    a = flash.flash_dropout_masks(5, 2, 2, 256, 256, 0.25, device="cpu")
    b = flash.flash_dropout_masks(5, 2, 2, 256, 256, 0.25, device="cpu")
    c = flash.flash_dropout_masks(6, 2, 2, 256, 256, 0.25, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(a.float().mean().item() - 0.75) < 0.01
    assert not torch.equal(a[0, 0], a[0, 1]) and not torch.equal(a[0, 0], a[1, 0])  # streams apart


def test_masks_refuse_what_the_stream_key_cannot_hold():
    """img * 1024 + head keys a stream: 1024 heads would collide, so every
    dropout entry refuses them; the replay runs only on the card or the CPU."""
    with pytest.raises(ValueError, match="1023 heads"):
        flash.flash_dropout_masks(1, 1, 1024, 4, 4, 0.1, device="cpu")
    with pytest.raises(ValueError, match="1023 heads"):
        flash.flash_dropout_masks_reference(1, 1, 1024, 4, 4, 0.1)
    q = torch.zeros(1, 1024, 4, 64)
    with pytest.raises(ValueError, match="1023 heads"):
        flash.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1)
    assert flash.flash_attention(q, q, q).shape == q.shape  # no stream without dropout
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_dropout_masks(1, 1, 2, 4, 4, 0.1, device="meta")


# -- forward and gradients against JAX ---------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_flash_dropout_matches_jax_composite(name):
    """o, dq, dk, dv of the Function on its twins against the JAX composite
    and ``jax.vjp`` fed the port's mask (as numpy)."""
    q, k, v, g, qs, ks = _case(name)
    n, m = q.shape[2], k.shape[2]
    scale = D**-0.5
    keep = flash.flash_dropout_masks(SEED, B, H, n, m, RATE, device="cpu").numpy()
    fn = lambda *a: _jax_composite(*a, keep, qs, ks, RATE, scale)
    with jax.enable_x64(True):  # the reference in f64 (see the top)
        o, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.float64) for a in (q, k, v)))
        want = [np.asarray(o), *map(np.asarray, vjp(jnp.asarray(g, jnp.float64)))]
    got = _port(q, k, v, g, qs, ks, dropout_rate=RATE, dropout_seed=SEED)
    assert type(got[0].grad_fn).__name__ == "_FlashAttentionBackward"
    for part, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), w, atol=ATOL, rtol=RTOL, err_msg=part)
    # it drops: the rate-0 output differs
    assert not np.allclose(got[0].detach().numpy(), _port(q, k, v, g, qs, ks)[0].detach().numpy(), atol=1e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_twins_match_the_materialized_reference_with_dropout(name):
    """The Function on the twins against autograd through
    ``flash_attention_reference`` (the materialized composite) with the same
    seed, hence the same mask, at fp32."""
    q, k, v, g, qs, ks = _case(name, seed=1)
    got = _port(q, k, v, g, qs, ks, dropout_rate=RATE, dropout_seed=SEED)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash.flash_attention_reference(*leaves, q_segment_ids=_t(qs), kv_segment_ids=_t(ks), dropout_rate=RATE,
                                          dropout_seed=SEED)
    want = [out, *torch.autograd.grad(out, leaves, torch.from_numpy(g))]
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_rate_zero_is_the_plain_path_bit_for_bit(name):
    """At rate 0 the seed is ignored and the Function is today's path: o and
    every gradient bitwise equal to the call without dropout keywords."""
    q, k, v, g, qs, ks = _case(name, seed=2)
    for a, b in zip(_port(q, k, v, g, qs, ks, dropout_rate=0.0, dropout_seed=SEED), _port(q, k, v, g, qs, ks)):
        assert torch.equal(a, b)


def test_wrappers_replay_one_mask():
    """The forward and both backward wrappers draw the same mask: the twins
    of dq and dk, dv with dropout equal the rate-0 twins fed p already
    dropped, i.e. the replay is the forward's mask, not a new draw."""
    q, k, v, g, qs, ks = (_t(a) for a in _case("segments", seed=3))
    kw = dict(scale=D**-0.5, q_segment_ids=qs, kv_segment_ids=ks)
    o, lse = flash.flash_fwd(q, k, v, **kw, dropout_rate=RATE, seed=SEED)
    o2, lse2 = flash.flash_fwd(q, k, v, **kw, dropout_rate=RATE, seed=SEED)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _, lse0 = flash.flash_fwd(q, k, v, **kw)
    assert torch.equal(lse, lse0)  # the lse is the undropped softmax's
    delta = (g * o).sum(-1)
    dq = flash.flash_bwd_dq(q, k, v, g, lse, delta, **kw, dropout_rate=RATE, seed=SEED)
    dk, dv = flash.flash_bwd_dkv(q, k, v, g, lse, delta, **kw, dropout_rate=RATE, seed=SEED)
    want = flash.flash_bwd_reference(q, k, v, g, lse, delta, **kw, dropout_rate=RATE, seed=SEED)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    other = flash.flash_bwd_dq(q, k, v, g, lse, delta, **kw, dropout_rate=RATE, seed=SEED + 1)
    assert not torch.allclose(dq, other)


# -- the dispatcher ---------------------------------------------------------


def _capture_flash(monkeypatch, run=False):
    calls = []

    def fake(q, k, v, **kw):
        calls.append(kw)
        return flash.flash_attention(q, k, v, **kw) if run else torch.zeros_like(q)

    monkeypatch.setattr(attention, "flash_attention", fake)
    return calls


def test_dispatcher_routes_dropout_to_flash(monkeypatch):
    """tests/test_flash_dropout.py:41-62: with segment ids and dropout on
    the card (taken as true), the dispatcher calls the flash kernels with
    the rate and an int seed, drawn on the host and repeatable under
    ``torch.manual_seed``."""
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    calls = _capture_flash(monkeypatch)
    q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    segs = torch.zeros(1, 16, dtype=torch.int32)
    seeds = []
    for s in (0, 0, 1):
        torch.manual_seed(s)
        attention.dot_product_attention(q, q, q, q_segment_ids=segs, kv_segment_ids=segs, dropout_rate=0.1)
        seeds.append(calls[-1]["dropout_seed"])
        assert calls[-1]["dropout_rate"] == 0.1 and isinstance(seeds[-1], int) and 0 <= seeds[-1] < 2**31 - 1
    assert seeds[0] == seeds[1] != seeds[2]
    gen = torch.Generator().manual_seed(0)
    attention.dot_product_attention(q, q, q, q_segment_ids=segs, kv_segment_ids=segs, dropout_rate=0.1,
                                    generator=gen)
    assert calls[-1]["dropout_seed"] == seeds[0]  # the generator's draw, as the global one seeded alike
    attention.dot_product_attention(q, q, q, q_segment_ids=segs, kv_segment_ids=segs)
    assert calls[-1]["dropout_rate"] == 0.0 and calls[-1]["dropout_seed"] is None


def test_dispatcher_dropout_routes_on_the_cpu(monkeypatch):
    """On the CPU, ``use_flash=None`` takes the composite with ``torch.rand``
    (JAX off the TPU); ``use_flash=True`` runs the flash Function on its
    twins with the drawn seed; a bias with dropout takes the composite (JAX
    :194-199), and ``flash_attention`` itself refuses it."""
    calls = _capture_flash(monkeypatch, run=True)
    q, k, v, _, qs, ks = (_t(a) for a in _case("segments", seed=4))
    kw = dict(q_segment_ids=qs, kv_segment_ids=ks, dropout_rate=RATE)
    torch.manual_seed(0)
    a = attention.dot_product_attention(q, k, v, **kw)
    b = attention.dot_product_attention(q, k, v, **kw)
    assert not calls and not torch.equal(a, b)  # the composite, a new torch.rand mask each call
    routed = attention.dot_product_attention(q, k, v, **kw, use_flash=True)
    assert len(calls) == 1 and calls[0]["dropout_rate"] == RATE
    want = flash.flash_attention_twins(q, k, v, q_segment_ids=qs, kv_segment_ids=ks, dropout_rate=RATE,
                                       dropout_seed=calls[0]["dropout_seed"])
    assert torch.equal(routed, want)
    bias = torch.zeros(B, H, 300, 300)
    attention.dot_product_attention(q, k, v, **kw, bias=bias, use_flash=True)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="bias"):
        flash.flash_attention(q, k, v, bias=bias, dropout_rate=RATE, dropout_seed=1)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash.flash_attention_twins(q, k, v, dropout_rate=RATE)


# -- the models --------------------------------------------------------------

MODEL_KW = dict(image_size=64, patch_size=16, num_classes=11, dim=64, depth=2, heads=2, dim_head=64, mlp_dim=128,
                dropout=0.1, emb_dropout=0.1)
SIZES = [(64, 64), (32, 32), (32, 64), (64, 32), (16, 16)]


def _masked_ce(logits, labels):
    valid = labels >= 0
    ls = F.cross_entropy(logits.float().flatten(0, 1), labels.clamp_min(0).flatten(), reduction="none")
    return (ls.view(labels.shape) * valid).sum() / valid.sum().clamp_min(1)


@pytest.mark.parametrize("cls", [na_vit.NaViT, na_vit_nested_tensor.NaViT], ids=["na_vit", "nested"])
def test_navit_trains_on_the_flash_dropout_route(monkeypatch, cls):
    """A depth-2 NaViT with dropout 0.1, every attention call on the flash
    route forced on the CPU (the Function on its twins): the layers' calls
    carry the rate and a seed, attn_pool none; one ``make_train_step`` step
    gives a finite loss, the same metrics from two equal generators and
    other metrics from another generator."""
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    calls = _capture_flash(monkeypatch, run=True)
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((3, h, w)).astype(np.float32) for h, w in SIZES]
    packed = pack_images(images, 16, max_seq_len=24, token_dropout_prob=0.25, train=True, max_images=4,
                         rng=np.random.default_rng(1), device="cpu")
    labels = torch.from_numpy(np.where(packed.is_image.numpy(), rng.integers(0, 11, packed.is_image.shape), -1))
    model = cls(**MODEL_KW, device="cpu", generator=torch.Generator().manual_seed(0))

    def step(seed):
        m = copy.deepcopy(model)
        return port_train.make_train_step(m, _masked_ce)(port_train.create_train_state(m), packed, labels,
                                                         torch.Generator().manual_seed(seed))

    first = step(3)
    rates = [c["dropout_rate"] for c in calls]
    assert rates == [0.1] * MODEL_KW["depth"] + [0.0]
    assert all(isinstance(c["dropout_seed"], int) for c in calls[:-1]) and calls[-1]["dropout_seed"] is None
    assert np.isfinite(first["loss"].item())
    again, other = step(3), step(4)
    assert all(torch.equal(first[k], again[k]) for k in first)
    assert first["loss"].item() != other["loss"].item()
