"""The flash kernels' in-tile qk-norm on the port (vit_pytorch_tpu_torch/ops/
flash_attention.py, the JAX opt-in ``VIT_TPU_FUSE_QKNORM``) against the JAX
package on the CPU.

On CPU tensors the port's ``flash_attention`` with ``gamma_q``/``gamma_k``
runs its autograd Function on the twins of the ``[qknorm]`` kernels (q and k
through ``rms_tile_reference``, dq and dk of the normalised q and k) and
closes the RMSNorm VJP on the host (``rms_norm_vjp``); the JAX side runs its
Pallas kernels with the gammas in interpret mode (tests/test_flash_qknorm.py:
20-58).  o, dq, dk, dv, dgamma_q and dgamma_k at fp32 within 2e-5 (the
gradients relative to their largest element, see ``_assert_parts``), on no ids, packed segment ids, the attn_pool shape with empty query
slots (-2) and an all-pad pack.  With dropout (rate 0.15) JAX cannot
interpret its PRNG, so, as tests/test_torch_flash_dropout.py does, the port's
masks go into a JAX composite (rms_norm, softmax under the segment mask, the
mask, the value product) run in f64.

Also held: ``rms_tile_reference`` against the JAX ``_rms_tile`` on bf16 to
within one bf16 ulp; the dispatcher's routes with and without the switch
(tests/test_flash_qknorm.py:87-112), set with ``monkeypatch.setenv`` on both
sides before JAX traces; NaViT at depth 2 with ``flash=True`` under the
switch on both sides, logits and every gradient within 5e-5, and one
``make_train_step`` step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.models.na_vit import NaViT as JaxNaViT
from vit_pytorch_tpu.ops import attention as jax_attention
from vit_pytorch_tpu.ops import flash_attention as jax_flash
from vit_pytorch_tpu.ops.packing import pack_images as jax_pack_images
from vit_pytorch_tpu_torch.models import na_vit
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.ops import flash_attention as flash
from vit_pytorch_tpu_torch.ops.packing import pack_images
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.utils.from_jax import na_vit_state_dict_from_jax

ATOL = RTOL = 2e-5
B, H, N, D = 2, 3, 256, 64
RATE, SEED = 0.15, 77
PARTS = ("o", "dq", "dk", "dv", "dgamma_q", "dgamma_k")
SWITCH = "VIT_TPU_FUSE_QKNORM"


def _packed_ids(rng, length, pad, n_seg=4):
    ids = np.full((B, length), -1, np.int32)
    ids[:, : length - pad] = np.sort(rng.integers(0, n_seg, (B, length - pad)), axis=1)
    return ids


CASES = {  # name: n, m, ids
    "no_ids": (N, N, None),
    "segments": (N, N, "packed"),
    "attn_pool": (16, N, "pool"),
    "all_pad": (N, N, "all_pad"),
}


def _case(name, seed=0):
    """Raw q, k, v, the cotangent, module-shaped (h, 1, d) gammas 1 + 0.2
    N(0, 1) (tests/test_flash_qknorm.py:24-32), and the ids."""
    n, m, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in ((B, H, n, D), (B, H, m, D), (B, H, m, D),
                                                                      (B, H, n, D)))
    gq, gk = (1.0 + 0.2 * rng.standard_normal((H, 1, D))).astype(np.float32), \
        (1.0 + 0.2 * rng.standard_normal((H, 1, D))).astype(np.float32)
    qs = ks = None
    if kind == "packed":
        qs = ks = _packed_ids(rng, m, pad=37)
    elif kind == "pool":
        ks = _packed_ids(rng, m, pad=37)
        qs = np.where(np.arange(n)[None] < 3, np.arange(n)[None], -2).repeat(B, 0).astype(np.int32)
    elif kind == "all_pad":
        qs, ks = np.full((B, n), -1, np.int32), np.full((B, m), -1, np.int32)
    return q, k, v, g, gq, gk, qs, ks


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port(q, k, v, g, gq, gk, qs, ks, **kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, gq, gk)]
    out = flash.flash_attention(*leaves[:3], scale=1.0, gamma_q=leaves[3], gamma_k=leaves[4], q_segment_ids=_t(qs),
                                kv_segment_ids=_t(ks), **kw)
    return [out, *torch.autograd.grad(out, leaves, torch.from_numpy(g))]


def _assert_parts(got, want):
    """o within atol = rtol = 2e-5; each gradient within 2e-5 of its largest
    element (at least 1) and 2e-5 relative: the form of the JAX test's own
    gradient bound (tests/test_flash_qknorm.py:80-84, there 5e-5).  At scale
    1 the normalised rows (norm ~8 gamma) give logits up to ~+-80, whose f32
    ulp (~8e-6) is a relative error of p; so two f32 computations of dq, in
    another order, read up to ~4e-5 apart on elements of ~0.2 where the
    largest is ~10."""
    for part, a, w in zip(PARTS, got, want):
        w = np.asarray(w)
        atol = ATOL if part == "o" else ATOL * max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(a.detach().numpy(), w, atol=atol, rtol=RTOL, err_msg=part)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_qknorm_matches_jax_kernels(name):
    """The Function with gammas on its twins against the JAX kernels with
    the gammas in interpret mode and their host epilogue: o and all five
    gradients."""
    q, k, v, g, gq, gk, qs, ks = _case(name)
    fn = lambda *a: jax_flash.flash_attention(*a[:3], scale=1.0, gamma_q=a[3], gamma_k=a[4], q_segment_ids=_j(qs),
                                              kv_segment_ids=_j(ks), interpret=True)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v, gq, gk)))
    want = [o, *vjp(jnp.asarray(g))]
    got = _port(q, k, v, g, gq, gk, qs, ks)
    assert type(got[0].grad_fn).__name__ == "_FlashAttentionBackward"
    assert got[4].shape == (H, 1, D) and got[5].shape == (H, 1, D)
    _assert_parts(got, want)
    if name == "all_pad":
        assert all(not a.detach().any() for a in got)


def _jax_composite(q, k, v, gq, gk, keep, qs, ks, rate):
    """rms_norm (the JAX definition), then the materialized attention at
    scale 1 with the dropout of tests/test_flash_dropout.py:79-83 under the
    segment mask; rows with no key give zeros."""
    q, k = jax_flash.rms_norm(q, gq), jax_flash.rms_norm(k, gk)
    s = jnp.einsum("bhnd,bhmd->bhnm", q, k)
    if qs is None:
        p = jax.nn.softmax(s, axis=-1)
    else:
        mask = jax_attention.build_segment_mask(jnp.asarray(qs), jnp.asarray(ks), q.shape[2], k.shape[2])
        p = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
        p = jnp.where(mask.any(-1, keepdims=True), p, 0.0)
    p = jnp.where(jnp.asarray(keep, bool), p, 0.0) / (1.0 - rate)
    return jnp.einsum("bhnm,bhmd->bhnd", p, v)


@pytest.mark.parametrize("name", ["no_ids", "segments", "attn_pool"])
def test_flash_qknorm_dropout_matches_jax_composite(name):
    """The [dropout,qknorm] twins and the epilogue at rate 0.15 against a JAX
    f64 composite fed the port's keep mask: o and all five gradients."""
    q, k, v, g, gq, gk, qs, ks = _case(name, seed=1)
    keep = flash.flash_dropout_masks(SEED, B, H, q.shape[2], k.shape[2], RATE, device="cpu").numpy()
    fn = lambda *a: _jax_composite(*a, keep, qs, ks, RATE)
    with jax.enable_x64(True):
        o, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.float64) for a in (q, k, v, gq, gk)))
        want = [np.asarray(o), *map(np.asarray, vjp(jnp.asarray(g, jnp.float64)))]
    got = _port(q, k, v, g, gq, gk, qs, ks, dropout_rate=RATE, dropout_seed=SEED)
    _assert_parts(got, want)
    plain = _port(q, k, v, g, gq, gk, qs, ks)
    assert not np.allclose(got[0].detach().numpy(), plain[0].detach().numpy(), atol=1e-3)  # it drops


def test_rms_tile_reference_matches_jax():
    """bf16 rows of spread norms and f32 gammas: the port's twin of the
    in-tile norm and the JAX ``_rms_tile`` (one head's rows at a time) agree
    to within one bf16 ulp of each element."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, 50, D)) * np.exp(rng.standard_normal((2, 3, 50, 1)))).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal((3, 1, D))).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    got = flash.rms_tile_reference(xb, torch.from_numpy(gamma))
    assert got.dtype == torch.bfloat16
    xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    want = np.stack([np.stack([np.asarray(jax_flash._rms_tile(xj[b, h], jnp.asarray(gamma[h])), np.float32)
                               for h in range(3)]) for b in range(2)])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)
    # and it is the kernels' rounding: f32 statistics, one cast, not the eager bf16 rms_norm
    assert not torch.equal(got, flash.rms_norm(xb, torch.from_numpy(gamma).bfloat16()))


def test_rms_norm_vjp_is_the_autograd_of_rms_norm():
    """The host epilogue gives what autograd through the eager f32
    ``rms_norm`` gives, dgamma in the gamma's shape and dtype."""
    rng = np.random.default_rng(4)
    x, d = (torch.from_numpy(rng.standard_normal((2, 3, 7, D)).astype(np.float32)) for _ in range(2))
    gamma = torch.from_numpy((1 + 0.2 * rng.standard_normal((3, 1, D))).astype(np.float32)).bfloat16()
    dx, dg = flash.rms_norm_vjp(x, gamma, d)
    x32, g32 = x.clone().requires_grad_(), gamma.float().requires_grad_()
    want = torch.autograd.grad(flash.rms_norm(x32, g32), (x32, g32), d)
    assert dg.dtype == torch.bfloat16 and dg.shape == gamma.shape
    torch.testing.assert_close(dx, want[0])
    torch.testing.assert_close(dg, want[1].bfloat16())


# -- the dispatcher ---------------------------------------------------------


def _spy(monkeypatch):
    calls, real = [], flash.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw.get("gamma_q") is not None)
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("switch", ["", "1"])
def test_dispatcher_routes_gammas_by_the_switch(monkeypatch, switch):
    """JAX tests/test_flash_qknorm.py:87-112: with the switch set the gammas
    reach the flash route (the kernels normalise); unset, they normalise
    here first; on the composite, and with a bias, they normalise here
    whatever the switch.  Each route against the JAX dispatcher under the
    same environment."""
    monkeypatch.setenv(SWITCH, switch)
    calls = _spy(monkeypatch)
    q, k, v, _, gq, gk, qs, ks = _case("segments", seed=2)
    kw = dict(scale=1.0, q_segment_ids=qs, kv_segment_ids=ks)
    for use_flash in (True, False):
        got = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), gamma_q=torch.from_numpy(gq),
                                              gamma_k=torch.from_numpy(gk), use_flash=use_flash,
                                              **{**kw, "q_segment_ids": _t(qs), "kv_segment_ids": _t(ks)})
        want = jax_attention.dot_product_attention(*map(jnp.asarray, (q, k, v)), gamma_q=jnp.asarray(gq),
                                                   gamma_k=jnp.asarray(gk), use_flash=use_flash,
                                                   **{**kw, "q_segment_ids": _j(qs), "kv_segment_ids": _j(ks)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=f"flash={use_flash}")
    assert calls == [bool(switch)]  # the flash route only, with gammas iff the switch is set
    bias = np.random.default_rng(5).standard_normal((H, N, N)).astype(np.float32)
    got = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), scale=1.0, bias=torch.from_numpy(bias),
                                          gamma_q=torch.from_numpy(gq), gamma_k=torch.from_numpy(gk))
    want = jax_attention.dot_product_attention(*map(jnp.asarray, (q, k, v)), scale=1.0, bias=jnp.asarray(bias),
                                               gamma_q=jnp.asarray(gq), gamma_k=jnp.asarray(gk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg="bias")
    assert len(calls) == 1


def test_switch_on_the_card_takes_the_qknorm_kernels_or_the_composite(monkeypatch):
    """With the switch on a CUDA device (taken as true), bf16 gammas ride
    to the flash kernels; an fp32 call, which the kernels' gate refuses,
    takes the composite with the eager norm, as the JAX non-flash route."""
    monkeypatch.setenv(SWITCH, "1")
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    calls = _spy(monkeypatch)
    q, k, v, _, gq, gk, qs, ks = (_t(a) for a in _case("segments", seed=6))
    kw = dict(scale=1.0, gamma_q=gq, gamma_k=gk, q_segment_ids=qs, kv_segment_ids=ks)
    composite = attention.dot_product_attention(q, k, v, **kw)  # fp32: refused by the gate
    assert calls == []
    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    routed = attention.dot_product_attention(q, k, v, **kw)
    assert calls == [True]
    torch.testing.assert_close(routed, composite, atol=ATOL, rtol=RTOL)


# -- NaViT under the switch ----------------------------------------------------

KW = dict(image_size=64, patch_size=16, num_classes=11, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)
SIZES = [(64, 64), (32, 32), (32, 64), (64, 32), (16, 16)]


def _masked_ce(logits, labels):
    valid = labels >= 0
    ls = F.cross_entropy(logits.float().flatten(0, 1), labels.clamp_min(0).flatten(), reduction="none")
    return (ls.view(labels.shape) * valid).sum() / valid.sum().clamp_min(1)


def _jax_masked_ce(logits, labels):
    valid = labels >= 0
    ls = -jnp.take_along_axis(jax.nn.log_softmax(logits, -1), jnp.maximum(labels, 0)[..., None], -1)[..., 0]
    return jnp.sum(ls * valid) / jnp.maximum(jnp.sum(valid), 1)


def test_navit_under_the_switch_matches_jax(monkeypatch):
    """NaViT at depth 2 with ``flash=True``, VIT_TPU_FUSE_QKNORM=1 on both
    sides: each layer's gammas ride into the flash kernels (JAX's in
    interpret mode, the port's twins), attn_pool takes the composite on the
    CPU on both sides.  Logits and every gradient within 5e-5 (+ 1e-3
    relative); one ``make_train_step`` step takes the JAX loss and
    gradients."""
    monkeypatch.setenv(SWITCH, "1")
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((3, h, w)).astype(np.float32) for h, w in SIZES]
    pkw = dict(max_seq_len=24, token_dropout_prob=0.25, train=True, max_images=4)
    jpacked = jax_pack_images(images, 16, rng=np.random.default_rng(1), **pkw)
    packed = pack_images(images, 16, rng=np.random.default_rng(1), device="cpu", **pkw)
    labels = np.where(np.asarray(jpacked.is_image), rng.integers(0, 11, jpacked.is_image.shape), -1).astype(np.int32)
    jmodel = JaxNaViT(**KW, flash=True)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jpacked)["params"])
    loss, grads = jax.value_and_grad(
        lambda p: _jax_masked_ce(jmodel.apply({"params": p}, jpacked, train=True), jnp.asarray(labels)))(params)
    want_logits = np.asarray(jmodel.apply({"params": params}, jpacked, train=True))
    want = na_vit_state_dict_from_jax(jax.tree.map(np.asarray, grads))

    model = na_vit.NaViT(**KW, flash=True, device="cpu")
    model.load_state_dict(na_vit_state_dict_from_jax(params), strict=True)
    model.train()
    logits = model(packed)
    assert calls == [True] * KW["depth"]  # the layers; attn_pool takes the composite on the CPU
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=5e-5, rtol=1e-4)
    step = port_train.make_train_step(model, _masked_ce)
    metrics = step(port_train.create_train_state(model), packed, torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), atol=5e-5, rtol=1e-4)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-5, rtol=1e-3, err_msg=name)
