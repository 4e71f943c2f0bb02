"""The port's short-sequence attention (vit_pytorch_tpu_torch/ops/
short_attention.py) against the JAX package's ``short_attention`` on the CPU.

On CPU tensors the port's ``short_attention`` runs its autograd Function on
the kernel's plain twin ``short_attention_reference``; the JAX side runs its
Pallas kernel ``_short_kernel`` in interpret mode, on the cases of
tests/test_short_bias.py: MaxViT windows (49 x 49, h = 4 and h = 3), a
rectangular LeViT shape (n = 65, m = 130, padded to 256 keys on the TPU),
dv != d on the twin, and m = 1024, the dispatcher's edge.  Forward within
2e-5 absolute at fp32; each gradient (dq, dk, dv, dbias, against
``jax.grad``) within 2e-5 of its largest element.

Also held here: the twin's rounding points in bf16 (division after the p.v
product, against the composite that normalises before), the JAX shape check
on the bias, the gate ``short_supported``, the wrapper's refusal off the
card, and the dispatcher's short route (m <= 1024 without segment ids,
causal mask or dropout) against its flash route at m = 1025."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import attention as jax_attention
from vit_pytorch_tpu.ops import short_attention as jax_short
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.ops import short_attention as short

ATOL = 2e-5
GRAD_FRAC = 2e-5

CASES = {  # name: b, h, n, m, d
    "maxvit window": (6, 4, 49, 49, 32),
    "three heads": (2, 3, 49, 49, 32),
    "levit n != m": (1, 8, 65, 130, 64),
    "m = 1024": (1, 2, 1024, 1024, 64),
    # the edges of the card kernel's 64-key ring and head-ordered grid
    "m = 1000": (1, 2, 129, 1000, 64),
    "n = 1, m = 130": (2, 2, 1, 130, 64),
    "b = 3, h = 2": (3, 2, 129, 130, 64),
}


def _case(name, seed=0, dv=None):
    b, h, n, m, d = CASES[name]
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, n, d), (b, h, m, d)))
    v = rng.standard_normal((b, h, m, dv or d)).astype(np.float32)
    bias = rng.standard_normal((h, n, m)).astype(np.float32)
    g = rng.standard_normal((b, h, n, dv or d)).astype(np.float32)
    return q, k, v, bias, g


def _jax(q, k, v, bias):
    return jax_short.short_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     bias=None if bias is None else jnp.asarray(bias), interpret=True)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_short_attention_matches_jax(name, with_bias):
    q, k, v, bias, _ = _case(name)
    bias = bias if with_bias else None
    want = np.asarray(_jax(q, k, v, bias))
    got = short.short_attention(*map(torch.from_numpy, (q, k, v)), bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    twin = short.short_attention_reference(*map(torch.from_numpy, (q, k, v)), scale=q.shape[-1] ** -0.5,
                                           bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(twin.numpy(), want, atol=ATOL, rtol=0)


def test_dv_different_from_d():
    """LeViT shapes (dim_key 32, dim_value 64): the twin and the Function
    take dv != d, as the JAX kernel does (tests/test_short_bias.py:47-61)."""
    q, k, v, bias, _ = _case("maxvit window", dv=64)
    for b in (bias, None):
        want = np.asarray(_jax(q, k, v, b))
        got = short.short_attention(*map(torch.from_numpy, (q, k, v)), bias=None if b is None else torch.from_numpy(b))
        assert tuple(got.shape) == want.shape == (6, 4, 49, 64)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["maxvit window", "levit n != m"])
def test_short_gradients_including_dbias(name):
    """dq, dk, dv and dbias of the Function (autograd through the port's
    composite on the saved inputs) against ``jax.grad`` of the JAX function
    (its custom_vjp through the JAX composite); dbias is (h, n, m), summed
    over the batch."""
    q, k, v, bias, g = _case(name, seed=1)
    loss = lambda *a: jnp.sum(_jax(*a) * jnp.asarray(g))
    want = jax.grad(loss, (0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = short.short_attention(*leaves[:3], bias=leaves[3])
    assert type(out.grad_fn).__name__ == "_ShortAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert got[3].shape == bias.shape
    for part, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, atol=GRAD_FRAC * np.abs(w).max(), rtol=0, err_msg=part)


def test_twin_divides_after_the_value_product():
    """The twin's rounding points in bf16 (_short_kernel :51-61): with q = 0
    every p is exactly 1, so o is bf16 of the f32 mean of v, bit for bit;
    the composite, which casts p / l (1/49 rounded) before the product,
    does not give it."""
    rng = np.random.default_rng(2)
    k, v = (torch.from_numpy(rng.standard_normal((2, 3, 49, 64)).astype(np.float32)).bfloat16() for _ in range(2))
    q = torch.zeros(2, 3, 49, 64, dtype=torch.bfloat16)
    got = short.short_attention_reference(q, k, v, scale=0.125)
    want = (v.float().sum(2, keepdim=True) / 49).bfloat16().expand_as(got)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not torch.equal(attention.xla_attention(q, k, v, scale=0.125), want)


def test_bias_shape_validation():
    """The JAX shape check (:225-229): a bias other than (h, n, m) raises."""
    q, k, v, bias, _ = _case("three heads")
    with pytest.raises(ValueError, match="heads, n, m"):
        _jax(q, k, v, bias[:1])
    t = lambda a: torch.from_numpy(a)
    with pytest.raises(ValueError, match="heads, n, m"):
        short.short_attention(t(q), t(k), t(v), bias=t(bias[:1]))
    with pytest.raises(ValueError, match="heads, n, m"):
        short.short_attention(t(q), t(k), t(v), bias=t(bias)[None])


def test_kernel_gate():
    bf16 = torch.bfloat16
    shape = (32, 12, 1024, 64)
    assert short.short_supported(shape, shape, shape, bf16)
    assert short.short_supported((32, 12, 49, 64), (32, 12, 49, 64), (32, 12, 49, 64), bf16)
    assert not short.short_supported(shape, shape, shape, torch.float32)
    assert not short.short_supported(shape, (32, 12, 1025, 64), (32, 12, 1025, 64), bf16)  # past the short route
    assert not short.short_supported((2, 4, 49, 32), (2, 4, 49, 32), (2, 4, 49, 32), bf16)  # dh 32
    assert not short.short_supported((2, 4, 49, 64), (2, 4, 49, 64), (2, 4, 49, 32), bf16)  # dv != 64
    assert not short.short_supported((40000, 2, 8, 64), (40000, 2, 8, 64), (40000, 2, 8, 64), bf16)  # grid y


def test_wrapper_refuses_off_the_card():
    """A tensor that is not on the CPU never takes the twin: the wrapper
    checks it and raises (the meta device stands in for a non-CUDA one)."""
    q = torch.empty(1, 2, 8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        short.short_fwd(q, q, q, scale=0.125)
    assert short.LAUNCHES == {"short_attention": 0, "short_attention[bias]": 0}


def _spy_routes(monkeypatch):
    routes = []
    for name in ("flash_attention", "short_attention"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name, lambda *a, _fn=fn, _name=name, **k: routes.append(_name) or _fn(*a, **k))
    return routes


@pytest.mark.parametrize("m", [1024, 1025])
def test_dispatcher_edge_at_1024_keys(m, monkeypatch):
    """On a CUDA device (taken as true, the gates too): a plain call with m
    = 1024 takes the short route, at m = 1025 the flash route, as the JAX
    dispatcher on a TPU (:235-254); a per-head bias rides along on the short
    route and becomes (1, h, n, m) on flash.  Both match the JAX composite."""
    routes = _spy_routes(monkeypatch)
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "short_supported", lambda *a: True)
    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, m, 16)).astype(np.float32) for _ in range(2))
    bias = rng.standard_normal((2, 8, m)).astype(np.float32)
    for b in (None, bias):
        want = jax_attention.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           bias=None if b is None else jnp.asarray(b))
        got = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                              bias=None if b is None else torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert routes == ["short_attention" if m == 1024 else "flash_attention"] * 2


def test_dispatcher_short_route_and_its_gate(monkeypatch):
    """The short route's predicate (JAX :242-248): segment ids, the causal
    mask, a 4-D bias or dropout send m = 1024 to flash; with the real gate
    (fp32 refused) the short route falls to the composite, which gives the
    same numbers; on the CPU (no card) the composite, as JAX off the TPU."""
    routes = _spy_routes(monkeypatch)
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    q = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 2, 16, 16)).astype(np.float32))
    kv = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 2, 1024, 16)).astype(np.float32))
    ids = torch.zeros(1, 16, dtype=torch.int32), torch.zeros(1, 1024, dtype=torch.int32)
    attention.dot_product_attention(q, kv, kv, q_segment_ids=ids[0], kv_segment_ids=ids[1])
    attention.dot_product_attention(q, kv, kv, causal=True)
    attention.dot_product_attention(q, kv, kv, bias=torch.zeros(1, 2, 16, 1024))
    attention.dot_product_attention(q, kv, kv, dropout_rate=0.1)
    assert routes == ["flash_attention"] * 4
    composite = attention.dot_product_attention(q, kv, kv)  # the real short gate refuses fp32
    assert len(routes) == 4
    monkeypatch.setattr(attention, "short_supported", lambda *a: True)
    torch.testing.assert_close(attention.dot_product_attention(q, kv, kv), composite, atol=1e-5, rtol=1e-5)
    assert routes[-1] == "short_attention"
    monkeypatch.setattr(attention, "on_cuda", lambda x: False)
    attention.dot_product_attention(q, kv, kv)
    assert len(routes) == 5


@pytest.mark.parametrize("switch", [False, True])
def test_gammas_are_normalised_before_the_short_route(switch, monkeypatch):
    """qk-norm gammas reach the short route normalised eagerly, with
    ``VIT_TPU_FUSE_QKNORM`` set or not (JAX :252-253): against the JAX
    dispatcher with ``use_flash=True`` (its short kernel in interpret mode)
    under the same switch on both sides."""
    if switch:
        monkeypatch.setenv("VIT_TPU_FUSE_QKNORM", "1")
    else:
        monkeypatch.delenv("VIT_TPU_FUSE_QKNORM", raising=False)
    routes = _spy_routes(monkeypatch)
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 2, 64, 64)).astype(np.float32) for _ in range(3))
    gq, gk = (0.125 * (1 + 0.2 * rng.standard_normal((2, 1, 64))).astype(np.float32) for _ in range(2))
    want = jax_attention.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), scale=1.0, use_flash=True,
                                               gamma_q=jnp.asarray(gq), gamma_k=jnp.asarray(gk))
    got = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), scale=1.0, use_flash=True,
                                          gamma_q=torch.from_numpy(gq), gamma_k=torch.from_numpy(gk))
    assert routes == ["short_attention"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
