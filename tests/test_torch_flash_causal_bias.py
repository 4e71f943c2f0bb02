"""The causal and bias variants of the port's flash attention
(vit_pytorch_tpu_torch/ops/flash_attention.py) against the JAX package's
``flash_attention`` on the CPU.

On CPU tensors the port's ``flash_attention`` runs its autograd Function on
the kernels' plain twins; the JAX side runs its Pallas kernels in interpret
mode.  Cases: the causal mask on a square problem, with n < m and n > m (top-
left aligned in absolute positions, as ``_tile_mask`` :161-164), with packed
segment ids; an additive bias broadcast as (1, h), (b, 1) and (b, h), with
the causal mask and with segment ids.  o and the LSE within 2e-5 absolute
at fp32; dq, dk, dv (the causal kernels' twins; with a bias the composite's
backward, as JAX's) and dbias, against ``jax.vjp``, each within 2e-5 of its
largest element (the bound PR 8's flash tests use).

Also held: causal attention at dropout 0.15 against a JAX f64 composite fed
the port's keep mask (the TPU PRNG has no interpreter lowering), causal with
qk-norm gammas under ``VIT_TPU_FUSE_QKNORM`` on both sides, the causal
tile-skip predicate against brute force, the twins against the materialized
``flash_attention_reference``, and the JAX bias shape checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import attention as jax_attention
from vit_pytorch_tpu.ops import flash_attention as jax_flash
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.ops import flash_attention as flash

ATOL = 2e-5
GRAD_FRAC = 2e-5
RATE, SEED = 0.15, 91


def _packed_ids(rng, b, length, pad, n_seg=4):
    ids = np.full((b, length), -1, np.int32)
    ids[:, : length - pad] = np.sort(rng.integers(0, n_seg, (b, length - pad)), axis=1)
    return ids


CASES = {
    # name: b, h, n, m, causal, bias broadcast (None, "1h", "b1", "bh"), segment ids
    "causal": (2, 2, 256, 256, True, None, False),
    "causal n < m": (1, 2, 200, 264, True, None, False),
    "causal n > m": (1, 2, 264, 200, True, None, False),
    "causal segments": (2, 2, 256, 256, True, None, True),
    "bias (1, h)": (2, 2, 128, 160, False, "1h", False),
    "bias (b, 1)": (2, 2, 128, 160, False, "b1", False),
    "bias (b, h)": (2, 2, 128, 160, False, "bh", False),
    "bias causal": (2, 2, 192, 192, True, "1h", False),
    "bias segments": (2, 2, 256, 256, False, "bh", True),
    # the edges of the card kernel's 64-key ring and head-ordered grid
    "causal n = 129, m = 1000": (1, 2, 129, 1000, True, None, False),
    "bias (b, h) n = 1, m = 130": (2, 2, 1, 130, False, "bh", False),
    "bias (1, h) b = 3, h = 2": (3, 2, 129, 130, False, "1h", False),
    "bias (b, 1) m = 1000": (2, 2, 129, 1000, False, "b1", False),
}


def _case(name, seed=0):
    b, h, n, m, causal, bias_kind, segs = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, n, 64), (b, h, m, 64), (b, h, m, 64)))
    g = rng.standard_normal((b, h, n, 64)).astype(np.float32)
    bias = None
    if bias_kind:
        shape = {"1h": (1, h, n, m), "b1": (b, 1, n, m), "bh": (b, h, n, m)}[bias_kind]
        bias = rng.standard_normal(shape).astype(np.float32)
    qs = ks = None
    if segs:
        qs = ks = _packed_ids(rng, b, n, pad=29)
    return dict(q=q, k=k, v=v, g=g, bias=bias, qs=qs, ks=ks, causal=causal)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jax_vjp(c):
    """o and the gradients of the JAX kernels in interpret mode (dbias
    too, with a bias)."""
    args = [jnp.asarray(c[x]) for x in "qkv"] + ([jnp.asarray(c["bias"])] if c["bias"] is not None else [])

    def fn(q, k, v, bias=None):
        return jax_flash.flash_attention(q, k, v, bias=bias, q_segment_ids=_j(c["qs"]), kv_segment_ids=_j(c["ks"]),
                                         causal=c["causal"], interpret=True)

    o, vjp = jax.vjp(fn, *args)
    return [np.asarray(o), *map(np.asarray, vjp(jnp.asarray(c["g"])))]


def _port(c, fn=flash.flash_attention, **kw):
    names = ["q", "k", "v"] + (["bias"] if c["bias"] is not None else [])
    leaves = [torch.from_numpy(c[x]).requires_grad_() for x in names]
    out = fn(*leaves[:3], bias=leaves[3] if len(leaves) > 3 else None, q_segment_ids=_t(c["qs"]),
             kv_segment_ids=_t(c["ks"]), causal=c["causal"], **kw)
    return [out, *torch.autograd.grad(out, leaves, torch.from_numpy(c["g"]))]


def _close(got, want, parts):
    for part, a, w in zip(parts, got, want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        atol = ATOL if part == "o" else GRAD_FRAC * np.abs(w).max()
        np.testing.assert_allclose(a, w, atol=atol, rtol=0, err_msg=part)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_causal_bias_matches_jax(name):
    c = _case(name)
    got = _port(c)
    assert type(got[0].grad_fn).__name__ == "_FlashAttentionBackward"
    _close(got, _jax_vjp(c), ("o", "dq", "dk", "dv", "dbias"))
    if c["bias"] is not None:
        assert tuple(got[4].shape) == c["bias"].shape  # dbias in the bias's broadcast shape


@pytest.mark.parametrize("name", list(CASES))
def test_lse_matches_jax(name):
    """The forward's f32 LSE against the JAX kernel's, causal mask and bias
    included."""
    c = _case(name)
    b, h, n, _ = c["q"].shape
    m = c["k"].shape[2]
    bq, bk = jax_flash.default_blocks(n, m)
    _, lse = jax_flash._flash_forward(
        *(jnp.asarray(c[x]) for x in "qkv"), _j(c["bias"]), _j(c["qs"]), _j(c["ks"]), 64**-0.5, c["causal"], bq, bk,
        True, save_lse=True,
    )
    want = np.asarray(lse)[:, :n, 0].reshape(b, h, n)
    _, got = flash.flash_fwd(*(torch.from_numpy(c[x]) for x in "qkv"), scale=64**-0.5, q_segment_ids=_t(c["qs"]),
                             kv_segment_ids=_t(c["ks"]), causal=c["causal"], bias=_t(c["bias"]))
    live = want > -1e29
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=ATOL, rtol=0)
    assert np.all(got.numpy()[~live] == flash.NEG_INF)


@pytest.mark.parametrize("name", ["causal", "causal n < m", "causal segments", "bias causal", "bias segments"])
def test_twins_match_the_materialized_reference(name):
    """The Function on the twins against autograd through
    ``flash_attention_reference`` (the materialized composite with the
    causal triangle and the bias), at fp32."""
    c = _case(name, seed=1)
    for a, w in zip(_port(c), _port(c, flash.flash_attention_reference)):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
    for a, w in zip(_port(c, flash.flash_attention_twins), _port(c)):
        assert torch.equal(a, w)


def _jax_composite_causal(q, k, v, keep, qs, ks, rate, scale):
    """The materialized JAX attention under the causal triangle (and the
    segment mask), dropping the normalized matrix with ``keep``."""
    s = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
    mask = jax_attention.build_segment_mask(_j(qs), _j(ks), q.shape[2], k.shape[2], causal=True)
    p = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
    p = jnp.where(mask.any(-1, keepdims=True), p, 0.0)
    p = jnp.where(jnp.asarray(keep, bool), p, 0.0) / (1.0 - rate)
    return jnp.einsum("bhnm,bhmd->bhnd", p, v)


@pytest.mark.parametrize("name", ["causal", "causal n < m", "causal segments"])
def test_causal_dropout_matches_jax_composite(name):
    """Causal at rate 0.15 (the [dropout,causal] variants' twins): o, dq, dk,
    dv against a JAX f64 composite fed the port's keep mask, within 2e-5
    (tests/test_torch_flash_dropout.py's bound)."""
    c = _case(name)
    b, h, n, _ = c["q"].shape
    m = c["k"].shape[2]
    keep = flash.flash_dropout_masks(SEED, b, h, n, m, RATE, device="cpu").numpy()
    fn = lambda *a: _jax_composite_causal(*a, keep, c["qs"], c["ks"], RATE, 64**-0.5)
    with jax.enable_x64(True):
        o, vjp = jax.vjp(fn, *(jnp.asarray(c[x], jnp.float64) for x in "qkv"))
        want = [np.asarray(o), *map(np.asarray, vjp(jnp.asarray(c["g"], jnp.float64)))]
    got = _port(c, dropout_rate=RATE, dropout_seed=SEED)
    for part, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), w, atol=ATOL, rtol=ATOL, err_msg=part)
    assert not np.allclose(got[0].detach().numpy(), _port(c)[0].detach().numpy(), atol=1e-3)  # it drops


def test_causal_qknorm_under_the_switch(monkeypatch):
    """Causal with qk-norm gammas through the dispatcher (``use_flash=True``)
    with ``VIT_TPU_FUSE_QKNORM`` set on both sides: the gammas ride into the
    flash kernels ([qknorm,causal] twins here, JAX's kernels in interpret
    mode); o and the gradients of q, k, v and both gammas."""
    monkeypatch.setenv("VIT_TPU_FUSE_QKNORM", "1")
    c = _case("causal segments", seed=2)
    rng = np.random.default_rng(3)
    gq, gk = (0.125 * (1 + 0.2 * rng.standard_normal((2, 1, 64))).astype(np.float32) for _ in range(2))
    jkw = dict(q_segment_ids=_j(c["qs"]), kv_segment_ids=_j(c["ks"]), causal=True, scale=1.0, use_flash=True)
    fn = lambda q, k, v, a, b: jax_attention.dot_product_attention(q, k, v, gamma_q=a, gamma_k=b, **jkw)
    o, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (c["q"], c["k"], c["v"], gq, gk)))
    want = [np.asarray(o), *map(np.asarray, vjp(jnp.asarray(c["g"])))]
    routes = []
    real = attention.flash_attention

    def spy(*a, **kw):
        routes.append(kw["gamma_q"] is not None)
        return real(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (c["q"], c["k"], c["v"], gq, gk)]
    out = attention.dot_product_attention(*leaves[:3], gamma_q=leaves[3], gamma_k=leaves[4], q_segment_ids=_t(c["qs"]),
                                          kv_segment_ids=_t(c["ks"]), causal=True, scale=1.0, use_flash=True)
    got = [out, *torch.autograd.grad(out, leaves, torch.from_numpy(c["g"]))]
    assert routes == [True]  # the gammas reached the kernels
    _close(got, want, ("o", "dq", "dk", "dv", "dgamma_q", "dgamma_k"))


def _brute_force(qs, ks, bq, bk):
    """(b, nq, nk): whether any pair (query r, key c <= r) shares an id."""
    b, n = qs.shape
    m = ks.shape[1]
    out = np.zeros((b, -(-n // bq), -(-m // bk)), bool)
    rows, cols = np.arange(n)[:, None], np.arange(m)[None, :]
    for i in range(out.shape[1]):
        for j in range(out.shape[2]):
            r, c = slice(i * bq, (i + 1) * bq), slice(j * bk, (j + 1) * bk)
            a, d = qs[:, r, None], ks[:, None, c]
            out[:, i, j] = ((a == d) & (a >= 0) & (cols[:, c] <= rows[r])[None]).any((1, 2))
    return out


@pytest.mark.parametrize("bq,bk", [(64, 64), (64, 32), (32, 64)])
def test_causal_tile_skip_predicate(bq, bk):
    """With ``causal`` the tiles the kernels run: conservative (every tile
    with a visible same-id pair runs) and exact for packed ids, whose ids
    rise along the pack, and for no ids (all one segment)."""
    rng = np.random.default_rng(4)
    ks = _packed_ids(rng, 3, 300, pad=45, n_seg=7)
    got = flash.tile_admitted(torch.from_numpy(ks), torch.from_numpy(ks), block_q=bq, block_k=bk, causal=True).numpy()
    want = _brute_force(ks, ks, bq, bk)
    np.testing.assert_array_equal(got, want)
    one = np.zeros((1, 200), np.int32)
    got = flash.tile_admitted(torch.from_numpy(one), torch.from_numpy(one[:, :150]), block_q=bq, block_k=bk,
                              causal=True).numpy()
    np.testing.assert_array_equal(got, _brute_force(one, one[:, :150], bq, bk))


@pytest.mark.parametrize("shape", [(1, 2, 8, 9), (3, 2, 8, 8), (1, 3, 8, 8), (2, 8, 8)])
def test_bias_shape_checks_match_jax(shape):
    """A bias that does not broadcast as (1|b, 1|h, n, m) raises
    ``ValueError`` on both sides (JAX :563-573); fewer dims gain leading ones
    first, so (2, 8, 8) against h = 2 is a (1, 2, 8, 8) bias and runs."""
    q = np.zeros((2, 2, 8, 64), np.float32)
    bias = np.zeros(shape, np.float32)
    runs = shape == (2, 8, 8)
    for call in (lambda: jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), bias=jnp.asarray(bias),
                                                   interpret=True),
                 lambda: flash.flash_attention(_t(q), _t(q), _t(q), bias=_t(bias))):
        if runs:
            assert call().shape == q.shape
        else:
            with pytest.raises(ValueError, match="bias"):
                call()
    with pytest.raises(ValueError, match="unsupported with bias"):
        flash.flash_attention(_t(q), _t(q), _t(q), bias=_t(np.zeros((1, 2, 8, 8), np.float32)), dropout_rate=0.1,
                              dropout_seed=1)


def test_bias_dtypes_reach_the_twin_upcast():
    """A bf16 bias is upcast to f32 before it joins the logits (:242), in the
    kernel and in its twin: the forward equals the one on the f32 copy."""
    c = _case("bias (1, h)")
    q, k, v = (torch.from_numpy(c[x]) for x in "qkv")
    b16 = torch.from_numpy(c["bias"]).bfloat16()
    got = flash.flash_fwd(q, k, v, scale=0.125, bias=b16)
    want = flash.flash_fwd(q, k, v, scale=0.125, bias=b16.float())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
