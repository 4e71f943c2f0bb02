"""The port's flash attention (vit_pytorch_tpu_torch/ops/flash_attention.py)
against the JAX package's ``flash_attention`` on the CPU.

On CPU tensors the port's ``flash_attention`` runs its autograd Function on
the kernels' plain twins (``flash_fwd_reference``, ``flash_bwd_reference``);
the JAX side runs its Pallas kernels in interpret mode.  Forward, LSE and
dq/dk/dv at fp32, atol 2e-4 / rtol 1e-3 (the bar of
tests/test_flash_bwd.py:58-61); the readings are ~1e-6.  The cases name the
hazards of the kernels: uneven shapes (n and m not multiples of the tile),
packed segment ids with pad tokens (-1), the attn_pool shape with empty
query slots (-2) and an all-pad pack, whose rows attend nothing and must
give o = 0, lse = -1e30 and no gradient (the backward zeroes p after the
exp, where exp(s - lse) of a masked entry is 1).

Also held here: ``rms_norm`` and ``build_segment_mask`` against JAX, the
tile-skip predicate against brute force, the twins against the materialized
``flash_attention_reference``, and the routes of the dispatcher."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import attention as jax_attention
from vit_pytorch_tpu.ops import flash_attention as jax_flash
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.ops import flash_attention as flash

ATOL, RTOL = 2e-4, 1e-3


def _packed_ids(rng, b, length, pad, n_seg=5):
    """Monotonic ids of packed images, the last ``pad`` tokens -1."""
    ids = np.full((b, length), -1, np.int32)
    ids[:, : length - pad] = np.sort(rng.integers(0, n_seg, (b, length - pad)), axis=1)
    return ids


CASES = {
    # name: b, h, n, m, d, ids
    "plain": (2, 2, 128, 128, 64, None),
    "uneven": (1, 2, 200, 264, 32, None),
    "segments": (2, 2, 256, 256, 64, "packed"),
    "attn_pool": (2, 2, 16, 256, 64, "pool"),
    "all_pad": (1, 2, 128, 128, 64, "all_pad"),
}


def _case(name, seed=0):
    b, h, n, m, d, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, n, d), (b, h, m, d), (b, h, m, d)))
    g = rng.standard_normal((b, h, n, d)).astype(np.float32)
    qs = ks = None
    if kind == "packed":
        qs = ks = _packed_ids(rng, b, m, pad=37)
    elif kind == "pool":
        ks = _packed_ids(rng, b, m, pad=37)
        qs = np.where(np.arange(n)[None] < 4, np.arange(n)[None], -2).repeat(b, 0).astype(np.int32)
    elif kind == "all_pad":
        qs, ks = np.full((b, n), -1, np.int32), np.full((b, m), -1, np.int32)
    return q, k, v, g, qs, ks


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_jax(name):
    q, k, v, g, qs, ks = _case(name)
    fn = lambda *a: jax_flash.flash_attention(*a, q_segment_ids=_j(qs), kv_segment_ids=_j(ks), interpret=True)
    o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(o), *map(np.asarray, vjp(jnp.asarray(g)))]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash.flash_attention(*leaves, q_segment_ids=_t(qs), kv_segment_ids=_t(ks))
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = [out, *torch.autograd.grad(out, leaves, torch.from_numpy(g))]
    for part, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), w, atol=ATOL, rtol=RTOL, err_msg=part)
    if name == "all_pad":
        assert all(not a.detach().any() for a in got)


@pytest.mark.parametrize("name", ["plain", "uneven", "segments", "attn_pool", "all_pad"])
def test_lse_matches_jax(name):
    """The forward's f32 LSE against the JAX kernel's (its lane-broadcast
    residual); a row with no key reads the sentinel -1e30 on both sides."""
    q, k, v, _, qs, ks = _case(name)
    b, h, n, d = q.shape
    scale = d**-0.5
    segs = None if qs is None else (_j(qs), _j(ks))
    bq, bk = jax_flash.default_blocks(n, k.shape[2])
    _, lse = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, *(segs or (None, None)), scale, False, bq, bk, True,
        save_lse=True,
    )
    want = np.asarray(lse)[:, :n, 0].reshape(b, h, n)
    _, got = flash.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale,
                             q_segment_ids=_t(qs), kv_segment_ids=_t(ks))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    dead = want <= -1e29
    assert np.array_equal(got.numpy()[dead], np.full(dead.sum(), flash.NEG_INF, np.float32))
    assert dead.any() == (name in ("segments", "attn_pool", "all_pad"))


@pytest.mark.parametrize("name", list(CASES))
def test_twins_match_the_materialized_reference(name):
    """The Function on the twins gives what autograd through
    ``flash_attention_reference`` (the JAX ``_reference_attention``) gives,
    at fp32 (the twins compute in f32 whatever the input; readings ~4e-7)."""
    q, k, v, g, qs, ks = _case(name, seed=1)
    outs = []
    for fn in (flash.flash_attention, flash.flash_attention_reference):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*leaves, q_segment_ids=_t(qs), kv_segment_ids=_t(ks))
        outs.append([out, *torch.autograd.grad(out, leaves, torch.from_numpy(g))])
    for a, w in zip(*outs):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    gamma = rng.standard_normal((3, 1, 16)).astype(np.float32)
    want = np.asarray(jax_flash.rms_norm(jnp.asarray(x), jnp.asarray(gamma)))
    np.testing.assert_allclose(flash.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)).numpy(), want,
                               atol=1e-6, rtol=1e-6)
    # in x's own dtype, as the JAX function computes: bf16 in, bf16 out
    xb = torch.from_numpy(x).bfloat16()
    got = flash.rms_norm(xb, torch.from_numpy(gamma).bfloat16())
    assert got.dtype == torch.bfloat16
    want_b = np.asarray(jax_flash.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma, jnp.bfloat16)), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want_b, atol=2**-6 * np.abs(want_b).max(), rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_build_segment_mask_matches_jax(causal):
    rng = np.random.default_rng(3)
    qs = _packed_ids(rng, 2, 12, pad=3)
    qs[1, :2] = -2
    ks = _packed_ids(rng, 2, 12, pad=2)
    want = np.asarray(jax_attention.build_segment_mask(jnp.asarray(qs), jnp.asarray(ks), 12, 12, causal=causal))
    got = attention.build_segment_mask(torch.from_numpy(qs), torch.from_numpy(ks), 12, 12, causal=causal)
    assert got.shape == (2, 1, 12, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def _brute_force(qs, ks, bq, bk):
    """(b, nq, nk): whether any pair of the tile shares a non-negative id."""
    b, n = qs.shape
    m = ks.shape[1]
    out = np.zeros((b, -(-n // bq), -(-m // bk)), bool)
    for i in range(out.shape[1]):
        for j in range(out.shape[2]):
            a, c = qs[:, i * bq:(i + 1) * bq, None], ks[:, None, j * bk:(j + 1) * bk]
            out[:, i, j] = ((a == c) & (a >= 0)).any((1, 2))
    return out


@pytest.mark.parametrize("layout", ["packed", "shuffled", "pool"])
def test_tile_skip_predicate(layout):
    """Conservative for any ids (every tile holding a pair that shares an id
    runs); exact for packed sequences, whose ids rise along the pack."""
    rng = np.random.default_rng(4)
    ks = _packed_ids(rng, 3, 300, pad=45, n_seg=7)
    qs = ks.copy()
    if layout == "shuffled":
        qs = np.stack([rng.permutation(r) for r in qs])
    elif layout == "pool":
        qs = np.where(np.arange(16)[None] < 5, np.arange(16)[None], -2).repeat(3, 0).astype(np.int32)
    got = flash.tile_admitted(torch.from_numpy(qs), torch.from_numpy(ks), block_q=64, block_k=32).numpy()
    want = _brute_force(qs, ks, 64, 32)
    assert got.shape == want.shape
    assert np.all(got[want])
    if layout != "shuffled":
        np.testing.assert_array_equal(got, want)
    all_pad = np.full((1, 128), -1, np.int32)
    assert not flash.tile_admitted(torch.from_numpy(all_pad), torch.from_numpy(all_pad)).any()


def test_flash_refuses_the_options_off_this_path():
    """Every option of the JAX function is on the path now: a bias and the
    causal mask run on the twins and match the JAX kernels in interpret mode
    (atol 2e-5); gammas and dropout run with JAX's refusals."""
    q = torch.zeros(1, 2, 8, 64)
    rng = np.random.default_rng(4)
    qa, ka, va = (rng.standard_normal((1, 2, 8, 64)).astype(np.float32) for _ in range(3))
    for kw in (dict(bias=rng.standard_normal((1, 2, 8, 8)).astype(np.float32)), dict(causal=True)):
        jkw = {k: _j(a) if isinstance(a, np.ndarray) else a for k, a in kw.items()}
        want = jax_flash.flash_attention(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va), interpret=True, **jkw)
        tkw = {k: _t(a) if isinstance(a, np.ndarray) else a for k, a in kw.items()}
        got = flash.flash_attention(*map(torch.from_numpy, (qa, ka, va)), **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # the in-kernel qk-norm is on this path now: it runs, with JAX's refusals
    # (both gammas or neither, none with a bias)
    gamma = torch.ones(2, 1, 64)
    x, y = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1, 2, 8, 64)).astype(np.float32))
    normed = flash.flash_attention(x, 2 * y, y, scale=1.0, gamma_q=gamma, gamma_k=gamma)
    assert normed.shape == x.shape and bool(torch.isfinite(normed).all())
    assert not torch.allclose(normed, flash.flash_attention(x, 2 * y, y, scale=1.0), atol=1e-3)
    with pytest.raises(ValueError, match="both q and k"):
        flash.flash_attention(q, q, q, gamma_q=gamma)
    with pytest.raises(ValueError, match="unsupported with bias"):
        flash.flash_attention(q, q, q, gamma_q=gamma, gamma_k=gamma, bias=torch.zeros(1, 2, 8, 8))
    # dropout is on this path now: it runs, with the seed JAX requires
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 2, 8, 64)).astype(np.float32))
    out = flash.flash_attention(x, x, x, dropout_rate=0.1, dropout_seed=1)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert not torch.equal(out, flash.flash_attention(x, x, x))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="both"):
        flash.flash_attention(q, q, q, q_segment_ids=torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="tiles"):
        flash.flash_attention(q, q, q, block_q=1024)
    assert flash.default_blocks(2048, 2048) == (64, 64)


def test_kernel_gate():
    bf16 = torch.bfloat16
    assert flash.flash_supported((16, 12, 2048, 64), (16, 12, 2048, 64), (16, 12, 2048, 64), bf16)
    assert flash.flash_supported((16, 12, 16, 64), (16, 12, 2048, 64), (16, 12, 2048, 64), bf16)  # attn_pool
    assert not flash.flash_supported((16, 12, 2048, 64), (16, 12, 2048, 64), (16, 12, 2048, 64), torch.float32)
    assert not flash.flash_supported((16, 4, 2048, 16), (16, 4, 2048, 16), (16, 4, 2048, 16), bf16)  # dh 16
    assert not flash.flash_supported((40000, 2, 8, 64), (40000, 2, 8, 64), (40000, 2, 8, 64), bf16)  # grid y


def test_wrappers_refuse_cpu_contract_breaks_on_a_device(monkeypatch):
    """A tensor that is not on the CPU never takes the twin: the wrapper
    checks it and raises (here on the meta device, which is no CUDA device)."""
    q = torch.empty(1, 2, 8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_fwd(q, q, q, scale=1.0)
    with pytest.raises(ValueError, match="not supported"):
        flash.flash_attention(q.float(), q.float(), q.float())


def _spy_flash(monkeypatch):
    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.dtype, kw["q_segment_ids"] is not None))
        return flash.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    return calls


def test_dispatcher_flash_route(monkeypatch):
    """On a CUDA device (taken as true) segment ids and m >= 1024 take the
    flash route, as on the JAX package's TPU; the gate sends fp32 to the
    composite, which gives the same numbers; qk-norm gammas are applied
    before the route."""
    calls = _spy_flash(monkeypatch)
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    q, k, v, g, qs, ks = _case("segments")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    gamma = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1, 64)).astype(np.float32))
    kw = dict(q_segment_ids=_t(qs), kv_segment_ids=_t(ks), scale=1.0, gamma_q=gamma, gamma_k=gamma)

    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    routed = attention.dot_product_attention(tq, tk, tv, **kw)
    assert calls == [(torch.float32, True)]
    monkeypatch.setattr(attention, "flash_supported", flash.flash_supported)  # fp32: refused
    composite = attention.dot_product_attention(tq, tk, tv, **kw)
    assert len(calls) == 1
    torch.testing.assert_close(routed, composite, atol=1e-5, rtol=1e-5)
    want = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_segment_ids=_j(qs), kv_segment_ids=_j(ks), scale=1.0,
        gamma_q=jnp.asarray(gamma.numpy()), gamma_k=jnp.asarray(gamma.numpy()),
    )
    np.testing.assert_allclose(composite.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    long = torch.zeros(1, 2, 4, 64), torch.zeros(1, 2, 1100, 64)
    attention.dot_product_attention(long[0], long[1], long[1])  # m >= 1024, no ids
    assert calls[-1] == (torch.float32, False)
    monkeypatch.setattr(attention, "on_cuda", lambda x: False)
    attention.dot_product_attention(tq, tk, tv, **kw)  # CPU: the composite, as JAX off the TPU
    assert len(calls) == 2


def test_dispatcher_raises_for_routes_still_to_port(monkeypatch):
    """The routes that raised until their kernels were ported (the short
    kernel with and without a per-head bias, flash with the causal mask and
    with a bias beside segment ids) now run their plain twins on the CPU and
    match the JAX dispatcher's kernels in interpret mode (atol 2e-5)."""
    q = torch.zeros(1, 2, 8, 64)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    rng = np.random.default_rng(8)
    qa, ka, va = (rng.standard_normal((1, 2, 8, 64)).astype(np.float32) for _ in range(3))
    ida = np.array([[0, 0, 0, 1, 1, 1, 1, -1]], np.int32)
    for kw in (dict(), dict(bias=rng.standard_normal((2, 8, 8)).astype(np.float32)), dict(causal=True),
               dict(bias=rng.standard_normal((1, 2, 8, 8)).astype(np.float32), q_segment_ids=ida,
                    kv_segment_ids=ida)):
        jkw = {k: _j(a) if isinstance(a, np.ndarray) else a for k, a in kw.items()}
        want = jax_attention.dot_product_attention(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va),
                                                   use_flash=True, **jkw)
        tkw = {k: _t(a) if isinstance(a, np.ndarray) else a for k, a in kw.items()}
        got = attention.dot_product_attention(*map(torch.from_numpy, (qa, ka, va)), use_flash=True, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # segment ids with dropout on the card: the flash route runs (its twins
    # here), no longer a raise
    calls = _spy_flash(monkeypatch)
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 2, 8, 64)).astype(np.float32))
    out = attention.dot_product_attention(x, x, x, q_segment_ids=ids, kv_segment_ids=ids, dropout_rate=0.1)
    assert calls == [(torch.float32, True)]
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="both"):
        attention.dot_product_attention(q, q, q, q_segment_ids=ids)
