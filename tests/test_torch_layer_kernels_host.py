"""The host side of the layer chain's kernels (``csrc/gemm_bf16.cu``,
``csrc/attention_rows.cu``, ``csrc/attention_bwd_rows.cu``,
``csrc/gemm_wgrad.cu``), on the CPU.

- The key-chunk count ``attention_rows`` runs at n keys
  (``fused_block.attention_key_chunks``, the C entry point's
  ``attn_key_chunks``) against brute force for every n in 1..208, and
  against the instantiations the sources build (``VIT_ATTN_KEY_CHUNKS`` in
  ``csrc/layer_tiles.cuh``, read from the file).
- The constants ``ops/fused_block.py`` mirrors (``ATTN_MAX_KEYS``,
  ``GEMM_BM``, ``GEMM_BK``) against ``csrc/``.
- ``attention_rows_reference`` (the kernel's plain twin) at n = 64, 68, 197
  and 208, the key counts whose instantiations the chip runs, with and
  without ``n_keys``, against the JAX per-head loop of ``_layer_rows``
  (``vit_pytorch_tpu/ops/fused_block.py:1021-1037``) rebuilt here from JAX's
  ``_softmax_from_dots`` (:82) and ``jnp.dot``, in fp32 within 5e-5 (f32
  summation order only).
- The backward's key-chunk count for every n in 1..208 against the
  instantiations ``csrc/attention_bwd_rows.cu`` builds, and
  ``attention_bwd_rows_reference`` (plain and qk-norm, dropout 0) at the
  same four n against ``_bwd_kernel``'s per-head loop (:608-692) rebuilt
  from ``_softmax_from_dots`` and ``jnp.dot``/``dot_general``, fp32, 5e-5.
- ``gemm_wgrad``'s persistent work split (``gemm_wgrad_blocks``,
  ``gemm_wgrad_pieces``, the kernel's walk) against brute force.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops.fused_block import _softmax_from_dots
from vit_pytorch_tpu_torch.ops import fused_block as fb

CSRC = Path(fb.__file__).resolve().parents[1] / "csrc"
TOL = dict(atol=5e-5, rtol=5e-5)


def _csrc_int(name: str, constant: str) -> int:
    """The value of ``constexpr int <constant> = <int>`` in csrc/<name>."""
    m = re.search(rf"\b{constant}\s*=\s*(\d+)\s*[;,]", (CSRC / name).read_text())
    assert m, f"{constant} not found in csrc/{name}"
    return int(m.group(1))


def _built_key_chunks() -> tuple:
    """The KT list of the VIT_ATTN_KEY_CHUNKS macro, as the sources build it."""
    text = (CSRC / "layer_tiles.cuh").read_text()
    m = re.search(r"#define VIT_ATTN_KEY_CHUNKS\(X\)((?:\s*X\(\d+\))+)", text)
    assert m, "VIT_ATTN_KEY_CHUNKS not found in csrc/layer_tiles.cuh"
    return tuple(int(v) for v in re.findall(r"X\((\d+)\)", m.group(1)))


def _brute_key_chunks(n: int) -> int:
    """The fewest 16-key chunks that hold n keys."""
    kt = 1
    while 16 * kt < n:
        kt += 1
    return kt


@pytest.mark.parametrize("n", range(1, fb.ATTN_MAX_KEYS + 1))
def test_key_chunks_rule(n):
    """ceil(n / 16), an instantiation the sources build, and the one the
    C entry point picks (attn_key_chunks: (n + 15) / 16)."""
    kt = fb.attention_key_chunks(n)
    assert kt == _brute_key_chunks(n)
    assert kt in _built_key_chunks()
    assert (n + 15) // 16 == kt


def test_key_chunks_built_set():
    """The sources build every count 1..13 (the gate's 208 keys), the list
    the Python side mirrors, each instantiated by the entry point's switch
    over the macro at the rule's count."""
    assert _built_key_chunks() == fb.ATTN_KEY_CHUNKS == tuple(range(1, 14))
    rule = re.search(r"constexpr int attn_key_chunks\(int n\) \{ return \(n \+ 15\) / 16; \}",
                     (CSRC / "layer_tiles.cuh").read_text())
    assert rule, "attn_key_chunks is not ceil(n / 16) in csrc/layer_tiles.cuh"
    text = (CSRC / "attention_rows.cu").read_text()
    assert "const int kt = attn_key_chunks(n);" in text and "VIT_ATTN_KEY_CHUNKS(VIT_ATTN_ROWS_CASE)" in text


@pytest.mark.parametrize("n", [0, fb.ATTN_MAX_KEYS + 1])
def test_key_chunks_refuses_outside_the_gate(n):
    with pytest.raises(ValueError, match="n="):
        fb.attention_key_chunks(n)


def test_mirrored_constants():
    assert fb.ATTN_MAX_KEYS == 16 * _csrc_int("common.cuh", "kAttnKT") == 16 * max(_built_key_chunks())
    assert fb.ATTN_DIM_HEAD == _csrc_int("common.cuh", "kAttnDh")
    assert fb.ATTN_Q_TILE == _csrc_int("common.cuh", "kAttnQT")
    assert fb.GEMM_BM == _csrc_int("layer_tiles.cuh", "kGemmBM")
    assert fb.GEMM_BK == _csrc_int("layer_tiles.cuh", "kGemmBK")
    # the entry points refuse what the gates refuse
    assert "n > 16 * kAttnKT" in (CSRC / "attention_rows.cu").read_text()
    assert "K % kGemmBK" in (CSRC / "gemm_bf16.cu").read_text()


def _jax_layer_rows_attention(qkv, heads, dim_head, scale, n_keys):
    """The per-head loop of _layer_rows (:1021-1037) for each image, with the
    padded prototypes' -inf key bias beyond n_keys (bench_layer_fused.py:
    267-268) before _softmax_from_dots."""
    b, n, _ = qkv.shape
    inner = heads * dim_head
    imgs = []
    for i in range(b):
        rows = jnp.asarray(qkv[i])
        outs = []
        for h in range(heads):
            q = rows[:, h * dim_head:(h + 1) * dim_head]
            k = rows[:, inner + h * dim_head:inner + (h + 1) * dim_head]
            v = rows[:, 2 * inner + h * dim_head:2 * inner + (h + 1) * dim_head]
            dots = jnp.dot(q, k.T, preferred_element_type=jnp.float32)
            if n_keys is not None:
                dots = jnp.where(jnp.arange(n) < n_keys, dots, -jnp.inf)
            p = _softmax_from_dots(dots, scale)
            outs.append(jnp.dot(p.astype(rows.dtype), v, preferred_element_type=jnp.float32).astype(rows.dtype))
        imgs.append(jnp.concatenate(outs, axis=-1))
    return np.asarray(jnp.stack(imgs))


@pytest.mark.parametrize("n", [64, 68, 197, 208])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_rows_reference_matches_jax_layer_rows(n, masked):
    heads, dim_head, b = 2, 64, 2
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((b, n, 3 * heads * dim_head)).astype(np.float32)
    n_keys = n - 5 if masked else None
    scale = dim_head**-0.5
    want = _jax_layer_rows_attention(qkv, heads, dim_head, scale, n_keys)
    got = fb.attention_rows_reference(torch.from_numpy(qkv), heads=heads, dim_head=dim_head, scale=scale,
                                      n_keys=n_keys)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # on a CPU tensor the wrapper is the twin
    assert torch.equal(fb.attention_rows(torch.from_numpy(qkv), heads=heads, dim_head=dim_head, scale=scale,
                                         n_keys=n_keys), got)


# ---- attention_bwd_rows: its key chunks and its twin ----

@pytest.mark.parametrize("n", range(1, fb.ATTN_MAX_KEYS + 1))
def test_backward_key_chunks_rule(n):
    """attention_bwd_rows runs the forward's rule at every n the gate
    admits: ceil(n / 16), an instantiation csrc/attention_bwd_rows.cu builds
    (its launcher's switch over VIT_ATTN_KEY_CHUNKS at attn_key_chunks(n),
    in csrc/attention_bwd_rows.cuh), with one
    keep word a row for each 32 of its 16 ceil(n / 16) keys."""
    entry, kernel = (CSRC / "attention_bwd_rows.cu").read_text(), (CSRC / "attention_bwd_rows.cuh").read_text()
    assert "const int kt = attn_key_chunks(n);" in entry and "n > 16 * kAttnKT" in entry
    assert "VIT_ATTN_KEY_CHUNKS(VIT_ATTN_BWD_CASE)" in kernel
    for variant in ("dropout", "qknorm", "dropout_qknorm"):  # a source a variant, each on the same switch
        assert f"attention_bwd_launch_{variant}(" in (CSRC / f"attention_bwd_rows_{variant}.cu").read_text()
    kt = fb.attention_key_chunks(n)
    assert kt == _brute_key_chunks(n) and kt in _built_key_chunks()
    assert 16 * kt >= n > 16 * (kt - 1)
    assert -(-kt // 2) == -(-16 * kt // 32)  # the wrapper's keep words, attn_keep_words(kt)


def _jax_bwd_heads(qkv, dm, heads, dim_head, scale, gq=None, gk=None):
    """The per-head loop of _bwd_kernel (vit_pytorch_tpu/ops/fused_block.py:
    608-692) for each image at dropout 0, in fp32: q.k^T by dot_general,
    _softmax_from_dots, m = p.v, dv = p^T.dm, dp = dm.v^T, ds = p (dp -
    rowsum(dp p)), dq = ds.k scale, dk = ds^T.q scale, with the gammas the
    norm's recompute and closing and dgamma = sum of d * xhat times sqrt(dh)
    over every row of the batch.  Returns m, dqkv (and dgamma_q, dgamma_k)."""
    b, n, _ = qkv.shape
    inner = heads * dim_head
    root = float(dim_head) ** 0.5
    nt = (((1,), (1,)), ((), ()))  # a . b^T
    tn = (((0,), (0,)), ((), ()))  # a^T . b
    ms, dqkvs = [], []
    dgq, dgk = jnp.zeros((inner,), jnp.float32), jnp.zeros((inner,), jnp.float32)
    for i in range(b):
        rows, drows = jnp.asarray(qkv[i]), jnp.asarray(dm[i])
        outs, dqs, dks, dvs, dgqs, dgks = [], [], [], [], [], []
        for hh in range(heads):
            cols = slice(hh * dim_head, (hh + 1) * dim_head)
            q = rows[:, cols]
            k = rows[:, inner + hh * dim_head:inner + (hh + 1) * dim_head]
            v = rows[:, 2 * inner + hh * dim_head:2 * inner + (hh + 1) * dim_head]
            if gq is not None:
                g_q, g_k = jnp.asarray(gq[cols]) * root, jnp.asarray(gk[cols]) * root
                rq = jax.lax.rsqrt(jnp.sum(q * q, axis=-1, keepdims=True) + 1e-12)
                rk = jax.lax.rsqrt(jnp.sum(k * k, axis=-1, keepdims=True) + 1e-12)
                qhat, khat = q * rq, k * rk
                q, k = qhat * g_q[None, :], khat * g_k[None, :]
            p = _softmax_from_dots(jax.lax.dot_general(q, k, nt, preferred_element_type=jnp.float32), scale)
            outs.append(jnp.dot(p, v, preferred_element_type=jnp.float32))
            dm_h = drows[:, cols]
            dv = jax.lax.dot_general(p, dm_h, tn, preferred_element_type=jnp.float32)
            dp = jax.lax.dot_general(dm_h, v, nt, preferred_element_type=jnp.float32)
            ds = p * (dp - jnp.sum(dp * p, axis=-1, keepdims=True))
            dq = jnp.dot(ds, k, preferred_element_type=jnp.float32) * scale
            dk = jax.lax.dot_general(ds, q, tn, preferred_element_type=jnp.float32) * scale
            if gq is not None:
                dgqs.append(jnp.sum(dq * qhat, axis=0))
                dgks.append(jnp.sum(dk * khat, axis=0))
                dqh, dkh = dq * g_q[None, :], dk * g_k[None, :]
                dq = rq * (dqh - qhat * jnp.sum(dqh * qhat, axis=-1, keepdims=True))
                dk = rk * (dkh - khat * jnp.sum(dkh * khat, axis=-1, keepdims=True))
            dqs.append(dq)
            dks.append(dk)
            dvs.append(dv)
        ms.append(jnp.concatenate(outs, axis=-1))
        dqkvs.append(jnp.concatenate(dqs + dks + dvs, axis=-1))
        if gq is not None:
            dgq = dgq + jnp.concatenate(dgqs) * root
            dgk = dgk + jnp.concatenate(dgks) * root
    out = (np.asarray(jnp.stack(ms)), np.asarray(jnp.stack(dqkvs)))
    return out if gq is None else (*out, np.asarray(dgq), np.asarray(dgk))


@pytest.mark.parametrize("n", [64, 68, 197, 208])
@pytest.mark.parametrize("qknorm", [False, True])
def test_attention_bwd_rows_reference_matches_jax_bwd_kernel(n, qknorm):
    """attention_bwd_rows_reference (the kernel's twin, whose arithmetic the
    chip holds the kernel to) against _bwd_kernel's per-head loop rebuilt in
    JAX, fp32, no dropout (no bits drawn), at the key counts whose
    instantiations the chip runs (4, 5 and 13 chunks of 16, 208 with none
    padded): only the f32 summation order differs."""
    heads, dim_head, b = 2, 64, 2
    rng = np.random.default_rng(1000 + n + qknorm)
    qkv = rng.standard_normal((b, n, 3 * heads * dim_head)).astype(np.float32)
    dm = rng.standard_normal((b, n, heads * dim_head)).astype(np.float32)
    gq = gk = None
    if qknorm:
        gq, gk = (1 + 0.2 * rng.standard_normal((2, heads * dim_head))).astype(np.float32)
    scale = dim_head**-0.5
    want = _jax_bwd_heads(qkv, dm, heads, dim_head, scale, gq, gk)
    gammas = {} if gq is None else dict(gamma_q=torch.from_numpy(gq), gamma_k=torch.from_numpy(gk))
    got = fb.attention_bwd_rows_reference(torch.from_numpy(qkv), torch.from_numpy(dm), heads=heads,
                                          dim_head=dim_head, scale=scale, **gammas)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, **TOL)


# ---- gemm_wgrad's work split ----

WGRAD_SHAPES = [(768, 3072, 25216), (3072, 768, 25216), (768, 768, 25216), (2304, 768, 25216),
                (3072, 768, 201728), (768, 3072, 183 * 8), (200, 264, 183), (8, 8, 1), (136, 1000, 64 * 7 + 1)]


@pytest.mark.parametrize("m,n,k", WGRAD_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_wgrad_pieces_cover_every_k_tile_once_in_order(m, n, k, sms):
    """gemm_wgrad's persistent walk against brute force: every k-tile of
    every output tile is added exactly once, in ascending k within a piece;
    a stream-K tile's pieces come from consecutive blocks, their indices
    0..P-1 and their slots shared by no other piece; every block gets the
    same share of each whole chunk; blocks, chunk and the pieces are a
    function of (M, N, K, SM count) alone."""
    blocks, chunk = fb.gemm_wgrad_blocks(m, n, k, sms)
    assert (blocks, chunk) == fb.gemm_wgrad_blocks(m, n, k, sms) and blocks == sms
    ktiles = -(-k // fb.WGRAD_BK)
    tiles = -(-m // fb.WGRAD_BM) * -(-n // fb.WGRAD_BN)
    full, rem = divmod(tiles, blocks)
    if rem:
        assert chunk == min(ktiles, blocks // math.gcd(rem, blocks))
        assert chunk == ktiles or rem * chunk % blocks == 0  # every block the same share of a chunk
    walk = fb.gemm_wgrad_pieces(m, n, k, blocks, chunk)
    assert walk == fb.gemm_wgrad_pieces(m, n, k, blocks, chunk)
    chunks = -(-ktiles // chunk) if rem else 0
    lengths = [sum(len(p[1]) for p in pieces) for pieces in walk]
    assert max(lengths) <= sum(lengths) / blocks + chunk  # only the last, shorter chunk is uneven
    covered, slots, by_tile = {}, [], {}
    for b, pieces in enumerate(walk):
        assert len(pieces) <= full + 2
        for piece in pieces:
            tile, kts = piece[:2]
            assert kts == sorted(kts)
            for kt in kts:
                covered[(tile, kt)] = covered.get((tile, kt), 0) + 1
            if len(piece) > 2:
                slot, index, count = piece[2:]
                assert tile >= full * blocks and slot == tile - full * blocks + b
                slots.append(slot)
                by_tile.setdefault(tile, []).append((b, index, count))
            else:
                assert len(kts) == ktiles and tile % blocks == b
    assert covered == {(t, kt): 1 for t in range(tiles) for kt in range(ktiles)}
    assert len(slots) == len(set(slots)) and all(s < rem + blocks for s in slots)
    assert sorted(by_tile) == list(range(full * blocks, tiles))
    for tile, ps in by_tile.items():
        assert [p[1] for p in ps] == list(range(len(ps))) and all(p[2] == len(ps) for p in ps)
        assert [p[0] for p in ps] == list(range(ps[0][0], ps[0][0] + len(ps)))


def test_wgrad_walk_mirrors_the_kernel():
    """The Python walk is the kernel's: the same block-of-unit rule, range
    cut, slot and k-tile constants."""
    text = (CSRC / "gemm_wgrad.cu").read_text()
    assert "((u + 1) * blocks - 1) / units" in text and "units < blocks ? static_cast<int>(units) : blocks" in text
    assert "b * units / blocks, e = (b + 1) * units / blocks" in text
    assert "ts + blockIdx.x" in text and "ts + b0" in text and "rem = tiles % blocks" in text
    assert fb.WGRAD_BM == _csrc_int("gemm_wgrad.cu", "kWgBM")
    assert fb.WGRAD_BK == _csrc_int("gemm_wgrad.cu", "kWgBK")
    assert fb.WGRAD_BN == _csrc_int("gemm_wgrad.cu", "kWgBN")
