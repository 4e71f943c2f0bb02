"""The host side of the layer chain's kernels (``csrc/gemm_bf16.cu``,
``csrc/attention_rows.cu``), on the CPU.

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
"""

import re
from pathlib import Path

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
