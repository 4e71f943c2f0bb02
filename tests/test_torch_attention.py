"""The port's materialized attention (vit_pytorch_tpu_torch/ops/attention.py)
against the JAX package's ``xla_attention`` on the CPU, fp32, with the
options the ported signature keeps: additive bias, boolean mask (a fully
masked row gives zeros) and the returned attention matrix; and the
dispatcher's kernel routes asked for with ``use_flash=True``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from vit_pytorch_tpu.ops.attention import xla_attention as jax_attention
from vit_pytorch_tpu_torch.ops.attention import dot_product_attention, xla_attention

B, H, N, M, D = 2, 3, 5, 7, 8
ATOL = 1e-6  # fp32, same operations in the same order up to summation


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, H, N, D), (B, H, M, D), (B, H, M, D)))
    bias = rng.standard_normal((B, H, N, M)).astype(np.float32)
    mask = rng.random((B, 1, N, M)) > 0.3
    mask[0, 0, 2] = False  # a query that may attend nothing
    return q, k, v, bias, mask


@pytest.mark.parametrize("with_bias,with_mask", [(False, False), (True, False), (False, True), (True, True)])
def test_xla_attention_matches_jax(with_bias, with_mask):
    q, k, v, bias, mask = _inputs()
    bias, mask = (bias if with_bias else None), (mask if with_mask else None)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    want_out, want_attn = jax_attention(j(q), j(k), j(v), bias=j(bias), mask=j(mask), return_attn=True)
    got_out, got_attn = xla_attention(t(q), t(k), t(v), bias=t(bias), mask=t(mask), return_attn=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), atol=ATOL, rtol=1e-5)


def test_dispatcher_raises_for_unported_routes():
    """No route raises any more: what ``use_flash=True`` asks for, the short
    kernel (no mask, m <= 1024) and flash with the causal mask, runs on the
    CPU on the kernels' plain twins and matches the JAX dispatcher's kernels
    in interpret mode (atol 2e-5); the composite takes causal attention as
    before (tests/test_torch_attention_dispatch.py)."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 4, 8)).astype(np.float32) for _ in range(3))
    for kw in (dict(), dict(causal=True)):
        want = jax_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_flash=True, **kw)
        got = dot_product_attention(*map(torch.from_numpy, (q, k, v)), use_flash=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    t = torch.from_numpy(q)
    assert dot_product_attention(t, t, t, causal=True).shape == t.shape
