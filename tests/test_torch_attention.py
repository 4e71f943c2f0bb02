"""The port's materialized attention (vit_pytorch_tpu_torch/ops/attention.py)
against the JAX package's ``xla_attention`` on the CPU, fp32, with the
options the ported signature keeps: additive bias, boolean mask (a fully
masked row gives zeros) and the returned attention matrix."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    """Only the kernel routes still to port raise, and only when asked for;
    the composite takes causal attention (tests/test_torch_attention_dispatch.py)."""
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dot_product_attention(q, q, q, use_flash=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dot_product_attention(q, q, q, causal=True, use_flash=True)
    assert dot_product_attention(q, q, q, causal=True).shape == q.shape
