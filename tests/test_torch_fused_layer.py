"""The port's whole-layer forward (vit_pytorch_tpu_torch/ops/fused_block.py)
against the JAX ``fused_transformer_layer`` in interpret mode, on the CPU in
fp32, at the shapes of tests/test_fused_layer.py.  On CPU tensors the port
runs its plain twin ``layer_reference`` and launches no kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops.fused_block import fused_transformer_layer as jax_layer
from vit_pytorch_tpu_torch.ops import fused_block as port

B, H, N, D = 2, 4, 23, 16
DIM = H * D
MLP = 2 * DIM
ATOL, RTOL = 3e-5, 1e-4  # fp32, as tests/test_fused_layer.py holds the kernel


def _inputs(qkv_bias):
    """numpy arrays in the JAX layout: Dense kernels (in, out)."""
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(
        x=f(B, N, DIM),
        w_qkv=f(DIM, 3 * DIM, scale=0.05),
        b_qkv=f(3 * DIM, scale=0.05) if qkv_bias else None,
        w_out=f(DIM, DIM, scale=0.05),
        b_out=f(DIM, scale=0.05),
        ln1s=1.0 + f(DIM, scale=0.1),
        ln1b=f(DIM, scale=0.1),
        ln2s=1.0 + f(DIM, scale=0.1),
        ln2b=f(DIM, scale=0.1),
        w1=f(DIM, MLP, scale=0.05),
        b1=f(MLP, scale=0.05),
        w2=f(MLP, DIM, scale=0.05),
        b2=f(DIM, scale=0.05),
    )


def _port_args(a):
    t = lambda v: None if v is None else torch.from_numpy(v)
    w = lambda v: torch.from_numpy(np.ascontiguousarray(v.T))  # nn.Linear's (out, in)
    pos = (
        t(a["x"]), w(a["w_qkv"]), w(a["w_out"]), t(a["ln1s"]), t(a["ln1b"]),
        t(a["ln2s"]), t(a["ln2b"]), w(a["w1"]), t(a["b1"]), w(a["w2"]), t(a["b2"]),
    )
    return pos, dict(heads=H, dim_head=D, b_qkv=t(a["b_qkv"]), b_out=t(a["b_out"]))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_port_layer_matches_jax_kernel(qkv_bias):
    a = _inputs(qkv_bias)
    j = {k: None if v is None else jnp.asarray(v) for k, v in a.items()}
    want = jax_layer(
        j["x"], j["w_qkv"], j["w_out"], j["ln1s"], j["ln1b"], j["ln2s"], j["ln2b"],
        j["w1"], j["b1"], j["w2"], j["b2"],
        heads=H, dim_head=D, b_qkv=j["b_qkv"], b_out=j["b_out"], interpret=True,
    )
    port.reset_launch_counts()
    pos, kw = _port_args(a)
    got = port.fused_transformer_layer(*pos, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert not any(port.LAUNCHES.values()) and not any(port.GEMM_LAUNCHES.values())


def test_cpu_wrappers_are_their_plain_twins():
    """Each kernel wrapper on a CPU tensor is exactly its plain twin."""
    pos, kw = _port_args(_inputs(qkv_bias=True))
    x, w_qkv, w_out, ln1s, ln1b, _, _, w1, b1, w2, b2 = pos
    h = port.layernorm_rows(x, ln1s, ln1b)
    assert torch.equal(h, port.layernorm_rows_reference(x, ln1s, ln1b))
    qkv = port.gemm_bf16(h, w_qkv, "qkv", bias=kw["b_qkv"])
    assert torch.equal(qkv, port.gemm_bf16_reference(h, w_qkv, "qkv", bias=kw["b_qkv"]))
    m = port.attention_rows(qkv, heads=H, dim_head=D, scale=D**-0.5)
    assert torch.equal(m, port.attention_rows_reference(qkv, heads=H, dim_head=D, scale=D**-0.5))
    assert m.shape == (B, N, DIM)


def test_layer_refuses_grad():
    """The layer is differentiable (its autograd Function runs the kernels
    with grad off); a direct kernel call on an operand that requires grad
    is refused."""
    pos, kw = _port_args(_inputs(qkv_bias=False))
    pos[0].requires_grad_(True)
    out = port.fused_transformer_layer(*pos, **kw)
    assert type(out.grad_fn).__name__ == "_FusedLayerBackward"
    with pytest.raises(ValueError, match="requires grad"):
        port._check_operands("layernorm_rows", torch.device("cuda"), pos[0].bfloat16())


def test_gate_admits_the_flagship_and_refuses_what_the_kernels_cannot_take():
    bf16 = torch.bfloat16
    for b in (1, 8, 32, 128):  # every Predictor bucket of ViT-B/16 @224
        assert port.whole_layer_supported((b, 197, 768), bf16, 12, 64, 768, 3072)
    # attention_rows' shared memory, (q-tile + k + v rows) x (dh + 8) bf16, is
    # under the 232,448-byte block limit; registers bind n, not shared memory
    assert (port.ATTN_Q_TILE + 2 * port.ATTN_MAX_KEYS) * (64 + 8) * 2 == 69_120 <= 232_448
    assert port.whole_layer_supported((8, 208, 768), bf16, 12, 64, 768, 3072)
    assert not port.whole_layer_supported((8, 197, 768), torch.float32, 12, 64, 768, 3072)
    # the JAX width ladder on the wide kernels: ViT-H/14 and ViT-g/14 at their bench batches, ViT-L/14,
    # the dim_head 32 / 128 ViT-Bs, 209 tokens (the narrow kernels' edge) and ViT-B/16 @384
    assert port.whole_layer_supported((64, 257, 1280), bf16, 16, 80, 1280, 5120)
    assert port.whole_layer_supported((64, 257, 1408), bf16, 16, 88, 1408, 6144)
    assert port.whole_layer_supported((8, 257, 1024), bf16, 16, 64, 1024, 4096)
    assert port.whole_layer_supported((128, 197, 768), bf16, 24, 32, 768, 3072)
    assert port.whole_layer_supported((128, 197, 768), bf16, 6, 128, 768, 3072)
    assert port.whole_layer_supported((8, 209, 768), bf16, 12, 64, 768, 3072)
    assert port.whole_layer_supported((8, 577, 768), bf16, 12, 64, 768, 3072)
    # the wide kernels' edges: 578 tokens, dh 88 past 577, dh 72 (SigLIP so400m's, not built)
    assert not port.whole_layer_supported((8, 578, 768), bf16, 12, 64, 768, 3072)
    assert not port.whole_layer_supported((8, 578, 1408), bf16, 16, 88, 1408, 6144)
    assert not port.whole_layer_supported((8, 256, 1152), bf16, 16, 72, 1152, 4352)
    assert not port.whole_layer_supported((8, 197, 768), bf16, 12, 64, 1024, 3072)  # d != dim
