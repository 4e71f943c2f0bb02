"""The port's whole-layer backward (vit_pytorch_tpu_torch/ops/fused_block.py)
against the JAX package on the CPU in fp32, at the shapes of
tests/test_fused_layer.py: the plain twin of the attention-block backward
against ``_pallas_backward`` in interpret mode, output for output; the
differentiable layer's 13 operand gradients against ``jax.grad`` of the JAX
``fused_transformer_layer``; and each new kernel wrapper, which on a CPU
tensor is exactly its twin and on any other device refuses before launching.

Tolerances: both sides compute in fp32 and differ only in summation order;
the readings are max_abs <= 1.5e-6 for the backward outputs and <= 6e-6 for
the layer's gradients (|grad| up to ~37), so the bounds are about 10x those
and stay inside the JAX test's own grad bar (atol 5e-4, rtol 2e-3,
tests/test_fused_layer.py:85)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu_torch.ops import fused_block as port

B, H, N, D = 2, 4, 23, 16
DIM = H * D
MLP = 2 * DIM
BWD_ATOL, BWD_RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 2e-4
DROP_RATE, DROP_SEED = 0.1, 77
# the JAX order of fused_transformer_layer's differentiable operands
OPERANDS = ("x", "w_qkv", "b_qkv", "w_out", "b_out", "ln1s", "ln1b", "ln2s", "ln2b", "w1", "b1", "w2", "b2")
KERNELS = ("w_qkv", "w_out", "w1", "w2")  # Dense (in, out) in JAX, Linear (out, in) in the port


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(
        x=f(B, N, DIM), g=f(B, N, DIM),
        w_qkv=f(DIM, 3 * DIM, scale=0.05), b_qkv=f(3 * DIM, scale=0.05),
        w_out=f(DIM, DIM, scale=0.05), b_out=f(DIM, scale=0.05),
        ln1s=1.0 + f(DIM, scale=0.1), ln1b=f(DIM, scale=0.1),
        ln2s=1.0 + f(DIM, scale=0.1), ln2b=f(DIM, scale=0.1),
        w1=f(DIM, MLP, scale=0.05), b1=f(MLP, scale=0.05),
        w2=f(MLP, DIM, scale=0.05), b2=f(DIM, scale=0.05),
    )


def _torch(a, name):
    v = a[name]
    return torch.from_numpy(np.ascontiguousarray(v.T) if name in KERNELS else v.copy())


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_block_bwd_matches_jax_pallas_backward(monkeypatch, qkv_bias):
    """``attention_block_bwd_reference`` against ``_pallas_backward`` in
    interpret mode: dx_ln, the kernel's emitted h, dqkv and m (read from the
    pallas_call), dW_qkv, dW_out, dgamma, dbeta, and db_qkv with a bias."""
    a = _arrays()
    captured = {}
    pallas_call = jax_fb.pl.pallas_call

    def spy(*args, **kwargs):
        call = pallas_call(*args, **kwargs)

        def run(*operands):
            captured["out"] = call(*operands)
            return captured["out"]

        return run

    monkeypatch.setattr(jax_fb.pl, "pallas_call", spy)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    dx, dw_qkv, db_qkv, dw_out, dgamma, dbeta, *_ = jax_fb._pallas_backward(
        j["x"], j["g"], j["w_qkv"], j["b_qkv"] if qkv_bias else None, j["w_out"], j["ln1s"], j["ln1b"],
        heads=H, dim_head=D, scale=D**-0.5, eps=1e-5, interpret=True,
    )
    _, h, dqkv, m, _, _ = captured["out"]

    t = lambda name: _torch(a, name)
    got = port.attention_block_bwd_reference(
        t("x"), t("g"), t("w_qkv"), t("b_qkv") if qkv_bias else None, t("w_out"), t("ln1s"), t("ln1b"),
        heads=H, dim_head=D,
    )
    want = dict(dx=dx, h=h, dqkv=dqkv, m=m, dW_qkv=dw_qkv.T, dW_out=dw_out.T, dgamma=dgamma, dbeta=dbeta)
    if qkv_bias:
        want["db_qkv"] = db_qkv
    else:
        assert got.db_qkv is None
    for name, w in want.items():
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(w), atol=BWD_ATOL, rtol=BWD_RTOL, err_msg=name
        )


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_layer_grads_match_jax(qkv_bias):
    """``torch.autograd.grad`` through the port's layer Function on CPU
    tensors, on every one of the 13 operands, against ``jax.grad`` of the JAX
    whole-layer kernel's custom_vjp in interpret mode (loss sum(out^2), as
    tests/test_fused_layer.py:62-86)."""
    a = _arrays(seed=1)
    names = [n for n in OPERANDS if qkv_bias or n != "b_qkv"]

    def jax_loss(*values):
        v = dict(zip(names, values))
        out = jax_fb.fused_transformer_layer(
            v["x"], v["w_qkv"], v["w_out"], v["ln1s"], v["ln1b"], v["ln2s"], v["ln2b"], v["w1"], v["b1"],
            v["w2"], v["b2"], heads=H, dim_head=D, b_qkv=v.get("b_qkv"), b_out=v["b_out"], interpret=True,
        )
        return jnp.sum(out**2)

    want = jax.grad(jax_loss, argnums=tuple(range(len(names))))(*(jnp.asarray(a[n]) for n in names))

    leaves = {n: _torch(a, n).requires_grad_() for n in names}
    port.reset_launch_counts()
    out = port.fused_transformer_layer(
        leaves["x"], leaves["w_qkv"], leaves["w_out"], leaves["ln1s"], leaves["ln1b"], leaves["ln2s"],
        leaves["ln2b"], leaves["w1"], leaves["b1"], leaves["w2"], leaves["b2"],
        heads=H, dim_head=D, b_qkv=leaves.get("b_qkv"), b_out=leaves["b_out"],
    )
    assert type(out.grad_fn).__name__ == "_FusedLayerBackward"
    got = torch.autograd.grad((out**2).sum(), [leaves[n] for n in names])
    for name, g, w in zip(names, got, want):
        g = g.numpy().T if name in KERNELS else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    assert not any(port.LAUNCHES.values())


def _wrapper_cases(heads=H, dim_head=D):
    """(name, wrapper call, twin call) of the backward's wrappers and the
    attention block's dropout wrappers, on the inputs ``t`` (a dict of
    tensors)."""
    akw = dict(heads=heads, dim_head=dim_head, scale=dim_head**-0.5)
    dkw = dict(dropout_rate=DROP_RATE, seed=DROP_SEED)
    return {
        "attention_bwd_rows": (
            lambda t: port.attention_bwd_rows(t["qkv"], t["dm"], **akw),
            lambda t: port.attention_bwd_rows_reference(t["qkv"], t["dm"], **akw),
        ),
        "gemm_f32out": (
            lambda t: port.gemm_f32out(t["dqkv"], t["w_qkv_t"]),
            lambda t: port.gemm_f32out_reference(t["dqkv"], t["w_qkv_t"]),
        ),
        "layernorm_bwd_rows": (
            lambda t: port.layernorm_bwd_rows(t["x"], t["dh"], t["ln1s"], residual=t["g"]),
            lambda t: port.layernorm_bwd_rows_reference(t["x"], t["dh"], t["ln1s"], residual=t["g"]),
        ),
        "gemm_bf16[cast]": (
            lambda t: port.gemm_bf16(t["g"], t["w_out_t"], "cast"),
            lambda t: port.gemm_bf16_reference(t["g"], t["w_out_t"], "cast"),
        ),
        # the attention block's dropout kernels and variants
        "attention_rows[dropout]": (
            lambda t: port.attention_rows(t["qkv"], **akw, **dkw),
            lambda t: port.attention_rows_reference(t["qkv"], **akw, **dkw),
        ),
        "gemm_bf16[block_out]": (
            lambda t: port.gemm_bf16(t["x"], t["w_out_t"], "block_out", bias=t["b_out"], residual=t["g"],
                                     heads=heads, **dkw),
            lambda t: port.gemm_bf16_reference(t["x"], t["w_out_t"], "block_out", bias=t["b_out"], residual=t["g"],
                                               heads=heads, **dkw),
        ),
        "dropout_apply": (
            lambda t: port.dropout_apply(t["g"], DROP_SEED, heads=heads, rate=DROP_RATE),
            lambda t: port.out_dropout_bwd_reference(t["g"], DROP_SEED, heads=heads, rate=DROP_RATE),
        ),
        "attention_bwd_rows[dropout]": (
            lambda t: port.attention_bwd_rows(t["qkv"], t["dm"], **akw, **dkw),
            lambda t: port.attention_bwd_rows_reference(t["qkv"], t["dm"], **akw, **dkw),
        ),
        "dropout_masks": (
            lambda t: port.dropout_masks(DROP_SEED, B, N, DIM, heads, DROP_RATE, device=t["x"].device),
            lambda t: port.dropout_masks_reference(DROP_SEED, B, N, DIM, heads, DROP_RATE, device="cpu"),
        ),
    }


def _wrapper_inputs(dtype=torch.float32):
    a = _arrays(seed=2)
    rng = np.random.default_rng(3)
    t = {k: _torch(a, k).to(dtype) for k in ("x", "g", "ln1s")}
    t["qkv"] = torch.from_numpy(rng.standard_normal((B, N, 3 * DIM)).astype(np.float32)).to(dtype)
    t["dm"] = torch.from_numpy(rng.standard_normal((B, N, DIM)).astype(np.float32)).to(dtype)
    t["dqkv"] = t["qkv"] * 0.1
    t["w_qkv_t"] = torch.from_numpy(a["w_qkv"].copy()).to(dtype)  # W_qkv^T in the (out, in) layout: (dim, 3*inner)
    t["w_out_t"] = torch.from_numpy(a["w_out"].copy()).to(dtype)
    t["dh"] = torch.from_numpy(rng.standard_normal((B, N, DIM)).astype(np.float32))  # f32, as gemm_f32out gives it
    t["b_out"] = _torch(a, "b_out").to(dtype)
    return t


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_cpu_wrappers_are_their_twins(name):
    """On CPU tensors (fp32 and bf16) each backward wrapper is exactly its
    plain twin and counts no launch."""
    wrapper, twin = _wrapper_cases()[name]
    port.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        t = _wrapper_inputs(dtype)
        got, want = _flat(wrapper(t)), _flat(twin(t))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert not any(port.LAUNCHES.values())


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_wrappers_refuse_tensors_off_the_card(name):
    """A tensor that is neither on the CPU nor on a CUDA device reaches the
    kernel path, which refuses it before loading or launching anything (at
    shapes the kernels take: one head of 64)."""
    wrapper, _ = _wrapper_cases(heads=1, dim_head=port.ATTN_DIM_HEAD)[name]
    t = {k: v.to("meta") for k, v in _wrapper_inputs(torch.bfloat16).items()}
    t["dh"] = t["dh"].float()
    port.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(t)
    assert not any(port.LAUNCHES.values())
