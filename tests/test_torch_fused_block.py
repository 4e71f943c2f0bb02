"""The port's attention block (vit_pytorch_tpu_torch/ops/fused_block.py::
fused_attention_block) against the JAX package on the CPU in fp32, at the
shapes of tests/test_fused_block.py.  On CPU tensors the port's Function
runs its plain twins.

- At rate 0 against the JAX ``fused_attention_block(..., interpret=True)``,
  whose forward and backward are the Pallas ``_kernel`` and ``_bwd_kernel``
  in interpret mode: output and every operand gradient of sum(out^2).
- At rate 0.1 against a JAX composite that consumes the port's masks
  (after ``_ref_with_masks``, tests/test_fused_dropout.py:84-114), with
  ``jax.grad``: the JAX kernel's own masks come from the TPU PRNG, which has
  no interpret lowering (fused_block.py:2209-2215).

With qk-norm (``gamma_q``/``gamma_k``, module-shaped (H, 1, D)) the same two
comparisons hold every gradient, dgamma_q and dgamma_k included, as
tests/test_fused_qknorm.py:40-110 holds the JAX kernel.

Tolerance atol 5e-5 (the JAX package's fp32 parity bar) and rtol 1e-4: both
sides compute in fp32 and differ in summation order and exp vs exp2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ops import fused_block as port

B, H, N, D = 2, 4, 23, 16
DIM = H * D
ATOL, RTOL = 5e-5, 1e-4
RATE, SEED = 0.1, 1234
KERNELS = ("w_qkv", "w_out")  # Dense (in, out) in JAX, Linear (out, in) in the port


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(
        x=f(B, N, DIM), res=f(B, N, DIM),
        w_qkv=f(DIM, 3 * DIM, scale=0.05), b_qkv=f(3 * DIM, scale=0.05),
        w_out=f(DIM, DIM, scale=0.05), b_out=f(DIM, scale=0.05),
        ln_s=1.0 + f(DIM, scale=0.1), ln_b=f(DIM, scale=0.1),
        # module-shaped (heads, 1, dim_head) qk-norm gammas, non-trivial values
        gq=1.0 + f(H, 1, D, scale=0.2), gk=1.0 + f(H, 1, D, scale=0.2),
    )


def _names(residual, qkv_bias, out_bias, qk_norm=False):
    return [n for n in ("x", "res", "w_qkv", "w_out", "ln_s", "ln_b", "b_qkv", "b_out", "gq", "gk")
            if not ((n == "res" and residual != "other") or (n == "b_qkv" and not qkv_bias)
                    or (n == "b_out" and not out_bias) or (n in ("gq", "gk") and not qk_norm))]


def _port(a, names, residual, **kw):
    """Output and gradients of sum(out^2) through the port's block."""
    leaves = {n: torch.from_numpy(np.ascontiguousarray(a[n].T) if n in KERNELS else a[n].copy()).requires_grad_()
              for n in names}
    res = leaves["x"] if residual == "x" else leaves.get("res")
    out = port.fused_attention_block(
        leaves["x"], res, leaves["w_qkv"], leaves["w_out"], leaves["ln_s"], leaves["ln_b"], heads=H, dim_head=D,
        b_qkv=leaves.get("b_qkv"), b_out=leaves.get("b_out"), gamma_q=leaves.get("gq"), gamma_k=leaves.get("gk"),
        **kw,
    )
    assert type(out.grad_fn).__name__ == "_FusedAttentionBlockBackward"
    grads = torch.autograd.grad((out**2).sum(), [leaves[n] for n in names])
    return out.detach().numpy(), [g.numpy().T if n in KERNELS else g.numpy() for n, g in zip(names, grads)]


def _check(names, got, want):
    (out, grads), (out_w, grads_w) = got, want
    np.testing.assert_allclose(out, np.asarray(out_w), atol=ATOL, rtol=RTOL, err_msg="out")
    for n, g, w in zip(names, grads, grads_w):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL, err_msg=f"d{n}")


CASES = [("x", True, True), ("other", False, True), (None, True, False), ("x", False, False)]


def _jax_kernel_grads(a, names, residual):
    """Output and gradients of sum(out^2) through the JAX block in interpret
    mode (its Pallas ``_kernel`` and ``_bwd_kernel``)."""

    def jax_loss(*values):
        v = dict(zip(names, values))
        res = v["x"] if residual == "x" else v.get("res")
        out = jax_fb.fused_attention_block(
            v["x"], res, v["w_qkv"], v["w_out"], v["ln_s"], v["ln_b"], heads=H, dim_head=D,
            b_qkv=v.get("b_qkv"), b_out=v.get("b_out"), gamma_q=v.get("gq"), gamma_k=v.get("gk"), interpret=True,
        )
        return jnp.sum(out**2), out

    grads, out = jax.grad(jax_loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(a[n]) for n in names))
    return out, grads


@pytest.mark.parametrize("residual,qkv_bias,out_bias", CASES)
def test_block_matches_jax_kernel_at_rate_0(residual, qkv_bias, out_bias):
    """Residual x (the Transformer's call: the LayerNorm backward adds g),
    another tensor, or none; with and without the biases."""
    a = _arrays()
    names = _names(residual, qkv_bias, out_bias)
    port.reset_launch_counts()
    _check(names, _port(a, names, residual), _jax_kernel_grads(a, names, residual))
    assert not any(port.LAUNCHES.values())


@pytest.mark.parametrize("residual,qkv_bias,out_bias", CASES)
def test_qk_norm_block_matches_jax_kernel(residual, qkv_bias, out_bias):
    """The qk-norm block (scale 1 by default) against the JAX kernels with
    the same gammas: the output and every gradient, dgamma_q and dgamma_k
    in the gammas' (H, 1, D) shape included.  (None, False, False) is
    SimpleViT-qk-norm's call (bias-free out projection, residual added
    outside)."""
    a = _arrays(seed=3)
    names = _names(residual, qkv_bias, out_bias, qk_norm=True)
    port.reset_launch_counts()
    got = _port(a, names, residual)
    assert [g.shape for n, g in zip(names, got[1]) if n in ("gq", "gk")] == [(H, 1, D)] * 2
    _check(names, got, _jax_kernel_grads(a, names, residual))
    assert not any(port.LAUNCHES.values())


def _ref_with_masks(x, residual, w_qkv, b_qkv, w_out, b_out, lns, lnb, akeep, okeep, gq=None, gk=None):
    """XLA composite of ``_kernel``'s function with the masks injected (after
    tests/test_fused_dropout.py:84-114, in fp32, with both biases); with the
    gammas the qk-norm of ``_xla_reference`` (fused_block.py:400-411) and
    scale 1."""
    b, n, dim = x.shape
    inv = 1.0 / (1.0 - RATE)
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    ln = (x - mu) * jax.lax.rsqrt(var + 1e-5) * lns + lnb
    qkv = ln @ w_qkv
    if b_qkv is not None:
        qkv = qkv + b_qkv
    q, k, v = jnp.split(qkv, 3, axis=-1)
    rs = lambda t: t.reshape(b, n, H, D).transpose(0, 2, 1, 3)
    q, k, v = rs(q), rs(k), rs(v)
    scale = D**-0.5
    if gq is not None:
        rms = lambda t, g: t * jax.lax.rsqrt(jnp.sum(t * t, -1, keepdims=True) + 1e-12) * g.reshape(1, H, 1, D) * D**0.5
        q, k, scale = rms(q, gq), rms(k, gk), 1.0
    dots = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
    p = jax.nn.softmax(dots, axis=-1)
    p = jnp.where(akeep, p, 0.0) * inv
    o = jnp.einsum("bhnm,bhmd->bhnd", p, v).transpose(0, 2, 1, 3).reshape(b, n, H * D)
    out = o @ w_out
    if b_out is not None:
        out = out + b_out
    out = jnp.where(okeep, out, 0.0) * inv
    return out if residual is None else out + residual


@pytest.mark.parametrize("residual,qkv_bias,out_bias", CASES)
def test_block_with_dropout_matches_jax_composite_with_the_port_masks(residual, qkv_bias, out_bias):
    _check_dropout(_arrays(seed=1), _names(residual, qkv_bias, out_bias), residual)


@pytest.mark.parametrize("residual,qkv_bias,out_bias", CASES)
def test_qk_norm_block_with_dropout_matches_jax_composite_with_the_port_masks(residual, qkv_bias, out_bias):
    """qk-norm and dropout 0.1 together (the JAX kernels compose them, round
    4): every gradient, the gammas' included."""
    _check_dropout(_arrays(seed=4), _names(residual, qkv_bias, out_bias, qk_norm=True), residual)


def _check_dropout(a, names, residual):
    akeep, okeep = (jnp.asarray(m.numpy().astype(bool))
                    for m in port.dropout_masks(SEED, B, N, DIM, H, RATE, device="cpu"))

    def jax_loss(*values):
        v = dict(zip(names, values))
        res = v["x"] if residual == "x" else v.get("res")
        out = _ref_with_masks(v["x"], res, v["w_qkv"], v.get("b_qkv"), v["w_out"], v.get("b_out"), v["ln_s"],
                              v["ln_b"], akeep, okeep, v.get("gq"), v.get("gk"))
        return jnp.sum(out**2), out

    grads, out = jax.grad(jax_loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(a[n]) for n in names))
    _check(names, _port(a, names, residual, dropout_rate=RATE, dropout_seed=SEED), (out, grads))


def test_dropout_changes_the_block_and_the_seed_decides():
    a = _arrays(seed=2)
    names = _names("x", True, True)
    plain = _port(a, names, "x")[0]
    one = _port(a, names, "x", dropout_rate=RATE, dropout_seed=SEED)[0]
    again = _port(a, names, "x", dropout_rate=RATE, dropout_seed=SEED)[0]
    other = _port(a, names, "x", dropout_rate=RATE, dropout_seed=SEED + 1)[0]
    assert np.array_equal(one, again)
    assert not np.allclose(one, plain) and not np.allclose(one, other)


def _zeros(dim=64):
    z = torch.zeros
    return z(2, 8, dim), z(3 * dim, dim), z(dim, dim), torch.ones(dim), z(dim)


def test_dropout_requires_seed():
    x, w_qkv, w_out, s, b = _zeros()
    with pytest.raises(ValueError, match="dropout_seed"):
        port.fused_attention_block(x, None, w_qkv, w_out, s, b, heads=1, dim_head=64, dropout_rate=0.1)


def test_qk_norm_is_refused_until_its_slice():
    """The qk-norm slice is ported: with gammas the block no longer raises on
    the CPU (its twins run) and returns the block's output; one gamma alone
    is still refused."""
    x, w_qkv, w_out, s, b = _zeros()
    g = torch.ones(1, 64)
    out = port.fused_attention_block(x, None, w_qkv, w_out, s, b, heads=1, dim_head=64, gamma_q=g, gamma_k=g)
    assert out.shape == x.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="together"):
        port.fused_attention_block(x, None, w_qkv, w_out, s, b, heads=1, dim_head=64, gamma_q=g)


def test_block_refuses_shapes_the_kernels_cannot_take():
    """Off the CPU the block checks the gates before any launch."""
    x, w_qkv, w_out, s, b = (t.to("meta") for t in _zeros())
    with pytest.raises(ValueError, match="not supported by the kernels"):
        port.fused_attention_block(x, None, w_qkv, w_out, s, b, heads=1, dim_head=64)  # fp32


def test_gates_admit_vit_b_and_refuse_what_the_kernels_cannot_take():
    bf16 = torch.bfloat16
    for b in (1, 8, 32, 1024):
        assert port.fused_block_supported((b, 197, 768), bf16, 12, 64, 768)
        assert port.fused_dropout_supported((b, 197, 768), 12, 64)
    assert not port.fused_block_supported((8, 197, 768), torch.float32, 12, 64, 768)
    # the JAX width ladder on the wide kernels, forward and backward, with dropout: ViT-H/14, ViT-g/14,
    # ViT-L/14 (257 tokens), bench_d128.py's ViT-Bs at 24 x 32 and 6 x 128, ViT-B/16 @384 (577 tokens)
    for shape, heads, dh in (((8, 257, 1280), 16, 80), ((8, 257, 1408), 16, 88), ((8, 257, 1024), 16, 64),
                             ((8, 197, 768), 24, 32), ((8, 197, 768), 6, 128), ((8, 577, 768), 12, 64)):
        assert port.fused_block_supported(shape, bf16, heads, dh, shape[-1])
        assert port.fused_dropout_supported(shape, heads, dh)
    # the new edges: past 577 tokens, a head width not built, dim_head 256
    assert not port.fused_block_supported((8, 578, 768), bf16, 12, 64, 768)
    assert not port.fused_block_supported((8, 257, 1152), bf16, 16, 72, 1152)
    assert not port.fused_block_supported((8, 197, 768), bf16, 3, 256, 768)
    assert not port.fused_dropout_supported((8, 578, 1280), 16, 80)
    assert not port.fused_dropout_supported((8, 197, 768), 3, 256)
    assert not port.fused_block_supported((8, 197, 800), bf16, 12, 64, 800)  # dim % 64
    assert not port.fused_dropout_supported((8, 197, 768), 1024, 64)  # streams would collide
    # the whole layer needs what the block needs, and mlp_dim % 64
    assert port.whole_layer_supported((8, 197, 768), bf16, 12, 64, 768, 3072)
    assert not port.whole_layer_supported((8, 197, 768), bf16, 12, 64, 768, 3000)


def test_dropout_keeps_the_block_eligible(monkeypatch):
    """The reference-default ViT trains with dropout 0.1: on the card it
    takes the attention-block kernels (the JAX
    tests/test_fused_dropout.py:34-50, with ``on_cuda`` for ``on_tpu``)."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    x = torch.zeros(8, 197, 768, dtype=torch.bfloat16)
    common = dict(x=x, heads=12, dim_head=64, dim=768, flash=None, project_out=True)
    assert torch_blocks.fused_block_eligible(**common, dropout=0.0, train=True)
    assert torch_blocks.fused_block_eligible(**common, dropout=0.1, train=True)
    assert torch_blocks.fused_block_eligible(**common, dropout=0.1, train=False)
    assert not torch_blocks.fused_block_eligible(**{**common, "flash": False}, dropout=0.1, train=True)
    assert not torch_blocks.fused_block_eligible(**{**common, "x": x.float()})
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: False)
    assert not torch_blocks.fused_block_eligible(**common)
