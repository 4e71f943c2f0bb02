"""The port's opt-in backwards of the whole layer (vit_pytorch_tpu_torch/ops/
fused_block.py: ``_ff_backward``, the port of ``_ff_bwd_kernel``, and
``_layer_backward``, the port of ``_layer_bwd_kernel``) against the JAX
package on the CPU in fp32, the JAX kernels run in interpret mode as
tests/test_fused_layer.py:89-199 runs them:

- ``_ff_backward`` in ``full`` and ``hybrid`` against ``_ff_pallas_backward``
  at b=2, n=96 (three 64-row tiles of the JAX kernel), all seven outputs;
- the layer's 13 operand gradients under each switch (``VIT_TPU_FF_BWD=full``,
  ``=hybrid``, ``VIT_TPU_ENABLE_WHOLE_LAYER_BWD=1``, set on both sides)
  against ``jax.grad`` of the JAX ``fused_transformer_layer``, with and
  without a qkv bias;
- the switches' parsing and precedence, and the gates: the port's are its
  kernels' own limits, so a b*n that the JAX row tiling refuses runs;
- each new kernel wrapper, which on a CPU tensor is exactly its twin and on
  any other device refuses before launching.

Tolerances: both sides compute in fp32 and differ in summation order only;
the readings are max_abs <= 7.6e-6 for the FF backward's outputs (on the
largest, the f32 sum db2 of |39|) and <= 1.5e-5 for the layer's gradients
(|grad| up to ~49), so the bounds are those of
tests/test_torch_fused_layer_bwd.py: |d| <= 1e-5 + 1e-4|want| and 5e-5 +
2e-4|want|, inside the JAX tests' own (tests/test_fused_layer.py:130, 166)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu_torch.ops import fused_block as port

H, D = 4, 16
DIM = H * D
MLP = 2 * DIM
FF_ATOL, FF_RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 2e-4
OPERANDS = ("x", "w_qkv", "b_qkv", "w_out", "b_out", "ln1s", "ln1b", "ln2s", "ln2b", "w1", "b1", "w2", "b2")
KERNELS = ("w_qkv", "w_out", "w1", "w2")  # Dense (in, out) in JAX, Linear (out, in) in the port
SWITCHES = {
    "full": {port.FF_BWD_ENV: "full"},
    "hybrid": {port.FF_BWD_ENV: "hybrid"},
    "layer": {port.LAYER_BWD_ENV: "1"},
}
ALL_ENV = (port.FF_BWD_ENV, port.FF_BWD_LEGACY_ENV, port.LAYER_BWD_ENV)


def _arrays(b, n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(
        x=f(b, n, DIM), g=f(b, n, DIM),
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


def _switch(monkeypatch, env):
    for k in ALL_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("ops", ["KERNELS", "TWINS"])
@pytest.mark.parametrize("hybrid", [False, True])
def test_ff_backward_matches_jax_ff_pallas_backward(ops, hybrid):
    """``_ff_backward`` (the wrappers, which take their twins on CPU tensors,
    or the twins themselves) against ``_ff_pallas_backward(interpret=True)``:
    dy, dln2s, dln2b, dW1, db1, dW2, db2."""
    b, n = 2, 96
    assert jax_fb._ff_bwd_rows(b * n) == 64
    a = _arrays(b, n, seed=7)
    y = a["x"]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = jax_fb._ff_pallas_backward(j["x"], j["g"], j["ln2s"], j["ln2b"], j["w1"], j["b1"], j["w2"], eps=1e-5,
                                      interpret=True, hybrid=hybrid)
    t = lambda name: _torch(a, name)
    port.reset_launch_counts()
    got = port._ff_backward(getattr(port, ops), torch.from_numpy(y), t("g"), t("ln2s"), t("ln2b"), t("w1"), t("b1"),
                            t("w2"), eps=1e-5, hybrid=hybrid)
    assert not any(port.LAUNCHES.values())
    for name, g, w in zip(("dy", "dln2s", "dln2b", "dW1", "db1", "dW2", "db2"), got, want):
        g = g.numpy().T if name in ("dW1", "dW2") else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=FF_ATOL, rtol=FF_RTOL, err_msg=name)


def _layer_grads_both(monkeypatch, mode, qkv_bias, b, n, seed=1):
    """(port grads, JAX grads, names) of sum(out^2) under one switch, set on
    both sides; the port's backward dispatch is spied on."""
    _switch(monkeypatch, SWITCHES[mode])
    a = _arrays(b, n, seed=seed)
    names = [name for name in OPERANDS if qkv_bias or name != "b_qkv"]

    def jax_loss(*values):
        v = dict(zip(names, values))
        out = jax_fb.fused_transformer_layer(
            v["x"], v["w_qkv"], v["w_out"], v["ln1s"], v["ln1b"], v["ln2s"], v["ln2b"], v["w1"], v["b1"],
            v["w2"], v["b2"], heads=H, dim_head=D, b_qkv=v.get("b_qkv"), b_out=v["b_out"], interpret=True,
        )
        return jnp.sum(out**2)

    want = jax.grad(jax_loss, argnums=tuple(range(len(names))))(*(jnp.asarray(a[k]) for k in names))

    calls = []
    for fn in ("_ff_backward", "_layer_backward"):
        real = getattr(port, fn)
        monkeypatch.setattr(port, fn, lambda *args, _real=real, _fn=fn, **kw: calls.append(_fn) or _real(*args, **kw))
    leaves = {k: _torch(a, k).requires_grad_() for k in names}
    port.reset_launch_counts()
    out = port.fused_transformer_layer(
        leaves["x"], leaves["w_qkv"], leaves["w_out"], leaves["ln1s"], leaves["ln1b"], leaves["ln2s"],
        leaves["ln2b"], leaves["w1"], leaves["b1"], leaves["w2"], leaves["b2"],
        heads=H, dim_head=D, b_qkv=leaves.get("b_qkv"), b_out=leaves["b_out"],
    )
    got = torch.autograd.grad((out**2).sum(), [leaves[k] for k in names])
    assert not any(port.LAUNCHES.values())
    return got, want, names, calls


def _assert_grads(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.numpy().T if name in KERNELS else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("mode", list(SWITCHES))
def test_layer_grads_under_each_switch_match_jax(monkeypatch, mode, qkv_bias):
    """The 13 operand gradients of the port's layer Function on CPU tensors
    under each switch against ``jax.grad`` of the JAX layer under the same
    switch, at b=2, n=32 (one 64-row tile, so the JAX FF kernel engages),
    and the port took the switch's backward."""
    b, n = 2, 32
    _switch(monkeypatch, SWITCHES[mode])
    if mode == "layer":
        assert jax_fb.layer_bwd_supported((b, n, DIM), jnp.float32, H, D, DIM, MLP)
    else:
        assert jax_fb.ff_bwd_mode((b, n, DIM), jnp.float32, DIM, MLP) == mode
    got, want, names, calls = _layer_grads_both(monkeypatch, mode, qkv_bias, b, n)
    # the whole-layer backward runs the FF chain itself
    assert calls == (["_layer_backward", "_ff_backward"] if mode == "layer" else ["_ff_backward"])
    _assert_grads(got, want, names)


def test_no_tpu_row_tiling_in_the_gate(monkeypatch):
    """b*n = 46 has no 64-row tile: JAX's ``ff_bwd_mode`` refuses it (its
    ``_ff_bwd_rows``) and takes XLA's vjp; the port's kernels mask rows, so
    its full mode runs, with the same gradients."""
    b, n = 2, 23
    _switch(monkeypatch, SWITCHES["full"])
    assert jax_fb._ff_bwd_rows(b * n) == 0 and jax_fb.ff_bwd_mode((b, n, DIM), jnp.float32, DIM, MLP) == ""
    assert port.ff_bwd_mode((b, n, DIM), torch.float32, DIM, MLP) == "full"
    got, want, names, calls = _layer_grads_both(monkeypatch, "full", True, b, n)
    assert calls == ["_ff_backward"]
    _assert_grads(got, want, names)


# (environment, the mode both packages read from it)
ENV_CASES = [
    ({}, ""),
    ({port.FF_BWD_ENV: "full"}, "full"),
    ({port.FF_BWD_ENV: "hybrid"}, "hybrid"),
    ({port.FF_BWD_LEGACY_ENV: "1"}, "full"),
    ({port.FF_BWD_ENV: "hybrid", port.FF_BWD_LEGACY_ENV: "1"}, "hybrid"),
    ({port.FF_BWD_ENV: "bogus", port.FF_BWD_LEGACY_ENV: "1"}, ""),
    ({port.FF_BWD_ENV: "FULL"}, ""),
    ({port.FF_BWD_ENV: ""}, ""),
]


@pytest.mark.parametrize("env,mode", ENV_CASES)
def test_ff_bwd_mode_parses_the_switches_as_jax(monkeypatch, env, mode):
    _switch(monkeypatch, env)
    shape = (2, 32, DIM)
    assert port.ff_bwd_mode(shape, torch.bfloat16, DIM, MLP) == mode
    assert jax_fb.ff_bwd_mode(shape, jnp.bfloat16, DIM, MLP) == mode
    assert port.ff_bwd_supported(shape, torch.bfloat16, DIM, MLP) == bool(mode)


@pytest.mark.parametrize("value,on", [(None, False), ("1", True), ("yes", True), ("", False)])
def test_layer_bwd_supported_reads_its_switch(monkeypatch, value, on):
    _switch(monkeypatch, {} if value is None else {port.LAYER_BWD_ENV: value})
    shape = (2, 32, DIM)
    assert port.layer_bwd_supported(shape, torch.bfloat16, H, D, DIM, MLP) == on
    assert jax_fb.layer_bwd_supported(shape, jnp.bfloat16, H, D, DIM, MLP) == on


def test_gates_are_the_h100_kernels_not_the_tpu_vmem(monkeypatch):
    """No TPU VMEM estimate carries over: at dim 2048, mlp 8192 the JAX FF
    gate refuses (its f32 dW accumulators alone exceed _FF_BWD_EST_LIMIT),
    the port's admits; the port refuses what its own kernels do not take
    (dim > 2416, the [res_f32] LayerNorm backward's shared memory; a K not a
    multiple of 64)."""
    _switch(monkeypatch, SWITCHES["full"])
    assert jax_fb.ff_bwd_mode((1, 1024, 2048), jnp.bfloat16, 2048, 8192) == ""
    assert port.ff_bwd_mode((1, 1024, 2048), torch.bfloat16, 2048, 8192) == "full"
    assert port.ff_bwd_mode((1, 1024, 2560), torch.bfloat16, 2560, 8192) == ""
    assert port.ff_bwd_mode((1, 1024, 768), torch.bfloat16, 768, 3000) == ""
    _switch(monkeypatch, SWITCHES["layer"])
    assert port.layer_bwd_supported((1024, 197, 768), torch.bfloat16, 12, 64, 768, 3072)
    assert not port.layer_bwd_supported((1, 1024, 2560), torch.bfloat16, 40, 64, 2560, 8192)


def test_layer_switch_takes_precedence(monkeypatch):
    """With both switches set the whole-layer backward runs, as in JAX's
    ``_fused_layer_bwd`` (:1802)."""
    _switch(monkeypatch, {**SWITCHES["full"], **SWITCHES["layer"]})
    calls = []
    real = port._layer_backward
    monkeypatch.setattr(port, "_layer_backward", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    a = _arrays(1, 8)
    leaves = [_torch(a, k).requires_grad_() for k in OPERANDS if k not in ("b_qkv", "b_out")]
    out = port.fused_transformer_layer(*leaves, heads=H, dim_head=D)
    torch.autograd.grad(out.sum(), leaves)
    assert calls == [1]


def _wrapper_cases():
    """(wrapper call, twin call) of each new wrapper on the inputs ``t``."""
    rows = lambda v: v.reshape(-1, v.shape[-1])
    return {
        "gemm_bf16[fc1_save]": (
            lambda t: port.gemm_bf16(t["y2"], t["w1"], "fc1_save", bias=t["b1"]),
            lambda t: port.gemm_bf16_reference(t["y2"], t["w1"], "fc1_save", bias=t["b1"]),
        ),
        "gemm_bf16[gelu_bwd]": (
            lambda t: port.gemm_bf16(t["g"], t["w2_t"], "gelu_bwd", aux=t["h1"]),
            lambda t: port.gemm_bf16_reference(t["g"], t["w2_t"], "gelu_bwd", aux=t["h1"]),
        ),
        "layernorm_bwd_rows[res_f32]": (
            lambda t: port.layernorm_bwd_rows(t["y"], t["dh"], t["ln2s"], residual=t["g"], res_f32=True),
            lambda t: port.layernorm_bwd_rows_reference(t["y"], t["dh"], t["ln2s"], residual=t["g"], res_f32=True),
        ),
        "layernorm_bwd_rows[res_f32, f32 dx]": (
            lambda t: port.layernorm_bwd_rows(t["y"], t["dh"], t["ln2s"], residual=t["dh"], res_f32=True,
                                              out_f32=True),
            lambda t: port.layernorm_bwd_rows_reference(t["y"], t["dh"], t["ln2s"], residual=t["dh"], res_f32=True,
                                                        out_f32=True),
        ),
        "gemm_wgrad": (
            lambda t: port.gemm_wgrad(rows(t["g"]), rows(t["h1"])),
            lambda t: port.gemm_wgrad_reference(rows(t["g"]), rows(t["h1"])),
        ),
    }


def _wrapper_inputs(dtype=torch.float32):
    a = _arrays(2, 23, seed=2)
    rng = np.random.default_rng(3)
    t = {k: _torch(a, k).to(dtype) for k in ("g", "ln2s", "w1", "b1")}
    t["y"] = _torch(a, "x").to(dtype)
    t["y2"] = port.layernorm_rows_reference(t["y"], t["ln2s"], _torch(a, "ln2b").to(dtype))
    t["h1"] = torch.from_numpy(rng.standard_normal((2, 23, MLP)).astype(np.float32)).to(dtype)
    t["w2_t"] = torch.from_numpy(a["w2"].copy()).to(dtype)  # W2^T in the (out, in) layout: (mlp, dim)
    t["dh"] = torch.from_numpy(rng.standard_normal((2, 23, DIM)).astype(np.float32))  # f32, as gemm_f32out gives it
    return t


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_cpu_wrappers_are_their_twins(name):
    """On CPU tensors (fp32 and bf16) each new wrapper is exactly its plain
    twin and counts no launch."""
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
    kernel path, which refuses it before loading or launching anything."""
    wrapper, _ = _wrapper_cases()[name]
    t = {k: v.to("meta") for k, v in _wrapper_inputs(torch.bfloat16).items()}
    t["dh"] = t["dh"].float()
    port.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(t)
    assert not any(port.LAUNCHES.values())


def test_twin_pieces():
    """The twins' own arithmetic: gelu_tanh_grad is the derivative autograd
    takes of the tanh GELU; gelu_bwd's db1 is the f32 column sum of its
    f32 dh1 (before the cast); [res_f32] adds the residual before one cast
    and sums it per column."""
    h = torch.linspace(-6, 6, 241, dtype=torch.float64, requires_grad=True)
    (want,) = torch.autograd.grad(torch.nn.functional.gelu(h, approximate="tanh").sum(), h)
    torch.testing.assert_close(port.gelu_tanh_grad_reference(h.detach()), want, atol=1e-12, rtol=1e-12)
    t = _wrapper_inputs(torch.bfloat16)
    dh1, db1 = port.gemm_bf16_reference(t["g"], t["w2_t"], "gelu_bwd", aux=t["h1"])
    f32 = torch.nn.functional.linear(t["g"].float(), t["w2_t"].float()) * port.gelu_tanh_grad_reference(t["h1"].float())
    assert dh1.dtype == torch.bfloat16 and torch.equal(dh1, f32.to(torch.bfloat16))
    torch.testing.assert_close(db1, f32.reshape(-1, MLP).sum(0), atol=0, rtol=0)
    dx, _, _, rsum = port.layernorm_bwd_rows_reference(t["y"], t["dh"], t["ln2s"], residual=t["g"], res_f32=True)
    plain = port.layernorm_bwd_rows_reference(t["y"], t["dh"], t["ln2s"], residual=t["g"], res_f32=True,
                                              out_f32=True)[0]
    assert torch.equal(dx, plain.to(torch.bfloat16))
    torch.testing.assert_close(rsum, t["g"].float().reshape(-1, DIM).sum(0), atol=0, rtol=0)
