"""The port's multi-layer stack (vit_pytorch_tpu_torch/ops/fused_block.py::
fused_transformer_stack, the ``VIT_TPU_STACK_LAYERS`` switch) against the JAX
package on the CPU, fp32.

On CPU tensors ``stack_layers`` takes its twin, the per-layer chain of the
twins, so the stack equals the port's own per-layer route bitwise; the JAX
stack runs ``_stack_kernel`` in interpret mode.  Tolerance: 5e-5 absolute
(the JAX package's fp32 parity bar) and 1e-4 relative, as
tests/test_torch_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pytorch_tpu.nn.blocks as jax_blocks
from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu_torch import ViT
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ops import fused_block as port
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.serving import Predictor
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax

B, H, N, D = 2, 2, 17, 32
DIM = H * D
MLP = 2 * DIM
ATOL, RTOL = 5e-5, 1e-4
OPERANDS = ("w_qkv", "b_qkv", "w_out", "b_out", "ln1s", "ln1b", "ln2s", "ln2b", "w1", "b1", "w2", "b2")
_WEIGHTS = ("w_qkv", "w_out", "w1", "w2")  # Dense kernels: (in, out) in JAX, (out, in) in the port


def _arrays(g, qkv_bias, out_bias, seed=0):
    """x and g layers' operands as numpy arrays in the JAX layout."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f(B, N, DIM)
    layers = []
    for _ in range(g):
        layers.append(dict(
            w_qkv=f(DIM, 3 * DIM, scale=0.1), b_qkv=f(3 * DIM, scale=0.05) if qkv_bias else None,
            w_out=f(DIM, DIM, scale=0.1), b_out=f(DIM, scale=0.05) if out_bias else None,
            ln1s=1.0 + f(DIM, scale=0.1), ln1b=f(DIM, scale=0.1), ln2s=1.0 + f(DIM, scale=0.1), ln2b=f(DIM, scale=0.1),
            w1=f(DIM, MLP, scale=0.1), b1=f(MLP, scale=0.05), w2=f(MLP, DIM, scale=0.1), b2=f(DIM, scale=0.05),
        ))
    return x, layers


def _jax_layers(layers):
    return tuple(tuple(None if lw[k] is None else jnp.asarray(lw[k]) for k in OPERANDS) for lw in layers)


def _port_layers(layers, requires_grad=False):
    def conv(k, v):
        if v is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(v.T if k in _WEIGHTS else v))
        return t.requires_grad_() if requires_grad else t

    return [tuple(conv(k, lw[k]) for k in OPERANDS) for lw in layers]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("out_bias", [False, True])
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("g", [2, 3])
def test_stack_matches_jax_stack(g, qkv_bias, out_bias):
    """The stack against JAX ``fused_transformer_stack`` (``_stack_kernel`` in
    interpret mode), each bias present and absent; no kernel launches."""
    x, layers = _arrays(g, qkv_bias, out_bias)
    want = jax_fb.fused_transformer_stack(jnp.asarray(x), _jax_layers(layers), heads=H, dim_head=D, interpret=True)
    port.reset_launch_counts()
    got = port.fused_transformer_stack(torch.from_numpy(x), _port_layers(layers), heads=H, dim_head=D)
    _close(got.numpy(), want, f"g={g}")
    assert not any(port.LAUNCHES.values())


@pytest.mark.parametrize("g", [2, 3, 6])
def test_stack_equals_the_per_layer_chain_bitwise(g):
    """The twin of ``stack_layers`` is the per-layer chain, so the stack equals
    the port's per-layer route bit for bit, as the TPU stack equals its
    single-layer calls."""
    x, layers = _arrays(g, qkv_bias=True, out_bias=True, seed=1)
    pl = _port_layers(layers)
    want = torch.from_numpy(x)
    for w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 in pl:
        want = port.fused_transformer_layer(want, w_qkv, w_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, heads=H,
                                            dim_head=D, b_qkv=b_qkv, b_out=b_out)
    got = port.fused_transformer_stack(torch.from_numpy(x), pl, heads=H, dim_head=D)
    assert torch.equal(got, want)
    assert torch.equal(port.stack_layers(torch.from_numpy(x), pl, heads=H, dim_head=D, scale=D**-0.5), want)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_stack_grads_match_jax(qkv_bias):
    """Gradients of x and of all 12g operands against ``jax.grad`` through
    the JAX stack's custom_vjp; under autograd every layer of the port's
    stack is a ``_FusedLayer`` Function."""
    g = 2
    x, layers = _arrays(g, qkv_bias, out_bias=True, seed=2)

    def loss(x, layers):
        out = jax_fb.fused_transformer_stack(x, layers, heads=H, dim_head=D, interpret=True)
        return jnp.sum(out**2)

    gx, glayers = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), _jax_layers(layers))
    xt = torch.from_numpy(x).requires_grad_()
    pl = _port_layers(layers, requires_grad=True)
    out = port.fused_transformer_stack(xt, pl, heads=H, dim_head=D)
    assert type(out.grad_fn).__name__ == "_FusedLayerBackward"
    (out**2).sum().backward()
    _close(xt.grad.numpy(), gx, "dx")
    for li in range(g):
        for k, t, want in zip(OPERANDS, pl[li], glayers[li]):
            if t is None:
                assert want is None
                continue
            got = t.grad.numpy()
            _close(got.T if k in _WEIGHTS else got, want, f"layer {li} d{k}")


_VITB = ((128, 197, 768), 12, 64, 768, 3072)
# (env, dtype is bf16, depth): the cases of tests/test_fused_layer.py::test_stack_group_gate, the kill switch and
# values <= 1
_GROUP_CASES = {
    "unset": ({}, True, 12),
    "six": ({"VIT_TPU_STACK_LAYERS": "6"}, True, 12),
    "six_depth4": ({"VIT_TPU_STACK_LAYERS": "6"}, True, 4),
    "six_fp32": ({"VIT_TPU_STACK_LAYERS": "6"}, False, 12),
    "sixtyfour_depth64": ({"VIT_TPU_STACK_LAYERS": "64"}, True, 64),
    "five": ({"VIT_TPU_STACK_LAYERS": "5"}, True, 12),
    "one": ({"VIT_TPU_STACK_LAYERS": "1"}, True, 12),
    "zero": ({"VIT_TPU_STACK_LAYERS": "0"}, True, 12),
    "negative": ({"VIT_TPU_STACK_LAYERS": "-3"}, True, 12),
    "empty": ({"VIT_TPU_STACK_LAYERS": ""}, True, 12),
    "disabled": ({"VIT_TPU_STACK_LAYERS": "6", "VIT_TPU_DISABLE_STACK": "1"}, True, 12),
    "not_an_integer": ({"VIT_TPU_STACK_LAYERS": "six"}, True, 12),
}


def _set_env(monkeypatch, env):
    for k in ("VIT_TPU_STACK_LAYERS", "VIT_TPU_DISABLE_STACK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("case", list(_GROUP_CASES))
def test_stack_group_matches_jax(monkeypatch, case):
    """``whole_layer_stack_group`` against the JAX function under each switch
    case, both read at call time; a value that is not an integer raises
    ``ValueError`` naming the variable on both sides."""
    env, bf16, depth = _GROUP_CASES[case]
    _set_env(monkeypatch, env)
    shape, heads, dh, dim, mlp = _VITB
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jax_call = lambda: jax_fb.whole_layer_stack_group(shape, jdt, heads, dh, dim, mlp, depth=depth)
    port_call = lambda: port.whole_layer_stack_group(shape, tdt, heads, dh, dim, mlp, depth=depth)
    if case == "not_an_integer":
        for call in (jax_call, port_call):
            with pytest.raises(ValueError, match="VIT_TPU_STACK_LAYERS"):
                call()
        return
    assert port_call() == jax_call()


def test_stack_group_leaves_out_the_tpu_vmem_shrink(monkeypatch):
    """JAX shrinks a forced group until ``g - 1`` more layers' resident
    weights fit ``_STACK_EST_LIMIT`` of VMEM (the case of
    tests/test_fused_layer.py::test_stack_group_vmem_shrink).  That is a TPU
    calibration: the H100 kernel keeps no weights on chip, so the port runs
    the group asked for (up to 6) whatever that limit says."""
    _set_env(monkeypatch, {"VIT_TPU_STACK_LAYERS": "6"})
    shape, heads, dh, dim, mlp = _VITB
    base = jax_fb._vmem_bytes_whole(197, 768, 768, 3072, 2, jax_fb._whole_layer_ips(128, 197, 768))
    monkeypatch.setattr(jax_fb, "_STACK_EST_LIMIT", base + 2 * jax_fb._layer_weight_bytes(768, 768, 3072, 2))
    assert jax_fb.whole_layer_stack_group(shape, jnp.bfloat16, heads, dh, dim, mlp, depth=12) == 3
    assert port.whole_layer_stack_group(shape, torch.bfloat16, heads, dh, dim, mlp, depth=12) == 6


def test_stack_rejects_mixed_biases():
    x, layers = _arrays(2, qkv_bias=True, out_bias=True)
    pl = _port_layers(layers)
    broken = [pl[0], pl[1][:1] + (None,) + pl[1][2:]]
    with pytest.raises(ValueError, match="uniformly"):
        port.fused_transformer_stack(torch.from_numpy(x), broken, heads=H, dim_head=D)
    assert not port.stack_supported((B, N, DIM), torch.bfloat16, H, 64, DIM, MLP, broken)


def test_one_layer_is_fused_transformer_layer(monkeypatch):
    """A group of one is :func:`fused_transformer_layer`, as JAX's stack of
    one is ``_fused_layer``: no ``stack_layers`` call."""
    x, layers = _arrays(1, qkv_bias=False, out_bias=True, seed=3)
    calls = []
    orig = port.fused_transformer_layer
    monkeypatch.setattr(port, "fused_transformer_layer", lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(port, "stack_layers", lambda *a, **k: pytest.fail("stack_layers for one layer"))
    got = port.fused_transformer_stack(torch.from_numpy(x), _port_layers(layers), heads=H, dim_head=D)
    want = jax_fb.fused_transformer_stack(jnp.asarray(x), _jax_layers(layers), heads=H, dim_head=D, interpret=True)
    assert calls == [1]
    _close(got.numpy(), want, "one layer")


# -- the ViT route -------------------------------------------------------------

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=4, heads=4, dim_head=16, mlp_dim=128)


def _force_whole_layer(monkeypatch):
    """The whole-layer route on both sides on the CPU: the device tests and
    the gates taken as true, in ``blocks`` and inside each ``fused_block``
    (whose ``whole_layer_stack_group`` asks its own module's gate, which
    refuses fp32 on both sides)."""
    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_fb, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(port, "whole_layer_supported", lambda *a, **k: True)


def _spy(monkeypatch, module, name, calls, **extra):
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(len(args[1]) if name == "fused_transformer_stack" else 1)
        return orig(*args, **kwargs, **extra)

    monkeypatch.setattr(module, name, spy)


def _models(seed=0, batch=3):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)
    jmodel = JaxViT(**KW)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"])
    model = ViT(**KW, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params))
    return jmodel, params, model.eval(), img


@pytest.mark.parametrize("group,sizes", [("3", [3, 1]), ("4", [4])])
def test_vit_stack_route_matches_jax(monkeypatch, group, sizes):
    """ViT at depth 4 under ``VIT_TPU_STACK_LAYERS`` = 3 (groups 3 + 1) and 4
    on the forced whole-layer route of both packages: logits within the
    fp32 bar of the JAX ViT under the same switch, the same groups on both
    sides, and the port's logits bitwise those of its per-layer route."""
    _force_whole_layer(monkeypatch)
    jax_calls, port_calls, layer_calls = [], [], []
    _spy(monkeypatch, jax_blocks, "fused_transformer_stack", jax_calls, interpret=True)
    _spy(monkeypatch, jax_blocks, "fused_transformer_layer", layer_calls, interpret=True)
    _spy(monkeypatch, torch_blocks, "fused_transformer_stack", port_calls)
    jmodel, params, model, img = _models()
    _set_env(monkeypatch, {"VIT_TPU_STACK_LAYERS": group})
    want = jmodel.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert jax_calls == sizes and port_calls == sizes and not layer_calls
    _close(got.numpy(), want, f"logits, VIT_TPU_STACK_LAYERS={group}")
    _set_env(monkeypatch, {})
    with torch.no_grad():
        per_layer = model(torch.from_numpy(img))
    assert port_calls == sizes  # unset: the per-layer route
    assert torch.equal(got, per_layer)


def test_predictor_serves_through_the_stack(monkeypatch):
    """``Predictor`` runs under ``inference_mode``, so a served forward takes
    ``stack_layers`` (its twin here): 2 calls a bucket run at depth 4 with
    the switch at 3, and the logits of the switch unset."""
    _force_whole_layer(monkeypatch)
    launches = []
    orig = port.stack_layers
    monkeypatch.setattr(port, "stack_layers", lambda x, layers, **k: launches.append(len(layers)) or orig(x, layers, **k))
    _, _, model, img = _models(seed=1, batch=5)
    pred = Predictor(model, example_shape=(3, 32, 32), batch_sizes=(2, 8), param_dtype=torch.float32, device="cpu")
    _set_env(monkeypatch, {"VIT_TPU_STACK_LAYERS": "3"})
    got = pred(torch.from_numpy(img))
    assert launches == [3]  # the group of one is fused_transformer_layer
    _set_env(monkeypatch, {})
    want = pred(torch.from_numpy(img))
    assert launches == [3]
    assert got.shape == (5, KW["num_classes"]) and torch.equal(got, want)


def _step(model, img, labels):
    state = port_train.create_train_state(model)
    metrics = port_train.make_train_step(model)(state, torch.from_numpy(img), torch.from_numpy(labels).long())
    return float(metrics["loss"]), [p.grad.clone() for p in model.parameters()]


def test_train_step_under_the_switch_is_the_per_layer_step(monkeypatch):
    """One ``make_train_step`` step with ``VIT_TPU_STACK_LAYERS=4`` equals the
    per-layer route's step bit for bit (loss and every gradient), every
    layer's backward is ``_FusedLayerBackward`` (the stack runs the
    per-layer Functions under autograd, as JAX's custom_vjp), and no
    ``stack_layers`` call is made."""
    _force_whole_layer(monkeypatch)
    rng = np.random.default_rng(4)
    img = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    labels = rng.integers(0, KW["num_classes"], 4).astype(np.int32)
    _, params, _, _ = _models()
    backward_fns, stacks = [], []
    orig = port.fused_transformer_layer

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        backward_fns.append(type(out.grad_fn).__name__)
        return out

    monkeypatch.setattr(port, "fused_transformer_layer", spy)
    _spy(monkeypatch, torch_blocks, "fused_transformer_stack", stacks)
    monkeypatch.setattr(port, "stack_layers", lambda *a, **k: pytest.fail("stack_layers under autograd"))
    results = []
    for env in ({"VIT_TPU_STACK_LAYERS": "4"}, {}):
        _set_env(monkeypatch, env)
        model = ViT(**KW, device="cpu")
        model.load_state_dict(vit_state_dict_from_jax(params))
        results.append(_step(model, img, labels))
    assert stacks == [4]
    assert backward_fns == ["_FusedLayerBackward"] * KW["depth"]
    (loss, grads), (loss_want, grads_want) = results
    assert loss == loss_want
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_want))


# -- gates and refusals ----------------------------------------------------------


def test_stack_supported_is_the_whole_layer_gate_and_the_group_size():
    layer = (None,) * 12
    vitb = ((128, 197, 768), torch.bfloat16, 12, 64, 768, 3072)
    assert all(port.stack_supported(*vitb, [layer] * g) for g in range(1, 7))
    assert not port.stack_supported(*vitb, [layer] * 7)
    assert not port.stack_supported(*vitb, [])
    assert not port.stack_supported((128, 197, 768), torch.float32, 12, 64, 768, 3072, [layer] * 2)
    assert not port.stack_supported((128, 209, 768), torch.bfloat16, 12, 64, 768, 3072, [layer] * 2)


def _meta_layers(g, dim=768, heads=12, mlp=3072):
    inner = heads * 64
    t = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    return [(t(3 * inner, dim), None, t(dim, inner), t(dim), t(dim), t(dim), t(dim), t(dim), t(mlp, dim), t(mlp),
             t(dim, mlp), t(dim)) for _ in range(g)]


@pytest.mark.parametrize("entry", ["stack_layers", "fused_transformer_stack"])
def test_stack_refuses_tensors_off_the_card(entry):
    """A meta tensor reaches the kernel path, which refuses it before loading
    or launching anything; so does a shape the gate refuses (n = 209)."""
    call = {
        "stack_layers": lambda x, ls: port.stack_layers(x, ls, heads=12, dim_head=64, scale=0.125),
        "fused_transformer_stack": lambda x, ls: port.fused_transformer_stack(x, ls, heads=12, dim_head=64),
    }[entry]
    port.reset_launch_counts()
    x = torch.empty((2, 197, 768), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        call(x, _meta_layers(2))
    with pytest.raises(ValueError, match="not supported"):
        call(torch.empty((2, 209, 768), dtype=torch.bfloat16, device="meta"), _meta_layers(2))
    assert not any(port.LAUNCHES.values())
