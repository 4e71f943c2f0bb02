"""The port's Dino (vit_pytorch_tpu_torch/ssl/dino.py) against the JAX
package on the CPU, fp32, at tests/test_ssl2.py's ViT size at depth 2 (32 x
32, patch 8, dim 32, heads 2, mlp 64; K = 64, projector hidden 32, 3
layers), with the same weights on both sides (JAX init, the teacher
perturbed apart from the student, loaded through
``utils/from_jax.py::dino_state_dict_from_jax``), the same injected views
and non-zero centres.

Tolerances: the loss and ``last_teacher_centers`` within 5e-5 absolute and
1e-4 relative, every gradient within 5e-5 + 1e-3 relative (the JAX
package's fp32 parity bar, as tests/test_torch_mae.py); the EMA update bit
for bit, in fp32 and in bf16 (the centres float32 in both, as JAX's).  In
bf16: ``dino_loss_fn`` within 2^-8 relative of JAX's on the same logits,
the whole forward's float32 loss within 1e-2 relative and its last centres
within rel L2 2e-2 of JAX's, whose bf16 ViT rounds differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pytorch_tpu_torch
from vit_pytorch_tpu import ViT as JaxViT
from vit_pytorch_tpu.nn import blocks as jax_blocks
from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu.ssl.dino import Dino as JaxDino
from vit_pytorch_tpu.ssl.dino import dino_forward
from vit_pytorch_tpu.utils.convert import convert_dino
from vit_pytorch_tpu_torch import Dino, ViT
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ssl.dino import capture_hidden
from vit_pytorch_tpu_torch.utils.from_jax import dino_state_dict_from_jax

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=2, mlp_dim=64)
DINO = dict(image_size=32, num_classes_K=64, projection_hidden_size=32, projection_layers=3)
ATOL, RTOL, GRAD_RTOL = 5e-5, 1e-4, 1e-3


def _views(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.random((batch, 3, 32, 32), dtype=np.float32) for _ in range(4))


def _setup():
    """The JAX Dino, its params, a state whose teacher and centres differ
    from the student's and from zero, and the port's Dino loaded from them."""
    jdino = JaxDino(net=JaxViT(**KW), **DINO)
    variables = jdino.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(_views()[0]))
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(7)
    teacher = jax.tree.map(lambda a: (a * 0.9 + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)
    state = jdino.create_state(variables).replace(
        teacher_params={"params": teacher},
        teacher_centers=jnp.asarray(rng.standard_normal((1, 64)).astype(np.float32)),
        last_teacher_centers=jnp.asarray(rng.standard_normal((1, 64)).astype(np.float32)),
    )
    dino = Dino(ViT(**KW, device="cpu"), **DINO, device="cpu")
    missing, unexpected = dino.load_state_dict(dino_state_dict_from_jax(params, state.teacher_params), strict=False)
    assert sorted(missing) == ["last_teacher_centers", "teacher_centers"] and not unexpected
    dino.teacher_centers.copy_(torch.from_numpy(np.array(state.teacher_centers)))
    dino.last_teacher_centers.copy_(torch.from_numpy(np.array(state.last_teacher_centers)))
    return jdino, params, state, dino


def _check(jdino, params, state, dino, temps=None):
    temps = temps or {}
    views = _views()
    fn = lambda p: dino_forward(jdino, {"params": p}, state, None, views=tuple(map(jnp.asarray, views)), **temps)
    (want, want_last), grads = jax.value_and_grad(fn, has_aux=True)(params)
    got = dino(None, views=tuple(map(torch.from_numpy, views)), **temps)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dino.last_teacher_centers.numpy(), np.asarray(want_last), atol=ATOL, rtol=RTOL)
    got.backward()
    want_grads = dino_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    checked = 0
    assert all(p.grad is None and not p.requires_grad for p in dino.teacher_encoder.parameters())
    for k, p in dino.student_encoder.named_parameters(prefix="student_encoder"):
        checked += 1
        if p.grad is None:  # the ViT's head, after the captured layer: zeros on the JAX side
            assert k.startswith("student_encoder.net.mlp_head") and not want_grads[k].any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)
    assert checked == len([k for k in want_grads if k.startswith("student_encoder.")])


@pytest.mark.parametrize("temps", [None, dict(student_temp=0.5, teacher_temp=0.1)], ids=["default", "temps"])
def test_dino_matches_jax(temps):
    """The loss, the new last centres and every student gradient with the
    same views, the teacher apart from the student, non-zero centres, and
    with the temperatures overridden at the call."""
    _check(*_setup(), temps)


def test_kernel_route_matches_jax(monkeypatch):
    """The student's and teacher's Transformers on the forced whole-layer
    route of both packages (the JAX kernels in interpret mode, the port's
    Function on its plain twins): the student's two calls keep their own
    graphs through the Function, the teacher's two no-grad calls in between
    save none, the hook sees the Transformer's output, and the loss and
    every gradient match."""
    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_fb, "whole_layer_supported", lambda *a, **k: True)
    orig = jax_blocks.fused_transformer_layer
    monkeypatch.setattr(jax_blocks, "fused_transformer_layer", lambda *a, **k: orig(*a, **k, interpret=True))
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    calls, layer = [], torch_blocks.fused_transformer_layer

    def spy(x, *args, **kwargs):
        calls.append((tuple(x.shape), torch.is_grad_enabled()))
        return layer(x, *args, **kwargs)

    jdino, params, state, dino = _setup()
    monkeypatch.setattr(torch_blocks, "fused_transformer_layer", spy)
    _check(jdino, params, state, dino)
    shape, depth = (2, 17, 32), KW["depth"]
    assert calls == [(shape, True)] * (2 * depth) + [(shape, False)] * (2 * depth)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_moving_average_matches_jax_bitwise(dtype):
    """The teacher's EMA toward a changed student, in the parameters' own
    dtype (the bf16 constants rounded as JAX rounds them), and the centres':
    the module cast to ``dtype`` keeps its centre buffers float32, as JAX's
    ``create_state`` makes them, and the last centres hold what JAX's
    forward returns in the projections' dtype; bit for bit."""
    jdino, params, state, dino = _setup()
    rng = np.random.default_rng(3)
    student = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)
    torch_dtype, jax_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a).astype(jax_dtype), tree)
    f32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    student, teacher = cast(student), cast(state.teacher_params)
    state = state.replace(teacher_params=teacher, last_teacher_centers=state.last_teacher_centers.astype(jax_dtype))
    dino.to(torch_dtype)
    assert dino.teacher_centers.dtype == dino.last_teacher_centers.dtype == torch.float32
    dino.load_state_dict(dino_state_dict_from_jax(f32(student), f32(teacher)), strict=False)
    dino.last_teacher_centers.copy_(torch.from_numpy(np.array(state.last_teacher_centers, np.float32)))
    want = jdino.update_moving_average({"params": student}, state)
    dino.update_moving_average()
    want_sd = dino_state_dict_from_jax(f32(student), f32(want.teacher_params))
    teacher = {k: v for k, v in dino.state_dict().items() if k.startswith("teacher_encoder.")}
    assert teacher and all(v.dtype == torch_dtype for v in teacher.values())
    for k, v in teacher.items():
        assert torch.equal(v.float(), want_sd[k]), k
    assert want.teacher_centers.dtype == jnp.float32
    assert torch.equal(dino.teacher_centers, torch.from_numpy(np.array(want.teacher_centers)))


def _bf16_case():
    """``_setup``'s Dino and JAX state in bf16: the parameters cast, the
    centres float32 (JAX's ``create_state``; the port's buffers through
    ``.to(bfloat16)``), the views bf16."""
    jdino, params, state, dino = _setup()
    bf16 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    params, state = bf16(params), state.replace(teacher_params=bf16(state.teacher_params))
    dino.to(torch.bfloat16)
    views = tuple(jnp.asarray(v).astype(jnp.bfloat16) for v in _views())
    torch_views = tuple(torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) for v in views)
    return jdino, params, state, dino, views, torch_views


def test_bf16_loss_is_float32_as_jax():
    """In bf16 the teacher's logits less the float32 centres promote the
    teacher's softmax and the loss to float32 on both sides.  On the same
    bf16 logits and centres, ``dino_loss_fn`` matches JAX's within 2^-8
    relative, one bf16 rounding: the student's softmax and log are bf16 on
    both sides, rounded at different points (reading 1.7e-3); the
    whole bf16 forward, whose two ViTs round differently, within 1e-2
    relative of JAX's loss, and the new last centres (bf16 values in a
    float32 buffer) within rel L2 2e-2 of JAX's bf16 ones."""
    from vit_pytorch_tpu.ssl.dino import dino_loss_fn as jax_loss_fn
    from vit_pytorch_tpu_torch.ssl.dino import dino_loss_fn

    jdino, params, state, dino, views, torch_views = _bf16_case()
    assert dino.teacher_centers.dtype == torch.float32 and next(dino.parameters()).dtype == torch.bfloat16
    rng = np.random.default_rng(5)
    teacher, student = (jnp.asarray(rng.standard_normal((4, 64)), jnp.bfloat16) for _ in range(2))
    want = jax_loss_fn(teacher, student, 0.04, 0.9, state.teacher_centers)
    got = dino_loss_fn(*(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (teacher, student)),
                       0.04, 0.9, dino.teacher_centers)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=2.0**-8)

    want, want_last = dino_forward(jdino, {"params": params}, state, None, views=views)
    got = dino(None, views=torch_views)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert want_last.dtype == jnp.bfloat16 and dino.last_teacher_centers.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-2)
    last, want_last = dino.last_teacher_centers, torch.from_numpy(np.asarray(want_last, np.float32))
    assert torch.equal(last, last.bfloat16().float())
    assert ((last - want_last).norm() / want_last.norm()).item() < 2e-2


def test_capture_hidden_raises_where_jax_raises():
    """A non-string layer and a name no submodule has raise ValueError on
    both sides; the hook is gone after a forward that raises."""
    img = jnp.asarray(_views()[0])
    for layer, match in ((5, "hidden_layer must be"), ("no_such_layer", "never emitted an output")):
        with pytest.raises(ValueError, match=match):
            JaxDino(net=JaxViT(**KW), **DINO, hidden_layer=layer).init({"params": jax.random.PRNGKey(0)}, img)
        with pytest.raises(ValueError, match=match):
            Dino(ViT(**KW, device="cpu"), **DINO, hidden_layer=layer, device="cpu")
    vit = ViT(**KW, device="cpu")
    with pytest.raises(RuntimeError):
        capture_hidden(vit, torch.zeros(2, 4, 32, 32), "transformer")  # 4 channels fail in the forward
    assert not any(m._forward_hooks for m in vit.modules())
    hidden = capture_hidden(vit, torch.from_numpy(_views()[0]), "transformer")
    assert hidden.shape == (2, 17, 32) and not any(m._forward_hooks for m in vit.modules())


def test_state_dict_round_trip_is_exact():
    """The Dino map inverts ``convert_dino`` (which keeps the student and
    drops the teacher and the centres): the port's state_dict converts back
    to the params it was loaded from; the teacher holds DinoState's."""
    _, params, state, dino = _setup()
    got = jax.tree.map(np.asarray, convert_dino(dino.state_dict(), projection_layers=3)["params"])
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert np.array_equal(a, b)
    teacher = dino_state_dict_from_jax(params, state.teacher_params)
    for k, v in dino.teacher_encoder.state_dict().items():
        assert torch.equal(v, teacher[f"teacher_encoder.{k}"]), k


def test_teacher_is_a_frozen_copy_and_views_come_from_the_generator():
    """At construction the teacher equals the student and takes no
    gradient; the views of one generator seed repeat, another's differ; a
    training step writes the last centres and the EMA then moves the
    teacher toward the stepped student."""
    dino = Dino(ViT(**KW, device="cpu"), **DINO, device="cpu", generator=torch.Generator().manual_seed(0))
    s, t = dino.student_encoder.state_dict(), dino.teacher_encoder.state_dict()
    assert s.keys() == t.keys() and all(torch.equal(s[k], t[k]) for k in s)
    assert not any(p.requires_grad for p in dino.teacher_encoder.parameters())
    img = torch.from_numpy(_views()[0])
    a = dino.make_views(img, torch.Generator().manual_seed(1))
    b = dino.make_views(img, torch.Generator().manual_seed(1))
    c = dino.make_views(img, torch.Generator().manual_seed(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(v.shape == (2, 3, 32, 32) for v in a)
    opt = torch.optim.Adam(dino.parameters(), lr=1e-2)
    loss = dino(img, generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(loss) and dino.last_teacher_centers.abs().sum() > 0
    loss.backward()
    opt.step()
    before = {k: v.clone() for k, v in dino.teacher_encoder.state_dict().items()}
    dino.update_moving_average()
    s = dino.student_encoder.state_dict()
    for k, v in dino.teacher_encoder.state_dict().items():
        assert torch.equal(v, before[k] * 0.9 + torch.tensor(1 - 0.9).item() * s[k]), k
    assert not all(torch.equal(v, s[k]) for k, v in dino.teacher_encoder.state_dict().items())
    assert torch.equal(dino.teacher_centers, torch.tensor(1 - 0.9).item() * dino.last_teacher_centers)


def test_dino_is_exported_and_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    assert vit_pytorch_tpu_torch.Dino is Dino and "Dino" in vit_pytorch_tpu_torch.__all__
    assert set(vit_pytorch_tpu_torch.__all__) == {"ViT", "SimpleViT", "MAE", "Dino"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Dino(ViT(**KW, device="cpu"), **DINO)
