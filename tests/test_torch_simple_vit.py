"""The port's SimpleViTs (vit_pytorch_tpu_torch/models/simple_vit.py,
simple_vit_with_qk_norm.py, simple_vit_with_register_tokens.py) and its sincos
tables (nn/posemb.py) against the JAX package on the CPU, fp32, at a small
size (depth 2, dim 128, heads 2, dim_head 64), with the same weights on both
sides (JAX init, loaded through ``utils/from_jax.py``) and the same images
(numpy seed).

Tolerances: logits within 5e-5 absolute (the JAX package's fp32 parity bar)
and 1e-4 relative; gradients within 5e-5 + 1e-3 relative (sums over the
batch); the train step's loss within 5e-5 and its updated params as
tests/test_torch_train.py compares them (Adam's first step is ~lr * sign(g)).
The sincos tables are equal bit for bit.

On the CPU both sides run their module composites.  The kernel-route tests
force the port's attention-block route (the device test and the kernels'
gate taken as true), so that every attention call runs the block Function on
its plain twins, qk-norm included, and hold it to the JAX models too."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.models.simple_vit import SimpleViT as JaxSimpleViT
from vit_pytorch_tpu.models.simple_vit_with_qk_norm import SimpleViT as JaxQkNormViT
from vit_pytorch_tpu.models.simple_vit_with_register_tokens import SimpleViT as JaxRegisterViT
from vit_pytorch_tpu.nn import posemb as jax_posemb
from vit_pytorch_tpu.parallel.train import TrainState as JaxTrainState
from vit_pytorch_tpu.parallel.train import make_train_step as jax_make_train_step
from vit_pytorch_tpu.utils.convert import convert_simple_vit, convert_simple_vit_with_qk_norm
from vit_pytorch_tpu_torch import SimpleViT, ViT
from vit_pytorch_tpu_torch.models import na_vit, simple_vit_with_qk_norm, simple_vit_with_register_tokens
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.nn import posemb
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.ops.packing import pack_images
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.utils.from_jax import (
    simple_vit_qk_norm_state_dict_from_jax,
    simple_vit_register_tokens_state_dict_from_jax,
    simple_vit_state_dict_from_jax,
)

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)
ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
LR = 3e-4
PARAM_ATOL, G_MIN = 1e-6, 1e-5

MODELS = {
    "simple_vit": (JaxSimpleViT, SimpleViT, simple_vit_state_dict_from_jax),
    "qk_norm": (JaxQkNormViT, simple_vit_with_qk_norm.SimpleViT, simple_vit_qk_norm_state_dict_from_jax),
    "register_tokens": (JaxRegisterViT, simple_vit_with_register_tokens.SimpleViT,
                        simple_vit_register_tokens_state_dict_from_jax),
}


def _images(batch=3, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 3, 32, 32)).astype(np.float32)


def _labels(name, batch=3, seed=1):
    """Labels in [0, width of the output): SimpleViT-qk-norm's "head" is a
    LayerNorm, so its outputs are dim wide."""
    width = KW["dim"] if name == "qk_norm" else KW["num_classes"]
    return np.random.default_rng(seed).integers(0, width, batch).astype(np.int32)


def _setup(name):
    jax_cls, port_cls, to_torch = MODELS[name]
    jmodel = jax_cls(**KW)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(_images()))["params"])
    model = port_cls(**KW, device="cpu")
    model.load_state_dict(to_torch(params), strict=True)
    return jmodel, params, model


def _jax_grads(name, jmodel, params, img, labels):
    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(img), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    grads = jax.tree.map(np.asarray, jax.grad(loss)(params))
    return {k: v.numpy() for k, v in MODELS[name][2](grads).items()}


def _check_model(name, jmodel, params, model):
    """Logits of eval mode, then every parameter gradient of the mean
    cross-entropy in training mode."""
    img, labels = _images(), _labels(name)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    got = model.eval()(torch.from_numpy(img)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    model.train()
    F.cross_entropy(model(torch.from_numpy(img)), torch.from_numpy(labels).long()).backward()
    want_grads = _jax_grads(name, jmodel, params, img, labels)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k], atol=ATOL, rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Logits and every parameter gradient of each SimpleViT against the JAX
    model with the same weights; the output shape is the JAX model's (dim
    wide for qk-norm)."""
    jmodel, params, model = _setup(name)
    assert model(torch.from_numpy(_images())).shape == (3, KW["dim"] if name == "qk_norm" else KW["num_classes"])
    _check_model(name, jmodel, params, model)


@pytest.mark.parametrize("name", list(MODELS))
def test_kernel_route_matches_jax(name, monkeypatch):
    """With the device test and the kernels' gate taken as true, every
    attention call takes ``fused_attention_block`` (its twins on the CPU):
    with ``residual=x`` for SimpleViT and the registers, with the gammas and
    no residual for qk-norm; logits and every gradient, the gammas' included,
    still match the JAX model."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    block, calls = torch_blocks.fused_attention_block, []

    def spy(x, residual, *args, **kwargs):
        calls.append((residual is x, kwargs["gamma_q"] is not None))
        return block(x, residual, *args, **kwargs)

    monkeypatch.setattr(torch_blocks, "fused_attention_block", spy)
    jmodel, params, model = _setup(name)
    port_fb.reset_launch_counts()
    _check_model(name, jmodel, params, model)
    qk = name == "qk_norm"
    assert calls == [(not qk, qk)] * (2 * KW["depth"])  # the eval forward, then the training forward
    assert not any(port_fb.LAUNCHES.values())


@pytest.mark.parametrize("name,convert", [("simple_vit", convert_simple_vit),
                                          ("qk_norm", convert_simple_vit_with_qk_norm)])
def test_state_dict_round_trip_is_exact(name, convert):
    """The from_jax maps invert the JAX package's torch -> JAX conversions
    (the reference layout), so the port's state_dict converts back to the
    very params it was loaded from."""
    _, params, model = _setup(name)
    got = jax.tree.map(np.asarray, convert(model.state_dict())["params"])
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


def test_train_step_matches_jax():
    """One ``make_train_step`` step of SimpleViT-qk-norm against the JAX
    step: loss, gradients (the gammas' included) and the updated params."""
    jmodel, params, model = _setup("qk_norm")
    img, labels = _images(batch=4), _labels("qk_norm", batch=4)
    want_grads = _jax_grads("qk_norm", jmodel, params, img, labels)
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=optax.adam(LR))
    jstate, jmetrics = jax_make_train_step(jmodel, donate=False)(
        state, jnp.asarray(img), jnp.asarray(labels), jax.random.PRNGKey(1))
    new = simple_vit_qk_norm_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))

    pstate = port_train.create_train_state(model)
    metrics = port_train.make_train_step(model)(pstate, torch.from_numpy(img), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=ATOL, rtol=RTOL)
    assert any(k.endswith("q_norm.gamma") for k, _ in model.named_parameters())
    for k, p in model.named_parameters():
        g = want_grads[k]
        np.testing.assert_allclose(p.grad.numpy(), g, atol=ATOL, rtol=GRAD_RTOL, err_msg=f"grad {k}")
        got, want = p.detach().numpy(), new[k].numpy()
        big = np.abs(g) > G_MIN
        np.testing.assert_allclose(got[big], want[big], atol=PARAM_ATOL, rtol=0, err_msg=f"param {k}")
        assert np.all(np.abs(got - want) <= 2 * LR), k


TABLES = [
    ("posemb_sincos_1d", (20, 64)),
    ("posemb_sincos_2d", (4, 5, 64)),
    ("posemb_sincos_2d", (7, 7, 1024)),
    ("posemb_sincos_3d", (2, 3, 4, 96)),
    ("posemb_sincos_3d", (2, 3, 4, 100)),  # padded past 6 * (dim // 6)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn,args", TABLES)
def test_posemb_tables_equal_jax_bit_for_bit(fn, args, dtype):
    got = getattr(posemb, fn)(*args, dtype=getattr(torch, dtype))
    want = np.asarray(getattr(jax_posemb, fn)(*args, dtype=getattr(jnp, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    bits = torch.int32 if dtype == "float32" else torch.int16
    assert np.array_equal(got.view(bits).numpy(), want.view(np.int32 if dtype == "float32" else np.int16))


ENTRY_POINTS = {
    "ViT": lambda **kw: ViT(**KW, **kw),
    "SimpleViT": lambda **kw: SimpleViT(**KW, **kw),
    "SimpleViT-qk-norm": lambda **kw: simple_vit_with_qk_norm.SimpleViT(**KW, **kw),
    "NaViT": lambda **kw: na_vit.NaViT(**KW, **kw),
    "pack_images": lambda **kw: pack_images([np.zeros((3, 32, 32), np.float32)], 16, **kw),
    "dropout_masks": lambda **kw: port_fb.dropout_masks(1, 2, 4, 8, 2, 0.1, **kw),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_build_on_the_card_unless_told(entry, monkeypatch):
    """The entry points default to the CUDA card: with no card and no device
    named they raise instead of running the plain path on the CPU, and
    ``device="cpu"`` builds there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry]()
    assert ENTRY_POINTS[entry](device="cpu") is not None
