"""SimpleViT and SimpleViT-qk-norm at 1024 tokens (vit_pytorch_tpu_torch/
models/simple_vit.py, simple_vit_with_qk_norm.py) against the JAX models on
the CPU, fp32, at a small width (image 64, patch 2: 1024 patches; dim 64,
depth 2, heads 2, dim_head 32, mlp 128), with the same weights on both sides
(JAX init, loaded through ``utils/from_jax.py``) and the same images (numpy
seed).

At 1024 tokens the attention-block kernels refuse the layer (n > 208), so
every attention call reaches ``ops/attention.py::dot_product_attention``,
which on the card takes the kernel route at m >= 1024: m = 1024 exactly, no
cls token, is the short route.  Until the dispatcher was repaired that route
raised ``NotImplementedError`` on the card, for every dtype, before any gate
was asked; the first test takes the device test as true (fp32, so the short
kernel's gate sends the call to the composite) and shows the model runs and
matches.  The others force the short route itself (its gate taken as true
too), so that every attention call runs the short Function on its plain
twin, the gammas normalised before it, and hold logits, every gradient and
one ``make_train_step`` step to the JAX models.

Tolerances: logits within 5e-5 absolute and 1e-4 relative (the JAX
package's fp32 parity bar, as tests/test_torch_simple_vit.py), gradients
within 5e-5 + 1e-3 relative, the step's updated params as that file
compares them."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.models.simple_vit import SimpleViT as JaxSimpleViT
from vit_pytorch_tpu.models.simple_vit_with_qk_norm import SimpleViT as JaxQkNormViT
from vit_pytorch_tpu.parallel.train import TrainState as JaxTrainState
from vit_pytorch_tpu.parallel.train import make_train_step as jax_make_train_step
from vit_pytorch_tpu_torch import SimpleViT
from vit_pytorch_tpu_torch.models import simple_vit_with_qk_norm
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.ops import short_attention as short
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.utils.from_jax import simple_vit_qk_norm_state_dict_from_jax, simple_vit_state_dict_from_jax

KW = dict(image_size=64, patch_size=2, num_classes=10, dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)
TOKENS = (64 // 2) ** 2
ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
LR = 3e-4
PARAM_ATOL, G_MIN = 1e-6, 1e-5

MODELS = {
    "simple_vit": (JaxSimpleViT, SimpleViT, simple_vit_state_dict_from_jax),
    "qk_norm": (JaxQkNormViT, simple_vit_with_qk_norm.SimpleViT, simple_vit_qk_norm_state_dict_from_jax),
}


def _images(batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 3, 64, 64)).astype(np.float32)


def _labels(name, batch=2, seed=1):
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


def _spy_routes(monkeypatch, names=("flash_attention", "short_attention")):
    """Record the route of each dispatcher call (the short Function's
    backward calls ``xla_attention`` itself, so it is spied on only where no
    kernel route runs)."""
    routes = []
    for route in names:
        fn = getattr(attention, route)
        monkeypatch.setattr(attention, route, lambda *a, _fn=fn, _r=route, **k: routes.append(_r) or _fn(*a, **k))
    return routes


@pytest.mark.parametrize("name", list(MODELS))
def test_1024_tokens_on_the_card_route_match_jax(name, monkeypatch):
    """The fault, and its repair: with the device test taken as true, each
    attention call of the model at 1024 tokens came to the dispatcher's short
    route and raised ``NotImplementedError`` (fp32 included: the raise came
    before any gate).  Now the route asks the short kernel's gate, which
    refuses fp32, and the composite computes it: logits and every gradient
    match the JAX model."""
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    routes = _spy_routes(monkeypatch, ("flash_attention", "short_attention", "xla_attention"))
    jmodel, params, model = _setup(name)
    _check_model(name, jmodel, params, model)
    assert routes == ["xla_attention"] * (2 * KW["depth"])  # the eval forward, then the training forward


@pytest.mark.parametrize("name", list(MODELS))
def test_forced_short_route_matches_jax(name, monkeypatch):
    """With the short kernel's gate taken as true as well, every attention
    call (1024 keys, no cls token) takes the short route, the Function on its
    plain twin here, with q and k already normalised for qk-norm; logits and
    every gradient, the gammas' included, match the JAX model (which runs its
    composite on the CPU)."""
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "short_supported", lambda *a: True)
    routes = _spy_routes(monkeypatch)
    jmodel, params, model = _setup(name)
    with torch.no_grad():
        x = model.embed(torch.from_numpy(_images()))
    assert x.shape[1] == TOKENS == 1024
    _check_model(name, jmodel, params, model)
    assert routes == ["short_attention"] * (2 * KW["depth"])
    assert not any(short.LAUNCHES.values())  # CPU tensors: the twin, no kernel


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_on_the_short_route_matches_jax(name, monkeypatch):
    """One ``make_train_step`` step on the forced short route (forward the
    short Function, backward the composite, as in JAX) against the JAX step:
    loss, every gradient and the updated params."""
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "short_supported", lambda *a: True)
    routes = _spy_routes(monkeypatch)
    jmodel, params, model = _setup(name)
    img, labels = _images(batch=3), _labels(name, batch=3)
    want_grads = _jax_grads(name, jmodel, params, img, labels)
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=optax.adam(LR))
    jstate, jmetrics = jax_make_train_step(jmodel, donate=False)(
        state, jnp.asarray(img), jnp.asarray(labels), jax.random.PRNGKey(1))
    new = MODELS[name][2](jax.tree.map(np.asarray, jstate.params))

    pstate = port_train.create_train_state(model)
    metrics = port_train.make_train_step(model)(pstate, torch.from_numpy(img), torch.from_numpy(labels).long())
    assert routes == ["short_attention"] * KW["depth"]
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=ATOL, rtol=RTOL)
    for k, p in model.named_parameters():
        g = want_grads[k]
        np.testing.assert_allclose(p.grad.numpy(), g, atol=ATOL, rtol=GRAD_RTOL, err_msg=f"grad {k}")
        got, want = p.detach().numpy(), new[k].numpy()
        big = np.abs(g) > G_MIN
        np.testing.assert_allclose(got[big], want[big], atol=PARAM_ATOL, rtol=0, err_msg=f"param {k}")
        assert np.all(np.abs(got - want) <= 2 * LR), k
