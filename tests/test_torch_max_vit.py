"""The port's MaxViTs (vit_pytorch_tpu_torch/models/max_vit.py,
max_vit_with_registers.py) against the JAX package on the CPU, fp32, at
tests/test_models_smoke3.py:97's size (dim 32, dim_head 16, depth (1, 1),
window 4, 64 x 64 images, dropout 0), with the same weights and BatchNorm
statistics on both sides (JAX init, the statistics moved off their init
values, loaded through ``utils/from_jax.py``) and the same images (numpy
seed).

Tolerances: logits and updated statistics within 5e-5 absolute (the JAX
package's fp32 parity bar) and 1e-4 relative; gradients within 5e-5 + 1e-3
relative.  The served bf16 model against the JAX ``Predictor`` at bf16:
relative L2 of the logits within 2e-2 (see ``test_served_bf16_matches_jax``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.models.max_vit import MaxViT as JaxMaxViT
from vit_pytorch_tpu.models.max_vit import rel_pos_indices as jax_rel_pos_indices
from vit_pytorch_tpu.models.max_vit_with_registers import MaxViT as JaxRegistersMaxViT
from vit_pytorch_tpu.serving import Predictor as JaxPredictor
from vit_pytorch_tpu.utils.convert import convert_max_vit, convert_max_vit_with_registers
from vit_pytorch_tpu_torch.models import max_vit, max_vit_with_registers
from vit_pytorch_tpu_torch.serving import Predictor
from vit_pytorch_tpu_torch.utils.from_jax import (
    max_vit_state_dict_from_jax,
    max_vit_with_registers_state_dict_from_jax,
)

KW = dict(num_classes=10, dim=32, dim_head=16, depth=(1, 1), window_size=4, dropout=0.0)
ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
# bf16 serving: both sides round every op's output to bf16 (the BatchNorm
# arithmetic in bf16 statistics included), but XLA's CPU backend keeps some
# fused elementwise chains in f32 and both sum convolutions and products in
# their own orders, so single roundings differ (a bf16 ulp is 2^-8
# relative) through ~25 layers: the logits read 6.6e-3 to 9.3e-3 relative
# L2 at k = 1, 3, 9.  Bound: ~2x the worst reading
BF16_REL_L2 = 2e-2

MODELS = {
    "max_vit": (JaxMaxViT, max_vit.MaxViT, max_vit_state_dict_from_jax, convert_max_vit),
    "registers": (JaxRegistersMaxViT, max_vit_with_registers.MaxViT, max_vit_with_registers_state_dict_from_jax,
                  convert_max_vit_with_registers),
}


def _images(batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 3, 64, 64)).astype(np.float32)


def _labels(batch=2, seed=1):
    return np.random.default_rng(seed).integers(0, KW["num_classes"], batch).astype(np.int32)


def _moved_stats(stats, seed=2):
    """The BatchNorm statistics off their init values (mean 0, var 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: np.asarray(rng.uniform(0.5, 1.5, v.shape) if float(v.mean()) == 1.0 else 0.1 * rng.standard_normal(
            v.shape), np.float32), stats)


def _setup(name):
    jax_cls, port_cls, to_torch, _ = MODELS[name]
    jmodel = jax_cls(**KW)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(_images()))
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": _moved_stats(variables["batch_stats"])}
    model = port_cls(**KW, device="cpu")
    model.load_state_dict(to_torch(variables["params"], variables["batch_stats"]), strict=True)
    return jmodel, variables, model


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_jax(name):
    jmodel, variables, model = _setup(name)
    img = _images()
    want = jmodel.apply(variables, jnp.asarray(img))
    got = model.eval()(torch.from_numpy(img)).detach()
    assert got.shape == (2, KW["num_classes"])
    _close(got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_forward_statistics_and_grads_match_jax(name):
    """A train-mode forward at dropout 0: the logits, every BatchNorm's
    updated running mean and variance against JAX's ``mutable=
    ["batch_stats"]`` (flax momentum 0.9, the biased f32 variance), and
    every parameter gradient of the mean cross-entropy."""
    jmodel, variables, model = _setup(name)
    to_torch = MODELS[name][2]
    img, labels = _images(), _labels()

    def loss(params):
        logits, updates = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                       jnp.asarray(img), train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean(), (logits, updates)

    grads, (want_logits, updates) = jax.grad(loss, has_aux=True)(variables["params"])
    model.train()
    logits = model(torch.from_numpy(img))
    _close(logits.detach(), want_logits)
    want_stats = to_torch(variables["params"], jax.tree.map(np.asarray, updates["batch_stats"]))
    state = model.state_dict()
    stat_keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * 3 * len(KW["depth"])  # 3 BatchNorms a block
    for k in stat_keys:
        _close(state[k], want_stats[k], msg=k)
        assert not torch.equal(state[k], to_torch(variables["params"], variables["batch_stats"])[k]), k
    F.cross_entropy(logits, torch.from_numpy(labels).long()).backward()
    want_grads = to_torch(jax.tree.map(np.asarray, grads))
    for k, p in model.named_parameters():
        _close(p.grad, want_grads[k], atol=ATOL, rtol=GRAD_RTOL, msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_map_is_the_inverse_of_convert(name):
    """``convert_max_vit*`` of the port's ``state_dict`` gives back the JAX
    ``params`` and ``batch_stats``, leaf for leaf."""
    _, variables, model = _setup(name)
    back = MODELS[name][3](model.state_dict())
    for col in ("params", "batch_stats"):
        want = jax.tree_util.tree_flatten_with_path(variables[col])[0]
        got = dict(jax.tree_util.tree_flatten_with_path(back[col])[0])
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


def test_rel_pos_indices_match_jax():
    for w in (2, 4, 7):
        np.testing.assert_array_equal(max_vit.rel_pos_indices(w), jax_rel_pos_indices(w))


def test_dropsample_drops_per_sample():
    """Dropsample keeps or zeroes each sample whole, scaled by 1 / (1 - p),
    and passes x through in evaluation or at p = 0."""
    x = torch.ones(64, 3, 4, 4)
    drop = max_vit.Dropsample(0.5).train()
    torch.manual_seed(0)
    out = drop(x)
    per_sample = out.reshape(64, -1)
    assert all(bool((row == row[0]).all()) for row in per_sample)
    kept = per_sample[:, 0]
    assert set(kept.tolist()) == {0.0, 2.0}
    assert 16 <= int((kept == 2.0).sum()) <= 48
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(max_vit.Dropsample(0.0).train()(x), x)


def test_mbconv_residual_takes_the_dropsample():
    m = max_vit.MBConv(8, 8, downsample=False, dropout=0.25, device="cpu")
    assert m.residual and isinstance(m[9], max_vit.Dropsample) and m[9].prob == 0.25
    assert not max_vit.MBConv(8, 8, downsample=True, device="cpu").residual
    assert not max_vit.MBConv(8, 16, downsample=False, device="cpu").residual


def _rel_l2(got, want):
    num = sum(float(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).sum()) for a, b in zip(got, want))
    return (num / sum(float((np.asarray(b, np.float64) ** 2).sum()) for b in want)) ** 0.5


def test_bf16_gradients_deviate_from_fp32_as_jax_does():
    """A train-mode step in bf16 against the same step in fp32: the port's
    gradients deviate from its fp32 ones by no more than 1.5x the JAX
    model's bf16 gradients from JAX's fp32 ones.  MaxViT's bf16 gradients
    are far from its fp32 ones on both sides (the deviation is the model's
    bf16 numerics, which the port mirrors); on the card, phase 39 holds the
    port's bf16 step to fp32 with a bound read from this."""
    jmodel, variables, model = _setup("max_vit")
    img, labels = _images(batch=4), _labels(batch=4)

    def jax_grads(dtype):
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)

        def loss(p):
            logits, _ = jmodel.apply({"params": p, "batch_stats": cast(variables["batch_stats"])},
                                     jnp.asarray(img, dtype), train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32),
                                                                   jnp.asarray(labels)).mean()

        return jax.tree.leaves(jax.grad(loss)(cast(variables["params"])))

    def port_grads(dtype):
        m = copy.deepcopy(model).to(dtype).train()
        F.cross_entropy(m(torch.from_numpy(img).to(dtype)).float(), torch.from_numpy(labels).long()).backward()
        return [p.grad.float().numpy() for p in m.parameters()]

    r_jax = _rel_l2(jax_grads(jnp.bfloat16), jax_grads(jnp.float32))
    r_port = _rel_l2(port_grads(torch.bfloat16), port_grads(torch.float32))
    assert r_jax > 1e-2
    assert r_port <= 1.5 * r_jax, (r_port, r_jax)


@pytest.mark.parametrize("k", [1, 3, 9])
def test_served_bf16_matches_jax(k):
    """``Predictor`` at bf16 (bucket 8) against the JAX ``Predictor`` on the
    same variables: the BatchNorm statistics are cast to bf16 on both sides
    (JAX casts every floating leaf of the variables); logits within
    BF16_REL_L2 relative L2, and the served model's statistics are bf16."""
    jmodel, variables, model = _setup("max_vit")
    jpred = JaxPredictor(jmodel, variables, example_shape=(3, 64, 64), batch_sizes=(8,))
    pred = Predictor(model, example_shape=(3, 64, 64), batch_sizes=(8,), device="cpu")
    assert all(b.dtype == torch.bfloat16 for n, b in pred.model.named_buffers() if "running" in n)
    x = np.random.default_rng(k).standard_normal((k, 3, 64, 64)).astype(np.float32)
    want = np.asarray(jpred(x), np.float32)
    got = pred(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape == (k, KW["num_classes"])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_REL_L2


def test_served_fp32_matches_jax():
    jmodel, variables, model = _setup("registers")
    jpred = JaxPredictor(jmodel, variables, example_shape=(3, 64, 64), batch_sizes=(4,), param_dtype=jnp.float32)
    pred = Predictor(model, example_shape=(3, 64, 64), batch_sizes=(4,), param_dtype=torch.float32, device="cpu")
    x = _images(batch=5, seed=3)
    _close(pred(torch.from_numpy(x)), jpred(x))


def test_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cls in (max_vit.MaxViT, max_vit_with_registers.MaxViT):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(**KW)
