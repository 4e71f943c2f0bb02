"""The port's sharded train step (vit_pytorch_tpu_torch/parallel/) against
the JAX package's own sharded step, the counterparts of
tests/test_parallel_equivalence.py, on the CPU at fp32.

The JAX side runs here on its virtual CPU devices (tests/conftest.py); the
port runs in one gloo world of 4 processes (tests/torch_mesh_world.py),
started once for the module, which takes every step below and writes its
results.  Both sides start from the same weights (the JAX init, through
``vit_state_dict_from_jax``) and take the same batch (numpy seed), on a
mesh of the same shape: data parallel (4, 1), tensor parallel (2, 2), FSDP
(2, 2) with ``fsdp_min_size=512``, ``grad_accum=2`` on (4, 1), FSDP on
(4, 1).  Tolerances are JAX's own: loss rtol 1e-5, parameters atol 1e-5
and rtol 1e-4.  The model has no dropout, as JAX's tests hold it
(test_parallel_equivalence.py:14-20): the ranks' dropout draws differ.

Placements: every parameter's realized layout (its DTensor placements on
the named mesh axes) is the JAX spec through the converter and the
transpose, and every Adam moment carries its parameter's placements."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.parallel.mesh import infer_param_shardings, infer_param_shardings_fsdp, make_mesh
from vit_pytorch_tpu.parallel.train import create_train_state, make_sharded_train_step, shard_train_state
from vit_pytorch_tpu_torch.utils import from_jax
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_world as world  # noqa: E402
from torch_mesh_worker import PARALLEL_CASES  # noqa: E402

KW = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=2, heads=2, dim_head=16, mlp_dim=64)
LOSS_RTOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
TX = {"sgd": lambda: optax.sgd(1e-2), "adam": lambda: optax.adam(1e-3)}


def _batch():
    rng = np.random.default_rng(1)
    return rng.standard_normal((8, 3, 32, 32)).astype(np.float32), (np.arange(8) % 5).astype(np.int32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model = JaxViT(**KW)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"])
    images, labels = _batch()
    results = world.run_world(tmp_path_factory.mktemp("parallel"), "parallel", 4, {
        "kw": KW, "state_dict": vit_state_dict_from_jax(params),
        "images": torch.from_numpy(images), "labels": torch.from_numpy(labels).long(),
    })
    return model, params, images, labels, results


def _jax_sharded(model, params, images, labels, case):
    shape, fsdp, opt, accum = PARALLEL_CASES[case]
    state = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)), TX[opt]())
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    state = state.replace(opt_state=state.tx.init(state.params))
    mesh = make_mesh(*shape, devices=jax.devices("cpu")[: shape[0] * shape[1]])
    state = shard_train_state(state, mesh, fsdp=fsdp, fsdp_min_size=512)
    step = make_sharded_train_step(model, mesh, donate=False, grad_accum=accum)
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(2))
    return state, metrics, mesh


@pytest.mark.parametrize("case", ["dp", "tp", "fsdp", "accum", "tp_adam", "fsdp_dp"])
def test_sharded_step_matches_the_jax_sharded_step(setup, case):
    model, params, images, labels, results = setup
    got = world.check(results[0], case)
    state, metrics, _ = _jax_sharded(model, params, images, labels, case)
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["accuracy"], float(metrics["accuracy"]), rtol=1e-6)
    want = vit_state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    assert set(got["params"]) == set(want)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("case", ["dp", "tp", "fsdp", "accum", "tp_adam", "fsdp_dp"])
def test_ranks_agree(setup, case):
    """Every rank ends with the same whole parameters and reports the global
    batch's loss and accuracy."""
    results = setup[-1]
    first = world.check(results[0], case)
    for result in results[1:]:
        other = world.check(result, case)
        assert other["loss"] == first["loss"] and other["accuracy"] == first["accuracy"]
        for name, p in first["params"].items():
            assert torch.equal(other["params"][name], p), name


@pytest.mark.parametrize("case", ["dp", "tp", "fsdp", "tp_adam", "fsdp_dp"])
def test_param_placements_are_the_jax_specs(setup, case):
    """Each parameter's realized layout is the JAX spec of its param through
    the converter and the transpose.  On an axis of size 1 a JAX spec that
    names it holds the whole dim, as does the port's parameter, which stays
    a plain tensor along a 'model' axis of 1 (the kernels take plain
    tensors): the comparison drops the axes of size 1 from both."""
    model, params, images, labels, results = setup
    got = world.check(results[0], case)
    shape, fsdp, _, _ = PARALLEL_CASES[case]
    mesh = make_mesh(*shape, devices=jax.devices("cpu")[: shape[0] * shape[1]])
    shardings = infer_param_shardings_fsdp(params, mesh, min_size=512) if fsdp else infer_param_shardings(params, mesh)
    want = world.jax_specs_by_port_name(shardings, params, from_jax._VIT_MODULES, from_jax._TOP_LEVEL)
    sizes = dict(zip(("data", "model"), shape))
    assert set(want) == set(got["specs"])
    for name, spec in want.items():
        assert world.drop_unit_axes(got["specs"][name], sizes) == world.drop_unit_axes(spec, sizes), (
            name, got["specs"][name], spec)
    # data parallelism replicates every parameter; the other layouts shard some
    assert any(world.drop_unit_axes(spec, sizes) for spec in want.values()) == (case != "dp")


@pytest.mark.parametrize("case", ["fsdp", "tp_adam", "fsdp_dp"])
def test_adam_moments_follow_their_parameter(setup, case):
    """Adam's moments carry their parameter's placements on its mesh (a
    sharded moment saves the memory the sharded parameter does); the step
    counts are whole on every rank."""
    got = world.check(setup[-1][0], case)
    sharded = 0
    for name, moments in got["moments"].items():
        assert set(moments) == {"exp_avg", "exp_avg_sq"}, name
        for key, (spec, same) in moments.items():
            assert same, (name, key)
            assert spec == got["specs"][name], (name, key)
            sharded += bool(spec)
    assert sharded
    assert got["step_counts"] == ["Tensor"]


def test_kernel_gates_refuse_dtensor_weights(setup):
    """With the device test and the shape gates taken as true, the
    whole-layer and attention-block predicates refuse a tensor-parallel
    layer (plain x or DTensor x: its weights are DTensors), and accept the
    same unsharded layer."""
    got = world.check(setup[-1][0], "gates")
    assert got["whole_layer"] == [False, False]
    assert got["block"] == [False, False]
    assert got["plain_model"] == [True, True]
