"""The port's multi-process entry (parallel/mesh.py::initialize_distributed,
utils/data.py's placement over a mesh), the counterpart of
tests/test_multihost.py, on the CPU.

Four gloo processes (tests/torch_mesh_world.py) each call
``initialize_distributed`` twice (idempotent), build one global (4, 1)
mesh, keep their ``process_local_slice`` of one global batch and feed it
through ``prefetch_to_device(mesh=...)``, which assembles a batch of the
global shape; one data-parallel Adam step follows.  Every rank agrees, and
the loss and parameters match the JAX single-process step on the same
global batch (JAX's tolerances: loss rtol 2e-5 atol 1e-6; parameters atol
1e-5 rtol 1e-4).  On a (2, 2) mesh the slice and the batch follow the
rank's 'data' coordinate: the 'model' peers hold the same rows.  A mesh
that leaves ranks idle warns, as JAX's does."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.parallel.train import create_train_state, make_train_step
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_world as world  # noqa: E402

KW = dict(image_size=16, patch_size=8, num_classes=5, dim=32, depth=1, heads=2, mlp_dim=64)


def _global_batch():
    g = np.random.default_rng(7)
    return g.normal(size=(8, 3, 16, 16)).astype(np.float32), g.integers(0, 5, size=(8,)).astype(np.int32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model = JaxViT(**KW)
    state = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)), optax.adam(1e-3))
    X, Y = _global_batch()
    ranks = world.run_world(tmp_path_factory.mktemp("multihost"), "multihost", 4, {
        "kw": KW, "state_dict": vit_state_dict_from_jax(jax.tree.map(np.asarray, state.params)),
        "images": torch.from_numpy(X), "labels": torch.from_numpy(Y).long(),
    })
    new, metrics = make_train_step(model, donate=False)(state, jnp.asarray(X), jnp.asarray(Y),
                                                         jax.random.PRNGKey(3))
    return ranks, float(metrics["loss"]), vit_state_dict_from_jax(jax.tree.map(np.asarray, new.params))


def test_initialize_distributed_twice(setup):
    for rank, r in enumerate(setup[0]):
        assert world.check(r, "initialize") == (rank, 4)
        assert world.check(r, "initialize_again") == (rank, 4)


def test_prefetch_assembles_the_global_batch(setup):
    X, Y = _global_batch()
    for r in setup[0]:
        assert world.check(r, "local_rows") == 2
        shape, placements, x, y = world.check(r, "global_shape")
        assert shape == (8, 3, 16, 16) and placements == "(Shard(dim=0), Replicate())"
        np.testing.assert_array_equal(x.numpy(), X)
        np.testing.assert_array_equal(y.numpy(), Y)


def test_ranks_agree_with_each_other_and_with_jax(setup):
    ranks, want_loss, want_params = setup
    losses = [world.check(r, "loss") for r in ranks]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], want_loss, rtol=2e-5, atol=1e-6)
    for r in ranks:
        for name, p in world.check(r, "params").items():
            np.testing.assert_allclose(p.numpy(), want_params[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
            assert torch.equal(p, world.check(ranks[0], "params")[name])


def test_model_axis_peers_hold_the_same_rows(setup):
    """On a (2, 2) mesh ``process_local_slice(mesh=)`` takes the rows of the
    rank's 'data' coordinate, and the placed batch is the global one."""
    for r in setup[0]:
        data, model, rows = world.check(r, "grid_rows")
        assert rows == list(range(4 * data, 4 * data + 4))
        shape, placements, whole = world.check(r, "grid_global")
        assert shape == (8,) and placements == "(Shard(dim=0), Replicate())" and whole == list(range(8))


def test_grid_step_matches_jax(setup):
    """The sharded step on the (2, 2) mesh, handed the global batch (its
    qkv, projection out and FF weights sharded over 'model'), takes the
    same step as the JAX single-process one."""
    ranks, want_loss, _ = setup
    losses = {world.check(r, "grid_loss") for r in ranks}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), want_loss, rtol=2e-5, atol=1e-6)


def test_mesh_leaving_ranks_idle_warns(setup):
    for r in setup[0]:
        shape, ranks, warned = world.check(r, "idle")
        assert shape == (1, 3) and ranks == [[0, 1, 2]]
        assert any("leaving 1 device(s) idle" in w for w in warned)
