"""The port's checkpoints (vit_pytorch_tpu_torch/utils/checkpoint.py) on the
CPU: round trips of a ``TrainState`` and of a dict, the manager's retention,
interval, discovery, async snapshot and flush; a bit-exact resume of a
training run with dropout (the JAX tests/test_checkpoint.py:122 contract);
and the port's checkpointed loop against the JAX one (``make_train_step`` +
``CheckpointManager`` + ``minibatches``) from the same weights on the same
rows, params within ``tests/test_torch_train.py``'s fp32 tolerances.

Across layouts, in a gloo world of 2 CPU processes
(tests/torch_mesh_world.py): an FSDP state (``fsdp_min_size=512``) after
one step is saved (gathered, rank 0 writes) and restored bitwise into a
(1, 2) tensor-parallel layout there and into one device here; a
one-device checkpoint written here restores bitwise into the FSDP layout
there; a dict holding a DTensor restores into a placed target; the
manager's async saves of DTensors commit once, seen by every rank."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.parallel.train import create_train_state as jax_create_train_state
from vit_pytorch_tpu.parallel.train import make_train_step as jax_make_train_step
from vit_pytorch_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from vit_pytorch_tpu.utils.data import minibatches as jax_minibatches
from vit_pytorch_tpu_torch import ViT
from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step
from vit_pytorch_tpu_torch.utils.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from vit_pytorch_tpu_torch.utils.data import minibatches
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)
ATOL, RTOL = 5e-5, 1e-4  # tests/test_torch_train.py's fp32 parity bar
JOIN_TIMEOUT = 30.0


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 3, 32, 32)).astype(np.float32),
            "y": rng.integers(0, KW["num_classes"], n).astype(np.int64)}


def _state(seed=0, **model_kw):
    model = ViT(**KW, **model_kw, device="cpu", generator=torch.Generator().manual_seed(seed))
    return create_train_state(model)


def _step(state, gen=None, batch=None):
    batch = batch if batch is not None else _data(4, seed=state.step)
    step = make_train_step(state.model)
    return step(state, torch.from_numpy(batch["x"]), torch.from_numpy(batch["y"]), gen)


def _assert_states_equal(a, b):
    for (name, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for key in sa["state"][i]:
            assert torch.equal(sa["state"][i][key], sb["state"][i][key]), (i, key)
    assert a.step == b.step


def test_train_state_round_trip(tmp_path):
    state = _state()
    _step(state)
    save_checkpoint(str(tmp_path / "ckpt"), state, step=1)
    fresh = _state(seed=9)
    restored = restore_checkpoint(str(tmp_path / "ckpt"), fresh, step=1)
    assert restored is fresh  # loaded in place
    _assert_states_equal(fresh, state)
    # continuing from the restore matches continuing from the original
    batch = _data(4, seed=7)
    m1, m2 = _step(state, batch=batch), _step(fresh, batch=batch)
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_states_equal(fresh, state)


def test_dict_round_trip_and_mismatch(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "count": 3, "nested": [torch.ones(2, dtype=torch.int32), 1.5]}
    save_checkpoint(str(tmp_path / "d"), tree)
    target = {"w": torch.zeros(2, 3), "count": 0, "nested": [torch.zeros(2, dtype=torch.int32), 0.0]}
    got = restore_checkpoint(str(tmp_path / "d"), target)
    assert torch.equal(got["w"], tree["w"]) and got["count"] == 3
    assert torch.equal(got["nested"][0], tree["nested"][0]) and got["nested"][1] == 1.5
    with pytest.raises(ValueError, match="target"):
        restore_checkpoint(str(tmp_path / "d"), {**target, "w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="target"):
        restore_checkpoint(str(tmp_path / "d"), {**target, "w": torch.zeros(2, 3, dtype=torch.float64)})
    with pytest.raises(ValueError, match="keys"):
        restore_checkpoint(str(tmp_path / "d"), {"w": torch.zeros(2, 3)})


def test_train_state_shape_mismatch_raises(tmp_path):
    state = _state()
    _step(state)
    save_checkpoint(str(tmp_path / "c"), state)
    other = create_train_state(ViT(**{**KW, "mlp_dim": 64}, device="cpu"))
    with pytest.raises(ValueError, match="model/"):
        restore_checkpoint(str(tmp_path / "c"), other)


def test_manager_retention_and_latest(tmp_path):
    state = {"w": torch.arange(4.0), "count": 0}
    with CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(state)
        for step in range(1, 6):
            assert mgr.save(step, {"w": state["w"] * step, "count": step})
        mgr.wait_until_finished()
        assert mgr.latest_step() == 5
        assert list(mgr.all_steps()) == [4, 5]
    # a fresh manager discovers the steps on disk
    with CheckpointManager(str(tmp_path / "ckpts")) as mgr2:
        assert mgr2.latest_step() == 5
        restored = mgr2.restore(state)
        assert torch.equal(restored["w"], torch.arange(4.0) * 5)
        assert mgr2.restore(state, step=4)["count"] == 4


def test_manager_interval_and_force(tmp_path):
    tree = {"w": torch.zeros(2)}
    with CheckpointManager(str(tmp_path), save_interval_steps=2, async_save=False) as mgr:
        assert mgr.save(1, tree) is False
        assert mgr.save(2, tree) is True
        assert mgr.save(3, tree) is False
        assert mgr.save(3, tree, force=True) is True
        assert mgr.save(2, tree) is False  # not after the latest step
        assert mgr.save(4, tree, metrics={"loss": 0.5}) is True
        assert list(mgr.all_steps()) == [2, 3, 4]


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nothing"), {"w": torch.zeros(1)})


def test_leftover_temporary_directory_is_never_a_step(tmp_path):
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, {"w": torch.ones(1)})
        # a save cut off before its rename, and a step directory without its file
        os.makedirs(tmp_path / ".tmp-2-deadbeef")
        torch.save({"w": torch.ones(1)}, tmp_path / ".tmp-2-deadbeef" / "state.pt")
        os.makedirs(tmp_path / "3")
        assert list(mgr.all_steps()) == [1]
        assert mgr.latest_step() == 1


def test_async_save_snapshots_before_the_next_step(tmp_path):
    """An optimizer step right after an async save must not reach the
    checkpoint: the restore gives the pre-step parameters and moments."""
    state = _state()
    _step(state)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    want_moments = {i: {k: v.clone() for k, v in s.items()} for i, s in state.optimizer.state_dict()["state"].items()}
    with CheckpointManager(str(tmp_path), async_save=True) as mgr:
        assert mgr.save(1, state)
        _step(state)  # updates the live tensors in place at once
        mgr.wait_until_finished()
        fresh = mgr.restore(_state(seed=3))
    assert any(not torch.equal(t, want[name]) for name, t in state.model.state_dict().items())  # the step ran
    for name, t in fresh.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    got_moments = fresh.optimizer.state_dict()["state"]
    for i, moments in want_moments.items():
        for key, t in moments.items():
            assert torch.equal(got_moments[i][key], t), (i, key)
    assert fresh.step == 1


def test_close_and_context_manager_flush(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(1, {"w": torch.ones(3)})
    writer = mgr._writer
    mgr.close()
    assert writer is None or not writer.is_alive()
    assert mgr.latest_step() == 1
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(2, {"w": torch.ones(3)})
    with CheckpointManager(str(tmp_path / "b")) as mgr:
        mgr.save(7, {"w": torch.ones(3)})
        writer = mgr._writer
    if writer is not None:
        writer.join(JOIN_TIMEOUT)
        assert not writer.is_alive()
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 7


def test_async_save_error_is_raised_to_the_caller(tmp_path):
    """A failed background write raises at the next wait, and leaves no
    step behind."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"f": lambda: 0})  # torch.save cannot pickle a lambda
    with pytest.raises(Exception, match="pickle|lambda"):
        mgr.wait_until_finished()
    assert mgr.latest_step() is None and os.listdir(tmp_path) == []
    mgr.close()


# ---------------------------------------------------------------------------
# resume mid-training


def _port_run(epochs, ckpt_dir, resume, data, batch_size=16, **model_kw):
    """Epochs of ``minibatches(rng=default_rng((1, epoch)))`` through
    ``make_train_step`` with a generator seeded per epoch, checkpointed each
    epoch; with ``resume`` a new model and optimizer restore the latest
    step first."""
    state = _state(seed=11 if resume else 0, **model_kw)
    step = make_train_step(state.model)
    with CheckpointManager(ckpt_dir, max_to_keep=3) as mgr:
        start = 0
        if resume and mgr.latest_step() is not None:
            mgr.restore(state)
            start = mgr.latest_step()
        for epoch in range(start, epochs):
            gen = torch.Generator().manual_seed(1000 + epoch)
            for batch in minibatches(data, batch_size, rng=np.random.default_rng((1, epoch))):
                step(state, torch.as_tensor(batch["x"]), torch.as_tensor(batch["y"]), gen)
            mgr.save(epoch + 1, state)
    return state


def test_resume_mid_training_bit_exact(tmp_path):
    """Interrupt after 2 epochs, resume from the checkpoint into a fresh
    model and optimizer, finish at 4: params and Adam state BIT-exact with
    an uninterrupted 4-epoch run (fp32, dropout 0.1 from a generator seeded
    per epoch)."""
    data = _data(48, seed=5)
    kw = dict(dropout=0.1, emb_dropout=0.1)
    full = _port_run(4, str(tmp_path / "full"), False, data, **kw)
    _port_run(2, str(tmp_path / "split"), False, data, **kw)
    resumed = _port_run(4, str(tmp_path / "split"), True, data, **kw)
    _assert_states_equal(resumed, full)
    assert full.step == 4 * 3


def _jax_run(params, data, ckpt_dir, epochs, resume):
    jmodel = JaxViT(**KW)
    state = jax_create_train_state(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)), optax.adam(3e-4))
    state = state.replace(params=params)
    state = state.replace(opt_state=state.tx.init(params))
    step = jax_make_train_step(jmodel, donate=False)
    with JaxCheckpointManager(ckpt_dir, max_to_keep=2) as mgr:
        start = 0
        if resume:
            state = mgr.restore(state)
            start = mgr.latest_step()
        for epoch in range(start, epochs):
            for batch in jax_minibatches(data, 8, rng=np.random.default_rng((1, epoch))):
                state, _ = step(state, jnp.asarray(batch["x"]), jnp.asarray(batch["y"]), jax.random.PRNGKey(epoch))
            mgr.save(epoch + 1, state)
    return state


def test_checkpointed_loop_matches_jax(tmp_path):
    """2 + 2 Adam steps with a checkpoint and a resume between them, from
    the same weights on the same rows: the port against the JAX loop."""
    data = _data(16, seed=3)
    data["y"] = data["y"].astype(np.int32)
    jmodel = JaxViT(**KW)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"])

    _jax_run(params, data, str(tmp_path / "jax"), 1, False)
    jax_state = _jax_run(params, data, str(tmp_path / "jax"), 2, True)

    def port_run(epochs, resume):
        model = ViT(**KW, device="cpu")
        if not resume:
            model.load_state_dict(vit_state_dict_from_jax(params))
        state = create_train_state(model)
        step = make_train_step(model)
        with CheckpointManager(str(tmp_path / "port"), max_to_keep=2) as mgr:
            start = 0
            if resume:
                mgr.restore(state)
                start = mgr.latest_step()
            for epoch in range(start, epochs):
                for batch in minibatches(data, 8, rng=np.random.default_rng((1, epoch))):
                    step(state, torch.from_numpy(batch["x"]), torch.from_numpy(batch["y"]).long())
                mgr.save(epoch + 1, state)
        return state

    port_run(1, False)
    port = port_run(2, True)
    assert port.step == 4 and int(jax_state.step) == 4
    want = vit_state_dict_from_jax(jax.tree.map(np.asarray, jax_state.params))
    for name, p in port.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL, err_msg=name)


def _whole(state):
    """Every tensor of a one-device TrainState by name, as the world's
    ``_full_state`` gathers them."""
    names = [n for n, _ in state.model.named_parameters()]
    sd = state.optimizer.state_dict()
    return {"model": state.model.state_dict(),
            "optimizer": {names[i]: m for i, m in sd["state"].items()}, "step": state.step}


def _assert_whole_equal(got, want):
    assert set(got["model"]) == set(want["model"])
    for name, t in want["model"].items():
        assert torch.equal(got["model"][name], t), name
    assert set(got["optimizer"]) == set(want["optimizer"])
    for name, moments in want["optimizer"].items():
        for key, t in moments.items():
            assert torch.equal(got["optimizer"][name][key], t), (name, key)
    assert got["step"] == want["step"]


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_world as world

    directory = tmp_path_factory.mktemp("checkpoint")
    model = ViT(**KW, device="cpu", generator=torch.Generator().manual_seed(0))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _data(4, seed=3)
    single = create_train_state(model)
    _step(single, batch=_data(4, seed=9))
    save_checkpoint(str(directory / "single"), single)
    ranks = world.run_world(directory, "checkpoint", 2, {
        "kw": KW, "state_dict": weights,
        "images": torch.from_numpy(batch["x"]), "labels": torch.from_numpy(batch["y"]),
    })
    return world, ranks, directory, single


def test_fsdp_checkpoint_restores_into_a_tp_layout(mesh_ranks):
    world, ranks, _, _ = mesh_ranks
    for r in ranks:
        assert any("data" in spec for spec in world.check(r, "fsdp_specs").values())
        assert any("model" in spec for spec in world.check(r, "tp_specs").values())
        _assert_whole_equal(world.check(r, "into_tp"), world.check(ranks[0], "saved"))
        m1, m2 = world.check(r, "next_losses")
        np.testing.assert_allclose(m2, m1, rtol=1e-5)
    assert world.check(ranks[0], "committed") == ["state.pt"]


def test_fsdp_checkpoint_restores_into_one_device(mesh_ranks):
    world, ranks, directory, _ = mesh_ranks
    state = _state(seed=1)
    restore_checkpoint(str(directory / "fsdp"), state)
    _assert_whole_equal(_whole(state), world.check(ranks[0], "saved"))


def test_one_device_checkpoint_restores_into_fsdp(mesh_ranks):
    world, ranks, _, single = mesh_ranks
    for r in ranks:
        _assert_whole_equal(world.check(r, "into_fsdp"), _whole(single))


def test_dtensor_tree_restores_into_placed_target(mesh_ranks):
    world, ranks, _, _ = mesh_ranks
    for r in ranks:
        assert world.check(r, "tree") == ("(Replicate(),)", True, 3)


def test_manager_commits_dtensor_saves_once(mesh_ranks):
    world, ranks, _, _ = mesh_ranks
    for r in ranks:
        assert world.check(r, "manager") == (2, [2])
