"""The port's mesh (vit_pytorch_tpu_torch/parallel/mesh.py) against the JAX
package's, on the CPU.

- Layout rules: for the flagship (ViT-B/16, built on ``meta``), a tiny ViT
  and a SimpleViT, each port parameter's spec from ``infer_param_shardings``
  and ``infer_param_shardings_fsdp`` (with ``min_size``) equals the JAX
  function's spec of its param on a JAX mesh of the same shape, named
  through ``utils/from_jax.py``'s tables and transposed as the converter
  transposes kernels.  The rules read only the mesh's axis names and sizes,
  so the port side takes a stand-in mesh here: no process group.
- ``make_mesh`` and ``initialize_distributed`` in a gloo world of 2 CPU
  processes (tests/torch_mesh_world.py): a larger mesh without a process
  group raises naming ``initialize_distributed``, a 1 x 1 mesh starts a
  world of one itself, the initialisation is idempotent, the defaults and
  the errors follow JAX's (too few devices, no card without the CPU being
  asked for: the CPU is never taken unasked), a subset of the ranks, and
  ``global_array_from_process_local``."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from vit_pytorch_tpu.models.simple_vit import SimpleViT as JaxSimpleViT
from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.parallel import mesh as jax_mesh
from vit_pytorch_tpu_torch import SimpleViT, ViT
from vit_pytorch_tpu_torch.parallel import mesh as port_mesh
from vit_pytorch_tpu_torch.utils import from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_world as world  # noqa: E402

FLAGSHIP = dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=12, mlp_dim=3072)
TINY = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=2, heads=2, dim_head=16, mlp_dim=64)
SIMPLE = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)
MODELS = {
    "flagship": (JaxViT, ViT, FLAGSHIP, from_jax._VIT_MODULES, from_jax._TOP_LEVEL),
    "tiny_vit": (JaxViT, ViT, TINY, from_jax._VIT_MODULES, from_jax._TOP_LEVEL),
    "simple_vit": (JaxSimpleViT, SimpleViT, SIMPLE, from_jax._SIMPLE_VIT_MODULES, ()),
}
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8), (1, 1)]


def _stand_in(data, model):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(data, model))


@pytest.fixture(scope="module")
def shapes_of():
    cache = {}

    def get(name):
        if name not in cache:
            jax_cls, _, kw, _, _ = MODELS[name]
            size = kw["image_size"]
            cache[name] = jax.eval_shape(lambda: jax_cls(**kw).init(jax.random.PRNGKey(0),
                                                                     jnp.zeros((1, 3, size, size))))["params"]
        return cache[name]

    return get


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(MODELS))
def test_param_specs_are_the_jax_specs(shapes_of, name, shape, fsdp):
    jax_cls, port_cls, kw, modules, top_level = MODELS[name]
    params = shapes_of(name)
    jmesh = jax_mesh.make_mesh(*shape, devices=jax.devices("cpu")[: shape[0] * shape[1]])
    model = port_cls(**kw, device="meta")
    min_size = 2**14 if name == "flagship" else 512
    if fsdp:
        want = jax_mesh.infer_param_shardings_fsdp(params, jmesh, min_size=min_size)
        got = port_mesh.infer_param_shardings_fsdp(model, _stand_in(*shape), min_size=min_size)
    else:
        want = jax_mesh.infer_param_shardings(params, jmesh)
        got = port_mesh.infer_param_shardings(model, _stand_in(*shape))
    want = world.jax_specs_by_port_name(want, params, modules, top_level)
    assert set(got) == set(want)
    for param, sharding in got.items():
        assert sharding.spec == want[param], (param, sharding.spec, want[param])


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _stand_in(2, 2)
    assert port_mesh.Sharding(mesh, ("model", "data")).placements == (Shard(1), Shard(0))
    assert port_mesh.Sharding(mesh, (None, "model")).placements == (Replicate(), Shard(1))
    assert port_mesh.replicated(mesh).placements == (Replicate(), Replicate())
    assert port_mesh.batch_sharding(mesh).placements == (Shard(0), Replicate())


@pytest.mark.parametrize("name,spec", [
    ("transformer.layers.0.0.to_qkv.weight", ("model", None)),
    ("layers.3.0.to_q.weight", ("model", None)),
    ("x.to_kv.weight", ("model", None)),
    ("transformer.layers.1.1.net.1.weight", ("model", None)),
    ("transformer.layers.1.1.net.1.bias", ("model",)),
    ("transformer.layers.0.0.to_out.0.weight", (None, "model")),
    ("transformer.layers.0.0.to_out.weight", (None, "model")),
    ("transformer.layers.0.1.net.4.weight", (None, "model")),
    ("transformer.layers.0.1.net.3.weight", (None, "model")),
    ("transformer.layers.0.0.to_out.0.bias", ()),
    ("transformer.layers.0.1.net.4.bias", ()),
    ("transformer.layers.0.0.to_qkv.bias", ()),
    ("mlp_head.weight", ()),
    ("pos_embedding", ()),
])
def test_param_partition_spec_rules(name, spec):
    """The JAX rules (mesh.py:135-140) on the port's names, transposed:
    column-parallel kernels P(None, 'model') are weights sharded on dim 0,
    row-parallel P('model', None) on dim 1, fc1's bias P('model')."""
    assert port_mesh.param_partition_spec(name) == spec


def test_make_mesh_without_a_card_raises_here():
    """No card and no ``device_type="cpu"``: an error, before anything is
    initialised, as JAX's mis-sized request errors instead of taking the
    host CPUs."""
    assert not torch.cuda.is_available()
    with pytest.raises(ValueError, match="CUDA"):
        port_mesh.make_mesh()
    with pytest.raises(ValueError, match="initialize_distributed"):
        port_mesh.make_mesh(2, 2, device_type="cpu")
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.run_world(tmp_path_factory.mktemp("mesh"), "mesh", 2, {})


def test_larger_mesh_without_a_group_names_initialize_distributed(ranks):
    for r in ranks:
        kind, message = world.check(r, "larger_mesh_without_a_group")
        assert kind == "ValueError" and "initialize_distributed" in message


def test_one_by_one_mesh_starts_a_world_of_one(ranks):
    for r in ranks:
        assert world.check(r, "world_of_one") == (1, "gloo", (1, 1), ("data", "model"), "cpu")


def test_initialize_distributed_is_idempotent(ranks):
    for rank, r in enumerate(ranks):
        assert world.check(r, "initialize") == (rank, 2)
        assert world.check(r, "initialize_again") == (rank, 2)


def test_make_mesh_defaults(ranks):
    """``data`` fills the ranks after 'model' is taken, as JAX's fills the
    devices; ``allow_cpu_fallback`` takes the CPU only where no card is
    visible."""
    for r in ranks:
        assert world.check(r, "default") == (2, 1)
        assert world.check(r, "model_2") == (1, 2)
        assert world.check(r, "fallback") == ((2, 1), "cpu")


def test_make_mesh_errors_follow_jax(ranks):
    """Where JAX's ``make_mesh`` raises, the port's does: more devices asked
    of the default set than it has (ValueError from ``_available_devices``;
    JAX asked for 16 of its 8, the port for 4 and 3 of its 2 ranks), a mesh
    over more devices than given (AssertionError); and with no card and no
    CPU asked for, a ValueError, never the CPU."""
    with pytest.raises(ValueError, match="16 devices"):
        jax_mesh._available_devices(16)
    with pytest.raises(AssertionError):
        jax_mesh.make_mesh(data=2, model=2, devices=jax.devices("cpu")[:2])
    for r in ranks:
        for key, count in (("too_many", 4), ("too_wide", 3)):
            kind, message = world.check(r, key)
            assert kind == "ValueError" and f"{count} devices" in message
        assert world.check(r, "over_the_devices")[0] == "AssertionError"
        for key in ("no_card", "no_card_sized"):
            kind, message = world.check(r, key)
            assert kind == "ValueError" and "CUDA" in message and "device_type='cpu'" in message


def test_make_mesh_on_a_subset_of_the_ranks(ranks):
    for r in ranks:
        assert world.check(r, "subset") == ((1, 1), [[1]])


def test_global_array_from_process_local(ranks):
    """Each rank's (3, 2) rows become one (6, 2) tensor sharded on 'data',
    rank 0's rows first, as ``jax.make_array_from_process_local_data``
    assembles them."""
    want = torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * rank for rank in range(2)])
    for r in ranks:
        shape, placements, whole = world.check(r, "global_array")
        assert shape == (6, 2) and placements == "(Shard(dim=0), Replicate())"
        assert torch.equal(whole, want)
