"""The port's Predictor on the CPU in fp32: padding up to a bucket and
chunking by the largest bucket give what a direct forward gives; the
package imports without JAX; ``input_dtype``, ``apply_fn``, ``aot`` against
``compiled_buckets``, ``cost_analysis`` against the count from the widths,
``from_checkpoint`` of a ViT and of a SimpleViT (whose sincos table is a
non-persistent buffer) bitwise the in-memory Predictor's, and the port's
Predictor against the JAX one at fp32.

Mesh serving (the counterpart of tests/test_serving.py:98-140) runs in a
gloo world of 2 CPU processes (tests/torch_mesh_world.py) on a (2, 1)
mesh: parameters replicated, each rank's half of the padded bucket, the
output gathered over 'data', equal to the one-device Predictor (JAX's
atol 1e-5) at k = 1, 3, 4 and 7 (padding and chunking); buckets that do not
divide by the data axis are refused."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.serving import Predictor as JaxPredictor
from vit_pytorch_tpu_torch import SimpleViT, ViT
from vit_pytorch_tpu_torch.parallel.train import create_train_state
from vit_pytorch_tpu_torch.serving import Predictor
from vit_pytorch_tpu_torch.utils.checkpoint import save_checkpoint
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)
# fp32 on the CPU; padding rows change the GEMMs' blocking, so allow a few ulps
ATOL, RTOL = 1e-5, 1e-5


@pytest.mark.parametrize("k", [3, 11])
def test_predictor_pads_and_chunks(k):
    model = ViT(**KW, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    pred = Predictor(
        model, example_shape=(3, 32, 32), batch_sizes=(2, 4), param_dtype=torch.float32, device="cpu"
    ).warmup()
    img = torch.from_numpy(np.random.default_rng(k).standard_normal((k, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want = model(img)
    got = pred(img)
    assert got.shape == (k, 10)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert next(model.parameters()).requires_grad  # the caller's model is untouched


def test_predictor_rejects_wrong_example_shape():
    pred = Predictor(ViT(**KW, device="cpu"), example_shape=(3, 32, 32), batch_sizes=(2,), param_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        pred(torch.zeros(1, 3, 16, 16))


def test_package_imports_without_jax():
    root = Path(__file__).resolve().parents[1]
    code = "import sys, vit_pytorch_tpu_torch, vit_pytorch_tpu_torch.serving, vit_pytorch_tpu_torch.utils.from_jax; assert 'jax' not in sys.modules, 'jax imported'"
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_module_imports_without_jax():
    """Every module of the package, found by walking it, imports in a fresh
    interpreter without bringing in JAX, flax or the JAX package."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys, vit_pytorch_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vit_pytorch_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 80  # the walk found the models, ops, nn, ssl, tools, ... modules


SIMPLE = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)
JAX_ATOL = 5e-5  # the port against the JAX Predictor, fp32 on the CPU


def _vit(seed=0):
    return ViT(**KW, device="cpu", generator=torch.Generator().manual_seed(seed)).eval()


def _images(k, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((k, 3, 32, 32)).astype(np.float32))


def test_input_dtype_sets_the_batch_dtype():
    seen = []

    def apply_fn(model, x):
        seen.append(x.dtype)
        return model(x.float())

    pred = Predictor(_vit(), example_shape=(3, 32, 32), batch_sizes=(2,), param_dtype=torch.float32,
                     input_dtype=torch.float64, apply_fn=apply_fn, device="cpu")
    assert pred.input_dtype == torch.float64 and pred(_images(1)).shape == (1, 10)
    assert set(seen) == {torch.float64}
    assert Predictor(_vit(), example_shape=(3, 32, 32), batch_sizes=(2,), param_dtype=torch.float32,
                     aot=False, device="cpu").input_dtype == torch.float32  # defaults to param_dtype


def test_apply_fn_runs_on_the_served_copy():
    model = _vit()
    pred = Predictor(model, example_shape=(3, 32, 32), batch_sizes=(4,), param_dtype=torch.float32,
                     apply_fn=lambda m, x: m(x)[:, :3], device="cpu")
    img = _images(3)
    with torch.no_grad():
        want = model(img)[:, :3]
    torch.testing.assert_close(pred(img), want, atol=ATOL, rtol=RTOL)


def test_aot_and_compiled_buckets():
    kw = dict(example_shape=(3, 32, 32), batch_sizes=(4, 2), param_dtype=torch.float32, device="cpu")
    assert Predictor(_vit(), **kw).compiled_buckets == (2, 4)
    lazy = Predictor(_vit(), aot=False, **kw)
    assert lazy.compiled_buckets == ()
    lazy(_images(3))
    assert lazy.compiled_buckets == (4,)
    assert lazy.warmup().compiled_buckets == (2, 4)


def _vit_flops(b, n=17, patch_dim=3 * 8 * 8, dim=64, depth=2, inner=64, heads=4, dim_head=16, mlp=128, classes=10):
    """The forward's products from the widths, 2 FLOP a multiply-add: the
    patch embedding, per layer qkv, out, fc1, fc2, q.k^T and p.v, and the
    head on the cls token."""
    patches = b * (n - 1)
    layer = 2 * b * n * (dim * 3 * inner + inner * dim + 2 * dim * mlp) + 2 * 2 * b * heads * n * n * dim_head
    return 2 * patches * patch_dim * dim + depth * layer + 2 * b * dim * classes


@pytest.mark.parametrize("bucket", [None, 1, 8])
def test_cost_analysis_counts_the_products(bucket):
    pred = Predictor(_vit(), example_shape=(3, 32, 32), batch_sizes=(1, 8, 16), param_dtype=torch.float32,
                     aot=False, device="cpu")
    assert pred.cost_analysis(bucket) == {"flops": _vit_flops(bucket or 16)}
    assert pred.compiled_buckets == ()  # the trace launches nothing


@pytest.mark.parametrize("kind", ["vit", "simple_vit"])
@pytest.mark.parametrize("layout", ["params", "train_state"])
def test_from_checkpoint_is_bitwise_the_in_memory_predictor(tmp_path, kind, layout):
    def make(device, generator=None):
        cls, kw = (ViT, KW) if kind == "vit" else (SimpleViT, SIMPLE)
        return cls(**kw, device=device, generator=generator)

    model = make("cpu", torch.Generator().manual_seed(0))
    if layout == "params":
        save_checkpoint(str(tmp_path / "ckpt"), {"params": model.state_dict()})
    else:
        save_checkpoint(str(tmp_path / "ckpt"), create_train_state(model))
    kw = dict(batch_sizes=(2, 4), device="cpu")
    want = Predictor(model, example_shape=(3, 32, 32), **kw)
    skeleton = make("meta")
    assert all(p.is_meta for p in skeleton.parameters())
    got = Predictor.from_checkpoint(skeleton, str(tmp_path / "ckpt"), torch.zeros(1, 3, 32, 32), **kw)
    assert got.example_shape == (3, 32, 32) and got.compiled_buckets == (2, 4)
    img = _images(7, seed=2)
    assert torch.equal(got(img), want(img))


def test_from_checkpoint_refuses_other_trees(tmp_path):
    save_checkpoint(str(tmp_path / "c"), {"weights": torch.zeros(2)})
    with pytest.raises(ValueError, match="TrainState"):
        Predictor.from_checkpoint(_vit(), str(tmp_path / "c"), torch.zeros(1, 3, 32, 32), device="cpu")


@pytest.mark.parametrize("k", [1, 5, 9])
def test_predictor_matches_jax(k):
    jmodel = JaxViT(**KW)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))
    jpred = JaxPredictor(jmodel, variables, example_shape=(3, 32, 32), batch_sizes=(2, 4), param_dtype=jnp.float32)
    model = ViT(**KW, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(jax.tree.map(np.asarray, variables["params"])))
    pred = Predictor(model, example_shape=(3, 32, 32), batch_sizes=(2, 4), param_dtype=torch.float32, device="cpu")
    img = _images(k, seed=k)
    np.testing.assert_allclose(pred(img).numpy(), np.asarray(jpred(img.numpy())), atol=JAX_ATOL, rtol=0)


def test_predictor_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(_vit(), example_shape=(3, 32, 32))


def test_entry_is_the_zero_weight_flagship():
    """``entry()``: ViT-B/16 @224 in bf16 with zero weights and a batch of 8
    ones, as the JAX ``__graft_entry__.py::entry``; zero weights give zero
    logits."""
    from vit_pytorch_tpu_torch.entry import entry

    forward, (img,) = entry("cpu")
    assert img.shape == (8, 3, 224, 224) and img.dtype == torch.bfloat16 and bool((img == 1).all())
    out = forward(img[:1])
    assert out.shape == (1, 1000) and out.dtype == torch.bfloat16 and not out.any()


def test_entry_takes_the_card_by_default(monkeypatch):
    from vit_pytorch_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_world as world

    model = ViT(**KW, device="cpu", generator=torch.Generator().manual_seed(0))
    simple_kw = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)
    simple = SimpleViT(**simple_kw, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 3, 32, 32)).astype(np.float32))
    return world, world.run_world(tmp_path_factory.mktemp("serving"), "serving", 2, {
        "kw": KW, "state_dict": model.state_dict(), "images": x,
        "simple_kw": simple_kw, "simple_state_dict": simple.state_dict(),
    })


def test_mesh_sharded_serving_matches_single_device(mesh_ranks):
    world, ranks = mesh_ranks
    for r in ranks:
        assert world.check(r, "buckets") == (2, 4)
        for k, (single, sharded) in world.check(r, "logits").items():
            assert sharded.shape == (k, 10)
            torch.testing.assert_close(sharded, single, atol=1e-5, rtol=0)
    for k in (1, 3, 4, 7):
        assert torch.equal(world.check(ranks[0], "logits")[k][1], world.check(ranks[1], "logits")[k][1])


def test_mesh_serving_of_a_simple_vit(mesh_ranks):
    """SimpleViT's sincos table (a non-persistent buffer) rides along."""
    world, ranks = mesh_ranks
    for r in ranks:
        served, eager = world.check(r, "simple")
        torch.testing.assert_close(served, eager, atol=1e-5, rtol=0)


def test_mesh_rejects_indivisible_buckets(mesh_ranks):
    world, ranks = mesh_ranks
    for r in ranks:
        assert "multiples" in world.check(r, "indivisible")
