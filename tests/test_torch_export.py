"""The port's program artifacts (``serving.export_model`` / ``load_model``)
and the kernel ops they trace, on the CPU.

- An artifact exported on the CPU (the plain composite) loads from bytes, a
  ``str`` and a ``pathlib.Path`` and serves batches of 1, 3 and 17 as the
  eager model does; it holds the program only (other variables change the
  output; the blob is smaller than the weights); a custom ``apply_fn``, the
  refusal of ``apply_kwargs`` beside one, SimpleViT's sincos table as a
  constant.
- The mesh artifact (tests/test_export.py:115-145), in a gloo world of 2
  CPU processes (tests/torch_mesh_world.py) on a (2, 1) mesh: exported with
  the Predictor's layout, loaded with the mesh, it serves every admissible
  batch (2, 4, 6) as the eager model does and refuses a batch that the
  data axis does not divide; the device count is checked both ways.
- The loaded artifact against the JAX ``export_model`` / ``load_model`` on
  the CPU at fp32.
- A program that calls a kernel op loads only in a process that has
  imported ``vit_pytorch_tpu_torch.ops``, and needs no model code.
- Every kernel op's ``register_fake`` under ``FakeTensorMode`` on
  ``device="cuda"`` gives the shape and dtype its plain twin gives on real
  CPU tensors, and its FLOP formula the twin's count."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.serving import export_model as jax_export_model
from vit_pytorch_tpu.serving import load_model as jax_load_model
from vit_pytorch_tpu_torch import SimpleViT, ViT
from vit_pytorch_tpu_torch.ops import flash_attention as fa
from vit_pytorch_tpu_torch.ops import fused_block as fb
from vit_pytorch_tpu_torch.ops import short_attention as sa
from vit_pytorch_tpu_torch.serving import export_model, load_model
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)
SIMPLE = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)
EAGER_ATOL = 1e-6
JAX_ATOL = 5e-5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def vit_artifact():
    model = ViT(**KW, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    return model, export_model(model, model.state_dict(), (3, 32, 32))


def _images(k, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((k, 3, 32, 32)).astype(np.float32))


@pytest.mark.parametrize("source", ["bytes", "str", "path"])
def test_round_trip_serves_every_batch(vit_artifact, tmp_path, source):
    model, blob = vit_artifact
    if source == "bytes":
        fn = load_model(blob)
    else:
        path = tmp_path / "vit.pt2"
        export_model(model, model.state_dict(), (3, 32, 32), path=str(path))
        assert path.read_bytes() == blob
        fn = load_model(str(path) if source == "str" else path)
    for k in (1, 3, 17):
        img = _images(k, seed=k)
        with torch.no_grad():
            want = model(img)
        got = fn(model.state_dict(), img)
        assert got.shape == (k, 10)
        torch.testing.assert_close(got, want, atol=EAGER_ATOL, rtol=0)


def test_artifact_is_program_only(vit_artifact):
    model, blob = vit_artifact
    assert len(blob) < sum(t.numel() * t.element_size() for t in model.state_dict().values())
    fn = load_model(blob)
    other = ViT(**KW, device="cpu", generator=torch.Generator().manual_seed(5)).eval()
    img = _images(4)
    with torch.no_grad():
        want = other(img)
    got = fn(other.state_dict(), img)
    torch.testing.assert_close(got, want, atol=EAGER_ATOL, rtol=0)
    assert not torch.allclose(got, fn(model.state_dict(), img))
    with pytest.raises(KeyError, match="lack"):
        fn({k: v for k, v in model.state_dict().items() if k != "cls_token"}, img)


def test_simple_vit_table_is_a_constant():
    model = SimpleViT(**SIMPLE, device="cpu", generator=torch.Generator().manual_seed(1)).eval()
    fn = load_model(export_model(model, model.state_dict(), (3, 32, 32)))
    assert "pos_embedding" not in model.state_dict()
    img = _images(3)
    with torch.no_grad():
        torch.testing.assert_close(fn(model.state_dict(), img), model(img), atol=EAGER_ATOL, rtol=0)


def test_custom_apply_fn_and_apply_kwargs():
    model = ViT(**KW, device="cpu").eval()
    fn = load_model(export_model(model, model.state_dict(), (3, 32, 32), apply_fn=lambda m, x: m(x).softmax(-1)))
    img = _images(2)
    with torch.no_grad():
        torch.testing.assert_close(fn(model.state_dict(), img), model(img).softmax(-1), atol=EAGER_ATOL, rtol=0)
    with pytest.raises(ValueError, match="apply_kwargs"):
        export_model(model, model.state_dict(), (3, 32, 32), apply_fn=lambda m, x: m(x), train=False)


def test_platforms_are_cpu_or_cuda(vit_artifact):
    model, _ = vit_artifact
    with pytest.raises(ValueError, match="platforms"):
        export_model(model, model.state_dict(), (3, 32, 32), platforms=("tpu",))


def test_loaded_artifact_matches_jax():
    jmodel = JaxViT(**KW)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))
    jfn = jax_load_model(jax_export_model(jmodel, variables, (3, 32, 32), platforms=("cpu",)))
    model = ViT(**KW, device="cpu").eval()
    model.load_state_dict(vit_state_dict_from_jax(jax.tree.map(np.asarray, variables["params"])))
    fn = load_model(export_model(model, model.state_dict(), (3, 32, 32), platforms=("cpu",)))
    for k in (1, 6):
        img = _images(k, seed=10 + k)
        np.testing.assert_allclose(fn(model.state_dict(), img).numpy(), np.asarray(jfn(variables, img.numpy())),
                                   atol=JAX_ATOL, rtol=0)


def test_kernel_op_artifact_needs_the_ops_module_only(tmp_path):
    """A program calling ``vit_torch::gemm_bf16`` (traced through the op on
    fake CPU tensors) is refused by ``load_model`` in a process that has not
    imported ``vit_pytorch_tpu_torch.ops``, naming that module; after the
    import it loads, and no model code was imported."""
    lin = torch.nn.Linear(64, 64).to(torch.bfloat16)
    path = tmp_path / "op.pt2"
    export_model(lin, lin.state_dict(), (4, 64), input_dtype=torch.bfloat16, path=str(path),
                 apply_fn=lambda m, x: torch.ops.vit_torch.gemm_bf16(x, m.weight, "qkv", m.bias, None, 0.0, None, 0))
    code = (
        "import sys, torch\n"
        "from vit_pytorch_tpu_torch.serving import load_model\n"
        f"path = {str(path)!r}\n"
        "try:\n"
        "    load_model(path)\n"
        "    raise SystemExit('loaded without the ops')\n"
        "except RuntimeError as e:\n"
        "    assert 'vit_pytorch_tpu_torch.ops' in str(e) and 'vit_torch::gemm_bf16' in str(e), e\n"
        "import vit_pytorch_tpu_torch.ops\n"
        "load_model(path)\n"
        "bad = [m for m in sys.modules if m.startswith(('vit_pytorch_tpu_torch.models', 'vit_pytorch_tpu_torch.nn'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


# ---------------------------------------------------------------------------
# the kernel ops' fake implementations and FLOP formulas


def _rnd(*shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


def _layer(dim=128, heads=2, mlp=256, seed=0):
    inner = heads * 64
    shapes = ((3 * inner, dim), (3 * inner,), (dim, inner), (dim,), (dim,), (dim,), (dim,), (dim,), (mlp, dim),
              (mlp,), (dim, mlp), (dim,))
    return tuple(_rnd(*s, seed=seed + i) for i, s in enumerate(shapes))


def _cases():
    """(name, wrapper call, twin call), each taking a dict of its operands
    (on whichever device they were made)."""
    x = dict(x=(2, 5, 128), w=(128,), b=(128,))
    gemm = dict(a=(2, 5, 128), w=(192, 128), bias=(192,), res=(2, 5, 192))
    attn = dict(qkv=(2, 9, 3 * 2 * 64), g=(128,))
    flash = dict(q=(2, 2, 9, 64), k=(2, 2, 11, 64), v=(2, 2, 11, 64), bias=(1, 2, 9, 11))
    short = dict(q=(2, 2, 9, 64), k=(2, 2, 11, 64), v=(2, 2, 11, 64), bias=(2, 9, 11))
    cases = [("layernorm_rows", x, lambda o, f: f.layernorm_rows(o["x"], o["w"], o["b"]))]
    for epi, kw in (("qkv", dict(bias=True)), ("cast", {}), ("out", dict(bias=True, res=True)),
                    ("fc1", dict(bias=True)), ("fc2", dict(bias=True, res=True)), ("block_out", dict(res=True)),
                    ("fc1_f32", dict(bias=True))):
        cases.append((f"gemm_bf16[{epi}]", gemm, lambda o, f, epi=epi, kw=kw: f.gemm_bf16(
            o["a"], o["w"], epi, bias=o["bias"] if kw.get("bias") else None,
            residual=o["res"] if kw.get("res") else None, heads=2)))
    for tag, kw in (("", {}), ("[qknorm]", dict(qk=True)), ("[n_keys]", dict(n_keys=6))):
        cases.append((f"attention_rows{tag}", attn, lambda o, f, kw=kw: f.attention_rows(
            o["qkv"], heads=2, dim_head=64, scale=0.125, n_keys=kw.get("n_keys"),
            gamma_q=o["g"] if kw.get("qk") else None, gamma_k=o["g"] if kw.get("qk") else None)))
    cases.append(("stack_layers", dict(x=(2, 9, 128)), "stack"))
    for tag, kw in (("", {}), ("[causal]", dict(causal=True)), ("[bias]", dict(bias=True))):
        cases.append((f"flash_fwd{tag}", flash, lambda o, f, kw=kw: f.flash_fwd(
            o["q"], o["k"], o["v"], scale=0.125, causal=kw.get("causal", False),
            bias=o["bias"] if kw.get("bias") else None)))
    for tag, kw in (("", {}), ("[bias]", dict(bias=True))):
        cases.append((f"short_attention{tag}", short, lambda o, f, kw=kw: f.short_fwd(
            o["q"], o["k"], o["v"], scale=0.125, bias=o["bias"] if kw.get("bias") else None)))
    return cases


CASES = _cases()


class _Twins:
    """The wrappers' plain twins under the wrappers' names."""
    layernorm_rows = staticmethod(fb.layernorm_rows_reference)
    gemm_bf16 = staticmethod(fb.gemm_bf16_reference)
    attention_rows = staticmethod(fb.attention_rows_reference)
    flash_fwd = staticmethod(fa.flash_fwd_reference)
    short_fwd = staticmethod(sa.short_attention_reference)


class _Wrappers:
    layernorm_rows = staticmethod(fb.layernorm_rows)
    gemm_bf16 = staticmethod(fb.gemm_bf16)
    attention_rows = staticmethod(fb.attention_rows)
    flash_fwd = staticmethod(fa.flash_fwd)
    short_fwd = staticmethod(sa.short_fwd)


def _call(call, operands, f, stack_layers):
    if call == "stack":
        return stack_layers(operands["x"], operands["layers"], heads=2, dim_head=64, scale=0.125)
    return call(operands, f)


def _real_operands(shapes):
    ops = {k: _rnd(*s, seed=i) for i, (k, s) in enumerate(shapes.items())}
    if "x" in shapes and len(shapes) == 1:
        ops["layers"] = [_layer(seed=10), _layer(seed=30)]
    return ops


@pytest.mark.parametrize("name,shapes,call", CASES, ids=[c[0] for c in CASES])
def test_fake_op_on_cuda_matches_the_twin(name, shapes, call):
    real = _real_operands(shapes)
    with FlopCounterMode(display=False) as twin_flops:
        want = _call(call, real, _Twins, fb.stack_layers_reference)
    with FakeTensorMode():
        fake = {k: torch.empty(v.shape, dtype=v.dtype, device="cuda") if isinstance(v, torch.Tensor) else
                [tuple(torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in lw) for lw in v]
                for k, v in real.items()}
        with FlopCounterMode(display=False) as op_flops:
            got = _call(call, fake, _Wrappers, fb.stack_layers)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype), name
    assert op_flops.get_total_flops() == twin_flops.get_total_flops(), name
    if op_flops.get_total_flops():  # counted by the op's formula, not by a plain product
        assert all(str(op).startswith("vit_torch.") for op in op_flops.get_flop_counts()["Global"]), name


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_world as world

    model = ViT(**KW, device="cpu", generator=torch.Generator().manual_seed(0))
    return world, world.run_world(tmp_path_factory.mktemp("export"), "export", 2, {
        "kw": KW, "state_dict": model.state_dict(), "images": _images(6),
    })


def test_export_mesh_sharded_serving(mesh_ranks):
    world, ranks = mesh_ranks
    for r in ranks:
        for k, (served, eager) in world.check(r, "served").items():
            assert served.shape == (k, 10)
            torch.testing.assert_close(served, eager, atol=1e-5, rtol=1e-5)
        assert "must divide by process_count 2" in world.check(r, "odd_batch")
        meta = world.check(r, "meta")
        assert meta["batch_symbol"] == "2*b" and meta["devices"] == 2 and meta["mesh"] == {"data": 2, "model": 1}


def test_export_mesh_device_count_checked(mesh_ranks):
    world, ranks = mesh_ranks
    for r in ranks:
        assert "2 devices" in world.check(r, "single_device_load")
        assert "2 devices" in world.check(r, "smaller_mesh_load")
        assert "1 devices" in world.check(r, "plain_on_a_mesh")
        assert world.check(r, "plain_on_one")
