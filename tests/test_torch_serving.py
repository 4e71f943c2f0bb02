"""The port's Predictor on the CPU in fp32: padding up to a bucket and
chunking by the largest bucket give what a direct forward gives; and the
package imports without JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_pytorch_tpu_torch import ViT
from vit_pytorch_tpu_torch.serving import Predictor

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
