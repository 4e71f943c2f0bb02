"""Two repairs of the port, on the CPU:

- the dispatcher ``dot_product_attention`` (vit_pytorch_tpu_torch/ops/
  attention.py) computes causal attention and a per-head (h, n, m) or
  per-image (b, h, n, m) additive bias on its composite, as the JAX
  dispatcher does (vit_pytorch_tpu/ops/attention.py:183-188, :290-310), in
  fp32 against it; the causal triangle lands on q's device; ``use_flash``
  sends causal and a bias to the kernel routes JAX takes, on their twins;
- the CUDA sources ship with the package (``pyproject.toml``'s package
  data), and the kernels build under ``build/`` in a checkout and under a
  user cache directory, or ``$VIT_TORCH_BUILD_DIR``, outside one (nothing is
  compiled here).

Tolerance: fp32 on both sides, the same operations up to summation order,
as tests/test_torch_attention.py (atol 1e-6, rtol 1e-5)."""

import fnmatch
import tomllib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import attention as jax_attention
from vit_pytorch_tpu_torch.ops import _build, attention

REPO = Path(__file__).resolve().parents[1]
B, H, N, M, D = 2, 3, 6, 6, 8
ATOL, RTOL = 1e-6, 1e-5


def _inputs(m=M):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, H, N, D), (B, H, m, D), (B, H, m, D)))
    return q, k, v, rng


# (case, keywords of both dispatchers: causal, bias shape)
CASES = {
    "causal": (True, None),
    "per-head bias (h, n, m)": (False, (H, N, M)),
    "per-image bias (b, h, n, m)": (False, (B, H, N, M)),
    "causal and per-head bias": (True, (H, N, M)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_composite_matches_the_jax_dispatcher(case):
    causal, bias_shape = CASES[case]
    q, k, v, rng = _inputs()
    bias = None if bias_shape is None else rng.standard_normal(bias_shape).astype(np.float32)
    want = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bias=None if bias is None else jnp.asarray(bias),
    )
    got = attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        bias=None if bias is None else torch.from_numpy(bias),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_causal_mask_builds_on_q_device():
    """Without segment ids the triangle is built on the device it is given
    (the dispatcher passes q's), so a causal call on a device tensor never
    meets a CPU mask; the meta device stands in for a card here."""
    mask = attention.build_segment_mask(None, None, 4, 5, causal=True, device=torch.device("meta"))
    assert mask.device.type == "meta" and mask.shape == (4, 5)
    cpu = attention.build_segment_mask(None, None, 4, 5, causal=True)
    assert cpu.device.type == "cpu" and torch.equal(cpu, torch.ones(4, 5, dtype=torch.bool).tril())
    q = torch.empty(1, 2, 4, 8, device="meta")
    out = attention.dot_product_attention(q, q, q, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape


@pytest.mark.parametrize("kw,match", [
    (dict(causal=True), "item 4"),  # flash causal
    (dict(bias=torch.zeros(H, N, M)), "item 6"),  # the short kernel takes a per-head bias
    (dict(bias=torch.zeros(B, H, N, M), seg=True), "item 4"),  # flash with a bias
    (dict(causal=True, seg=True), "item 4"),
])
def test_use_flash_still_raises_for_causal_and_bias(kw, match, monkeypatch):
    """``use_flash=True`` with causal or a bias takes the kernel route the
    JAX dispatcher takes ("item 6", the short kernel's ROADMAP item: the
    short route; "item 4": the flash route), runs it on the kernels' plain
    twins here, and matches the JAX dispatcher's kernels in interpret
    mode."""
    kw = dict(kw)
    routes = []
    for name in ("flash_attention", "short_attention"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name, lambda *a, _fn=fn, _name=name, **k: routes.append(_name) or _fn(*a, **k))
    q, k, v, rng = _inputs()
    jkw = {}
    if kw.pop("seg", False):
        ids = np.array([[0, 0, 0, 1, 1, -1], [0, 1, 1, 1, 2, 2]], np.int32)
        kw.update(q_segment_ids=torch.from_numpy(ids), kv_segment_ids=torch.from_numpy(ids))
        jkw.update(q_segment_ids=jnp.asarray(ids), kv_segment_ids=jnp.asarray(ids))
    if "bias" in kw:
        kw["bias"] = torch.from_numpy(rng.standard_normal(tuple(kw["bias"].shape)).astype(np.float32))
    jkw.update({key: jnp.asarray(val.numpy()) if key == "bias" else val for key, val in kw.items()
                if key not in jkw})
    want = jax_attention.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_flash=True, **jkw)
    got = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), use_flash=True, **kw)
    assert routes == ["short_attention" if match == "item 6" else "flash_attention"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_pyproject_ships_the_cuda_sources():
    """The wheel's package data covers every csrc/*.cu and *.cuh."""
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"]["vit_pytorch_tpu_torch"]
    assert {"csrc/*.cu", "csrc/*.cuh"} <= set(patterns)
    sources = sorted((REPO / "vit_pytorch_tpu_torch" / "csrc").iterdir())
    assert any(p.suffix == ".cu" for p in sources) and any(p.suffix == ".cuh" for p in sources)
    for p in sources:
        rel = f"csrc/{p.name}"
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel


@pytest.mark.parametrize("marker", [".git", "pyproject.toml"])
def test_build_dir_in_a_checkout(tmp_path, monkeypatch, marker):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    (tmp_path / marker).mkdir() if marker == ".git" else (tmp_path / marker).write_text("")
    assert _build.build_dir(tmp_path) == tmp_path / "build"


def test_build_dir_outside_a_checkout(tmp_path, monkeypatch):
    """An installed package's root is site-packages: the build goes to the
    user's cache directory."""
    site = tmp_path / "site-packages"
    site.mkdir()
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert _build.build_dir(site) == tmp_path / "xdg" / "vit_pytorch_tpu_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir(site) == tmp_path / "home" / ".cache" / "vit_pytorch_tpu_torch"


def test_build_dir_override(tmp_path, monkeypatch):
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert _build.build_dir(tmp_path) == tmp_path / "kernels"
    assert _build.build_dir() == tmp_path / "kernels"


def test_build_dir_of_this_checkout(monkeypatch):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert _build.build_dir() == REPO / "build"
