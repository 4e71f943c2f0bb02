"""The port's bench tools (``vit_pytorch_tpu_torch/tools/``) against the ten
Pallas kernels of the JAX package's ``tools/`` prototypes, on the CPU.

Each JAX tool is loaded from its path with its module constants cut to B=2,
H=2, D=64, N=10 (n_pad=16) and every ``pl.pallas_call`` in interpret mode;
the same numpy-seeded inputs, carried over by
``utils/from_jax.py::tool_layer_from_jax``, go through the tool's kernel
and through the port's function, which on a CPU tensor is the plain twin of
the kernel's lines.  Tolerances: 5e-5 at fp32; at bf16 ``2e-2 +
2e-2|want|`` (a bf16 rounding or two: the twins round where the kernels
do, but the f32 sums run in another order).  Also the new pieces of the
kernels' twins alone: ``attention_rows_reference(n_keys=...)``, the
``fc1_f32`` epilogue and ``stack_layers(epilogues="tools")``."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from vit_pytorch_tpu_torch.ops import fused_block as fb
from vit_pytorch_tpu_torch.tools import bench_fused_tuning, bench_layer_fused, bench_stack_fusion, fused_block_proto
from vit_pytorch_tpu_torch.tools import _common
from vit_pytorch_tpu_torch.utils.from_jax import tool_layer_from_jax

TOOLS = Path(__file__).resolve().parents[1] / "tools"
B, H, D, N, N_PAD = 2, 2, 64, 10, 16
DIM, MLP = H * D, 4 * H * D
TOL = {np.float32: dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


def _load(name, monkeypatch):
    """The JAX tool ``tools/<name>.py`` with its constants cut and its
    pallas_call in interpret mode (both undone after the test)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr, value in dict(B=B, H=H, D=D, N=N, DIM=DIM, MLP=MLP).items():
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, value)
    return mod


def _layer(rng, rows: bool):
    """One layer's weights in the JAX tools' layout, (in, out) matrices and
    (d,) vectors, or (1, d) with ``rows``: wqkv, wout, ln1s, ln1b, ln2s,
    ln2b, w1, b1, w2, b2."""
    vec = lambda d, s, base=0.0: (base + s * rng.standard_normal(d)).reshape((1, d) if rows else (d,))
    mat = lambda i, o: rng.standard_normal((i, o)) * i**-0.5
    return (mat(DIM, 3 * DIM), mat(DIM, DIM), vec(DIM, 0.1, 1.0), vec(DIM, 0.1), vec(DIM, 0.1, 1.0), vec(DIM, 0.1),
            mat(DIM, MLP), vec(MLP, 0.1), mat(MLP, DIM), vec(DIM, 0.1))


def _inputs(rng, dtype, n=N, layers=1, rows=False):
    """x and the layers' weights, as JAX arrays and as the port's tensors."""
    x = rng.standard_normal((B, n, DIM))
    ws = [w for _ in range(layers) for w in _layer(rng, rows)]
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    jx, jws = jnp.asarray(x, jdt), [jnp.asarray(w, jdt) for w in ws]
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    tx = torch.from_numpy(np.array(jx, np.float32)).to(tdt)
    return (jx, *jws), (tx, *tool_layer_from_jax([np.asarray(w) for w in jws]))


def _pick(args, idx):
    return tuple(args[i] for i in idx)


# kernel: (JAX tool module, inputs, how each side is called, dtypes); args = (x, wqkv, wout, ln1s, ln1b, ln2s,
# ln2b, w1, b1, w2, b2); make_whole_padded_tiled's scratch is bf16 (:388-390), so it runs at bf16 only
ATTN, FF = (0, 1, 2, 3, 4), (0, 7, 8, 9, 10, 3, 4)
BOTH, BF16 = (np.float32, "bf16"), ("bf16",)
CASES = {
    "bench_layer_fused.make_whole_resident": (
        "bench_layer_fused", dict(), lambda m: m.make_whole_resident(2), BOTH),
    "bench_layer_fused.make_whole_tiled": (
        "bench_layer_fused", dict(), lambda m: m.make_whole_tiled(1, 256), BOTH),
    "bench_layer_fused.make_whole_padded": (
        "bench_layer_fused", dict(n=N_PAD), lambda m: m.make_whole_padded(2, N_PAD, N), BOTH),
    "bench_layer_fused.make_whole_padded_tiled": (
        "bench_layer_fused", dict(n=N_PAD), lambda m: m.make_whole_padded_tiled(1, 256, N_PAD, N), BF16),
    "bench_layer_fused.make_attn_padded": (
        "bench_layer_fused", dict(n=N_PAD), lambda m: m.make_attn_padded(2, N_PAD, N), BOTH),
    "bench_stack_fusion.make_stack": (
        "bench_stack_fusion", dict(layers=2, rows=True), lambda m: m.make_stack(2), BOTH),
    "fused_block_proto._attn_block_kernel": (
        "fused_block_proto", dict(rows=True),
        lambda m: lambda *a: m.fused_attention_block(*_pick(a, (0, 1, 2, 10, 3, 4)), heads=H, dim_head=D), BOTH),
    "fused_block_proto._ff_block_kernel": (
        "fused_block_proto", dict(rows=True), lambda m: lambda *a: m.fused_ff_block(*_pick(a, FF)), BOTH),
    "fused_block_proto._ff_rows_kernel": (
        "fused_block_proto", dict(rows=True), lambda m: lambda *a: m.fused_ff_block_rows(*_pick(a, FF), rows=8), BOTH),
    "bench_fused_tuning.make_fused": (
        "bench_fused_tuning", dict(rows=True), lambda m: lambda *a: m.make_fused(2)(*_pick(a, ATTN)), BOTH),
}


@pytest.mark.parametrize("kernel,dtype", [
    pytest.param(kernel, dtype, id=f"{kernel}-{'fp32' if dtype is np.float32 else dtype}")
    for kernel, case in CASES.items() for dtype in case[3]
])
def test_tool_kernel_matches_jax(kernel, dtype, monkeypatch):
    tool, shape, build, _ = CASES[kernel]
    jmod = _load(tool, monkeypatch)
    port = {"bench_layer_fused": bench_layer_fused, "bench_stack_fusion": bench_stack_fusion,
            "fused_block_proto": fused_block_proto, "bench_fused_tuning": bench_fused_tuning}[tool]
    rng = np.random.default_rng(list(CASES).index(kernel))
    jargs, targs = _inputs(rng, dtype, **shape)
    want = np.asarray(build(jmod)(*jargs), np.float32)
    got = build(port)(*targs)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_padded_layer_ignores_padded_rows():
    """The real rows of a padded layer do not see the padded rows' inputs."""
    rng = np.random.default_rng(1)
    _, (x, *w) = _inputs(rng, np.float32, n=N_PAD)
    fn = bench_layer_fused.make_whole_padded(2, N_PAD, N)
    x2 = x.clone()
    x2[:, N:] = torch.randn(B, N_PAD - N, DIM, generator=torch.Generator().manual_seed(2))
    assert torch.equal(fn(x, *w)[:, :N], fn(x2, *w)[:, :N])
    assert not torch.equal(fn(x, *w)[:, N:], fn(x2, *w)[:, N:])  # the padded rows are computed


def test_tools_layer_is_not_the_package_layer():
    """At bf16 the tools' layer (f32 adds, one cast) and the package's
    fused_transformer_layer (each product rounded first) are different
    functions of the same weights: many outputs differ by a rounding."""
    rng = np.random.default_rng(3)
    _, (x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2) = _inputs(rng, "bf16")
    tools = bench_layer_fused.make_whole_resident(2)(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2)
    package = fb.layer_reference(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, heads=H, dim_head=D)
    differ = (tools != package).float().mean().item()
    assert differ > 0.05, differ
    np.testing.assert_allclose(tools.float().numpy(), package.float().numpy(), atol=0.1, rtol=0.05)


def _qkv(n, dtype=torch.float32, seed=4):
    return torch.randn(B, n, 3 * DIM, generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("n_keys", [1, 7, 10])
def test_attention_rows_reference_n_keys(n_keys):
    """Keys j >= n_keys get no weight in any row; every row is computed."""
    qkv = _qkv(N)
    got = fb.attention_rows_reference(qkv, heads=H, dim_head=D, scale=D**-0.5, n_keys=n_keys)
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
    want = F.scaled_dot_product_attention(q, k, v, attn_mask=(torch.arange(N) < n_keys).expand(N, N))
    torch.testing.assert_close(got, want.transpose(1, 2).reshape(B, N, DIM), atol=1e-5, rtol=1e-5)
    # the wrapper takes the twin on the CPU
    assert torch.equal(fb.attention_rows(qkv, heads=H, dim_head=D, scale=D**-0.5, n_keys=n_keys), got)


@pytest.mark.parametrize("n_keys", [0, N + 1])
def test_attention_rows_n_keys_refused(n_keys):
    for fn in (fb.attention_rows, fb.attention_rows_reference):
        with pytest.raises(ValueError, match="n_keys"):
            fn(_qkv(N), heads=H, dim_head=D, scale=D**-0.5, n_keys=n_keys)


def test_attention_rows_n_keys_refuses_dropout():
    with pytest.raises(ValueError, match="n_keys"):
        fb.attention_rows_reference(_qkv(N), heads=H, dim_head=D, scale=D**-0.5, n_keys=5, dropout_rate=0.1, seed=1)


def test_gemm_fc1_f32_twin_matches_jax():
    """fc1_f32: bf16(gelu_tanh(bf16(f32 dot + f32 b1))), the JAX tools' fc1
    (bench_layer_fused.py:141-143); the package's fc1 rounds the dot
    first, a different result."""
    rng = np.random.default_rng(5)
    a = jnp.asarray(rng.standard_normal((B * N, DIM)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((DIM, MLP)) * DIM**-0.5, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(MLP) * 0.5, jnp.bfloat16)
    h = (jnp.dot(a, w, preferred_element_type=jnp.float32) + b.astype(jnp.float32)).astype(jnp.bfloat16)
    want = np.asarray(jax.nn.gelu(h, approximate=True), np.float32)
    ta = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    tw, tb = tool_layer_from_jax([np.asarray(w), np.asarray(b)])
    got = fb.gemm_bf16_reference(ta, tw, "fc1_f32", bias=tb)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL["bf16"])
    assert torch.equal(fb.gemm_bf16(ta, tw, "fc1_f32", bias=tb), got)  # the wrapper takes the twin on the CPU
    package = fb.gemm_bf16_reference(ta, tw, "fc1", bias=tb)
    assert (got != package).float().mean().item() > 0.01


def test_stack_tools_epilogues_on_cpu():
    """stack_layers(epilogues="tools") on the CPU is its twin, the tools'
    chain of every layer; it refuses b_qkv and b_out and unknown epilogues;
    the tool's make_stack agrees with it."""
    rng = np.random.default_rng(6)
    _, (x, *w) = _inputs(rng, "bf16", layers=3, rows=True)
    layers = [(v[0], None, v[1], None, *v[2:]) for v in (w[10 * i: 10 * i + 10] for i in range(3))]
    kw = dict(heads=H, dim_head=D, scale=D**-0.5)
    got = fb.stack_layers(x, layers, **kw, epilogues="tools")
    want = x
    for lw in layers:
        want = fb._layer_forward(fb.TWINS, want, *lw, H, D, D**-0.5, fb.LN_EPS, "tools")[0]
    assert torch.equal(got, want)
    assert not torch.equal(got, fb.stack_layers(x, layers, **kw))  # the package's epilogues
    np.testing.assert_allclose(bench_stack_fusion.make_stack(3)(x, *w).float().numpy(), got.float().numpy(),
                               **TOL["bf16"])
    with pytest.raises(ValueError, match="b_qkv"):
        fb.stack_layers(x, [(layers[0][0], layers[0][0][:, 0].clone()) + layers[0][2:]], **kw, epilogues="tools")
    with pytest.raises(ValueError, match="epilogues"):
        fb.stack_layers(x, layers, **kw, epilogues="other")
    with pytest.raises(ValueError, match="weights"):
        bench_stack_fusion.make_stack(2)(x, *w)


def test_tool_layer_from_jax():
    w = tool_layer_from_jax([np.ones((3, 5), np.float32), np.arange(4, dtype=np.float32).reshape(1, 4),
                             np.zeros(6, np.float32), np.asarray(jnp.ones((2, 3), jnp.bfloat16))])
    assert [tuple(t.shape) for t in w] == [(5, 3), (4,), (6,), (3, 2)]
    assert [t.dtype for t in w] == [torch.float32] * 3 + [torch.bfloat16]
    assert torch.equal(w[1], torch.arange(4.0))


@pytest.mark.parametrize("main", [bench_layer_fused.main, bench_stack_fusion.main, fused_block_proto.main,
                                  bench_fused_tuning.tune_kernel])
def test_tool_main_needs_a_card(main):
    """A tool's main() times the card and raises without one (or on the
    CPU asked for): no CPU number stands in for a card time."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py phase 35 runs main()")
    with pytest.raises(RuntimeError, match="CUDA"):
        main()
    with pytest.raises(RuntimeError, match="CUDA"):
        main("cpu")


def test_heads_from_the_weights():
    assert _common.heads_of(torch.empty(DIM, DIM)) == H
    with pytest.raises(ValueError, match="heads"):
        fused_block_proto.fused_attention_block(torch.zeros(B, N, DIM), torch.zeros(3 * DIM, DIM),
                                                torch.zeros(DIM, DIM), torch.zeros(DIM), torch.ones(DIM),
                                                torch.zeros(DIM), heads=4, dim_head=32)


def test_tools_import_without_jax():
    """The port's tools import nothing of JAX (nor the JAX tools)."""
    import subprocess
    import sys

    code = ("import sys; import vit_pytorch_tpu_torch.tools.bench_layer_fused, "
            "vit_pytorch_tpu_torch.tools.bench_stack_fusion, vit_pytorch_tpu_torch.tools.fused_block_proto, "
            "vit_pytorch_tpu_torch.tools.bench_fused_tuning; "
            "assert not any(m.split('.')[0] in ('jax', 'vit_pytorch_tpu', 'tools') for m in sys.modules), "
            "'jax or a module of the JAX package imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=TOOLS.parent, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
