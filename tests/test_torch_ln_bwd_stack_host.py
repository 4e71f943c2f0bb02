"""The host side of ``csrc/fused_layer_bwd.cu``'s LayerNorm backward and of
``csrc/stack_layers.cu``, on the CPU, each read from the sources.

- The LayerNorm backward's grid (``layernorm_bwd_blocks``, which the wrapper
  reads through ``vit_layernorm_bwd_blocks``): a function of the rows alone,
  its constants read from the file, under which the kernels' row loop (warp
  w of block b: rows 4b + w, then every 4 x blocks) visits every row once,
  against brute force for rows in 1..70,000 and at 201,728 (ViT-B/16's
  bs=1024), at most 396 blocks.
- ``layernorm_bwd_rows_reference``, plain (dx + dy, cast between) and
  ``[res_f32]`` (the residual added in f32 before one cast, its column
  sum), against the JAX LayerNorm backward's lines rebuilt here from
  ``vit_pytorch_tpu/ops/fused_block.py`` (``_bwd_kernel`` :702-717 with the
  recompute of xhat and r and the add of :1868; ``_ff_bwd_kernel``
  :1588-1596 and the db2 sum of g), at dims 768, 1024 and 200, fp32 within
  5e-5 (f32 summation order only).
- ``stack_layers``' static budgets: the kernel-parameter block (the layers'
  pointers and the 35 tensor maps, the same at any g) against the size the
  source's note states and the 32,764-byte limit, and the shared memory of
  the union of gemm_bf16's ring and the attention tiles, against the note
  and the 232,448 bytes a block has.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu_torch.ops import fused_block as fb

CSRC = Path(fb.__file__).resolve().parents[1] / "csrc"
TOL = dict(atol=5e-5, rtol=5e-5)
SMEM_LIMIT = 232448  # a block's shared memory on an H100
PARAM_LIMIT = 32764  # a kernel's parameter block since CUDA 12.1


def _constexprs(*names: str) -> dict:
    """Every ``constexpr int NAME = EXPR;`` of csrc/<names> whose EXPR is
    integer arithmetic on literals, sizeof(bf16 | float) and the names
    before it, evaluated in the files' order."""
    sizes = {"bf16": 2, "float": 4}
    values = {}
    for name in names:
        for statement in re.findall(r"constexpr int ([^;(]+(?:\([^;]*\))?[^;]*);", (CSRC / name).read_text()):
            for lhs, rhs in re.findall(r"(\w+) = ((?:[^,(]|\([^)]*\))+)", statement):
                expr = re.sub(r"static_cast<int>\(sizeof\((\w+)\)\)|sizeof\((\w+)\)",
                              lambda m: str(sizes.get(m.group(1) or m.group(2), m.group(0))), rhs)
                try:
                    values[lhs] = int(eval(expr, {"__builtins__": {}}, dict(values)))
                except (NameError, SyntaxError, TypeError):
                    continue
    return values


# ---------------------------------------------------------------------------
# the LayerNorm backward's grid
# ---------------------------------------------------------------------------

LN = _constexprs("fused_layer_bwd.cu")
LN_SRC = (CSRC / "fused_layer_bwd.cu").read_text()


def _ln_blocks(rows: int) -> int:
    """layernorm_bwd_blocks as the source writes it (checked below)."""
    per_block = LN["kLnBwdRowsPerWarp"] * LN["kLnBwdWarps"]
    return min((rows + per_block - 1) // per_block, LN["kLnBwdMaxBlocks"])


def test_ln_bwd_grid_rule_in_the_source():
    """The rule reads the rows and constants alone; both kernels walk their
    rows with the same loop; the entry point hands the host the same rule."""
    body = re.search(r"int layernorm_bwd_blocks\(int rows\) \{(.*?)\n\}", LN_SRC, re.S)
    assert body, "layernorm_bwd_blocks not found"
    assert set(re.findall(r"[A-Za-z_]\w*", body.group(1))) <= {
        "const", "int", "want", "rows", "return", "kLnBwdRowsPerWarp", "kLnBwdWarps", "kLnBwdMaxBlocks"}
    loop = "for (int row = blockIdx.x * kLnBwdWarps + warp; row < rows; row += gridDim.x * kLnBwdWarps)"
    assert LN_SRC.count(loop) == 2
    assert "return rows > 0 ? layernorm_bwd_blocks(rows) : 0;" in LN_SRC
    assert LN["kLnBwdWarps"] * 32 == LN["kLnBwdThreads"]
    assert LN["kLnBwdMaxBlocks"] == 132 * LN["kLnBwdBlocksPerSm"]


def _visits(rows: int, blocks: int) -> np.ndarray:
    """How often the kernels' row loop visits each row, block by block and
    warp by warp (brute force)."""
    warps = LN["kLnBwdWarps"]
    count = np.zeros(rows, dtype=np.int64)
    for b in range(blocks):
        for w in range(warps):
            count[np.arange(b * warps + w, rows, blocks * warps)] += 1
    return count


def _row_cases():
    """rows 1..70,000 grouped by the block count they get: the rule's largest
    row count of each group is enumerated, since the loop's rows below it
    are its first rows; and 201,728."""
    groups = {}
    for rows in range(1, 70_001):
        groups[_ln_blocks(rows)] = rows
    return sorted(groups.values()) + [201_728]


_ROW_CASES = _row_cases()


@pytest.mark.parametrize("chunk", range(8))
def test_ln_bwd_grid_visits_every_row_once(chunk):
    """Every row once, no block past the cap, no block without a row."""
    for rows in _ROW_CASES[chunk::8]:
        blocks = _ln_blocks(rows)
        assert 1 <= blocks <= LN["kLnBwdMaxBlocks"]
        visits = _visits(rows, blocks)
        assert (visits == 1).all(), rows
        assert (blocks - 1) * LN["kLnBwdWarps"] < rows  # the last block has a row


def test_ln_bwd_grid_covers_every_row_count():
    """Every row count in 1..70,000 is the first rows of its group's
    enumerated count, with the same blocks (so its loop visits a prefix)."""
    largest = {}
    for rows in range(1, 70_001):
        largest[_ln_blocks(rows)] = rows
    assert sorted(largest.values()) == _ROW_CASES[:-1]
    assert _ln_blocks(201_728) == LN["kLnBwdMaxBlocks"]


# ---------------------------------------------------------------------------
# layernorm_bwd_rows_reference against the JAX LayerNorm backward
# ---------------------------------------------------------------------------


def _jax_ln_recompute(x, eps):
    """xhat and r recomputed from x in f32 (the LN forward lines the JAX
    backward kernels run, e.g. _ff_bwd_kernel :1536-1541)."""
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    xc = xf - mu
    var = jnp.mean(jnp.square(xc), axis=-1, keepdims=True)
    r = jax.lax.rsqrt(var + eps)
    return xc * r, r


def _jax_ln_bwd_lines(dh, xhat, r, gamma):
    """_bwd_kernel :708-717: dgamma, dbeta summed over the rows; dx."""
    dgamma = jnp.sum(dh * xhat, axis=0)
    dbeta = jnp.sum(dh, axis=0)
    dxhat = dh * gamma
    dx = r * (dxhat - jnp.mean(dxhat, axis=-1, keepdims=True)
              - xhat * jnp.mean(dxhat * xhat, axis=-1, keepdims=True))
    return dx, dgamma, dbeta


def _operands(rows, dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, dim), dtype=np.float32) * 2 + 0.5
    dh = rng.standard_normal((rows, dim), dtype=np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    res = rng.standard_normal((rows, dim), dtype=np.float32)
    return x, dh, gamma, res


LN_DIMS = [768, 1024, 200]


@pytest.mark.parametrize("dim", LN_DIMS)
def test_ln_bwd_reference_matches_jax_bwd_kernel(dim):
    """Plain: dx = bf16(bf16(dx_ln) + dy) (:1868), here in f32 where each cast
    is the identity; dgamma and dbeta."""
    x, dh, gamma, dy = _operands(70, dim, dim)
    xhat, r = _jax_ln_recompute(jnp.asarray(x), fb.LN_EPS)
    dx_ln, dgamma, dbeta = _jax_ln_bwd_lines(jnp.asarray(dh), xhat, r, jnp.asarray(gamma))
    dx = (dx_ln.astype(jnp.float32) + jnp.asarray(dy)).astype(jnp.float32)
    got = fb.layernorm_bwd_rows_reference(torch.from_numpy(x), torch.from_numpy(dh), torch.from_numpy(gamma),
                                          residual=torch.from_numpy(dy))
    for g, w in zip(got, (dx, dgamma, dbeta)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dim", LN_DIMS)
@pytest.mark.parametrize("out_f32", [False, True])
def test_ln_bwd_res_f32_reference_matches_jax_ff_bwd_kernel(dim, out_f32):
    """[res_f32]: dy = (dy_ln + g).astype(io) (_ff_bwd_kernel :1588-1596),
    dln2 gamma and beta, and db2, the column sum of g."""
    y, dyln, gamma, g = _operands(70, dim, dim + 1)
    xhat, r = _jax_ln_recompute(jnp.asarray(y), fb.LN_EPS)
    dy_ln, dgamma, dbeta = _jax_ln_bwd_lines(jnp.asarray(dyln), xhat, r, jnp.asarray(gamma))
    dy = (dy_ln + jnp.asarray(g)).astype(jnp.float32)
    db2 = jnp.sum(jnp.asarray(g), axis=0)
    got = fb.layernorm_bwd_rows_reference(torch.from_numpy(y), torch.from_numpy(dyln), torch.from_numpy(gamma),
                                          residual=torch.from_numpy(g), res_f32=True, out_f32=out_f32)
    assert len(got) == 4 and got[0].dtype == torch.float32
    for a, w in zip(got, (dy, dgamma, dbeta, db2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# stack_layers' static budgets
# ---------------------------------------------------------------------------

STACK_SRC = (CSRC / "stack_layers.cu").read_text()
STACK = _constexprs("common.cuh", "flash_tiles.cuh", "attn_wgmma.cuh", "layer_tiles.cuh", "gemm_ring.cuh", "stack_layers.cu")
_SCALARS = {"int": 4, "float": 4, "unsigned": 4}


def _struct_body(name: str) -> str:
    m = re.search(rf"struct (?:alignas\(\d+\) )?{name} \{{(.*?)\n\}};", STACK_SRC, re.S)
    assert m, f"struct {name} not found in stack_layers.cu"
    return m.group(1)


def _struct_bytes(name: str, structs: dict) -> int:
    """sizeof(struct name) on the card: pointers 8 bytes, int / float /
    unsigned 4, CUtensorMap 128, arrays of any of them and of the structs
    in ``structs``; padded to its alignment (8, or its alignas)."""
    body = re.sub(r"//[^\n]*", "", _struct_body(name))
    size = 0
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(?:const )?(\w+)\s*(.*)", decl, re.S)
        base, names = m.group(1), m.group(2)
        for item in (n.strip() for n in names.split(",")):
            dims = [STACK[d] if d in STACK else int(d) for d in re.findall(r"\[(\w+)\]", item)]
            count = int(np.prod(dims)) if dims else 1
            if "*" in item:
                elem = 8
            elif base == "CUtensorMap":
                elem = 128
            elif base in structs:
                elem = structs[base]
            else:
                elem = _SCALARS[base]
            size = -(-size // min(elem, 8)) * min(elem, 8) + elem * count
    align = int(re.search(rf"struct (?:alignas\((\d+)\) )?{name} ", STACK_SRC).group(1) or 8)
    return -(-size // align) * align


def test_stack_parameter_block():
    """The layers' operands and 4 x kStackMaxLayers + 11 tensor maps: the
    size the note states, under the parameter limit; the entry point needs
    CUDA 12.1 for it."""
    layer = _struct_bytes("StackLayer", {})
    args = _struct_bytes("StackArgs", {"StackLayer": layer})
    maps = _struct_bytes("StackMaps", {})
    assert STACK["kStackMaxLayers"] == fb.STACK_MAX_LAYERS == 6
    assert maps == (4 * STACK["kStackMaxLayers"] + 11) * 128
    total = args + maps
    assert total <= PARAM_LIMIT
    assert f"{args} + {maps:,} = {total:,} B" in STACK_SRC
    assert "kStackParamBytes <= 32764" in STACK_SRC and "CUDART_VERSION < 12010" in STACK_SRC


def test_stack_shared_memory_union():
    """gemm_bf16's ring (its stages, the consumers' bf16 staging, its
    mbarriers) with the attention tiles inside its stages, and the attention
    mbarriers: the bytes the note states, within a block's shared memory."""
    s = STACK
    staging = 2 * s["kBoxBytes"]  # every step's epilogue stages bf16: two boxes a consumer
    fixed = s["kWgAlign"] + s["kConsumers"] * staging + s["kRingBarriers"]
    stages = min(6, (s["kMaxSmem"] - fixed) // s["kStageBytes"])
    ring = fixed + stages * s["kStageBytes"]
    total = ring + s["kStackAttnBars"] * 8
    assert s["kMaxSmem"] == SMEM_LIMIT
    assert stages == 6 and (2 * stages + 2 * s["kConsumers"]) * 8 <= s["kRingBarriers"]
    assert s["kStackAttnBytes"] == 2 * s["kSwTileBytes"] + 2 * 16 * s["kAttnKT"] * s["kAttnDh"] * 2
    assert s["kConsumers"] * s["kStackAttnBytes"] <= stages * s["kStageBytes"]
    assert total <= SMEM_LIMIT
    assert f"{total:,} B of {SMEM_LIMIT:,}" in STACK_SRC
    ring_src = (CSRC / "gemm_ring.cuh").read_text()
    assert ("return kWgAlign + kConsumers * staging_bytes(epi) + (epi == kEpiGeluBwd ? kColBufBytes : 0) + "
            "kRingBarriers;") in ring_src
    assert "constexpr int kStackSmem = gemm_smem(kStackRingEpi) + kStackAttnBars * 8;" in STACK_SRC
