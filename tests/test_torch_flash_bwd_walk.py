"""The host side of the flash backward kernels (``csrc/flash_attention.cu``'s
``flash_bwd_dq`` and ``flash_bwd_dkv``) on the CPU.

- ``bwd_tile_lists``, the host mirror of the tiles each 128-row work item
  of the kernels walks (their ``admit_chunk``, the loader's walk), against
  the JAX ``_seg_overlap`` rebuilt on numpy ids at the kernels' blocks
  (128 rows of the item's side, 64 of the other), against the port's
  ``tile_admitted`` (a superset of what either of the item's 64-row tiles
  admits; equal for self-attention over packed ids) and against brute force
  (every pair that shares an id is in a walked tile), for packed,
  ``attn_pool``, all-pad, unsorted and causal ids.
- The kernels' tile and block constants, read from the sources, against
  ``BLOCK_Q``, ``BLOCK_K`` and ``BWD_ROWS``, and their shared-memory and
  register sums against the card's limits.
- ``flash_bwd_reference`` (the twin both kernels are held to on the card)
  against JAX's ``_flash_backward`` in interpret mode at the shapes where
  the work items' edges fall: n = m = 193 (a second item 65 rows deep),
  unsorted ids, causal with the diagonal mid-item, n != m; fp32, within
  5e-5.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops import flash_attention as jax_flash
from vit_pytorch_tpu_torch.ops import flash_attention as flash

CSRC = Path(flash.__file__).resolve().parents[1] / "csrc"
SMEM_LIMIT = 232448  # a block's shared memory on sm_90
REGISTERS = 65536  # an SM's


def _csrc_int(name: str, constant: str) -> int:
    """The value of ``constexpr int <constant> = <int>`` in csrc/<name>."""
    m = re.search(rf"\b{constant}\s*=\s*(\d+)\s*[;,]", (CSRC / name).read_text())
    assert m, f"{constant} not found in csrc/{name}"
    return int(m.group(1))


def _ids(layout: str, rng, b: int, length: int):
    """(b, length) int32 ids: packed (rising, pads -1 at the end), unsorted
    (0, 1, 0, 2, ... runs across tile boundaries, so a tile's admitted
    tiles have gaps), all-pad."""
    if layout == "all_pad":
        return np.full((b, length), -1, np.int32)
    if layout == "unsorted":
        runs = rng.integers(20, 260, size=(b, length))
        ids = np.empty((b, length), np.int32)
        for i in range(b):
            pos, k = 0, 0
            while pos < length:
                run = int(runs[i, k])
                ids[i, pos:pos + run] = 0 if k % 2 == 0 else k // 2 + 1
                pos, k = pos + run, k + 1
        return ids
    ids = np.full((b, length), -1, np.int32)
    real = length - length // 7
    ids[:, :real] = np.sort(rng.integers(0, 9, (b, real)), axis=1)
    return ids


def _jax_overlap(own: np.ndarray, other: np.ndarray) -> bool:
    """JAX's _seg_overlap on numpy blocks in its ref layouts: the item's
    ids lane-broadcast (1, rows, 128), the tile's sublane-broadcast (1, 8,
    cols)."""
    qref = np.broadcast_to(own[None, :, None], (1, own.size, 128))
    kref = np.broadcast_to(other[None, None, :], (1, 8, other.size))
    return bool(jax_flash._seg_overlap(jnp.asarray(qref), jnp.asarray(kref)))


def _blocks(ids: np.ndarray, rows: int):
    """(b, L) ids in blocks of ``rows``, rows past L read -1."""
    pad = (-ids.shape[1]) % rows
    return np.pad(ids, ((0, 0), (0, pad)), constant_values=-1).reshape(ids.shape[0], -1, rows)


def _brute_force(qs, ks, n, m, dkv):
    """Per image, per item, the other side's tiles holding a pair of the
    item's that shares an id."""
    own, other = (ks, qs) if dkv else (qs, ks)
    ob, tb = _blocks(own, flash.BWD_ROWS), _blocks(other, flash.BLOCK_K)
    shared = (ob[:, :, None, :, None] == tb[:, None, :, None, :]) & (ob[:, :, None, :, None] >= 0)
    return shared.any((3, 4))


CASES = {
    # name: q layout, kv layout, n, m, causal
    "packed": ("packed", "packed", 2048, 2048, False),
    "packed, n = m = 193": ("packed", "packed", 193, 193, False),
    "unsorted": ("unsorted", "unsorted", 1000, 1000, False),
    "unsorted q, packed kv": ("unsorted", "packed", 640, 520, False),
    "attn_pool": ("pool", "packed", 16, 2048, False),
    "all-pad": ("all_pad", "all_pad", 256, 256, False),
    "causal packed": ("packed", "packed", 1000, 1000, True),
    "causal unsorted, n != m": ("unsorted", "unsorted", 193, 130, True),
}


def _case_ids(name):
    ql, kl, n, m, causal = CASES[name]
    rng = np.random.default_rng(15)
    ks = _ids(kl, rng, 2, m)
    if ql == "pool":
        qs = np.where(np.arange(n)[None] < 5, np.arange(n)[None], -2).repeat(2, 0).astype(np.int32)
    elif ql == kl and n == m:
        qs = ks.copy()
    else:
        qs = _ids(ql, rng, 2, n)
    return qs, ks, n, m, causal


@pytest.mark.parametrize("dkv", [False, True], ids=["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("name", list(CASES))
def test_bwd_tile_lists_follow_seg_overlap(name, dkv):
    """Each item's walk is exactly the tiles _seg_overlap admits against the
    item's 128 rows, ascending, within the causal bound."""
    qs, ks, n, m, causal = _case_ids(name)
    got = flash.bwd_tile_lists(n, m, torch.from_numpy(qs), torch.from_numpy(ks), dkv=dkv, causal=causal)
    own, other = (ks, qs) if dkv else (qs, ks)
    ob, tb = _blocks(own, flash.BWD_ROWS), _blocks(other, flash.BLOCK_K)
    for b in range(qs.shape[0]):
        want = []
        for r in range(ob.shape[1]):
            tiles = [j for j in range(tb.shape[1]) if _jax_overlap(ob[b, r], tb[b, j])]
            if causal:
                first = r * flash.BWD_ROWS // flash.BLOCK_Q
                tiles = [j for j in tiles if (j >= first if dkv else j <= first + 1)]
            want.append(tiles)
        assert got[b] == want


@pytest.mark.parametrize("dkv", [False, True], ids=["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("name", list(CASES))
def test_bwd_tile_lists_are_conservative(name, dkv):
    """Every tile holding a pair that shares an id (inside the causal
    bound) is walked; every tile tile_admitted admits for either of the
    item's 64-row tiles is walked, and for self-attention over packed ids
    nothing else is."""
    qs, ks, n, m, causal = _case_ids(name)
    got = flash.bwd_tile_lists(n, m, torch.from_numpy(qs), torch.from_numpy(ks), dkv=dkv, causal=causal)
    walked = np.zeros((qs.shape[0], -(-(m if dkv else n) // flash.BWD_ROWS), -(-(n if dkv else m) // flash.BLOCK_K)),
                      bool)
    for b, image in enumerate(got):
        for r, tiles in enumerate(image):
            walked[b, r, tiles] = True
    need = _brute_force(qs, ks, n, m, dkv)
    tiles = flash.tile_admitted(torch.from_numpy(qs), torch.from_numpy(ks)).numpy()  # (b, n tiles, m tiles)
    if dkv:
        tiles = tiles.transpose(0, 2, 1)
    pad = (-tiles.shape[1]) % 2
    per_item = np.pad(tiles, ((0, 0), (0, pad), (0, 0))).reshape(tiles.shape[0], -1, 2, tiles.shape[2]).any(2)
    if causal:
        r = np.arange(walked.shape[1])[:, None] * 2
        j = np.arange(walked.shape[2])[None, :]
        bound = j >= r if dkv else j <= r + 1
        need, per_item = need & bound, per_item & bound
    assert np.all(walked[need])
    assert np.all(walked[per_item])
    if name in ("packed", "packed, n = m = 193", "causal packed"):
        np.testing.assert_array_equal(walked, per_item)
    if name == "all-pad":
        assert not walked.any()


@pytest.mark.parametrize("dkv", [False, True], ids=["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("n, m, causal", [(193, 193, False), (193, 130, True), (130, 1000, True), (1, 1000, False)])
def test_bwd_tile_lists_without_ids(n, m, causal, dkv):
    """Without ids every tile runs, within the causal bound: flash_bwd_dq's
    item r walks key tiles 0 .. 2r + 1, flash_bwd_dkv's query tiles 2r on."""
    (got,) = flash.bwd_tile_lists(n, m, dkv=dkv, causal=causal)
    own, other = (m, n) if dkv else (n, m)
    tiles = -(-other // flash.BLOCK_K)
    for r, walk in enumerate(got):
        want = list(range(tiles))
        if causal:
            want = [j for j in want if (j >= 2 * r if dkv else j <= 2 * r + 1)]
        assert walk == want
    assert len(got) == -(-own // flash.BWD_ROWS)


def test_bwd_constants_match_the_kernels():
    """The tiles and blocks the host mirrors, and the backward kernels'
    shared memory (two resident slots of four 64 x 64 bf16 tiles, the ring,
    the ids, lse and delta of both, the tile indices and mbarriers, two keep
    tiles a consumer with dropout) and registers within the card's."""
    tile = _csrc_int("flash_tiles.cuh", "kFlashTile")
    wgs = _csrc_int("flash_attention.cu", "kBwdWgs")
    stages = _csrc_int("flash_attention.cu", "kBwdStages")
    assert flash.BLOCK_Q == flash.BLOCK_K == tile == flash.DIM_HEAD
    assert flash.BWD_ROWS == wgs * tile == 2 * flash.BLOCK_Q
    src = (CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int kBwdRows = kBwdWgs \* kFlashTile;", src)
    queue = _csrc_int("flash_attention.cu", "kBwdQueue")
    tile_bytes = tile * tile * 2
    align = _csrc_int("attn_wgmma.cuh", "kWgAlign")
    vec = 4
    before_bars = (2 * 4 * tile_bytes + stages * 2 * tile_bytes + stages * 3 * tile * vec
                   + 2 * 3 * flash.BWD_ROWS * vec + queue * 16 + stages * 4)
    layout = -(-before_bars // 8) * 8 + (2 * stages + 4 + 2 * queue) * 8
    keep = wgs * 2 * tile * (tile // 32) * 4
    for term in ("kBwdRing = kBwdRes + 2 * 4 * kSwTileBytes", "kBwdRingVec = kBwdRing + kBwdStages * 2 * kSwTileBytes",
                 "kBwdResVec = kBwdRingVec + kBwdStages * 3 * kFlashTile * 4",
                 "kBwdQueueAt = kBwdResVec + 2 * 3 * kBwdRows * 4", "kBwdTileIdx = kBwdQueueAt + kBwdQueue * 16",
                 "kBwdBars = (kBwdTileIdx + kBwdStages * 4 + 7) / 8 * 8",
                 "kBwdKeep = kBwdBars + (2 * kBwdStages + 4 + 2 * kBwdQueue) * 8",
                 "return kWgAlign + kBwdKeep + (drop ? kBwdWgs * 2 * kFlashKeepTile * 4 : 0);"):
        assert term in src, term
    assert (2 * 4 * tile_bytes + stages * 2 * tile_bytes + stages * 3 * tile * vec + 2 * 3 * flash.BWD_ROWS * vec) % 16 == 0
    assert align + layout + keep <= SMEM_LIMIT
    assert "constexpr int kBwdThreads = 128 * (kBwdWgs + 1);" in src
    threads = 128 * (wgs + 1)
    consumer = _csrc_int("flash_attention.cu", "kBwdConsumerRegs")
    producer = _csrc_int("flash_attention.cu", "kBwdProducerRegs")
    assert 128 * wgs * consumer + 128 * producer <= REGISTERS
    assert consumer % 8 == 0 and producer % 8 == 0 and 24 <= producer <= consumer <= 256
    assert threads * 168 <= REGISTERS  # the launch's own budget, which setmaxnreg redistributes
    arrivals = _csrc_int("flash_attention.cu", "kBwdFullArrivals")
    assert arrivals == 32 + 1  # the loader warp's copies and its lane 0's expect_tx


def _seg_case(kind, rng, b, n, m):
    if kind is None:
        return None, None
    if kind == "unsorted":
        return _ids("unsorted", rng, b, n), _ids("unsorted", rng, b, m)
    ids = _ids("packed", rng, b, n)
    return ids, ids


@pytest.mark.parametrize("kind, n, m, causal", [
    (None, 193, 193, False),
    ("packed", 193, 193, False),
    ("unsorted", 193, 193, False),
    (None, 193, 193, True),
    (None, 193, 130, True),
    ("unsorted", 130, 193, True),
])
def test_flash_bwd_reference_matches_jax_backward(kind, n, m, causal):
    """The twin's dq, dk, dv against JAX's _flash_backward (interpret mode)
    fed the JAX forward's o and lse, in fp32."""
    rng = np.random.default_rng(7)
    b, h, d = 2, 2, 64
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, n, d), (b, h, m, d), (b, h, m, d)))
    g = rng.standard_normal((b, h, n, d)).astype(np.float32)
    qs, ks = _seg_case(kind, rng, b, n, m)
    scale = d**-0.5
    segs = (None, None) if qs is None else (jnp.asarray(qs), jnp.asarray(ks))
    bq, bk = jax_flash.default_blocks(n, m)
    out, lse_padded = jax_flash._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, *segs, scale,
                                               causal, bq, bk, True, save_lse=True)
    want = jax_flash._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *segs, out, lse_padded,
                                     jnp.asarray(g), scale, causal, bq, bk, True)
    lse = torch.from_numpy(np.asarray(lse_padded)[:, :n, 0].reshape(b, h, n).copy())
    delta = (torch.from_numpy(g) * torch.from_numpy(np.array(out))).sum(-1)
    got = flash.flash_bwd_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(g),
                                    lse, delta, scale=scale, q_segment_ids=None if qs is None else torch.from_numpy(qs),
                                    kv_segment_ids=None if ks is None else torch.from_numpy(ks), causal=causal)
    for part, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-5, rtol=0, err_msg=part)
