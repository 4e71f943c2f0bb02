"""Mutation check of the wgmma attention kernels on one CUDA card (H100,
sm_90a): the tile machinery of short_attention and flash_fwd
(``csrc/attn_wgmma.cuh``), then the layer chain's attention_rows
(``csrc/attention_rows.cu`` and its tile body in ``csrc/layer_tiles.cuh``).

    python3 chip_attn_mutants.py [wide]

Two sets (the layer set first), each first on the kernels as they are,
which must pass every check, then on deliberately wrong copies of ``vit_pytorch_tpu_torch/csrc``,
each built under ``build/mutants/`` with one edit, which must each fail at
least one check:
  - MUTANTS against chip_smoke.py's phases 12 (``check_flash``: the flash
    kernels against their twins, their edge cases included) and 28
    (``check_short_causal_bias``: the short kernel, the flash causal and
    bias variants, their edge cases);
  - LAYER_MUTANTS against phase 3 (``check_kernels``: attention_rows at n =
    197 and 50, the whole layer), phase 16's config-2 shapes
    (``check_simple_attention``: n = 64 and 68) and phase 34 (``check_tools``:
    attention_rows[n_keys] among the tools' counterparts);
  - WIDE_MUTANTS, the forward of the wide kernels (``csrc/attention_wide.cuh``),
    against phase 63's kernel checks (``check_ladder_kernels``: every variant
    at the width ladder's shapes and the 64-key chunks' edges).
Prints one line a kernel with the number of checks that refused it, and
exits 1 if the right kernels fail or a mutant passes.  The runner is
chip_qk_mutants.run.
"""

import sys

import torch

import chip_qk_mutants
import chip_smoke as cs

_PASS2_QK = "    qk_issue(s, qf, ring + 2 * (step % kStages) * kSwTile);\n    pv_issue(o, pf,"

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "the v tile read one 16-byte chunk off its swizzle": (
        "attn_wgmma.cuh", "desc_mn_major(vs + kc * 16 * kFlashDh)", "desc_mn_major(vs + kc * 16 * kFlashDh + 8)"),
    "flash_fwd: the bias tile taken from the previous ring stage": (
        "flash_attention.cu", "    [[maybe_unused]] const unsigned char* bstage = bias_ring + stage * kBiasStage;",
        "    [[maybe_unused]] const unsigned char* bstage = bias_ring + ((stage + kStages - 1) % kStages) * kBiasStage;"),
    "short: the bias tile taken from the previous ring stage": (
        "short_attention.cu", "  auto bias_stage = [&](int step) { return bias_ring + (step % kStages) * kBiasStage; };",
        "  auto bias_stage = [&](int step) { return bias_ring + ((step + kStages - 1) % kStages) * kBiasStage; };"),
    "flash_fwd: k copied (kAhead tiles ahead) into the stage this iteration's q.k^T still reads": (
        "flash_attention.cu", "      tma_load(ring + 2 * stage * kSwTile, maps.k,",
        "      tma_load(ring + 2 * ((stage + kStages - kAhead) % kStages) * kSwTile, maps.k,"),
    "short: k copied (kAhead steps ahead) into the stage this step's q.k^T still reads": (
        "short_attention.cu", "      tma_load(ring + 2 * st * kSwTile, maps.k,",
        "      tma_load(ring + 2 * ((st + kStages - kAhead) % kStages) * kSwTile, maps.k,"),
    "short: pass 2's q.k^T sequence other than pass 1's (its last k16 step left out)": (
        "short_attention.cu", _PASS2_QK,
        "#pragma unroll\n"
        "    for (int kk = 0; kk < kFlashDh / 16 - 1; ++kk)\n"
        "      wgmma_m64n64k16_rs<0>(s, qf[kk], desc_k_major(ring + 2 * (step % kStages) * kSwTile + kk * 16), kk);\n"
        "    wgmma_commit();\n"
        "    pv_issue(o, pf,"),
    # last: the swapped indices can reach past a tensor's end
    "the head-ordered grid with the image and head indices swapped": (
        "attn_wgmma.cuh", "  p.b = bid % batch;\n  const int rest = bid / batch;\n  p.qt = rest % qtiles;\n  p.h = rest / qtiles;",
        "  p.h = bid % batch;\n  const int rest = bid / batch;\n  p.qt = rest % qtiles;\n  p.b = rest / qtiles;"),
}


_PV = "  for (int kc = 0; kc < KT; ++kc) wgmma_m64n64k16_rs<1>(o, pf[kc],"
_K_TILE = "    tma_load_3d(ks, &maps.kv, inner + h * kAttnDh, 0, img, kv_full);"

# the layer chain's attention_rows: (file in csrc/, text replaced, replacement)
LAYER_MUTANTS = {
    "p.v without its last key chunk": ("layer_tiles.cuh", _PV, _PV.replace("kc < KT;", "kc < KT - 1;")),
    "n_keys masking off: keys masked at n": (
        "attention_rows.cu", "keep, a.n_keys, a.scale_log2e", "keep, a.n, a.scale_log2e"),
    "the k tile taken from the neighbouring head (the map's column offset one head off)": (
        "attention_rows.cu", _K_TILE, _K_TILE.replace("inner + h * kAttnDh", "inner + ((h + 1) % a.heads) * kAttnDh")),
    "KT chosen one chunk short of ceil(n / 16)": (
        "attention_rows.cu", "const int kt = attn_key_chunks(n);", "const int kt = attn_key_chunks(n) - 1;"),
}


_FWD_Q_PAD = "  zero_pad_cols<DH>(qs, tid);\n  if constexpr (QKNORM) rms_norm_wide<DH>(qs, a.gq + h * DH, a.root, tid, nullptr);"
_FWD_K_PAD = ("      zero_pad_cols<DH>(st, tid);\n"
              "      if constexpr (QKNORM) rms_norm_wide<DH>(st, a.gk + h * DH, a.root, tid, nullptr);")

# the wide forward (attention_wide_fwd_kernel and its host side): (file in csrc/, text replaced, replacement), or a
# tuple of such edits
WIDE_MUTANTS = {
    "dh 88's pad columns 88..95 left unzeroed (the next head's q and k in the last k16 step)": (
        ("attention_wide.cuh", _FWD_Q_PAD, _FWD_Q_PAD.replace("  zero_pad_cols<DH>(qs, tid);\n", "")),
        ("attention_wide.cuh", _FWD_K_PAD, _FWD_K_PAD.replace("      zero_pad_cols<DH>(st, tid);\n", ""))),
    "the qk-norm's root fixed at 8 (sqrt(64)) whatever dh": (
        "attention_wide.cu", "  a.scale_log2e = scale_log2e, a.root = wide_root(dim_head);",
        "  a.scale_log2e = scale_log2e, a.root = 8.f;"),
    "the last key chunk dropped": (
        "attention_wide.cuh", "  const int nc = (a.n_keys + kAttnWideTile - 1) / kAttnWideTile, total = 2 * nc;",
        "  const int nc = (a.n_keys - 1) / kAttnWideTile + (a.n_keys <= kAttnWideTile), total = 2 * nc;"),
}


def check_wide(fb, rnd, dev):
    """Phase 63's kernel checks (the runner's generator is unused: the
    checks draw their own)."""
    cs.check_ladder_kernels(fb, rnd, dev)


def check_layer(fb, rnd, dev):
    """Phase 3, phase 16's config-2 attention and phase 34 on the runner's
    generator."""
    cs.check_kernels(fb, rnd)
    cs.check_simple_attention(fb, rnd)
    cs.check_tools(fb, rnd, dev)


def check(fb, rnd, dev):
    """Phases 12 and 28, each with its own generator (``rnd`` is the
    runner's)."""
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    del fb, rnd
    cs.check_flash(fa, dev, torch.Generator(device=dev).manual_seed(cs.SEED))
    cs.check_short_causal_bias(fa, dev, torch.Generator(device=dev).manual_seed(cs.SEED))


if __name__ == "__main__":
    # the layer sets first: the last of MUTANTS may fault, which ends every later launch of the process;
    # "wide" alone runs the wide set
    if sys.argv[1:] == ["wide"]:
        sys.exit(0 if chip_qk_mutants.run(WIDE_MUTANTS, check_wide, "attn-wide") else 1)
    ok = chip_qk_mutants.run(LAYER_MUTANTS, check_layer, "attn-layer")
    ok &= chip_qk_mutants.run(WIDE_MUTANTS, check_wide, "attn-wide")
    ok &= chip_qk_mutants.run(MUTANTS, check, "attn")
    sys.exit(0 if ok else 1)
