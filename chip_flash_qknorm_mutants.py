"""Mutation check of the flash kernels' in-tile qk-norm instantiations on one
CUDA card (H100, sm_90a).

    python3 chip_flash_qknorm_mutants.py

Runs chip_smoke.py's phase 25 (``check_flash_qknorm``: the [qknorm] and
[dropout,qknorm] instantiations of flash_fwd, flash_bwd_dq and flash_bwd_dkv
against their twins, and the Function with gammas against the f32 composite)
first on the kernels as they are, which must pass every check, then on
deliberately wrong copies of ``vit_pytorch_tpu_torch/csrc``, each built under
``build/mutants/`` with one edit, which must each fail at least one check.
Prints one line a kernel with the number of checks that refused it, and
exits 1 if the right kernels fail or a mutant passes.  The runner is
chip_qk_mutants.main.
"""

from pathlib import Path

import torch

import chip_qk_mutants
import chip_smoke as cs

_FLASH = Path(__file__).resolve().parent / "vit_pytorch_tpu_torch" / "csrc" / "flash_attention.cu"


def _span(first: str, last: str):
    """The text of flash_attention.cu from ``first`` to the end of ``last``:
    one replacement that carries several edits apart in the source."""
    text = _FLASH.read_text()
    start = text.index(first)
    return text[start:text.index(last, start) + len(last)]


_FWD_NORM_STAGE = "      rms_norm_tile_sw<kThreads>(ring + 2 * stage * kSwTile, gring);"
# the backward kernels' ring tile, normalised in place once it has landed
_NORM_STAGE = ("        if constexpr (kDkv) rms_norm_tile_quads<128 * kBwdWgs>(threadIdx.x, xs, a.gq + it.h * kFlashDh);\n"
               "        else rms_norm_tile_sw_at<128 * kBwdWgs>(threadIdx.x, xs, a.gk + it.h * kFlashDh);\n")
# dk from the raw q tile: flash_bwd_dkv's consumers first copy each ring q
# tile into a 1024-aligned raw tile of its stage past the kernel's shared
# memory (the launch asks kBwdStages tiles and 1 KB more), then normalise
# the ring tile; s^T reads the normalised tile, dk's product the raw one
_SMEM = "  const int smem = bwd_smem(drop);"
_RING_NORM = "      if constexpr (kQkNorm) {\n" + _NORM_STAGE
_DK = "      pv_issue(acc0, df, xs);  // dq += bf16(ds).k, or dk += bf16(ds^T).q (q^ with qk-norm); retired next tile"
_RAW = "reinterpret_cast<bf16*>(smem + ((bwd_smem(kDropout) - kWgAlign + 1023) & ~1023)) + stage * kSwTile"
_DKV_SPAN = _span(_RING_NORM, _SMEM)
_RAW_Q = _DKV_SPAN.replace(
    _RING_NORM,
    "      if constexpr (kQkNorm && kDkv) {\n"
    "        bf16* raw = " + _RAW + ";\n"
    "        for (int i = threadIdx.x; i < kSwTile / 8; i += 128 * kBwdWgs)\n"
    "          reinterpret_cast<uint4*>(raw)[i] = reinterpret_cast<const uint4*>(xs)[i];\n"
    "        named_sync(1, 128 * kBwdWgs);\n"
    "      }\n" + _RING_NORM).replace(
    _DK, "      pv_issue(acc0, df, kQkNorm && kDkv ? " + _RAW + " : xs);").replace(
    _SMEM, "  const int smem = bwd_smem(drop) + kBwdStages * kSwTileBytes + 1024;")
assert _RAW_Q.count(_RAW) == 2 and "kBwdStages * kSwTileBytes + 1024" in _RAW_Q

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "flash_fwd: only ring stage 0's k tile normalised": (
        "flash_attention.cu", _FWD_NORM_STAGE, _FWD_NORM_STAGE.replace("      rms_norm", "      if (stage == 0) rms_norm")),
    "flash_bwd_dq, flash_bwd_dkv: only ring stage 0's tile normalised (k in dq, q in dkv)": (
        "flash_attention.cu", _NORM_STAGE, "        if (stage == 0) {\n" + _NORM_STAGE + "        }\n"),
    "flash_bwd_dkv: dk from the raw q tile": ("flash_attention.cu", _DKV_SPAN, _RAW_Q),
    "gamma without its sqrt(64) (the operand a block keeps)": (
        "flash_attention.cu", "a[kk][i] = pack_floats(x.x * r * (g.x * kRmsRoot), x.y * r * (g.y * kRmsRoot));",
        "a[kk][i] = pack_floats(x.x * r * g.x, x.y * r * g.y);"),
    "k normalised with gamma_q": (
        "flash_attention.cu", "a.gk = static_cast<const float*>(gk);", "a.gk = static_cast<const float*>(gq);"),
}


def check(fb, rnd, dev):
    """Phase 25 with its own generator (``rnd`` is the runner's)."""
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    del fb, rnd
    cs.check_flash_qknorm(fa, dev, torch.Generator(device=dev).manual_seed(cs.SEED))


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "flash-qknorm")
