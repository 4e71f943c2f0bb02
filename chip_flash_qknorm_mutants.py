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


_NORM_STAGE = "  rms_norm_rows<kFlashTile, kFlashLd, kFlashThreads>(ring + 2 * stage * kTileElems, gammas, nullptr, nullptr);"
_FWD_NORM_STAGE = "      rms_norm_tile_sw<kThreads>(ring + 2 * stage * kSwTile, gring);"
# dk from the raw q tile: the ring's q stage is normalised with a raw copy kept
# in a tile of shared memory past the gammas, which dk's product then reads
_DKV_SMEM = "constexpr int kDkvSmem = 4 * kTileElems * static_cast<int>(sizeof(bf16)) + 2 * 3 * kFlashTile * 4;"
_DKV_NORM = "    if constexpr (kQkNorm) rms_norm_stage(ring, stage, gring);\n\n    const bf16* qs = ring"
_DKV_DK = "mma_acc(dk, f, qs, g, t);  // dk += bf16(ds^T) . q (q^ with qk-norm)"
_DKV_SPAN = _span(_DKV_SMEM, _DKV_DK)

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "flash_fwd: only ring stage 0's k tile normalised": (
        "flash_attention.cu", _FWD_NORM_STAGE, _FWD_NORM_STAGE.replace("      rms_norm", "      if (stage == 0) rms_norm")),
    "flash_bwd_dq, flash_bwd_dkv: only ring stage 0's tile normalised (k in dq, q in dkv)": (
        "flash_attention.cu", _NORM_STAGE, "  if (stage == 0)\n  " + _NORM_STAGE),
    "flash_bwd_dkv: dk from the raw q tile": (
        "flash_attention.cu", _DKV_SPAN,
        _DKV_SPAN.replace(_DKV_SMEM, _DKV_SMEM[:-1] + " + kTileElems * 2;").replace(
            _DKV_NORM,
            "    bf16* raw_q = reinterpret_cast<bf16*>(gring + kFlashDh);\n"
            "    if constexpr (kQkNorm) {\n"
            "      rms_norm_rows<kFlashTile, kFlashLd, kFlashThreads>(ring + 2 * stage * kTileElems, gring, raw_q, "
            "nullptr);\n"
            "      __syncthreads();\n"
            "    }\n\n    const bf16* qs = ring").replace(
            _DKV_DK, "mma_acc(dk, f, kQkNorm ? raw_q : qs, g, t);")),
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
