"""Mutation check of the flash kernels' dropout instantiations on one CUDA
card (H100, sm_90a).

    python3 chip_flash_dropout_mutants.py

Runs chip_smoke.py's phase 22 (``check_flash_dropout``: the [dropout]
instantiations of flash_fwd, flash_bwd_dq and flash_bwd_dkv and the
flash_dropout_masks replay against their twins) first on the kernels as they
are, which must pass every check, then on deliberately wrong copies of
``vit_pytorch_tpu_torch/csrc``, each built under ``build/mutants/`` with one
edit, which must each fail at least one check.  Prints one line a kernel
with the number of checks that refused it, and exits 1 if the right kernels
fail or a mutant passes.  The runner is chip_qk_mutants.main.
"""

from pathlib import Path

import torch

import chip_qk_mutants
import chip_smoke as cs

_FLASH = Path(__file__).resolve().parent / "vit_pytorch_tpu_torch" / "csrc" / "flash_attention.cu"


def _span(first: str, last: str):
    """The text of flash_attention.cu from ``first`` to the end of ``last``:
    one replacement that carries two edits apart in the source."""
    text = _FLASH.read_text()
    start = text.index(first)
    return text[start:text.index(last, start) + len(last)]


_FWD_KEEP = "apply_keep_bits(s, keep_bits_rows(keep + stage * kKeepStage, lr, t), "
_FWD_NUM = "const float num = kDropout ? a.drop.inv : 1.f;"
_FWD_TAIL = _span(_FWD_KEEP + "1.f);", _FWD_NUM)
# flash_fwd's p loop, which sums l from the undropped p
_FWD_P_SUM = _span("        s[jj][e] = exp2_ftz((s[jj][e] - mn0) * kLog2e);", "        sum1 += s[jj][2 + e];\n      }\n    }\n")

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "flash_fwd: l accumulating the dropped p": (
        "flash_attention.cu", _FWD_P_SUM, _FWD_P_SUM.replace(
            "        sum0 += s[jj][e];\n        sum1 += s[jj][2 + e];\n      }\n    }\n",
            "      }\n    }\n"
            "    if constexpr (kDropout) " + _FWD_KEEP + "1.f);\n"
            "#pragma unroll\n    for (int jj = 0; jj < 8; ++jj) {\n#pragma unroll\n      for (int e = 0; e < 2; ++e) {\n"
            "        sum0 += s[jj][e];\n        sum1 += s[jj][2 + e];\n      }\n    }\n")),
    "flash_fwd: 1/(1 - rate) applied to p before its bf16 cast": (
        "flash_attention.cu", _FWD_TAIL,
        _FWD_TAIL.replace(_FWD_KEEP + "1.f);", _FWD_KEEP + "a.drop.inv);").replace(_FWD_NUM, "const float num = 1.f;")),
    "flash_bwd_dkv: the keep tile read untransposed": (
        "flash_attention.cu", "kbits = keep_bits_cols(kt, warp * 16 + g, t);",
        "kbits = keep_bits_rows(kt, warp * 16 + g, t);"),
    "flash_bwd_dq: dp left unmasked (scaled by 1/(1 - rate) only)": (
        "flash_attention.cu", "        if constexpr (kDropout) kbits = keep_bits_rows(kt, warp * 16 + g, t);",
        "        if constexpr (kDropout) kbits = ~0u;"),
}


def check(fb, rnd, dev):
    """Phase 22 with its own generator (``rnd`` is the runner's)."""
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    del rnd
    cs.check_flash_dropout(fa, fb, dev, torch.Generator(device=dev).manual_seed(cs.SEED))


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "flash-dropout")
