"""Mutation check of the redesigned flash backward kernels (flash_bwd_dq and
flash_bwd_dkv, csrc/flash_attention.cu) on one CUDA card (H100, sm_90a).

    python3 chip_flash_bwd_mutants.py

Runs chip_smoke.py's phases 12 (``check_flash``: every flash kernel against
its twin, with the backward kernels' work-item and admission cases) and 22
(``check_flash_dropout``: the [dropout] instantiations), each with its own
generator, first on the kernels as they are, which must pass every check,
then on deliberately wrong copies of ``vit_pytorch_tpu_torch/csrc``, each
built under ``build/mutants/`` with one edit, which must each fail at least
one check.  Prints one line a kernel with the number of checks that refused
it, and exits 1 if the right kernels fail or a mutant passes.  The runner is
chip_qk_mutants.main.
"""

from pathlib import Path

import torch

import chip_qk_mutants
import chip_smoke as cs

_FLASH = Path(__file__).resolve().parent / "vit_pytorch_tpu_torch" / "csrc" / "flash_attention.cu"


def _span(first: str, last: str):
    """The text of flash_attention.cu from ``first`` to the end of ``last``."""
    text = _FLASH.read_text()
    start = text.index(first)
    return text[start:text.index(last, start) + len(last)]


_QUEUE = "            queue[qslot] = make_int4(static_cast<int>(mask), base, last, 0);"
_DELTA = ("    [[maybe_unused]] const float dl0 = reinterpret_cast<const float*>(rv)[2 * kBwdRows + lr];\n"
          "    [[maybe_unused]] const float dl1 = reinterpret_cast<const float*>(rv)[2 * kBwdRows + lr + 8];\n")
# the p lines of both kernels: the masked logit's exp where the mask says 0
_P_LINES = ("            s[jj][e] = v0 ? exp2_ftz(fmaf(s[jj][e], sl2, -l0)) : 0.f;\n"
            "            s[jj][2 + e] = v1 ? exp2_ftz(fmaf(s[jj][2 + e], sl2, -l1)) : 0.f;\n")
# exp(-1e30 - lse) is 1 where lse is the sentinel -1e30 (a fully masked
# row) and 0 for any other lse: the masked logit's p, emulated exactly
_P_EXP_MASKED = ("            s[jj][e] = v0 ? exp2_ftz(fmaf(s[jj][e], sl2, -l0)) : (l0 == kNegInf * kLog2e ? 1.f : 0.f);\n"
                 "            s[jj][2 + e] = v1 ? exp2_ftz(fmaf(s[jj][2 + e], sl2, -l1)) : "
                 "(l1 == kNegInf * kLog2e ? 1.f : 0.f);\n")

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "the admission list dropping its last tile": (
        "flash_attention.cu", _QUEUE,
        _QUEUE.replace("static_cast<int>(mask)", "static_cast<int>(last && mask ? mask & ~(1u << (31 - __clz(mask))) : mask)")),
    "a stage's k (dq) or q (dkv) read from the next ring slot": (
        "flash_attention.cu", "      bf16* xs = ring + 2 * stage * kSwTile;  // k (dq) or q (dkv)",
        "      bf16* xs = ring + 2 * ((stage + 1) % kBwdStages) * kSwTile;  // k (dq) or q (dkv)"),
    "flash_bwd_dq: delta read for the row one tile on": (
        "flash_attention.cu", _DELTA,
        _DELTA.replace("[2 * kBwdRows + lr]", "[2 * kBwdRows + (lr + kFlashTile) % kBwdRows]").replace(
            "[2 * kBwdRows + lr + 8]", "[2 * kBwdRows + (lr + 8 + kFlashTile) % kBwdRows]")),
    "flash_bwd_dkv[dropout]: dv from the undropped p": (
        "flash_attention.cu", "          keep_to_a_frags(pf, s, kbits, a.drop.inv);  // scaled before its cast",
        "          keep_to_a_frags(pf, s, ~0u, a.drop.inv);"),
    "p as the exp of the masked logit (-1e30 - lse: 1 in a fully masked row)": (
        "flash_attention.cu", _P_LINES, _P_EXP_MASKED),
}


def check(fb, rnd, dev):
    """Phases 12 and 22, each with its own generator (``rnd`` is the
    runner's)."""
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    del rnd
    cs.check_flash(fa, dev, torch.Generator(device=dev).manual_seed(cs.SEED))
    cs.check_flash_dropout(fa, fb, dev, torch.Generator(device=dev).manual_seed(cs.SEED))


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "flash-bwd")
