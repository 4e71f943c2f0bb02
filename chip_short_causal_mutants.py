"""Mutation check of the short kernel and the flash kernels' causal and bias
variants on one CUDA card (H100, sm_90a).

    python3 chip_short_causal_mutants.py

Runs chip_smoke.py's phase 28 (``check_short_causal_bias``: short_attention
and short_attention[bias] against their twin, the flash [causal] variants and
flash_fwd[bias] against theirs, the Functions against the f32 composite)
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

_SHORT = Path(__file__).resolve().parent / "vit_pytorch_tpu_torch" / "csrc" / "short_attention.cu"

# the short kernel normalising p before its bf16 cast: a first pass 2 for l
# alone, then pass 2 again with p scaled by 1 / l, and no division at the end
_PV_CALL = "  pv_pass<kBias>(o, l0, l1, mx0, mx1, 1.f, 1.f, ring, qf, kb, vb, a, bias0, bias1, row0, row1, g, t);\n"
_DIVISORS = "  const float div0 = l0, div1 = l1;\n"
_PV_SPAN = _PV_CALL + _DIVISORS
assert _PV_SPAN in _SHORT.read_text()

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "short: p divided by l before the p.v product (p normalised before its bf16 cast)": (
        "short_attention.cu", _PV_SPAN,
        "  float first[8][4] = {};\n"
        + _PV_CALL.replace("(o, l0, l1,", "(first, l0, l1,")
        + "  float l0x = 0.f, l1x = 0.f;\n"
        + _PV_CALL.replace("(o, l0, l1, mx0, mx1, 1.f, 1.f,", "(o, l0x, l1x, mx0, mx1, 1.f / l0, 1.f / l1,")
        + "  const float div0 = 1.f, div1 = 1.f;\n"),
    "short: padded keys left in the softmax (m = 49 pads to 64)": (
        "short_attention.cu", "__device__ __forceinline__ bool key_in(int c, int m) { return c < m; }",
        "__device__ __forceinline__ bool key_in(int c, int m) { return c < m || true; }"),
    "flash: the causal mask aligned bottom-right": (
        "flash_attention.cu", "return !a.causal || c <= r; }", "return !a.causal || c <= r + a.m - a.n; }"),
    "flash: the causal loop stopping before the diagonal tile": (
        "flash_attention.cu", "return min(nk, qtile + 1); }", "return min(nk, qtile); }"),
    "flash: the bias added before the scale": (
        "flash_attention.cu", "return __fadd_rn(__fmul_rn(s, scale), bias);", "return __fmul_rn(__fadd_rn(s, bias), scale);"),
    # last: the wrong head index can read past the table
    "short: the bias read with the head index bh / heads instead of bh % heads": (
        "short_attention.cu", "(bh % a.heads) * a.bias_h", "(bh / a.heads) * a.bias_h"),
}


def check(fb, rnd, dev):
    """Phase 28 with its own generator (``rnd`` is the runner's)."""
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    del fb, rnd
    cs.check_short_causal_bias(fa, dev, torch.Generator(device=dev).manual_seed(cs.SEED))


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "short-causal")
