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


def _span(first: str, last: str):
    """The text of short_attention.cu from ``first`` to the end of ``last``:
    one replacement that carries several edits apart in the source."""
    text = _SHORT.read_text()
    start = text.index(first)
    return text[start:text.index(last, start) + len(last)]


# the short kernel normalising p before its bf16 cast: pass 1 also sums l
# (online, against its running max), pass 2 casts p / l, and the end divides
# by 1
_PASS1_MAX = """#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(s[jj][0], s[jj][1]));
      mx1 = fmaxf(mx1, fmaxf(s[jj][2], s[jj][3]));
    }
"""
_PASS1_L = """    {
      float t0 = kNegInf, t1 = kNegInf;
      for (int jj = 0; jj < 8; ++jj) {
        t0 = fmaxf(t0, fmaxf(s[jj][0], s[jj][1]));
        t1 = fmaxf(t1, fmaxf(s[jj][2], s[jj][3]));
      }
      const float n0 = fmaxf(mx0, quad_max(t0)), n1 = fmaxf(mx1, quad_max(t1));
      float e0 = 0.f, e1 = 0.f;
      for (int jj = 0; jj < 8; ++jj) {
        for (int e = 0; e < 2; ++e) {
          e0 += exp2f((s[jj][e] - n0) * kLog2e);
          e1 += exp2f((s[jj][2 + e] - n1) * kLog2e);
        }
      }
      ll0 = ll0 * exp2f((mx0 - n0) * kLog2e) + quad_sum(e0);
      ll1 = ll1 * exp2f((mx1 - n1) * kLog2e) + quad_sum(e1);
      mx0 = n0;
      mx1 = n1;
    }
"""
_MX_DECL = "  float mx0 = kNegInf, mx1 = kNegInf;\n"
_P_STORE = "        s[jj][e] = p0;\n        s[jj][2 + e] = p1;\n"
_DIVISORS = "  const float div0 = quad_sum(sum0), div1 = quad_sum(sum1);"
_NORMED_SPAN = _span(_MX_DECL, _DIVISORS)
assert _PASS1_MAX in _NORMED_SPAN and _P_STORE in _NORMED_SPAN

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "short: p divided by l before the p.v product (p normalised before its bf16 cast)": (
        "short_attention.cu", _NORMED_SPAN,
        _NORMED_SPAN.replace(_MX_DECL, _MX_DECL + "  float ll0 = 0.f, ll1 = 0.f;\n").replace(_PASS1_MAX, _PASS1_L)
        .replace(_P_STORE, "        s[jj][e] = p0 / ll0;\n        s[jj][2 + e] = p1 / ll1;\n")
        .replace(_DIVISORS, "  const float div0 = 1.f, div1 = 1.f;")),
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
    "short: the bias read with the image index as its head": (
        "short_attention.cu", "(h * a.bias_h + q0 * a.bias_row)", "(b * a.bias_h + q0 * a.bias_row)"),
}


def check(fb, rnd, dev):
    """Phase 28 with its own generator (``rnd`` is the runner's)."""
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    del fb, rnd
    cs.check_short_causal_bias(fa, dev, torch.Generator(device=dev).manual_seed(cs.SEED))


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "short-causal")
