"""Mutation check of the LayerNorm backward layernorm_bwd_rows and its
[res_f32] variant on one CUDA card (H100, sm_90a).

    python3 chip_ln_bwd_mutants.py

Runs chip_smoke.py's phases 6 (``check_backward``: layernorm_bwd_rows at
1,576 rows against its twin, run twice, bitwise) and 20
(``check_ff_kernels``: [res_f32] with a bf16 and an f32 residual at 1,576
and 183 rows, and both variants at every path, dims 200 to 3,584 and
bs=128's 25,216 rows, each against its twin and run twice) first on the
kernels as they are, which must pass every check, then on deliberately wrong
copies of ``vit_pytorch_tpu_torch/csrc``, each built under
``build/mutants/`` with one edit to fused_layer_bwd.cu, which must each
fail at least one check.  Prints one line a kernel and exits 1 if the right
kernels fail or a mutant passes.  The runner is chip_qk_mutants.main.
"""

import chip_qk_mutants
import chip_smoke as cs

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "one row's dgamma term dropped (row 5, the register path)": (
        "fused_layer_bwd.cu", "          pg[j][i] += dv[j][i] * xh;", "          if (row != 5) pg[j][i] += dv[j][i] * xh;"),
    "[res_f32] summing dh into the residual's column sum instead of the residual": (
        "fused_layer_bwd.cu", "          if constexpr (RES_F32) pr[j][i] += rv[j][i];",
        "          if constexpr (RES_F32) pr[j][i] += dv[j][i];"),
    "the variance about the chunk's first element, not the row's mean (the register path)": (
        "fused_layer_bwd.cu", "        for (int i = 0; i < 8; ++i) sq += (xv[i] - mu) * (xv[i] - mu);\n      }\n    }",
        "        for (int i = 0; i < 8; ++i) sq += (xv[i] - xv[0]) * (xv[i] - xv[0]);\n      }\n    }"),
    "the block's partials summed without its last warp": (
        "fused_layer_bwd.cu", "    for (int wi = 0; wi < kLnBwdWarps; ++wi) s += smem[wi * kSlices * dim + c];",
        "    for (int wi = 0; wi + 1 < kLnBwdWarps; ++wi) s += smem[wi * kSlices * dim + c];"),
    "the loop path's dbeta term dropped from its last chunk a row": (
        "fused_layer_bwd.cu", "        acc[dim + 8 * v + i] += dv[i];",
        "        acc[dim + 8 * v + i] += v + 32 < nvec ? dv[i] : 0.f;"),
}


def check(fb, rnd, dev):
    """Phases 6 and 20 on the runner's generator."""
    del dev
    cs.check_backward(fb, rnd)
    cs.check_ff_kernels(fb, rnd)


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "ln_bwd")
