"""Mutation check of the chain's GEMM (``csrc/gemm_bf16.cu`` on
``csrc/gemm_ring.cuh``'s main loop and epilogue) on one CUDA card (H100,
sm_90a).

    python3 chip_gemm_mutants.py

Runs chip_smoke.py's phases 3 (``check_kernels``: gemm_bf16 at the layer's
four sites against its twin, attention_rows, the whole layer) and 20
(``check_ff_kernels``: gemm_bf16[fc1_save] and [gelu_bwd] with db1 against
their twins at 1,576 and 183 rows, the column sums bitwise deterministic)
first on the kernels as they are, which must pass every check, then on
deliberately wrong copies of ``vit_pytorch_tpu_torch/csrc``, each built under
``build/mutants/`` with one edit to gemm_ring.cuh, which must each fail at
least one check.  Prints one line a kernel with the number of checks that
refused it, and exits 1 if the right kernels fail or a mutant passes.  The
runner is chip_qk_mutants.main.
"""

import chip_qk_mutants
import chip_smoke as cs

_PRODUCTS = "      for (int kk = 0; kk < kGemmBK / 16; ++kk)\n        wgmma_m64n128k16<0, 0>(d, wgmma_desc(as"
_STAGE_A = "      const bf16* as = r.As + pos.stage * kGemmATile + cw * 64 * kGemmBK;"
_PARTIALS = "      if (cw == 0 && n0 + wtid < p.N) {  // the tile's 8 warps in order, a column a thread"

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "the last k-tile's products skipped (its stage still waited for and released)": (
        "gemm_ring.cuh", _PRODUCTS,
        "      for (int kk = 0; kk < (kt + 1 < ktiles ? kGemmBK / 16 : 0); ++kk)\n"
        "        wgmma_m64n128k16<0, 0>(d, wgmma_desc(as"),
    "the rows of a partial last 64-row box left unstored": (
        "gemm_ring.cuh", "      if (r0 < p.M) {", "      if (r0 + 64 <= p.M) {"),
    "the consumers reading A from the ring one stage off": (
        "gemm_ring.cuh", _STAGE_A, _STAGE_A.replace("pos.stage * kGemmATile", "((pos.stage + 1) % S) * kGemmATile")),
    "gelu_bwd's column partials of a partial last 128-row tile dropped": (
        "gemm_ring.cuh", _PARTIALS,
        _PARTIALS.replace("if (cw == 0 && n0 + wtid < p.N) {", "if (cw == 0 && n0 + wtid < p.N && m0 + kGemmBM <= p.M) {")),
}


def check(fb, rnd, dev):
    """Phases 3 and 20 on the runner's generator."""
    del dev
    cs.check_kernels(fb, rnd)
    cs.check_ff_kernels(fb, rnd)


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "gemm")
