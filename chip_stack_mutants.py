"""Mutation check of the multi-layer kernel stack_layers on one CUDA card
(H100, sm_90a).

    python3 chip_stack_mutants.py

Runs chip_smoke.py's phase 31 (``check_stack``: stack_layers bitwise against
the chain of 7g launches and within the whole layer's bounds of its twin, the
grad route, the refusals) first on the kernels as they are, which must pass
every check, then on deliberately wrong copies of
``vit_pytorch_tpu_torch/csrc``, each built under ``build/mutants/`` with one
edit to stack_layers.cu, which must each fail at least one check.  Prints one
line a kernel with the number of checks that refused it, and exits 1 if the
right kernels fail or a mutant passes.  The runner is chip_qk_mutants.main.
"""

import chip_qk_mutants
import chip_smoke as cs

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "every layer reads layer 0's weights": (
        "stack_layers.cu", "const StackLayer& L = p.layer[l];", "const StackLayer& L = p.layer[0];"),
    "the fc2 residual taken from the layer's input x instead of y": (
        "stack_layers.cu", "L.w2, L.b2, p.y, p.out,", "L.w2, L.b2, x, p.out,"),
    "x carried between layers unrounded: the fc2 sum (product + b2 + y) kept in f32 to one cast": (
        "stack_layers.cu", "gemm_step<kFc2>(", "gemm_step<kEpiBlockOut>("),
    "the last partial 128-row GEMM tile skipped": (
        "stack_layers.cu", "const int mtiles = (M + kGemmBM - 1) / kGemmBM;", "const int mtiles = M / kGemmBM;"),
    "the grid barrier between the attention and the out projection dropped": (
        "stack_layers.cu", "    grid_sync(p.bar);  // m: attention done\n", ""),
}


def check(fb, rnd, dev):
    """Phase 31 on the runner's generator."""
    cs.check_stack(fb, rnd, dev)


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "stack")
