"""Mutation check of the multi-layer kernel stack_layers on one CUDA card
(H100, sm_90a).

    python3 chip_stack_mutants.py

Runs chip_smoke.py's phase 31 (``check_stack``: stack_layers bitwise against
the chain of 7g launches and within the whole layer's bounds of its twin, a
shape with a ragged last wave at every step, 20 relaunches of g = 6 at
bs=128 of both instantiations, the grad route, the refusals) first on the
kernels as they are, which must pass every check, then on deliberately wrong
copies of ``vit_pytorch_tpu_torch/csrc``, each built under ``build/mutants/``
with edits to stack_layers.cu, which must each fail at least one check.
Prints one line a kernel with the number of checks that refused it, and
exits 1 if the right kernels fail or a mutant passes.  The runner is
chip_qk_mutants.main.
"""

import chip_qk_mutants
import chip_smoke as cs

_FC2_PRODUCER = "&maps.a, &maps.w[l][3], &maps.y, M, p.dim, p.mlp, pos);"
_FC2_CONSUMER = "GemmArgs{L.b2, M, p.dim, p.mlp, 1,"

# name: (file in csrc/, text replaced, replacement), or a tuple of such edits;
# each text occurs once
MUTANTS = {
    "every layer reads layer 0's weights and operands": (
        "stack_layers.cu", "reinterpret_cast<const bf16* const*>(weights) + 12 * l;",
        "reinterpret_cast<const bf16* const*>(weights) + 0 * l;"),
    "the fc2 residual taken from the stack's input x instead of y": (
        "stack_layers.cu", _FC2_PRODUCER, _FC2_PRODUCER.replace("&maps.y", "&maps.x")),
    "x carried between layers unrounded: the fc2 sum (product + b2 + y) kept in f32 to one cast": (
        "stack_layers.cu", "gemm_consume<kFc2, S>(", "gemm_consume<kEpiBlockOut, S>("),
    "the last partial 128-row tile of every step skipped": (
        "stack_layers.cu", "const int M = p.batch * p.n, inner", "const int M = p.batch * p.n / kGemmBM * kGemmBM, inner"),
    "the grid barrier between the attention and the out projection not waited for": (
        "stack_layers.cu", "for (int spin = 0; ld_acquire_gpu(bar) < arrivals; ++spin)",
        "for (int spin = 0; arrivals % (7 * gridDim.x) != 3 * gridDim.x && ld_acquire_gpu(bar) < arrivals; ++spin)"),
    "the out step's residual from the stack's input x in every layer, not the layer's own x": (
        "stack_layers.cu", "l == 0 ? &maps.x : &maps.out", "&maps.x"),
    "the last GEMM step (fc2) one k-tile short": (
        ("stack_layers.cu", _FC2_PRODUCER, _FC2_PRODUCER.replace("p.mlp, pos", "p.mlp - kGemmBK, pos")),
        ("stack_layers.cu", _FC2_CONSUMER, _FC2_CONSUMER.replace("p.mlp, 1", "p.mlp - kGemmBK, 1"))),
}


def check(fb, rnd, dev):
    """Phase 31 on the runner's generator."""
    cs.check_stack(fb, rnd, dev)


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "stack")
