"""Mutation check of the kernels of the port's bench tools (the f32
epilogues of the JAX package's layer prototypes in ``tools/``) on one CUDA
card (H100, sm_90a).

    python3 chip_tools_mutants.py

Runs chip_smoke.py's phase 34 (``check_tools``: the ten counterparts
against their twins, make_stack bitwise the chain, the epilogues against
their exact references, attention_rows[n_keys]) first on the kernels as
they are, which must pass every check, then on deliberately wrong copies of
``vit_pytorch_tpu_torch/csrc``, each built under ``build/mutants/`` with one
edit, which must each fail at least one check.  Prints one line a kernel
with the number of checks that refused it, and exits 1 if the right kernels
fail or a mutant passes.  The runner is chip_qk_mutants.main.
"""

import chip_qk_mutants
import chip_smoke as cs

# name: (file in csrc/, text replaced, replacement), or a tuple of such edits; each text occurs once
MUTANTS = {
    "fc1_f32 rounding the dot before the bias (the package's fc1)": (
        "layer_tiles.cuh", "  } else if (EPI == kEpiFc1F32) {\n    if (has_bias) {",
        "  } else if (EPI == kEpiFc1F32) {\n    {\n      const float2 r = round_bf16(v0, v1);\n"
        "      v0 = r.x, v1 = r.y;\n    }\n    if (has_bias) {"),
    "the tools' stack rounding fc2 before its residual (kEpiFc2)": (
        "stack_layers.cu", "constexpr int kFc2 = TOOLS ? kEpiBlockOut : kEpiFc2;", "constexpr int kFc2 = kEpiFc2;"),
    "n_keys ignored: keys masked at n": (
        "attention_rows.cu", "keep, a.n_keys, a.scale_log2e", "keep, a.n, a.scale_log2e"),
    "the tools' stack reading layer 0's weights and operands in every layer": (
        ("stack_layers.cu", "const StackLayer& L = p.layer[l];", "const StackLayer& L = p.layer[TOOLS ? 0 : l];"),
        *(("stack_layers.cu", f"&maps.w[l][{i}]", f"&maps.w[TOOLS ? 0 : l][{i}]") for i in range(4))),
}


def check(fb, rnd, dev):
    """Phase 34 on the runner's generator."""
    cs.check_tools(fb, rnd, dev)


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "tools")
