"""Mutation check of the opt-in backwards' kernels on one CUDA card (H100,
sm_90a).

    python3 chip_ff_mutants.py

Runs chip_smoke.py's phase 20 (``check_ff_kernels``: gemm_bf16[fc1_save],
gemm_bf16[gelu_bwd], layernorm_bwd_rows[res_f32] and gemm_wgrad against
their twins, the column sums and gemm_wgrad bitwise deterministic, the whole
layer's 13 gradients under each switch) first on the kernels as they are,
which must pass every check, then on deliberately wrong copies of
``vit_pytorch_tpu_torch/csrc``, each built under ``build/mutants/`` with one
edit, which must each fail at least one check.  Prints one line a kernel
with the number of checks that refused it, and exits 1 if the right kernels
fail or a mutant passes.
"""

import chip_qk_mutants
import chip_smoke as cs

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "GELU' of the erf GELU instead of the tanh one": (
        "layer_tiles.cuh",
        "  const float t = tanhf(c * (h + a * h * h * h));\n"
        "  return 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * c * (1.0f + 3.0f * a * h * h);",
        "  return normcdff(h) + h * 0.3989422804014327f * expf(-0.5f * h * h) + 0.f * (c + a);"),
    "[res_f32] casting dy to bf16 before adding g": (
        "fused_layer_bwd.cu", "for (int i = 0; i < 8; ++i) out[i] += rv[i];  // in f32, before the one cast",
        "for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(__float2bfloat16(out[i])) + rv[i];"),
    "gemm_wgrad with a split tile's first piece dropped from its sum": (
        "gemm_wgrad.cu", "  for (int s = 0; s < pieces; ++s) {", "  for (int s = 1; s < pieces; ++s) {"),
    "gemm_wgrad adding a split tile's pieces from the next slot on": (
        "gemm_wgrad.cu", "(static_cast<size_t>(ts + b0) * kWgConsumers + cw)",
        "(static_cast<size_t>(ts + b0 + 1) * kWgConsumers + cw)"),
    "gemm_wgrad without the last k-tile of each piece's range (a zero tile in its place)": (
        "gemm_wgrad.cu", "load(sk0 + w.t0, k0 + o);", "load(sk0 + w.t0, k0 + o + (o + 1 == w.y0 ? ktiles : 0));"),
    "db1 summed from the bf16 dh1": (
        "gemm_ring.cuh", "            p0 += v.x;\n            p1 += v.y;",
        "            const float2 r = round_bf16(v.x, v.y);\n            p0 += r.x;\n            p1 += r.y;"),
}


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, lambda fb, rnd, dev: cs.check_ff_kernels(fb, rnd), "ff")
