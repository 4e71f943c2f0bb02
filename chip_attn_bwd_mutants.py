"""Mutation check of attention_bwd_rows on one CUDA card (H100, sm_90a).

    python3 chip_attn_bwd_mutants.py

Runs chip_smoke.py's phases 6, 9 and 16 (``check_backward``,
``check_dropout``, ``check_qknorm``, ``check_simple_attention``: every
instantiation of attention_bwd_rows against its twin at n = 197, 50, 1, 16,
17, 64 and 208, bitwise from run to run, inside the layer and block
Functions' gradients) first on the kernels as they are, which must pass
every check, then on deliberately wrong copies of
``vit_pytorch_tpu_torch/csrc``, each built under ``build/mutants/`` with one
edit, which must each fail at least one check.  Prints one line a kernel
and exits 1 if the right kernels fail or a mutant passes; the runner is
``chip_qk_mutants.main``.
"""

import chip_qk_mutants
import chip_smoke as cs

_D_SUM = ("            d0 += s[j][0] * dpj[0] + s[j][1] * dpj[1];\n"
          "            d1 += s[j][2] * dpj[2] + s[j][3] * dpj[3];")
_DS_T = ("                dpt[j][e] = p0 * ((keep0 ? dpt[j][e] * a.drop.inv : 0.f) - dd);\n"
         "                dpt[j][2 + e] = p1 * ((keep1 ? dpt[j][2 + e] * a.drop.inv : 0.f) - dd);")

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "D = rowsum(dp * p) from the bf16 p": (
        "attention_bwd_rows.cuh", _D_SUM,
        "            const float2 b0 = round_bf16(s[j][0], s[j][1]), b1 = round_bf16(s[j][2], s[j][3]);\n"
        "            d0 += b0.x * dpj[0] + b0.y * dpj[1];\n"
        "            d1 += b1.x * dpj[2] + b1.y * dpj[3];"),
    "dq without the scale": (
        "attention_bwd_rows.cuh", "      for (int e = 0; e < 4; ++e) dq[dj][e] *= a.scale;",
        "      for (int e = 0; e < 4; ++e) dq[dj][e] *= 1.f;"),
    "3 key chunks of 16 at n = 64 (the instantiation of 48 keys)": (
        "attention_bwd_rows.cu", "const int kt = attn_key_chunks(n);", "const int kt = n == 64 ? 3 : attn_key_chunks(n);"),
    "[dropout] ds^T from the masked p": (
        "attention_bwd_rows.cuh", _DS_T,
        "                dpt[j][e] = (keep0 ? p0 * a.drop.inv : 0.f) * ((keep0 ? dpt[j][e] * a.drop.inv : 0.f) - dd);\n"
        "                dpt[j][2 + e] = (keep1 ? p1 * a.drop.inv : 0.f) * "
        "((keep1 ? dpt[j][2 + e] * a.drop.inv : 0.f) - dd);"),
    "the key pass's keep words of the next key tile": (
        "attention_bwd_rows.cuh", "const int w = k0 / 32 + (i & 1);", "const int w = k0 / 32 + 2 + (i & 1);"),
}


def check(fb, rnd, dev):
    """attention_bwd_rows' phases: 6, 9 and 16."""
    cs.check_backward(fb, rnd)
    cs.check_dropout(fb, rnd, dev)
    cs.check_qknorm(fb, rnd, dev)
    cs.check_simple_attention(fb, rnd)


if __name__ == "__main__":
    chip_qk_mutants.main(MUTANTS, check, "attn-bwd")
