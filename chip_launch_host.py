"""Times the host side of the layer chain's launches at ViT-B/16's bs=1 for
one checkout, on one CUDA card (H100, sm_90a), for comparing two commits in
one call where serving is host-bound.

    python3 chip_launch_host.py <checkout> <label>

Builds ``<checkout>``'s kernels into its own ``build/`` and imports its
``chip_smoke.py`` and package (not this file's), then for layernorm_rows,
gemm_bf16 at its four sites, attention_rows and one whole layer
(``fused_transformer_layer``, 7 launches) on one image (n = 197, ViT-B
widths) prints the host µs a call (500 calls enqueued after 20 warm-up
ones, the host clock stopped before the synchronize) and the µs a call by
CUDA events over 200 chained calls, which at this size is the host's rate
too.  One JSON line {"tree": label, ...}.  Run two checkouts in turns (A,
B, B, A) in one call; to time a parent commit, unpack it with ``git
archive`` into a git-ignored directory.
"""

import json
import os
import sys
import time

if __name__ == "__main__":
    tree, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from vit_pytorch_tpu_torch.ops import fused_block as fb
    from vit_pytorch_tpu_torch.ops._build import load_library

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the timing needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    lib = load_library()
    if not str(lib.path).startswith(os.path.abspath(tree)):
        print(f"FAIL: the kernels came from {lib.path}, not from {tree}", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    w, kw = cs.layer_weights(rnd)
    n, dim, inner, mlp = cs.N, cs.DIM, cs.HEADS * cs.DH, cs.MLP
    x, h, m, a, qkv = rnd(1, n, dim), rnd(1, n, dim), rnd(1, n, inner), rnd(1, n, mlp), rnd(1, n, 3 * inner)
    calls = {
        "layernorm_rows": lambda: fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]),
        "gemm_bf16[qkv]": lambda: fb.gemm_bf16(h, w["w_qkv"], "qkv", bias=kw["b_qkv"]),
        "gemm_bf16[out]": lambda: fb.gemm_bf16(m, w["w_out"], "out", bias=kw["b_out"], residual=x),
        "gemm_bf16[fc1]": lambda: fb.gemm_bf16(h, w["w1"], "fc1", bias=w["b1"]),
        "gemm_bf16[fc2]": lambda: fb.gemm_bf16(a, w["w2"], "fc2", bias=w["b2"], residual=x),
        "attention_rows": lambda: fb.attention_rows(qkv, heads=cs.HEADS, dim_head=cs.DH, scale=cs.DH**-0.5),
        "the layer": lambda: fb.fused_transformer_layer(
            x, w["w_qkv"], w["w_out"], w["ln1_scale"], w["ln1_bias"], w["ln2_scale"], w["ln2_bias"], w["w1"],
            w["b1"], w["w2"], w["b2"], heads=cs.HEADS, dim_head=cs.DH, b_qkv=kw["b_qkv"], b_out=kw["b_out"]),
    }
    out = {"tree": label}
    with torch.inference_mode():
        for name, call in calls.items():
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(500):
                call()
            out[f"{name} host us"] = (time.perf_counter() - t) * 1e6 / 500
            torch.cuda.synchronize()
            out[f"{name} events us"] = cs.cuda_ms(call, 200) * 1e3
    print(json.dumps(out), flush=True)
