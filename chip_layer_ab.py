"""Times the layer chain's forward kernels (and gemm_f32out) of one checkout
at ViT-B/16's bs=128 on one CUDA card (H100, sm_90a), for comparing two
commits in one call.

    python3 chip_layer_ab.py <checkout> <label>

Builds ``<checkout>``'s kernels into its own ``build/`` and imports its
``chip_smoke.py`` and package (not this file's), then times layernorm_rows,
gemm_bf16 at its four sites (qkv, out +x, fc1, fc2 +y), attention_rows and
its [dropout] (rate 0.1) and [qknorm] instantiations, gemm_f32out (the
backward's dh = dqkv . W_qkv), the FF backward's gemm_bf16[fc1_save] and
[gelu_bwd], and gemm_bf16[block_out] bare at SimpleViT-qk-norm's served
shape (M = 128 x 196, 768 x 768) on one layer's random operands (b=128,
n=197, dim 768, 12 heads, mlp 3072); then at SimpleViT config 2's shapes
(b=256, n=64, dim 1024, 16 heads) gemm_bf16[block_out] +x and
attention_rows; then one stack_layers launch of 6 layers at bs=128 (phase
33's) and at bs=1, stack_layers[tools] of 6 layers at bs=128, and the chain
of 42 launches each stands for; then layernorm_bwd_rows (LN1's backward with
its dy) and its [res_f32] variant (with a bf16 residual) at 25,216 rows of
768, beside torch.ops.aten.native_layer_norm_backward on the same rows
(dx, dgamma and dbeta in one call, given the forward's mean and rstd; dh
cast to bf16 where it refuses the f32 dh beside bf16 x): CUDA events over
30 chained launches after 3 warm-up ones.  Prints one JSON line {"tree":
label, kernel: ms, ...} and, after a fresh build, the ptxas lines of those
kernels.  Run two checkouts in turns (A, B, B, A) in one call; to time a
parent commit, unpack it with ``git archive`` into a git-ignored directory.
"""

import json
import os
import sys

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

    b, n, dim, heads, mlp, inner = cs.B_TIME, cs.N, cs.DIM, cs.HEADS, cs.MLP, cs.HEADS * cs.DH
    w, kw = cs.layer_weights(rnd)
    x, m, a, qkv = rnd(b, n, dim), rnd(b, n, inner), rnd(b, n, mlp), rnd(b, n, 3 * inner)
    h = fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])
    gq, gk = 1 + rnd(inner, scale=0.2), 1 + rnd(inner, scale=0.2)
    akw = dict(heads=heads, dim_head=cs.DH, scale=cs.DH**-0.5)
    w_qkv_t = w["w_qkv"].t().contiguous()
    calls = {
        "layernorm_rows": lambda: fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]),
        "gemm_bf16[qkv]": lambda: fb.gemm_bf16(h, w["w_qkv"], "qkv"),
        "gemm_bf16[out]": lambda: fb.gemm_bf16(m, w["w_out"], "out", bias=kw["b_out"], residual=x),
        "gemm_bf16[fc1]": lambda: fb.gemm_bf16(h, w["w1"], "fc1", bias=w["b1"]),
        "gemm_bf16[fc2]": lambda: fb.gemm_bf16(a, w["w2"], "fc2", bias=w["b2"], residual=x),
        "attention_rows": lambda: fb.attention_rows(qkv, **akw),
        "attention_rows[dropout]": lambda: fb.attention_rows(qkv, **akw, dropout_rate=cs.RATE, seed=cs.DROP_SEED),
        "attention_rows[qknorm]": lambda: fb.attention_rows(qkv, heads=heads, dim_head=cs.DH, scale=1.0, gamma_q=gq,
                                                            gamma_k=gk),
        "gemm_f32out": lambda: fb.gemm_f32out(qkv, w_qkv_t),
    }
    # the FF backward's two epilogues, at the forward's widths
    act_h1 = fb.gemm_bf16(h, w["w1"], "fc1_save", bias=w["b1"])
    w2_t = w["w2"].t().contiguous()
    calls["gemm_bf16[fc1_save]"] = lambda: fb.gemm_bf16(h, w["w1"], "fc1_save", bias=w["b1"])
    calls["gemm_bf16[gelu_bwd]"] = lambda: fb.gemm_bf16(x, w2_t, "gelu_bwd", aux=act_h1[1])
    # SimpleViT-qk-norm's out projection (no bias, the residual outside the block)
    m_qk = rnd(b, 196, inner)
    calls["gemm_bf16[block_out, bare]"] = lambda: fb.gemm_bf16(m_qk, w["w_out"], "block_out")
    # SimpleViT config 2 (dim 1024, 16 heads, 64 tokens, bs=256)
    b2, n2, d2, h2 = 256, 64, 1024, 16
    m2, x2, w_out2 = rnd(b2, n2, d2), rnd(b2, n2, d2), rnd(d2, d2, scale=d2**-0.5)
    qkv2 = rnd(b2, n2, 3 * h2 * cs.DH)
    calls["gemm_bf16[block_out, +x]"] = lambda: fb.gemm_bf16(m2, w_out2, "block_out", residual=x2)
    calls["attention_rows[config 2]"] = lambda: fb.attention_rows(qkv2, heads=h2, dim_head=cs.DH, scale=cs.DH**-0.5)
    # the multi-layer kernel at g = 6, phase 33's launch (b_out on, b_qkv off), at bs=128 and 1; the tools'
    # instantiation (no b_qkv, b_out); beside each, the chain of 42 launches it stands for
    skw = dict(heads=heads, dim_head=cs.DH, scale=cs.DH**-0.5)
    layers, tools_layers = cs.stack_tuples(rnd, 6, False, True), cs.stack_tuples(rnd, 6, False, False)
    x1 = rnd(1, n, dim)

    def chain(x_, ls, epilogues="package"):
        for lw in ls:
            x_ = fb._layer_forward(fb.KERNELS, x_, *lw, heads, cs.DH, cs.DH**-0.5, fb.LN_EPS, epilogues)[0]
        return x_

    calls["stack_layers[g=6]"] = lambda: fb.stack_layers(x, layers, **skw)
    calls["chain[g=6]"] = lambda: chain(x, layers)
    calls["stack_layers[g=6 bs=1]"] = lambda: fb.stack_layers(x1, layers, **skw)
    calls["chain[g=6 bs=1]"] = lambda: chain(x1, layers)
    calls["stack_layers[tools, g=6]"] = lambda: fb.stack_layers(x, tools_layers, **skw, epilogues="tools")
    calls["chain[tools, g=6]"] = lambda: chain(x, tools_layers, "tools")
    # the LayerNorm backward at bs=128's rows: LN1's (+dy) and [res_f32] (+g, one cast)
    dh = torch.randn(b, n, dim, generator=gen, device=dev)
    dy = rnd(b, n, dim)
    calls["layernorm_bwd_rows"] = lambda: fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=dy)
    calls["layernorm_bwd_rows[res_f32]"] = lambda: fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=dy,
                                                                         res_f32=True)
    aten = torch.ops.aten
    ln_bias = torch.zeros_like(w["ln1_scale"])
    _, mean, rstd = aten.native_layer_norm(x, [dim], w["ln1_scale"], ln_bias, fb.LN_EPS)
    native = lambda g: aten.native_layer_norm_backward(g, x, [dim], mean, rstd, w["ln1_scale"], ln_bias,
                                                       [True, True, True])
    try:
        native(dh)
        dh_native, cast = dh, "none"
    except RuntimeError:
        dh_native, cast = dh.to(x.dtype), "dh cast from f32 to bf16"
    calls["native_layer_norm_backward"] = lambda: native(dh_native)
    out = {"tree": label, "native_layer_norm_backward cast": cast}
    with torch.inference_mode():
        for name, call in calls.items():
            out[name] = cs.cuda_ms(call, 30)
    print(json.dumps(out), flush=True)
    for line in cs.ptxas_report(lib.build_log):
        if any(k in line for k in ("layernorm_rows", "layernorm_bwd", "gemm_bf16", "attention_rows_kernel",
                                   "stack_layers")):
            print(label, line)
