"""Times the training kernels gemm_wgrad and attention_bwd_rows of one
checkout on one CUDA card (H100, sm_90a), beside their torch yardsticks, and
ViT-B/16 training under the opt-in backwards, for comparing two commits in
one call.

    python3 chip_bwd_ab.py <checkout> <label> [--no-steps]

Builds ``<checkout>``'s kernels into its own ``build/`` and imports its
``chip_smoke.py`` and package (not this file's), then on seeded random
operands (CUDA events over 20 chained launches after 3 warm-up ones; 5 at
bs=1024):

  - gemm_wgrad at one layer's four sites at bs=128 (K = 128 x 197 rows):
    dW2 = g^T act (768 x 3072) plus dW1 = dh1^T y2 (3072 x 768), and dW_out
    = dy^T m (768 x 768) plus dW_qkv = dqkv^T h (2304 x 768), each pair
    summed; dW1 at bs=1024 (K = 201,728); beside each, torch.matmul(a.t(),
    b) on the same operands;
  - attention_bwd_rows at ViT-B/16's bs=128 (n=197, 12 heads), its
    [dropout] (rate 0.1) and [qknorm] (n=196, SimpleViT-qk-norm's gammas at
    init, scale 1) instantiations, and at SimpleViT config 2's shape (b=256,
    n=64, 16 heads); beside each, scaled_dot_product_attention's forward and
    backward to q, k, v on the same operands (dropout_p=0.1 beside
    [dropout]; without the norm beside [qknorm]);
  - unless --no-steps: ViT-B/16 training at bs=1024 (phase 21's model) under
    the default backward and under VIT_TPU_FF_BWD=full, VIT_TPU_FF_BWD=hybrid
    and VIT_TPU_ENABLE_WHOLE_LAYER_BWD=1, ms a step over 2 steps.

Prints one JSON line {"tree": label, name: ms, ...} and, after a fresh
build, the ptxas lines of the two kernels.  Run two checkouts in turns (A, B,
B, A) in one call; to time a parent commit, unpack it with ``git archive``
into a git-ignored directory.
"""

import json
import os
import sys

if __name__ == "__main__":
    tree, label = sys.argv[1], sys.argv[2]
    steps = "--no-steps" not in sys.argv[3:]
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    def sdpa_fwd_bwd(qkv, dm, heads, **kw):
        """scaled_dot_product_attention forward + backward to q, k, v, dm the
        output's cotangent (the yardstick chip_smoke.sdpa_fwd_bwd_ms times)."""
        b, n, _ = qkv.shape
        q, k, v = (t.clone().requires_grad_() for t in qkv.view(b, n, 3, heads, cs.DH).permute(2, 0, 3, 1, 4))
        go = dm.view(b, n, heads, cs.DH).transpose(1, 2).clone()

        def run():
            o = torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)
            torch.autograd.grad(o, (q, k, v), go)

        return cs.cuda_ms(run, 20)

    out = {"tree": label}
    rows, d, mlp, inner = cs.B_TIME * cs.N, cs.DIM, cs.MLP, cs.HEADS * cs.DH
    with torch.inference_mode():
        g, act, dh1, y2 = rnd(rows, d), rnd(rows, mlp), rnd(rows, mlp), rnd(rows, d)
        m, dqkv = rnd(rows, inner), rnd(rows, 3 * inner)
        for name, pairs in (("dW2+dW1", ((g, act), (dh1, y2))), ("dWout+dWqkv", ((g, m), (dqkv, y2)))):
            out[f"gemm_wgrad[{name}]"] = sum(cs.cuda_ms(lambda: fb.gemm_wgrad(a, b), 20) for a, b in pairs)
            out[f"matmul[{name}]"] = sum(cs.cuda_ms(lambda: torch.matmul(a.t(), b), 20) for a, b in pairs)
        del g, act, dh1, y2, m, dqkv
        big = cs.B_TRAIN_TIME * cs.N
        a_big, b_big = rnd(big, mlp), rnd(big, d)
        out["gemm_wgrad[dW1 bs=1024]"] = cs.cuda_ms(lambda: fb.gemm_wgrad(a_big, b_big), 5)
        out["matmul[dW1 bs=1024]"] = cs.cuda_ms(lambda: torch.matmul(a_big.t(), b_big), 5)
        del a_big, b_big

        akw = dict(heads=cs.HEADS, dim_head=cs.DH, scale=cs.DH**-0.5)
        gq = torch.full((inner,), cs.DH**-0.5, dtype=bf16, device=dev)
        qk_kw = dict(heads=cs.HEADS, dim_head=cs.DH, scale=1.0, gamma_q=gq, gamma_k=gq.clone())
        drop_kw = dict(dropout_rate=cs.RATE, seed=cs.DROP_SEED)
        c2_heads = cs.SIMPLE["heads"]
        c2kw = dict(heads=c2_heads, dim_head=cs.DH, scale=cs.DH**-0.5)
        cases = (  # name, b, n, heads, kernel kwargs, sdpa kwargs
            ("attention_bwd_rows", cs.B_TIME, cs.N, cs.HEADS, akw, {}),
            ("attention_bwd_rows[dropout]", cs.B_TIME, cs.N, cs.HEADS, {**akw, **drop_kw}, dict(dropout_p=cs.RATE)),
            ("attention_bwd_rows[qknorm]", cs.QKNORM_BS, cs.QKNORM_N, cs.HEADS, qk_kw, dict(scale=1.0)),
            ("attention_bwd_rows[config 2]", cs.SIMPLE_BS, cs.SIMPLE_N, c2_heads, c2kw, {}),
        )
        for name, b, n, heads, kw, skw in cases:
            qkv, dm = rnd(b, n, 3 * heads * cs.DH), rnd(b, n, heads * cs.DH)
            out[name] = cs.cuda_ms(lambda: fb.attention_bwd_rows(qkv, dm, **kw), 20)
            with torch.inference_mode(False), torch.enable_grad():
                out[f"sdpa fwd+bwd[{name}]"] = sdpa_fwd_bwd(qkv, dm, heads, **skw)
    if steps:
        from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

        model = cs.vit_b(dev, bf16)
        images = torch.randn(cs.B_TRAIN_TIME, 3, 224, 224, generator=gen, device=dev).to(bf16)
        labels = torch.randint(0, 1000, (cs.B_TRAIN_TIME,), generator=gen, device=dev)
        state, step = create_train_state(model), make_train_step(model)
        for mode, env in (("default", {}), *cs.FF_MODES):
            with cs.env_switch(env):
                out[f"vit-b/16 training ms/step bs={cs.B_TRAIN_TIME} [{mode}]"] = cs.train_step_ms(
                    dev, lambda: step(state, images, labels))[0]
    print(json.dumps(out), flush=True)
    for line in cs.ptxas_report(lib.build_log):
        if any(k in line for k in ("gemm_wgrad", "attention_bwd")):
            print(label, line)
