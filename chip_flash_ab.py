"""Times the forward attention kernels and the flash backward kernels of one
checkout on one CUDA card (H100, sm_90a), for comparing two commits in one
call.

    python3 chip_flash_ab.py <checkout> <label>

Builds ``<checkout>``'s kernels into its own ``build/`` and imports its
``chip_smoke.py`` and package (not this file's), then times, with CUDA
events over chained launches after 3 warm-up ones:

  - at NaViT-B's packed training shape (phase 14's 16 packs of 2048 tokens
    with their segment ids, 12 heads, q and k through rms_norm, scale 1):
    flash_fwd, flash_bwd_dq and flash_bwd_dkv at rate 0 and [dropout] at
    0.1, and each at [qknorm] and [dropout,qknorm] (gammas 1 + 0.2 N);
  - short_attention and [bias] (a (12, 1024, 1024) f32 table) at
    SimpleViT-B/16 @512's 32 x 12 x 1024 (phase 30's shape);
  - flash_fwd without options, [causal], [dropout,causal], [bias] and
    [bias,causal] (a (1, 12, 2048, 2048) f32 table), and flash_bwd_dq and
    flash_bwd_dkv without options and at each causal variant ([causal],
    [dropout,causal], [qknorm,causal], [dropout,qknorm,causal]), at 8 x 12
    x 2048 (phase 30's shape).

Prints one JSON line {"tree": label, kernel: ms, ...} and, after a fresh
build, the ptxas line of each flash and short kernel.  Run two checkouts in
turns (A, B, B, A) in one call; to time a parent commit, unpack it with
``git archive`` into a git-ignored directory.
"""

import json
import os
import sys

if __name__ == "__main__":
    tree, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from vit_pytorch_tpu_torch.ops import flash_attention as fa
    from vit_pytorch_tpu_torch.ops import short_attention as sa
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
    packed, _ = cs.navit_train_batch(dev)
    ids = packed.image_ids
    shape = (ids.shape[0], cs.HEADS, cs.NAVIT_SEQ, cs.DH)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    q, k = fa.rms_norm(q, 1.0), fa.rms_norm(k, 1.0)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    kw = dict(scale=1.0, q_segment_ids=ids, kv_segment_ids=ids)
    gq, gk = ((1 + 0.2 * torch.randn(cs.HEADS, 1, cs.DH, generator=gen, device=dev)).to(torch.bfloat16)
              for _ in range(2))
    out = {"tree": label}
    with torch.inference_mode():
        for rate in (0.0, cs.RATE):
            dkw = dict(dropout_rate=rate, seed=cs.DROP_SEED if rate else None)
            tag = "[dropout]" if rate else ""
            o, lse = fa.flash_fwd(q, k, v, **kw, **dkw)
            delta = (do.float() * o.float()).sum(-1)
            out[f"flash_fwd{tag}"] = cs.cuda_ms(lambda: fa.flash_fwd(q, k, v, **kw, **dkw), 30)
            out[f"flash_bwd_dq{tag}"] = cs.cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw, **dkw), 30)
            out[f"flash_bwd_dkv{tag}"] = cs.cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw, **dkw), 30)
            qk_tag = "[dropout,qknorm]" if rate else "[qknorm]"
            gkw = dict(gamma_q=gq, gamma_k=gk)
            out[f"flash_fwd{qk_tag}"] = cs.cuda_ms(lambda: fa.flash_fwd(q, k, v, **kw, **dkw, **gkw), 30)
            o, lse = fa.flash_fwd(q, k, v, **kw, **dkw, **gkw)
            delta = (do.float() * o.float()).sum(-1)
            out[f"flash_bwd_dq{qk_tag}"] = cs.cuda_ms(
                lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw, **dkw, **gkw), 30)
            out[f"flash_bwd_dkv{qk_tag}"] = cs.cuda_ms(
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw, **dkw, **gkw), 30)
        rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
        b, n = cs.B_SHORT, cs.SIMPLE_512_N
        q, k, v = (rn(b, cs.HEADS, n, cs.DH).to(torch.bfloat16) for _ in range(3))
        bias = rn(cs.HEADS, n, n)
        out["short_attention"] = cs.cuda_ms(lambda: sa.short_fwd(q, k, v, scale=cs.DH**-0.5), 20)
        out["short_attention[bias]"] = cs.cuda_ms(lambda: sa.short_fwd(q, k, v, scale=cs.DH**-0.5, bias=bias), 20)
        b, n = cs.B_CAUSAL_TIME, cs.N_CAUSAL_TIME
        q, k, v, do = (rn(b, cs.HEADS, n, cs.DH).to(torch.bfloat16) for _ in range(4))
        bias = rn(1, cs.HEADS, n, n)
        long = dict(scale=cs.DH**-0.5)
        for tag, fkw in (("", {}), ("[causal]", dict(causal=True)),
                         ("[dropout,causal]", dict(causal=True, dropout_rate=cs.RATE, seed=cs.DROP_SEED)),
                         ("[bias]", dict(bias=bias)), ("[bias,causal]", dict(bias=bias, causal=True))):
            out[f"flash_fwd{tag} 8x12x2048"] = cs.cuda_ms(lambda: fa.flash_fwd(q, k, v, **long, **fkw), 10)
        o, lse = fa.flash_fwd(q, k, v, **long)
        delta = (do.float() * o.float()).sum(-1)
        out["flash_bwd_dq 8x12x2048"] = cs.cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **long), 10)
        out["flash_bwd_dkv 8x12x2048"] = cs.cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **long), 10)
        for tag in cs.CAUSAL_TAGS:
            ckw = dict(causal=True, dropout_rate=cs.RATE if "dropout" in tag else 0.0,
                       seed=cs.DROP_SEED if "dropout" in tag else None)
            if "qknorm" in tag:
                ckw.update(gamma_q=gq, gamma_k=gk)
            o, lse = fa.flash_fwd(q, k, v, **long, **ckw)
            delta = (do.float() * o.float()).sum(-1)
            out[f"flash_bwd_dq{tag} 8x12x2048"] = cs.cuda_ms(
                lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **long, **ckw), 10)
            out[f"flash_bwd_dkv{tag} 8x12x2048"] = cs.cuda_ms(
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **long, **ckw), 10)
    print(json.dumps(out), flush=True)
    for line in cs.ptxas_report(lib.build_log):
        if "flash" in line or "short" in line:
            print(label, line)
