"""Times the flash kernels of one checkout at NaViT-B's packed training shape
on one CUDA card (H100, sm_90a), for comparing two commits in one call.

    python3 chip_flash_ab.py <checkout> <label>

Builds ``<checkout>``'s kernels into its own ``build/`` and imports its
``chip_smoke.py`` and package (not this file's), then times flash_fwd,
flash_bwd_dq and flash_bwd_dkv, rate 0 and [dropout] at 0.1, on phase 14's
16 packs of 2048 tokens with their segment ids (12 heads, q and k through
rms_norm, scale 1): CUDA events over 30 chained launches after 3 warm-up
ones.  Prints one JSON line {"tree": label, kernel: ms, ...} and, after a
fresh build, the ptxas line of each flash kernel.  Run two checkouts in
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
    print(json.dumps(out), flush=True)
    for line in cs.ptxas_report(lib.build_log):
        if "flash" in line:
            print(label, line)
