"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. device: name, power limit, torch and CUDA versions (no card: exit 1);
  2. build: nvcc of vit_pytorch_tpu_torch/csrc into build/, with its seconds;
  3. kernels against their plain PyTorch twins, bf16, at ViT-B shapes
     (b=8, n=197, dim=768, heads=12, dh=64, mlp=3072; attention also at
     n=50, mostly padded keys), and the whole layer;
  4. serving: ViT-B/16 @224 from a seeded generator behind a Predictor with
     buckets (1, 8, 32, 128); requests of 1, 5, 32 and 130 images; launch
     counters; logits against the plain bf16 path and against fp32;
  5. timing at bs=128: model img/s, one layer, each kernel, kernel vs plain.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}.  Any failed check exits non-zero before it.

Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import torch

SEED = 0
B_CHECK, N, DIM, HEADS, DH, MLP, DEPTH = 8, 197, 768, 12, 64, 3072, 12
B_TIME = 128
BUCKETS = (1, 8, 32, 128)
REQUESTS = (1, 5, 32, 130)
LAUNCHES_PER_LAYER = {"layernorm_rows": 2, "gemm_bf16": 4, "attention_rows": 1}
ATTN_CHECK_N = (N, 50)  # 11 and 158 padded keys in the 208 the kernel holds
# Each kernel is held to its plain twin twice.  The twins round at the same
# points, so what differs is f32 summation order and exp2/rsqrt ulps, which
# can flip one bf16 rounding of an output element:
# - elementwise, |got - want| <= atol + rtol*|want|, a few ulps of the output.
#   LayerNorm and GEMM outputs reach |x| ~ 5 (ulp 2^-5); attention's stay
#   under ~1.3 (ulp 2^-7), so its bound is 2 ulps there and well under the
#   ~3% uniform shrink that letting the padded keys into the row sum makes;
# - relative L2 over the whole output: a flipped rounding moves one element
#   by one ulp, ~2^-8 of it, in a fraction of the elements, so a right kernel
#   reads ~1e-3; a systematic error of 0.5% or more fails it.
KERNEL_ATOL = KERNEL_RTOL = 2e-2
ATTN_ATOL = ATTN_RTOL = 8e-3
KERNEL_REL_L2 = 5e-3
# the whole layer chains 7 roundings; a flip in y (|y| up to ~8, ulp 2^-5)
# passes into the output unchanged when fc2's term cancels against it: 2 ulps
LAYER_ATOL, LAYER_RTOL = 6.25e-2, 2e-2
# relative L2 of ViT-B logits (12 layers, random weights)
LOGITS_VS_PLAIN_BF16 = 3e-2
LOGITS_VS_FP32 = 5e-2
TPU_KERNEL = "vit_pytorch_tpu/ops/fused_block.py:1053"
SOURCE = "vit_pytorch_tpu_torch/csrc/fused_layer.cu"


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters):
    """Mean device time of fn over iters chained calls (CUDA events)."""
    for _ in range(3):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, iters):
    """plain, kernel, kernel, plain on one card; the mean of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def compare(name, got, want, atol, rtol, max_rel_l2=KERNEL_REL_L2):
    d = (got.float() - want.float()).abs()
    max_abs = d.max().item()
    rel = max_abs / want.float().abs().max().item()
    l2 = rel_l2(got, want)
    ok = (bool(torch.isfinite(got).all()) and bool((d <= atol + rtol * want.float().abs()).all())
          and l2 <= max_rel_l2)
    log(f"  {name:30s} max_abs={max_abs:.4e} max_abs/max|want|={rel:.3e} bound |d|<={atol}+{rtol}|want|; "
        f"rel L2={l2:.3e} bound {max_rel_l2} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name} disagrees with its plain twin")
    return max_abs


def check_kernels(fb, rnd):
    """Phase 3: each kernel and the whole layer against its plain twin on the
    card; returns the largest max_abs of each kernel."""
    log(f"[3 kernels] b={B_CHECK} n={N} dim={DIM} heads={HEADS} dh={DH} mlp={MLP}, bf16")
    inner = HEADS * DH
    w = dict(
        w_qkv=rnd(3 * inner, DIM, scale=DIM**-0.5), w_out=rnd(DIM, inner, scale=inner**-0.5),
        ln1_scale=1 + rnd(DIM, scale=0.1), ln1_bias=rnd(DIM, scale=0.1),
        ln2_scale=1 + rnd(DIM, scale=0.1), ln2_bias=rnd(DIM, scale=0.1),
        w1=rnd(MLP, DIM, scale=DIM**-0.5), b1=rnd(MLP, scale=0.1),
        w2=rnd(DIM, MLP, scale=MLP**-0.5), b2=rnd(DIM, scale=0.1),
    )
    b_qkv, b_out = rnd(3 * inner, scale=0.1), rnd(DIM, scale=0.1)
    x = rnd(B_CHECK, N, DIM)
    errs = {}
    with torch.inference_mode():
        h = fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])
        errs["layernorm_rows"] = compare(
            "layernorm_rows", fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]), h, KERNEL_ATOL, KERNEL_RTOL)
        sync()
        m, a = rnd(B_CHECK, N, inner), rnd(B_CHECK, N, MLP)
        sites = (
            ("qkv", h, w["w_qkv"], None, None), ("qkv+bias", h, w["w_qkv"], b_qkv, None),
            ("out", m, w["w_out"], b_out, x), ("fc1", h, w["w1"], w["b1"], None),
            ("fc2", a, w["w2"], w["b2"], x),
        )
        gemm_errs = []
        for site, inp, weight, bias, res in sites:
            epi = site.split("+")[0]
            gemm_errs.append(compare(
                f"gemm_bf16[{site}]", fb.gemm_bf16(inp, weight, epi, bias=bias, residual=res),
                fb.gemm_bf16_reference(inp, weight, epi, bias=bias, residual=res), KERNEL_ATOL, KERNEL_RTOL))
        errs["gemm_bf16"] = max(gemm_errs)
        sync()
        attn_errs = []
        for n in ATTN_CHECK_N:
            qkv = (fb.gemm_bf16_reference(h, w["w_qkv"], "qkv", bias=b_qkv) if n == N
                   else rnd(B_CHECK, n, 3 * inner))
            akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
            attn_errs.append(compare(f"attention_rows[n={n}]", fb.attention_rows(qkv, **akw),
                                     fb.attention_rows_reference(qkv, **akw), ATTN_ATOL, ATTN_RTOL))
        errs["attention_rows"] = max(attn_errs)
        sync()
        lkw = dict(heads=HEADS, dim_head=DH, b_qkv=b_qkv, b_out=b_out)
        compare("fused_transformer_layer", fb.fused_transformer_layer(x, **w, **lkw),
                fb.layer_reference(x, **w, **lkw), LAYER_ATOL, LAYER_RTOL)
        sync()
    return errs


def main():
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a CUDA card")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    log(smi)
    # plain twins are held to f32 accumulation: no TF32, no reduced-precision
    # bf16 reductions in cuBLAS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # -- 2. build ----------------------------------------------------------
    from vit_pytorch_tpu_torch import ViT
    from vit_pytorch_tpu_torch.ops import fused_block as fb
    from vit_pytorch_tpu_torch.ops._build import load_library
    from vit_pytorch_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    lib = load_library()
    nvcc = "reused an existing build" if lib.build_seconds is None else f"nvcc {lib.build_seconds:.2f} s"
    log(f"[2 build] {lib.path.name}: {nvcc}, build+load {time.perf_counter() - t0:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # -- 3. kernels against their plain twins --------------------------------
    errs = check_kernels(fb, rnd)

    # -- 4. serving ----------------------------------------------------------
    log(f"[4 serving] ViT-B/16 @224, depth {DEPTH}, random weights (seed {SEED}), buckets {BUCKETS}, bf16")
    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS,
                mlp_dim=MLP, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).eval()
    t0 = time.perf_counter()
    pred = Predictor(model, example_shape=(3, 224, 224), batch_sizes=BUCKETS, device=dev).warmup()
    log(f"  warmup of {len(BUCKETS)} buckets: {time.perf_counter() - t0:.2f} s")
    for b in BUCKETS:
        if not fb.whole_layer_supported((b, N, DIM), bf16, HEADS, DH, DIM, MLP):
            fail(f"the kernel gate refuses the flagship at bucket {b}")
    images = {k: rnd(k, 3, 224, 224, dtype=torch.float32) for k in REQUESTS}
    runs = sum(-(-k // BUCKETS[-1]) for k in REQUESTS)  # chunks of the largest bucket
    fb.reset_launch_counts()
    outs = {k: pred(images[k]) for k in REQUESTS}
    sync()
    counts = dict(fb.LAUNCHES)
    for k, out in outs.items():
        if out.shape != (k, 1000) or not bool(torch.isfinite(out).all()):
            fail(f"request of {k} images: shape {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    want_counts = {name: DEPTH * per * runs for name, per in LAUNCHES_PER_LAYER.items()}
    log(f"  requests {REQUESTS} -> {runs} bucket runs; launches {counts} (expected {want_counts}, "
        f"{DEPTH} layers x 7 launches x {runs} runs = {DEPTH * 7 * runs})")
    if counts != want_counts:
        fail("the serving path did not launch every kernel of every layer")

    served = pred.model
    tr = served.transformer

    def plain_forward(img):
        """The same bf16 weights through the plain twins, layer by layer."""
        x = served.embed(img.to(bf16))
        for i in range(len(tr.layers)):
            ws, kws = tr.layer_weights(i, bf16)
            x = fb.layer_reference(x, *ws, heads=tr.heads, dim_head=tr.dim_head, **kws)
        return served.mlp_head(tr.norm(x)[:, 0])

    with torch.inference_mode():
        k = 32
        plain = plain_forward(images[k])
        fp32 = model(images[k])
    e_plain, e_fp32 = rel_l2(outs[k], plain), rel_l2(outs[k], fp32)
    log(f"  logits of the {k}-image request: rel L2 vs plain bf16 {e_plain:.4e} (bound {LOGITS_VS_PLAIN_BF16}), "
        f"vs fp32 {e_fp32:.4e} (bound {LOGITS_VS_FP32})")
    if not (e_plain <= LOGITS_VS_PLAIN_BF16 and e_fp32 <= LOGITS_VS_FP32):
        fail("served logits disagree with the plain path")
    sync()

    # -- 5. timing -----------------------------------------------------------
    log(f"[5 timing] bs={B_TIME}, {smi}")
    img = images[130][:B_TIME].to(bf16)
    with torch.inference_mode():
        def host_ms(fn, iters=10):
            fn()
            sync()
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            sync()
            return (time.perf_counter() - t) * 1e3 / iters

        run_kernel, run_plain = (lambda: served(img)), (lambda: plain_forward(img))
        p1, k1, k2, p2 = (host_ms(f) for f in (run_plain, run_kernel, run_kernel, run_plain))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"  model: kernel path {B_TIME * 1e3 / k_ms:.1f} img/s ({k_ms:.3f} ms/batch), "
            f"plain bf16 path {B_TIME * 1e3 / p_ms:.1f} img/s ({p_ms:.3f} ms/batch); turns ms "
            f"plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}")

        x = served.embed(img)
        ws, kws = tr.layer_weights(0, bf16)
        lkw = dict(heads=HEADS, dim_head=DH, **kws)
        lk, lp = in_turns(lambda: fb.fused_transformer_layer(x, *ws, **lkw),
                          lambda: fb.layer_reference(x, *ws, **lkw), 20)
        log(f"  one layer: kernels {lk:.4f} ms, plain {lp:.4f} ms")

        w_qkv, w_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 = ws
        h = fb.layernorm_rows(x, ln1s, ln1b)
        qkv = fb.gemm_bf16(h, w_qkv, "qkv")
        m = fb.attention_rows(qkv, heads=HEADS, dim_head=DH, scale=DH**-0.5)
        y = fb.gemm_bf16(m, w_out, "out", bias=kws["b_out"], residual=x)
        h2 = fb.layernorm_rows(y, ln2s, ln2b)
        a = fb.gemm_bf16(h2, w1, "fc1", bias=b1)
        launches = (  # (kernel, site, kernel call, plain call) in layer order
            ("layernorm_rows", "ln1", lambda: fb.layernorm_rows(x, ln1s, ln1b),
             lambda: fb.layernorm_rows_reference(x, ln1s, ln1b)),
            ("gemm_bf16", "qkv", lambda: fb.gemm_bf16(h, w_qkv, "qkv"),
             lambda: fb.gemm_bf16_reference(h, w_qkv, "qkv")),
            ("attention_rows", "attention", lambda: fb.attention_rows(qkv, heads=HEADS, dim_head=DH, scale=DH**-0.5),
             lambda: fb.attention_rows_reference(qkv, heads=HEADS, dim_head=DH, scale=DH**-0.5)),
            ("gemm_bf16", "out", lambda: fb.gemm_bf16(m, w_out, "out", bias=kws["b_out"], residual=x),
             lambda: fb.gemm_bf16_reference(m, w_out, "out", bias=kws["b_out"], residual=x)),
            ("layernorm_rows", "ln2", lambda: fb.layernorm_rows(y, ln2s, ln2b),
             lambda: fb.layernorm_rows_reference(y, ln2s, ln2b)),
            ("gemm_bf16", "fc1", lambda: fb.gemm_bf16(h2, w1, "fc1", bias=b1),
             lambda: fb.gemm_bf16_reference(h2, w1, "fc1", bias=b1)),
            ("gemm_bf16", "fc2", lambda: fb.gemm_bf16(a, w2, "fc2", bias=b2, residual=y),
             lambda: fb.gemm_bf16_reference(a, w2, "fc2", bias=b2, residual=y)),
        )
        per_kernel = {name: [0.0, 0.0] for name in LAUNCHES_PER_LAYER}
        for name, site, kern, plain in launches:
            km, pm = in_turns(kern, plain, 20)
            per_kernel[name][0] += km
            per_kernel[name][1] += pm
            log(f"  {name}[{site}]: kernel {km:.4f} ms, plain {pm:.4f} ms")
    sync()

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": TPU_KERNEL,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": per_kernel[name][0], "plain_ms": per_kernel[name][1]}
        for name in LAUNCHES_PER_LAYER
    ]
    log("  (ms, plain_ms: the kernel's launches in one layer at bs=128; launches: the serving requests)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
