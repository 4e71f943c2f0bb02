"""Where the time of the flash backward kernels goes, for one checkout, on
one CUDA card (H100, sm_90a).

    python3 chip_flash_bwd_profile.py <checkout> <label>

Builds ``<checkout>``'s kernels into its own ``build/`` and imports its
``chip_smoke.py`` and package (not this file's), then prints:

  1. ``torch.profiler`` device time a launch of flash_bwd_dq and
     flash_bwd_dkv, each instantiation (rate 0, [dropout] at 0.1, [qknorm],
     [dropout,qknorm]) at NaViT-B's packed training shape (phase 14's 16
     packs of 2048 tokens with their ids, 12 heads, q and k through
     rms_norm, scale 1), and the rate-0 pair without ids at 8 x 12 x 2048,
     with and without the causal mask;
  2. the tile admission alone, at the packed shape, as two probe kernels
     built here from this file's own source: the serial walk (one block of
     128 threads a 64-row tile, testing the other side's tiles one after
     another, each a warp's read of 64 ids and a shuffle reduction, as
     flash_attention.cu's next_admitted did up to 19594ab) and the
     block-parallel admission (one warp a 128-row block, 32 candidate tiles
     a chunk, each tile's 64 ids read in two coalesced loads a lane and
     reduced by redux.sync, as the redesigned kernels' admit_chunk), each
     timed with CUDA events and each checked to admit the same tiles as
     ``tile_admitted``;
  3. one NaViT-B training step (phase 15's; at dropout 0 and 0.1) under
     ``torch.profiler``: its host ms, the device busy share of the window
     from its first kernel's start to its last one's end, and the share of
     the device time in flash_bwd_dq, flash_bwd_dkv and flash_fwd;
  4. after a fresh build, the ptxas line of each flash kernel.

Then one JSON line {"tree": label, ...} with the numbers above.  Run two
checkouts in turns in one call to compare them; to profile a parent commit,
unpack it with ``git archive`` into a git-ignored directory.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

# the two admission probes: counts[block] = tiles the block admits
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
namespace {
constexpr int kBig = 1 << 30;
__device__ __forceinline__ int seg_id(const int* seg, int r, int len) { return r < len ? seg[r] : -1; }
// the walk of flash_attention.cu up to 19594ab: seg_range + next_admitted
__device__ __forceinline__ void seg_range(const int* seg, int r0, int len, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  const int a = seg_id(seg, r0 + lane, len), c = seg_id(seg, r0 + 32 + lane, len);
  hi = max(a, c);
  lo = min(a >= 0 ? a : kBig, c >= 0 ? c : kBig);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  }
}
__device__ __forceinline__ bool overlap(int qlo, int qhi, int klo, int khi) {
  return qhi >= 0 && khi >= 0 && qlo <= khi && klo <= qhi;
}
__device__ __forceinline__ int next_admitted(const int* seg, int len, int tiles, int j, int lo, int hi) {
  for (; j < tiles; ++j) {
    int l, h;
    seg_range(seg, j * 64, len, l, h);
    if (overlap(lo, hi, l, h)) break;
  }
  return j;
}
__global__ void serial_walk(const int* ids, int n, int* counts) {
  const int* seg = ids + blockIdx.y * n;
  const int tiles = (n + 63) / 64;
  int lo, hi;
  seg_range(seg, blockIdx.x * 64, n, lo, hi);
  int c = 0;
  for (int j = next_admitted(seg, n, tiles, 0, lo, hi); j < tiles; j = next_admitted(seg, n, tiles, j + 1, lo, hi))
    ++c;
  if (threadIdx.x == 0) counts[blockIdx.y * gridDim.x + blockIdx.x] = c;
}
// one warp a 128-row block (flash_attention.cu's admit_chunk): its range,
// then each candidate tile's 64 ids read by the warp at once (two
// coalesced loads a lane) and reduced by redux.sync, 32 tiles a chunk
__global__ void chunk_admit(const int* ids, int n, int* counts) {
  const int* seg = ids + blockIdx.y * n;
  const int tiles = (n + 63) / 64, lane = threadIdx.x, r0 = blockIdx.x * 128;
  int lo = kBig, hi = -1;
  for (int i = 0; i < 4; ++i) {
    const int v = seg_id(seg, r0 + 32 * i + lane, n);
    hi = max(hi, v);
    lo = min(lo, v >= 0 ? v : kBig);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  int c = 0;
  for (int j0 = 0; j0 < tiles; j0 += 32) {
    unsigned mask = 0u;
#pragma unroll 8
    for (int jj = 0; jj < 32; ++jj) {
      const int j = j0 + jj;
      const int a = seg_id(seg, j * 64 + lane, n), b = seg_id(seg, j * 64 + 32 + lane, n);
      const int thi = __reduce_max_sync(0xffffffffu, max(a, b));
      const int tlo = __reduce_min_sync(0xffffffffu, min(a >= 0 ? a : kBig, b >= 0 ? b : kBig));
      if (j < tiles && overlap(lo, hi, tlo, thi)) mask |= 1u << jj;
    }
    c += __popc(mask);
  }
  if (lane == 0) counts[blockIdx.y * gridDim.x + blockIdx.x] = c;
}
}  // namespace
extern "C" int probe_serial(const int* ids, int b, int n, int* counts, void* stream) {
  serial_walk<<<dim3((n + 63) / 64, b), 128, 0, static_cast<cudaStream_t>(stream)>>>(ids, n, counts);
  return cudaGetLastError();
}
extern "C" int probe_chunk(const int* ids, int b, int n, int* counts, void* stream) {
  chunk_admit<<<dim3((n + 127) / 128, b), 32, 0, static_cast<cudaStream_t>(stream)>>>(ids, n, counts);
  return cudaGetLastError();
}
"""


def build_probe(build_dir, nvcc):
    os.makedirs(build_dir, exist_ok=True)
    src, lib = os.path.join(build_dir, "admission_probe.cu"), os.path.join(build_dir, "admission_probe.so")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    for fn in (so.probe_serial, so.probe_chunk):
        fn.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    return so


def profiled_ms(torch, fn, iters, match):
    """Mean device us a launch of the kernels whose name contains ``match``,
    over ``iters`` calls of fn under torch.profiler (after 3 warm-up calls)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
    return sum(times) / len(times) / 1e3 if times else None


def step_profile(torch, step, steps=2):
    """(host ms a step, device busy share, {kernel group: share of device time})
    of ``steps`` training steps under torch.profiler, after one warm-up step."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    window = max(b for _, b in spans) - spans[0][0]
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    total = sum(e.time_range.elapsed_us() for e in events)
    groups = {}
    for e in events:
        key = next((k for k in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd") if k in e.name), "other")
        groups[key] = groups.get(key, 0.0) + e.time_range.elapsed_us()
    return host, busy / window, total / 1e3 / steps, {k: v / total for k, v in groups.items()}


if __name__ == "__main__":
    tree, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from vit_pytorch_tpu_torch.ops import _build
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the profile needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    lib = _build.load_library()
    if not str(lib.path).startswith(os.path.abspath(tree)):
        print(f"FAIL: the kernels came from {lib.path}, not from {tree}", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{label}] {smi}", flush=True)
    out = {"tree": label}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    packed, labels = cs.navit_train_batch(dev)
    ids = packed.image_ids
    shape = (ids.shape[0], cs.HEADS, cs.NAVIT_SEQ, cs.DH)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    q, k = fa.rms_norm(q, 1.0), fa.rms_norm(k, 1.0)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    gq, gk = ((1 + 0.2 * torch.randn(cs.HEADS, 1, cs.DH, generator=gen, device=dev)).to(torch.bfloat16)
              for _ in range(2))
    kw = dict(scale=1.0, q_segment_ids=ids, kv_segment_ids=ids)
    with torch.inference_mode():
        # 1. each instantiation a launch, device time from the profiler
        for rate, gammas in ((0.0, False), (cs.RATE, False), (0.0, True), (cs.RATE, True)):
            dkw = dict(dropout_rate=rate, seed=cs.DROP_SEED if rate else None)
            gkw = dict(gamma_q=gq, gamma_k=gk) if gammas else {}
            tag = ",".join(t for t, on in (("dropout", rate), ("qknorm", gammas)) if on)
            tag = f"[{tag}]" if tag else ""
            o, lse = fa.flash_fwd(q, k, v, **kw, **dkw, **gkw)
            delta = (do.float() * o.float()).sum(-1)
            for name, fn in (("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw, **dkw, **gkw)),
                             ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw, **dkw, **gkw))):
                out[f"{name}{tag}"] = profiled_ms(torch, fn, 10, name)
                out[f"{name}{tag} events"] = cs.cuda_ms(fn, 30)
        rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
        b, n = cs.B_CAUSAL_TIME, cs.N_CAUSAL_TIME
        dq_, dk_, dv_, ddo = (rn(b, cs.HEADS, n, cs.DH) for _ in range(4))
        for causal in (False, True):
            lkw = dict(scale=cs.DH**-0.5, causal=causal)
            o, lse = fa.flash_fwd(dq_, dk_, dv_, **lkw)
            delta = (ddo.float() * o.float()).sum(-1)
            tag = "[causal]" if causal else ""
            for name, fn in (("flash_bwd_dq", lambda: fa.flash_bwd_dq(dq_, dk_, dv_, ddo, lse, delta, **lkw)),
                             ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(dq_, dk_, dv_, ddo, lse, delta, **lkw))):
                out[f"{name}{tag} {b}x{cs.HEADS}x{n}"] = profiled_ms(torch, fn, 10, name)
        del dq_, dk_, dv_, ddo

        # 2. the admission alone, one (b, n) id array a (pack, head): the
        # ids repeated for each head, as the kernels' grid reads them
        probe = build_probe(os.path.join(os.path.abspath(tree), "build", "probe"), _build._nvcc())
        rows = ids.repeat_interleave(cs.HEADS, 0).contiguous()
        bh, n = rows.shape
        stream = torch.cuda.current_stream(dev).cuda_stream
        serial = torch.empty(bh * ((n + 63) // 64), dtype=torch.int32, device=dev)
        chunk = torch.empty(bh * ((n + 127) // 128), dtype=torch.int32, device=dev)
        run_serial = lambda: probe.probe_serial(rows.data_ptr(), bh, n, serial.data_ptr(), stream)
        run_chunk = lambda: probe.probe_chunk(rows.data_ptr(), bh, n, chunk.data_ptr(), stream)
        out["admission serial walk ms"] = cs.cuda_ms(run_serial, 30)
        out["admission block-parallel ms"] = cs.cuda_ms(run_chunk, 30)
        tiles = fa.tile_admitted(ids, ids)  # (b, 32, 32): a 64-row tile's admitted tiles
        want_serial = int(tiles.sum()) * cs.HEADS
        per_block = fa.tile_admitted(ids, ids, block_q=128)  # a 128-row block's range
        want_chunk = int(per_block.sum()) * cs.HEADS
        out["admission tiles serial/want"] = [int(serial.sum()), want_serial]
        out["admission tiles block-parallel/want"] = [int(chunk.sum()), want_chunk]
        print(f"  admission alone at {bh} (pack, head) rows of {n} ids: serial walk {out['admission serial walk ms']:.4f}"
              f" ms ({int(serial.sum())} tiles admitted, tile_admitted {want_serial}), block-parallel "
              f"{out['admission block-parallel ms']:.4f} ms ({int(chunk.sum())}, {want_chunk})", flush=True)

    # 3. one NaViT-B training step, profiled
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    for rate in (0.0, cs.RATE):
        extra = dict(dropout=rate, emb_dropout=rate) if rate else {}
        model = cs.navit_model(dev, torch.bfloat16, token_dropout_prob=cs.NAVIT_TOKEN_DROPOUT, **extra)
        state, step = create_train_state(model), make_train_step(model, cs.masked_ce)
        drop_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
        run = (lambda: step(state, packed, labels, drop_gen)) if rate else (lambda: step(state, packed, labels))
        host, busy, device_ms, shares = step_profile(torch, run)
        out[f"navit train {rate}"] = {"host_ms": host, "device_busy": busy, "device_ms": device_ms, "shares": shares}
        print(f"  NaViT-B training step at dropout {rate}: {host:.3f} ms a step on the host clock; profiled, device "
              f"time {device_ms:.3f} ms a step, busy {busy:.4f} of the window; shares "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(shares.items())), flush=True)
        del model, state, step
    for key, val in out.items():
        if isinstance(val, float):
            print(f"  {key}: {val:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    for line in cs.ptxas_report(lib.build_log):
        if "flash" in line:
            print(label, line)
