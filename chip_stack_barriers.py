"""Times the grid barriers of the multi-layer kernel stack_layers alone, on
one CUDA card (H100, sm_90a).

    python3 chip_stack_barriers.py

Builds a probe library under ``build/probe/`` from this checkout's
``csrc/stack_layers.cu`` (included whole, so the probe runs its grid_sync)
and times, with CUDA events over 50 chained launches after 3 warm-up ones:

  - the stack's launch with empty steps: the grid stack_layers launches (its
    block of 384 threads, its shared memory, one block an SM, cooperative),
    running only the 7g - 1 grid barriers of g = 6 layers (41), and the same
    launch with none (launch and set-up alone);
  - one stack_layers launch of 6 ViT-B layers at bs=128 and at bs=1 (phase
    33's operands), the launch the barriers belong to.

The barriers do not depend on the batch (each block arrives once a step
whatever its work), so the empty-step launch is the same kernel at bs=128
and bs=1; what the batch changes is how far apart the blocks arrive.
Prints the card, the times and one JSON line {"barriers_ms": ..., ...}.
"""

import ctypes
import json
import os
import subprocess
import sys

PROBE_SOURCE = r"""
#include "stack_layers.cu"

// the weight maps' cache lives in gemm_bf16.cu, which the probe does not
// link: stack_layers' entry point is never called here
bool gemm_weight_map(CUtensorMap&, const void*, int, int) { return false; }

namespace {
__global__ void __launch_bounds__(kWsThreads, 1) barriers_kernel(unsigned* bar, int count) {
  unsigned arrivals = 0;
  for (int i = 0; i < count; ++i) grid_sync(bar, arrivals);
}
}  // namespace

extern "C" int probe_barriers(void* bar, int count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(barriers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStackSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, barriers_kernel, kWsThreads, kStackSmem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), s)) != cudaSuccess) return err;
  unsigned* b = static_cast<unsigned*>(bar);
  void* args[] = {&b, &count};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barriers_kernel), dim3(sms * per_sm),
                                    dim3(kWsThreads), args, kStackSmem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
"""

GROUP = 6
BARRIERS = 7 * GROUP - 1


def build_probe(build_dir, csrc, nvcc):
    os.makedirs(build_dir, exist_ok=True)
    src, lib = os.path.join(build_dir, "barrier_probe.cu"), os.path.join(build_dir, "barrier_probe.so")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
                    "-fPIC", "-I", str(csrc), "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    so.probe_barriers.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    so.probe_barriers.restype = ctypes.c_int
    return so


if __name__ == "__main__":
    import torch

    import chip_smoke as cs
    from vit_pytorch_tpu_torch.ops import _build
    from vit_pytorch_tpu_torch.ops import fused_block as fb

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the timing needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    probe = build_probe(os.path.join(str(_build.build_dir()), "probe"), _build.CSRC_DIR, _build._nvcc())
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(count):
        err = probe.probe_barriers(bar.data_ptr(), count, stream)
        if err:
            raise RuntimeError(f"probe_barriers({count}): CUDA error {err}")

    out = {"card": smi}
    empty, barriers = cs.cuda_ms(lambda: launch(0), 50), cs.cuda_ms(lambda: launch(BARRIERS), 50)
    out["launch_no_barrier_ms"], out[f"launch_{BARRIERS}_barriers_ms"] = empty, barriers
    out["barriers_ms"] = barriers - empty
    out["ms_a_barrier"] = (barriers - empty) / BARRIERS
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    layers = cs.stack_tuples(rnd, GROUP, False, True)
    skw = dict(heads=cs.HEADS, dim_head=cs.DH, scale=cs.DH**-0.5)
    with torch.inference_mode():
        for b in (cs.B_TIME, 1):
            x = rnd(b, cs.N, cs.DIM)
            ms = cs.cuda_ms(lambda: fb.stack_layers(x, layers, **skw), 30)
            out[f"stack_layers g={GROUP} bs={b} ms"] = ms
            out[f"barriers share of the launch at bs={b}"] = out["barriers_ms"] / ms
    print(f"the launch with empty steps: {empty:.4f} ms with no barrier, {barriers:.4f} ms with {BARRIERS}: "
          f"{out['barriers_ms']:.4f} ms of barriers, {out['ms_a_barrier'] * 1e3:.2f} us each")
    for b in (cs.B_TIME, 1):
        print(f"stack_layers g={GROUP} bs={b}: {out[f'stack_layers g={GROUP} bs={b} ms']:.4f} ms; the barriers "
              f"{100 * out[f'barriers share of the launch at bs={b}']:.1f}% of it")
    print(json.dumps(out))
