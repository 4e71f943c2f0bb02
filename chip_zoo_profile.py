"""Where the device time of a ViViT and an MAE training step goes, on one
CUDA card (H100, sm_90a).

    python3 chip_zoo_profile.py

Builds the port's kernels, builds ``chip_smoke.py``'s ViViT (phase 37:
tools/bench_zoo.py:232-234, bs=16, dropout 0) and MAE (phase 38:
tools/bench_zoo.py:250-253, bs=256) in bf16 from the seed, runs 3 warm-up
steps of each (make_train_step's Adam for ViViT, AdamW(1e-4) for MAE), 3
timed on the host clock, then 3 under ``torch.profiler`` (CPU and CUDA
activities).  For each model prints the device time of each kernel group
(the port's kernels by name, cuBLAS / CUTLASS GEMMs, the rest) and of the
top kernels, their shares of the device total, and the share of the
profiled window (the first kernel's start to the last one's end) the device
was busy, then one JSON line {"model": ..., "step_ms": ..., "device_busy":
..., "groups": {group: share}}.
"""

import json
import re
import sys
import time

PORT_KERNELS = ("layernorm_rows", "gemm_bf16", "attention_rows", "attention_bwd", "layernorm_bwd", "gemm_wgrad",
                "stack_layers", "dropout", "flash_", "short_attention")
STEPS = 3


def group(name):
    """The kernel group of a device event's name."""
    for k in PORT_KERNELS:
        if k in name:
            return f"port: {k}"
    if re.search(r"gemm|xmma|cutlass|nvjet|cublas|sm90_", name, re.I):
        return "cuBLAS / CUTLASS GEMM"
    if re.search(r"elementwise|vectorized|unrolled", name, re.I):
        return "elementwise"
    if re.search(r"reduce|norm", name, re.I):
        return "reductions and norms"
    return "other"


def profile_steps(label, step):
    import torch

    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.events()  # kernels and copies; not the optimizer's annotation ranges
              if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    if not events:
        print(f"FAIL: the profiler saw no device time for {label}", file=sys.stderr)
        sys.exit(1)
    by_name, by_group, spans = {}, {}, []
    for e in events:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        by_group[group(e.name)] = by_group.get(group(e.name), 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    busy, window = cs.busy_share(spans)
    total = sum(by_name.values())
    print(f"[{label}] {step_ms:.3f} ms a step unprofiled; profiled, device kernel time {total / 1e3 / STEPS:.3f} ms "
          f"a step, device busy {busy:.4f} of the window ({window / 1e3 / STEPS:.3f} ms a step)")
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  group {t / total:7.4f}  {t / 1e3 / STEPS:8.4f} ms a step  {g}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {t / total:7.4f}  {t / 1e3 / STEPS:8.4f} ms a step  {name[:110]}")
    print(json.dumps({"model": label, "step_ms": step_ms, "device_busy": busy,
                      "groups": {g: t / total for g, t in by_group.items()}}), flush=True)


def main():
    import torch

    import chip_smoke as cs
    from vit_pytorch_tpu_torch.ops._build import load_library
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the profile needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    load_library()
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 41)
    vivit = cs.vivit_model(dev, bf16)
    videos = torch.randn(cs.VIVIT_BS, *cs.VIVIT_SHAPE, generator=gen, device=dev).to(bf16)
    labels = torch.randint(0, 1000, (cs.VIVIT_BS,), generator=gen, device=dev)
    state, step = create_train_state(vivit), make_train_step(vivit)
    profile_steps(f"ViViT training bs={cs.VIVIT_BS}", lambda: step(state, videos, labels))
    del vivit, state, step, videos

    mae = cs.mae_model(dev, bf16)
    size = cs.MAE_ENCODER["image_size"]
    img = torch.randn(cs.MAE_BS, 3, size, size, generator=gen, device=dev).to(bf16)
    opt = torch.optim.AdamW(mae.parameters(), lr=cs.MAE_LR, weight_decay=1e-4)

    def mae_step():
        opt.zero_grad(set_to_none=True)
        mae(img, generator=gen).backward()
        opt.step()

    profile_steps(f"MAE pretraining bs={cs.MAE_BS}", mae_step)


if __name__ == "__main__":
    main()
