"""Where the device time of one ViT-B/16 serving batch goes, for one
checkout, on one CUDA card (H100, sm_90a).

    python3 chip_profile.py <checkout> <label>

Builds ``<checkout>``'s kernels into its own ``build/`` and imports its
``chip_smoke.py`` and package (not this file's), builds phase 5's model
(ViT-B/16 @224, depth 12, random weights from the seed, cast to bf16 by the
Predictor, eval) and serves one batch of 128 images three times to warm
up, five times timed on the host clock, then five times under
``torch.profiler`` (CPU and CUDA activities).  Prints the device time of
each kernel name summed over the five batches, its share of the device
total, its launches a batch, and the share of the profiled window (the first
kernel's start to the last one's end) the device was busy (the union of the
kernels' intervals), then one JSON line
{"tree": label, "batch_ms": ..., "device_busy": ..., "kernels": {name:
share}}.  Run two checkouts in one call to compare them.
"""

import json
import os
import sys
import time

if __name__ == "__main__":
    tree, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from vit_pytorch_tpu_torch import ViT
    from vit_pytorch_tpu_torch.ops._build import load_library
    from vit_pytorch_tpu_torch.serving import Predictor

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the profile needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    lib = load_library()
    if not str(lib.path).startswith(os.path.abspath(tree)):
        print(f"FAIL: the kernels came from {lib.path}, not from {tree}", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    batches = 5
    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=cs.DIM, depth=cs.DEPTH, heads=cs.HEADS,
                mlp_dim=cs.MLP, device=dev, generator=torch.Generator(device=dev).manual_seed(cs.SEED)).eval()
    model = Predictor(model, example_shape=(3, 224, 224), batch_sizes=(cs.B_TIME,), device=dev).model  # bf16
    img = torch.randn(cs.B_TIME, 3, 224, 224, generator=torch.Generator(device=dev).manual_seed(cs.SEED + 1),
                      device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        for _ in range(3):
            model(img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            model(img)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3  # unprofiled
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(batches):
                model(img)
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        print("FAIL: the profiler saw no device time", file=sys.stderr)
        sys.exit(1)
    by_name, spans = {}, []
    for e in events:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.elapsed_us()
        t[1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    window = max(b for _, b in spans) - spans[0][0]  # the first kernel's start to the last one's end, in us
    busy, end = 0.0, None
    for a, b in spans:  # the union of the kernels' intervals, in us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    total = sum(t for t, _ in by_name.values())
    print(f"[{label}] {cs.B_TIME} images a batch: {wall_ms / batches:.3f} ms a batch unprofiled "
          f"({cs.B_TIME * batches * 1e3 / wall_ms:.1f} img/s); profiled, device kernel time "
          f"{total / 1e3 / batches:.3f} ms a batch, device busy {busy / window:.4f} of the window from the first "
          f"kernel's start to the last one's end ({window / 1e3 / batches:.3f} ms a batch)")
    shares = {}
    for name, (t, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        shares[name[:80]] = t / total
        print(f"  {t / total:7.4f}  {t / 1e3 / batches:8.4f} ms a batch  {count // batches:4d} a batch  {name[:110]}")
    print(json.dumps({"tree": label, "batch_ms": wall_ms / batches, "device_busy": busy / window,
                      "kernels": shares}), flush=True)
