"""Where the input pipeline's time goes on one CUDA card (H100, sm_90a):
ViT-B/16 @224 trained in bf16 at bs=32 and bs=256, fed by
``vit_pytorch_tpu_torch/utils/data.py``.

    python3 chip_feed_probe.py [steps]

For each batch size it prints the host's gather of ``steps`` shuffled
batches (``minibatches``), a fresh pinned buffer, the staging copy into a
fresh one and a stage / put / take cycle from the placer's pool, a pageable
and a pinned ``.to()``, and one training step from data already on the card
(when the host returns and when the card is done); then epochs of ``steps``
steps (default 3) fed by a direct ``.to()``, by ``prefetch_to_device(depth=2)``,
by it with ``host_workers=True`` and from data already on the card, 3 turns
of each, ms an epoch.  Prints the card's name and power limit first.  Needs a
card; exits 1 without one.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch


def ms(fn, n=1):
    """Mean ms of ``n`` calls of ``fn``, bracketed by synchronize(); and fn's last result."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n, out


def main(steps):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from vit_pytorch_tpu_torch.ops._build import load_library
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step
    from vit_pytorch_tpu_torch.utils.data import _CudaPlacer, minibatches, prefetch_to_device

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the probe needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    load_library()
    dev = torch.device("cuda", 0)
    for bs in (32, 256):
        rng = np.random.default_rng(1)
        data = {"x": rng.standard_normal((steps * bs, 3, 224, 224), dtype=np.float32),
                "y": rng.integers(0, 1000, steps * bs)}
        shuffled = lambda: minibatches(data, bs, rng=np.random.default_rng((1, 0)))  # noqa: E731
        t_gather, batches = ms(lambda: list(shuffled()))
        b = batches[0]
        placer = _CudaPlacer(dev)
        t_alloc, _ = ms(lambda: torch.empty(b["x"].shape, dtype=torch.float32, pin_memory=True), 5)
        t_stage, _ = ms(lambda: placer.stage(b), 5)

        def cycle():
            placed = placer.put(placer.stage(b))
            torch.cuda.synchronize()
            return placer.take(placed)

        cycle(), cycle()
        t_cycle, _ = ms(cycle, 5)
        t_pageable, _ = ms(lambda: torch.as_tensor(b["x"]).to(dev), 5)
        pinned = placer.stage(b)["x"]
        t_pinned, _ = ms(lambda: pinned.to(dev, non_blocking=True), 5)

        state = create_train_state(cs.infra_model(dev, cs.SEED))
        step = make_train_step(state.model)
        xd, yd = torch.as_tensor(b["x"]).to(dev), torch.as_tensor(b["y"]).to(dev)
        for _ in range(2):
            step(state, xd.to(torch.bfloat16), yd)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, xd.to(torch.bfloat16), yd)
        host = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        done = (time.perf_counter() - t) * 1e3
        t_step, _ = ms(lambda: step(state, xd.to(torch.bfloat16), yd), 3)
        print(f"bs={bs}: gather of {steps} batches {t_gather:.2f} ms; a fresh pinned buffer {t_alloc:.2f}; staging "
              f"into a fresh one {t_stage:.2f}; stage + put + take from the pool {t_cycle:.2f}; pageable .to "
              f"{t_pageable:.2f}; pinned .to {t_pinned:.2f}; a step from data on the card {t_step:.2f} (the host "
              f"returns after {host:.2f}, the card is done after {done:.2f})", flush=True)

        feeds = {
            "direct": lambda: ({k: torch.as_tensor(v).to(dev) for k, v in x.items()} for x in shuffled()),
            "prefetch": lambda: prefetch_to_device(shuffled(), depth=2, device=dev),
            "thread": lambda: prefetch_to_device(shuffled(), depth=2, host_workers=True, device=dev),
            "on the card": lambda: iter([{"x": xd, "y": yd}] * steps),
        }

        def epoch(feed):
            def run():
                for batch in feed():
                    step(state, batch["x"].to(torch.bfloat16), batch["y"])
            return ms(run)[0]

        for feed in feeds.values():
            epoch(feed)
        turns = {name: [] for name in feeds}
        for _ in range(3):
            for name, feed in feeds.items():
                turns[name].append(epoch(feed))
        print(f"bs={bs}, epochs of {steps} steps, ms (3 turns each): "
              + "; ".join(f"{name} {[round(v, 2) for v in vs]}" for name, vs in turns.items()), flush=True)
        del state, step, xd, yd, pinned, placer
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
