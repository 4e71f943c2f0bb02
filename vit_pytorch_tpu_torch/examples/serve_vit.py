"""Serving example: bucket-batched ViT-B/16 inference on one card, the port
of ``examples/serve_vit.py``.

The serving path of ``serving.Predictor``: every batch-size bucket runs once
at construction (ahead of traffic), the parameters live in bf16, a request
is padded up to the smallest bucket that fits and chunked by the largest.
On the card each layer of a bucket run is the whole-layer chain of
``ops/fused_block.py`` (7 launches a layer: 84 a run at depth 12).  Prints
the buckets, the largest bucket's FLOPs and per-request latency
percentiles (host clock around the call and a ``torch.cuda.synchronize()``).

    python -m vit_pytorch_tpu_torch.examples.serve_vit [--device cuda]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.vit import ViT
from ..serving import Predictor
from ..utils.helpers import pair
from ._common import ms_since, parse, parser

# the JAX script's model (examples/serve_vit.py:33-41)
CONFIG = dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=12, mlp_dim=3072)
BUCKETS = (1, 8, 32, 128)  # :29
REQUESTS = (1, 5, 8, 32, 100, 128)  # :56
RUNS = 10  # timed calls a request size, :61
OVERSIZE = 300  # :72, chunked 128 + 128 + 44 -> 128


def request(k: int, shape, device, seed: int) -> torch.Tensor:
    """k images of ``shape``, bf16 normal, from a generator seeded ``seed``
    (the JAX script's ``PRNGKey(k)``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((k, *shape), generator=gen, device=device).to(torch.bfloat16)


def main(argv=None):
    """Returns ``{"predictor", "gflop", "latency_ms": {k: [ms, ...]},
    "outputs": {k: (images, logits)}}`` (the last timed call of k = 5 and
    the oversize request)."""
    _, cfg, device = parse(parser(__doc__.splitlines()[0]), argv, CONFIG)
    model = ViT(**cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    shape = (cfg.get("channels", 3), *pair(cfg["image_size"]))

    t0 = time.perf_counter()
    p = Predictor(model, example_shape=shape, batch_sizes=BUCKETS, device=device)
    print(f"ran buckets {p.compiled_buckets} in {time.perf_counter() - t0:.1f}s (ahead of traffic: no request "
          f"pays a first run)")
    gflop = p.cost_analysis(BUCKETS[-1])["flops"] / 1e9
    print(f"largest bucket: {gflop:.1f} GFLOP a run\n")

    print(f"{'k':>4} {'bucket':>6} {'p50 ms':>8} {'p95 ms':>8}")
    latency, outputs = {}, {}
    for k in REQUESTS:
        x = request(k, shape, device, k)
        p(x)  # warm
        times = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            out = p(x)
            times.append(ms_since(t0, device))
        latency[k] = times
        if k == 5:
            outputs[k] = (x, out)
        print(f"{k:>4} {p._bucket_for(k):>6} {np.percentile(times, 50):>8.1f} {np.percentile(times, 95):>8.1f}")

    # oversize request: chunked by the largest bucket
    x = request(OVERSIZE, shape, device, 7)
    t0 = time.perf_counter()
    out = p(x)
    dt = ms_since(t0, device)
    outputs[OVERSIZE] = (x, out)
    print(f"\nk={OVERSIZE} (chunks of 128+128+44→128): {dt:.0f} ms end-to-end, {OVERSIZE / dt * 1e3:.0f} img/s, "
          f"out {tuple(out.shape)}")
    return {"predictor": p, "gflop": gflop, "latency_ms": latency, "oversize_ms": dt, "outputs": outputs}


if __name__ == "__main__":
    main()
