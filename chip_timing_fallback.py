"""Holds chip_smoke.py's two device timers against each other on the card.

``chip_smoke.device_ms`` sums the device time of a call's kernels under
``torch.profiler``; ``chip_smoke.queued_event_ms`` reads CUDA events around
calls queued behind a spin kernel.  This script times three library calls at ViViT's spatial chain shape
(128 x 65 rows, dim 1024, 8 heads of 64) with both and prints their ratio.

    python3 chip_timing_fallback.py
"""
import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs


def main():
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this script needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    x = torch.randn(128 * 65, 1024, device=dev, dtype=bf16, generator=g)
    w = torch.randn(1536, 1024, device=dev, dtype=bf16, generator=g)
    s, b = torch.ones(1024, device=dev, dtype=bf16), torch.zeros(1024, device=dev, dtype=bf16)
    q, k, v = (torch.randn(128, 8, 65, 64, device=dev, dtype=bf16, generator=g).requires_grad_() for _ in range(3))
    go = torch.randn(128, 8, 65, 64, device=dev, dtype=bf16, generator=g)
    cases = {
        "layer_norm": lambda: F.layer_norm(x, (1024,), s, b, 1e-6),
        "linear": lambda: F.linear(x, w),
        "sdpa fwd+bwd": lambda: torch.autograd.grad(F.scaled_dot_product_attention(q, k, v), (q, k, v), go),
    }
    for name, fn in cases.items():
        prof = cs.device_ms(fn)
        ev = cs.queued_event_ms(fn)
        print(f"{name}: profiler {prof:.4f} ms, queued events {ev:.4f} ms, ratio {ev / prof:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
