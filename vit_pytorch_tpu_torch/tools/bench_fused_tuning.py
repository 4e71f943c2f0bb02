"""The tuning prototype of ``tools/bench_fused_tuning.py`` on the port:
the attention block at several images a TPU grid step.

``make_fused`` (:40, call :66): LN -> qkv (no bias, one cast of the f32
dot) -> per-head softmax (``exp`` and a division) -> ``f32 x + f32 dot``,
one cast; no out bias.  On a CUDA tensor four launches of the port's
kernels (``_common.py``), on a CPU tensor the plain twin of the kernel's
lines.  ``imgs_per_step`` changes nothing here.

The tool's second experiment, ``tune_train`` (:106: Flax remat policies for
the ViT-B training step), has no Pallas kernel of its own and waits for a
later port (ROADMAP §1 item 11c); ``train`` on the command line says so.

    python -m vit_pytorch_tpu_torch.tools.bench_fused_tuning   # on a CUDA card
"""

from __future__ import annotations

import sys

import torch

from . import _common as c

# tune_kernel()'s sizes (the JAX tool's)
B, H, N, D = 128, 12, 197, 64
DIM = H * D
LAYERS = 12
INNER = 10


def make_fused(imgs_per_step):
    """``fn(x, w_qkv, w_out, lns, lnb)``: ``x + OutProj(Attention(LN(x) @
    Wqkv))``, one cast."""

    def fn(x, w_qkv, w_out, lns, lnb):
        if c.on_card(x):
            return c.attention_chain(x, w_qkv, w_out, lns, lnb)
        return c.attention_twin(x, w_qkv, w_out, lns, lnb)

    return fn


def tune_kernel(device=None):
    """The JAX tool's kernel sweep on the card: 12 blocks a call at 1, 2 and
    4 images a step.  Returns {imgs_per_step: ms a call}."""
    dev = c.card(device)
    c.print_card(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)
    x = rnd(B, N, DIM)
    w_qkv, w_out = rnd(3 * DIM, DIM, s=0.02), rnd(DIM, DIM, s=0.02)
    lns = torch.ones(DIM, dtype=torch.bfloat16, device=dev)
    lnb = torch.zeros(DIM, dtype=torch.bfloat16, device=dev)

    def stack(fn):
        def run(x, *rest):
            for _ in range(LAYERS):
                x = fn(x, *rest)
            return x

        return run

    results = {}
    with torch.inference_mode():
        for ips in (1, 2, 4):
            results[ips] = c.timeit(f"fused block {ips} img/step", stack(make_fused(ips)), x, w_qkv, w_out, lns, lnb,
                                    iters=INNER, layers=LAYERS, label="ms/layer-equiv")
    return results


if __name__ == "__main__":
    if "train" in sys.argv:
        raise SystemExit("tune_train (Flax remat policies for the training step) is not ported yet: "
                         "ROADMAP §1 item 11c")
    tune_kernel()
