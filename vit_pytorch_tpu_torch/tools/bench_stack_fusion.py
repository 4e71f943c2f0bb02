"""The stack prototype of ``tools/bench_stack_fusion.py`` on the port:
``n_layers`` whole layers in one call, against one call a layer.

The JAX kernel ``make_stack`` (:105, call :129) runs the layer body
``_layer_rows`` (:72-102) ``n_layers`` times: the layer of
``bench_layer_fused.py`` (no qkv or out bias; ``att + x``, ``dot + b1`` and
``dot + b2 + y`` added in f32 before one cast) with the softmax
``_softmax_from_dots`` (exp2 of the logits times scale * log2(e), one
reciprocal of the row sum).

On a CUDA tensor :func:`make_stack` returns one launch of the port's
``stack_layers`` with the prototype's epilogues (``stack_layers[tools]``,
``csrc/stack_layers.cu``), bitwise the seven-launch chain of each layer;
on a CPU tensor the plain twin, one layer after another.  ``IPS``, the TPU
kernel's images a grid step, changes nothing here; the shapes come from the
tensors.

    python -m vit_pytorch_tpu_torch.tools.bench_stack_fusion   # on a CUDA card
"""

from __future__ import annotations

import torch

from ..ops import fused_block as fb
from . import _common as c

# main()'s sizes (the JAX tool's)
B, H, N, D = 128, 12, 197, 64
DIM = H * D
MLP = 4 * DIM
IPS = 2
INNER_ITERS = 48  # divisible by 2/3/4/6 layer groupings
MAX_LAYERS = 6


def _layers(weights, n_layers):
    """The tool's flat weights, 10 a layer (wqkv, wout, ln1s, ln1b, ln2s,
    ln2b, w1, b1, w2, b2), as the port's stack tuples (no b_qkv, b_out)."""
    if len(weights) != 10 * n_layers:
        raise ValueError(f"make_stack({n_layers}): {len(weights)} weights, expected {10 * n_layers}")
    per = [weights[10 * i: 10 * (i + 1)] for i in range(n_layers)]
    return [(w[0], None, w[1], None, *w[2:]) for w in per]


def make_stack(n_layers):
    """``fn(x, *weights)``: ``n_layers`` layers back to back, ``weights``
    the 10 of each layer in order."""

    def fn(x, *weights):
        layers = _layers(weights, n_layers)
        if c.on_card(x):
            return fb.stack_layers(x, layers, heads=c.heads_of(layers[0][2]), dim_head=c.D, scale=c.D**-0.5,
                                   eps=c.EPS, epilogues="tools")
        for w_qkv, _, w_out, _, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 in layers:
            x = c.layer_twin(x, w_qkv, w_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, exp2=True)
        return x

    return fn


def layer_weights(gen, dev, *, dim=DIM, mlp=MLP):
    """One layer's weights as main() draws them (the JAX tool's, :146-158):
    matrices ~ 0.02 N(0, 1) in the (out, in) layout, LayerNorms at one and
    zero, zero biases, bf16."""
    rnd = lambda *shape: (torch.randn(*shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    ones = lambda d: torch.ones(d, dtype=torch.bfloat16, device=dev)
    zeros = lambda d: torch.zeros(d, dtype=torch.bfloat16, device=dev)
    return (rnd(3 * dim, dim), rnd(dim, dim), ones(dim), zeros(dim), ones(dim), zeros(dim), rnd(mlp, dim),
            zeros(mlp), rnd(dim, mlp), zeros(dim))


def main(device=None):
    """The JAX tool's main() on the card: one layer a call as the baseline,
    then L = 2, 3, 4, 6 layers a call (one stack_layers[tools] launch),
    ms a call and a layer against the baseline, and at L = 2 max|Δ|
    against two one-layer calls.  Returns {L: (ms a call, max|Δ| or None)}."""
    dev = c.card(device)
    c.print_card(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, N, DIM, generator=gen, device=dev).to(torch.bfloat16)
    all_w = [layer_weights(gen, dev) for _ in range(MAX_LAYERS)]
    results = {}
    with torch.inference_mode():
        one = make_stack(1)
        base = c.timeit("stack L=1 (per-layer calls, baseline)", one, x, *all_w[0], iters=INNER_ITERS)
        results[1] = (base, None)
        ref = one(one(x, *all_w[0]), *all_w[1])  # two layers through the L=1 path
        for L in (2, 3, 4, 6):
            flat = [w for lw in all_w[:L] for w in lw]
            fn = make_stack(L)
            t = c.timeit(f"stack L={L} (one call)", fn, x, *flat, iters=INNER_ITERS, layers=L)
            print(f"{'':52s} -> {t / L:.3f} ms/layer vs {base:.3f} baseline ({(1 - t / (L * base)) * 100:+.1f}%)",
                  flush=True)
            err = None
            if L == 2:
                err = c.max_delta(fn(x, *flat), ref)[0]
                print(f"{'':52s} max|Δ| vs two L=1 calls: {err:.5f}", flush=True)
            results[L] = (t, err)
    return results


if __name__ == "__main__":
    main()
