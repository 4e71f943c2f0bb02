"""The whole-layer prototypes of ``tools/bench_layer_fused.py`` on the port:
one pre-norm ViT layer (attention block + FF) against the pair of the
attention-block kernel and a plain FF.

Five JAX kernels, one function: LN1 -> qkv (no bias, one cast of the f32
dot) -> per-head softmax attention (``exp`` and a division) -> out
projection (no bias): ``att + x`` in f32, one cast -> LN2 -> fc1: f32 dot +
f32 b1, one cast, tanh GELU -> fc2: f32 dot + f32 b2 + f32 y, one cast.

- ``make_whole_resident`` (:123, call :151) and ``make_whole_tiled``
  (:178, call :223): the layer; the tiled one sums fc2 over hidden tiles
  in f32 scratch, which changes only the f32 summation order;
- ``make_whole_padded`` (:252, call :299) and ``make_whole_padded_tiled``
  (:324, call :378): the layer on x padded to ``n_pad`` rows, keys >=
  ``n_real`` masked, the padded rows computed and kept;
- ``make_attn_padded`` (:405, call :439): the padded attention block alone,
  with the plain FF of ``baseline_pair``.

On a CUDA tensor each returns the seven launches of the port's kernels
(four for the attention block alone; see ``_common.py``); on a CPU tensor
the plain twin of the tool's lines.  ``ips``, ``ht`` and ``batched_heads``
are the TPU kernels' grid and schedule parameters: they do not change the
function and do not change the Hopper launches.  The shapes come from the
tensors.

    python -m vit_pytorch_tpu_torch.tools.bench_layer_fused   # on a CUDA card
"""

from __future__ import annotations

import torch

from ..ops import fused_block as fb
from . import _common as c

# main()'s sizes (the JAX tool's): ViT-B/16 @224 at bs=128
B, H, N, D = 128, 12, 197, 64
DIM = H * D
MLP = 4 * DIM
INNER_ITERS = 100
N_PAD = 200


def baseline_pair(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2):
    """The JAX tool's round-2 pair (:80-92): the port's attention-block
    kernels (``fused_attention_block``, no biases), then the plain FF."""
    y = fb.fused_attention_block(x, x, wqkv, wout, ln1s, ln1b, heads=c.heads_of(wout), dim_head=c.D,
                                 scale=c.D**-0.5, eps=c.EPS)
    return c.plain_ff(y, w1, b1, w2, b2, ln2s, ln2b)


def _whole(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, n_real=None):
    if c.on_card(x):
        return c.layer_chain(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
                             n_keys=None if n_real == x.shape[1] else n_real)
    return c.layer_twin(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, n_real=n_real)


def make_whole_resident(ips, batched_heads=False):
    """``fn(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2)``: the
    whole layer (``ips`` images a grid step and ``batched_heads``, TPU
    schedule parameters, change nothing here)."""

    def fn(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2):
        return _whole(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2)

    return fn


def make_whole_tiled(ips, ht, batched_heads=False):
    """The whole layer with the TPU kernel's FF hidden dim tiled by ``ht``:
    the same function as :func:`make_whole_resident` (``ips``, ``ht`` and
    ``batched_heads`` change nothing here)."""
    return make_whole_resident(ips, batched_heads)


def make_whole_padded(ips, n_pad=N_PAD, n_real=N):
    """``fn(xp, ...)`` on x padded to ``n_pad`` rows an image: keys >=
    ``n_real`` get no weight (``attention_rows[n_keys]`` on the card); every
    row, padded ones too, is computed and kept (``ips`` changes nothing
    here)."""

    def fn(xp, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2):
        c.check_padded("make_whole_padded", xp, n_pad, n_real)
        return _whole(xp, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, n_real=n_real)

    return fn


def make_whole_padded_tiled(ips, ht, n_pad=N_PAD, n_real=N):
    """The padded layer with the TPU kernel's FF weights streamed in hidden
    tiles of ``ht``: the same function as :func:`make_whole_padded`."""
    return make_whole_padded(ips, n_pad, n_real)


def make_attn_padded(ips, n_pad=N_PAD, n_real=N):
    """The padded, key-masked attention block alone (four launches on the
    card), paired with the plain FF of :func:`baseline_pair` (:454-459)."""

    def fn(xp, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2):
        c.check_padded("make_attn_padded", xp, n_pad, n_real)
        if c.on_card(xp):
            y = c.attention_chain(xp, wqkv, wout, ln1s, ln1b, n_keys=None if n_real == n_pad else n_real)
        else:
            y = c.attention_twin(xp, wqkv, wout, ln1s, ln1b, n_real=n_real)
        return c.plain_ff(y, w1, b1, w2, b2, ln2s, ln2b)

    return fn


def make_args(dev, *, b=B, n=N, dim=DIM, mlp=MLP, seed=0):
    """main()'s operands: x ~ N(0, 1), weights ~ 0.02 N(0, 1) in the
    (out, in) layout, LayerNorms at one and zero, zero biases (the JAX
    tool's, :464-475), bf16, from a seeded generator on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)
    ones = lambda d: torch.ones(d, dtype=torch.bfloat16, device=dev)
    zeros = lambda d: torch.zeros(d, dtype=torch.bfloat16, device=dev)
    return (rnd(b, n, dim), rnd(3 * dim, dim, s=0.02), rnd(dim, dim, s=0.02), ones(dim), zeros(dim), ones(dim),
            zeros(dim), rnd(mlp, dim, s=0.02), zeros(mlp), rnd(dim, mlp, s=0.02), zeros(dim))


def main(device=None):
    """The JAX tool's main() on the card: the baseline pair, the resident
    layer and the padded variants at bs=128, ms a call and max|Δ| against
    the baseline.  Returns {name: (ms, max|Δ|)}."""
    dev = c.card(device)
    c.print_card(dev)
    args = make_args(dev)
    results = {}
    with torch.inference_mode():
        name = "baseline: fused-attn kernel + plain FF"
        results[name] = (c.timeit(name, baseline_pair, *args, iters=INNER_ITERS), 0.0)
        ref = baseline_pair(*args)
        variants = [("whole resident ips=2", make_whole_resident(2), args)]
        xp = torch.nn.functional.pad(args[0], (0, 0, 0, N_PAD - N))
        pargs = (xp,) + args[1:]
        variants += [(name, fn, pargs) for name, fn in (
            ("padded resident ips=4", make_whole_padded(4, N_PAD)),
            ("padded resident ips=8", make_whole_padded(8, N_PAD)),
            ("padded resident ips=16", make_whole_padded(16, N_PAD)),
            ("padded tiled ht=768 ips=8", make_whole_padded_tiled(8, 768, N_PAD)),
            ("padded attn-only ips=8 + plain FF", make_attn_padded(8, N_PAD)),
        )]
        for name, fn, a in variants:
            t = c.timeit(name, fn, *a, iters=INNER_ITERS)
            err, rel = c.max_delta(fn(*a)[:, :N], ref)
            print(f"{'':52s} max|Δ|={err:.4f} (rel {rel:.4f}) vs baseline", flush=True)
            results[name] = (t, err)
    return results


if __name__ == "__main__":
    main()
