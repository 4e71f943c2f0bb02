"""The block prototypes of ``tools/fused_block_proto.py`` on the port: the
attention block and the FF block, each against its plain reference.

- ``fused_attention_block`` (kernel ``_attn_block_kernel`` :26, call :63):
  LN -> qkv (no bias, one cast of the f32 dot) -> per-head softmax
  (``exp`` and a division) -> ``out = f32 x + (f32 dot + f32 b_out)``, one
  cast; one image a TPU grid step.
- ``fused_ff_block`` (``_ff_block_kernel`` :99, call :118) and
  ``fused_ff_block_rows`` (``_ff_rows_kernel`` :135, call :161, over row
  tiles zero-padded to a multiple of ``rows``): LN -> fc1: f32 dot + f32
  b1, one cast, tanh GELU -> ``out = f32 x + (f32 dot + f32 b2)``, one
  cast.

On a CUDA tensor the attention block is four launches of the port's kernels
and the FF block three (``_common.py``); on a CPU tensor the plain twin of
the kernel's lines.  The row tile changes nothing here.  ``reference_block``
and ``reference_ff`` are the tool's own XLA references, which add in x.dtype
and so differ from the kernels by a bf16 rounding or two; they are plain
PyTorch on every device.  Weights are in the (out, in) layout and vectors
(d,).

    python -m vit_pytorch_tpu_torch.tools.fused_block_proto   # on a CUDA card
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _common as c

# main()'s sizes (the JAX tool's)
B, H, N, D = 128, 12, 197, 64
DIM = H * D
MLP = 4 * DIM
LAYERS = 12
INNER = 10


def fused_attention_block(x, w_qkv, w_out, b_out, ln_scale, ln_bias, *, heads, dim_head, scale=None):
    """``x + OutProj(Attention(LN(x) @ Wqkv)) + b_out``, one cast."""
    if dim_head != c.D or scale not in (None, dim_head**-0.5) or heads != c.heads_of(w_out):
        raise ValueError(f"fused_attention_block: heads={heads}, dim_head={dim_head}, scale={scale}; the kernels "
                         f"take {c.heads_of(w_out)} heads of {c.D} at scale dim_head**-0.5")
    if c.on_card(x):
        return c.attention_chain(x, w_qkv, w_out, ln_scale, ln_bias, b_out=b_out)
    return c.attention_twin(x, w_qkv, w_out, ln_scale, ln_bias, b_out=b_out)


def reference_block(x, w_qkv, w_out, b_out, ln_scale, ln_bias, *, heads, dim_head, scale=None):
    """The tool's XLA reference (:76-96): softmax in f32, probabilities cast,
    ``x + (o @ w_out + b_out)`` in x.dtype."""
    b, n, dim = x.shape
    scale = dim_head**-0.5 if scale is None else scale
    ln = c._ln(x, ln_scale, ln_bias).to(x.dtype)
    q, k, v = F.linear(ln, w_qkv).chunk(3, dim=-1)
    rs = lambda t: t.reshape(b, n, heads, dim_head).transpose(1, 2)
    q, k, v = rs(q), rs(k), rs(v)
    dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = dots.softmax(-1).to(x.dtype)
    o = torch.matmul(attn.float(), v.float()).to(x.dtype)
    o = o.transpose(1, 2).reshape(b, n, dim)
    return x + (F.linear(o, w_out) + b_out.to(x.dtype))


def fused_ff_block(x, w1, b1, w2, b2, ln_scale, ln_bias):
    """``x + FF(LN(x))`` with the f32 adds of ``_ff_block_kernel``."""
    if c.on_card(x):
        return c.ff_chain(x, w1, b1, w2, b2, ln_scale, ln_bias)
    return c.ff_twin(x, w1, b1, w2, b2, ln_scale, ln_bias)


def fused_ff_block_rows(x, w1, b1, w2, b2, ln_scale, ln_bias, *, rows=512):
    """The FF block over row tiles of ``rows`` on the TPU: the same function
    as :func:`fused_ff_block` (``rows`` changes nothing here)."""
    return fused_ff_block(x, w1, b1, w2, b2, ln_scale, ln_bias)


def reference_ff(x, w1, b1, w2, b2, ln_scale, ln_bias):
    """The tool's XLA reference (:181-188): ``gelu(ln @ w1 + b1)`` and
    ``x + (h @ w2 + b2)`` in x.dtype."""
    ln = c._ln(x, ln_scale, ln_bias).to(x.dtype)
    h = F.gelu(F.linear(ln, w1) + b1, approximate="tanh")
    return x + (F.linear(h, w2) + b2)


def _stack(fn):
    def run(x, *rest):
        for _ in range(LAYERS):
            x = fn(x, *rest)
        return x

    return run


def main(device=None):
    """The JAX tool's main() on the card: each block against its XLA
    reference (max abs error), then 12 blocks a call timed, the kernels
    against the references, the FF also at the tool's row tiles.  Returns
    {name: ms a call}."""
    dev = c.card(device)
    c.print_card(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)
    ones = lambda d: torch.ones(d, dtype=torch.bfloat16, device=dev)
    zeros = lambda d: torch.zeros(d, dtype=torch.bfloat16, device=dev)
    x = rnd(B, N, DIM)
    w_qkv, w_out, b_out, lns, lnb = rnd(3 * DIM, DIM, s=0.02), rnd(DIM, DIM, s=0.02), zeros(DIM), ones(DIM), zeros(DIM)
    kw = dict(heads=H, dim_head=D)
    attn = lambda *a: fused_attention_block(*a, **kw)
    ref = lambda *a: reference_block(*a, **kw)
    results = {}
    with torch.inference_mode():
        err, rel = c.max_delta(attn(x, w_qkv, w_out, b_out, lns, lnb), ref(x, w_qkv, w_out, b_out, lns, lnb))
        print(f"max abs err fused vs XLA: {err:.3e} (rel {rel:.3e})", flush=True)
        t = dict(iters=INNER, layers=LAYERS, label="ms/layer-equiv")
        for name, fn in (("XLA reference block", ref), ("fused block (kernels)", attn)):
            results[name] = c.timeit(name, _stack(fn), x, w_qkv, w_out, b_out, lns, lnb, **t)

        w1, b1, w2, b2 = rnd(MLP, DIM, s=0.02), zeros(MLP), rnd(DIM, MLP, s=0.02), zeros(DIM)
        ff = (x, w1, b1, w2, b2, lns, lnb)
        err = c.max_delta(fused_ff_block(*ff), reference_ff(*ff))[0]
        print(f"FF max abs err fused vs XLA: {err:.3e}", flush=True)
        for name, fn in (("XLA reference FF", reference_ff), ("fused FF (kernels)", fused_ff_block)):
            results[name] = c.timeit(name, _stack(fn), *ff, **t)
        for rows in (256, 512):
            name = f"fused FF row-tiled ({rows})"
            results[name] = c.timeit(name, _stack(lambda *a, rows=rows: fused_ff_block_rows(*a, rows=rows)), *ff, **t)
    return results


if __name__ == "__main__":
    main()
