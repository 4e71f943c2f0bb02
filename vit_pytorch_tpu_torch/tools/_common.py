"""What the port's bench tools share.

The JAX package's layer prototypes in ``tools/`` (the whole layer, the stack
and the attention and FF blocks) compute one function in several Pallas
schedules.  Here each is a chain of the port's Hopper kernels on a CUDA
tensor, and on a CPU tensor a plain twin that follows the tool's lines:

- ``_ln`` of every tool (f32 statistics, ``var = mean((x - mu)^2)``);
- each ``jnp.dot(..., preferred_element_type=jnp.float32)`` as an f32
  product of the bf16 operands;
- the attention of ``_attn_rows`` (bench_layer_fused.py:72-102) and of the
  proto and tuning kernels: f32 logits times the scale, plus the -inf key
  bias of the padded variants, minus the row max, ``exp``, divided by the
  row sum, p cast, p.v in f32, cast;
- the epilogues: ``(att + x)`` in f32, one cast; ``(dot + b1)`` in f32, one
  cast, then the tanh GELU; ``dot + b2 + y`` in f32, one cast.

On the card the chain is LN -> ``gemm_bf16[qkv]`` (no bias) ->
``attention_rows`` (``n_keys`` for the padded variants) ->
``gemm_bf16[block_out]`` (+x) -> LN -> ``gemm_bf16[fc1_f32]`` ->
``gemm_bf16[block_out]`` (+b2 +y); the attention block and the FF block run
their halves.  The TPU's grid and schedule parameters (images a step,
hidden tiles, row tiles, batched heads) do not change the function, so they
do not change the launches either.

Weights are in ``nn.Linear``'s (out, in) layout and vectors are (d,):
``utils/from_jax.py::tool_layer_from_jax`` carries a JAX tool's tuple over.
The tools' heads are 64 wide (``D = 64`` in every tool); the head count is
the attention width over 64.
"""

from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from ..ops import fused_block as fb

D = fb.ATTN_DIM_HEAD  # the tools' dim_head
EPS = 1e-5


def heads_of(w_out) -> int:
    """The head count of a layer: the attention width (w_out's input) over
    the tools' 64-wide heads."""
    return w_out.shape[1] // D


def on_card(x) -> bool:
    return x.device.type != "cpu"


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _ln(x, scale, bias):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + EPS) * scale.float() + bias.float()


def _dot(a, w):
    """``jnp.dot(a, w_jax, preferred_element_type=jnp.float32)``, w as (out, in)."""
    return F.linear(a.float(), w.float())


def attn_rows(qkv, heads: int, scale: float, *, n_real=None, exp2: bool = False):
    """Every head's attention of packed (b, n, 3*inner) rows to merged heads:
    ``_attn_rows`` (exp and a division; with ``n_real`` the -inf key bias of
    keys >= n_real), or with ``exp2`` the ``_softmax_from_dots`` of
    bench_stack_fusion.py:86-92, which is the port's own twin
    ``ops/fused_block.py::attention_rows_reference``."""
    if exp2:
        return fb.attention_rows_reference(qkv, heads=heads, dim_head=D, scale=scale, n_keys=n_real)
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, D).permute(2, 0, 3, 1, 4)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if n_real is not None:
        logits = logits + torch.where(torch.arange(n, device=qkv.device) < n_real, 0.0, -torch.inf)
    logits = logits - logits.amax(-1, keepdim=True)
    p = torch.exp(logits)
    p = p / p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()).to(qkv.dtype)
    return o.transpose(1, 2).reshape(b, n, heads * D)


def attention_twin(x, w_qkv, w_out, ln_s, ln_b, *, b_out=None, n_real=None, exp2=False):
    """The attention block of the prototypes: ``ln`` cast, qkv = one cast of
    the f32 dot, the attention, ``out = f32 dot (+ f32 b_out) + f32 x``, one
    cast."""
    heads = heads_of(w_out)
    h = _ln(x, ln_s, ln_b).to(x.dtype)
    qkv = _dot(h, w_qkv).to(x.dtype)
    merged = attn_rows(qkv, heads, D**-0.5, n_real=n_real, exp2=exp2)
    att = _dot(merged, w_out)
    if b_out is not None:
        att = att + b_out.float()
    return (att + x.float()).to(x.dtype)


def ff_twin(y, w1, b1, w2, b2, ln_s, ln_b):
    """The FF block of the prototypes: ``ln`` cast, ``h = f32 dot + f32 b1``,
    one cast, tanh GELU, ``out = f32 dot + f32 b2 + f32 y``, one cast."""
    h = _ln(y, ln_s, ln_b).to(y.dtype)
    h = (_dot(h, w1) + b1.float()).to(y.dtype)
    h = F.gelu(h, approximate="tanh")
    return (_dot(h, w2) + b2.float() + y.float()).to(y.dtype)


def layer_twin(x, w_qkv, w_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, *, n_real=None, exp2=False):
    """One whole layer of the prototypes: the attention block, then the FF
    block on its output y."""
    y = attention_twin(x, w_qkv, w_out, ln1s, ln1b, n_real=n_real, exp2=exp2)
    return ff_twin(y, w1, b1, w2, b2, ln2s, ln2b)


def plain_ff(y, w1, b1, w2, b2, ln2s, ln2b):
    """The XLA FF that bench_layer_fused.py pairs with an attention kernel
    (:80-84, :454-459): ``h @ w1 + b1`` and ``h @ w2 + b2`` in x.dtype, then
    ``+ f32 y``, one cast.  Plain PyTorch on every device, as the JAX tool
    leaves it to XLA."""
    h = _ln(y, ln2s, ln2b).to(y.dtype)
    h = F.gelu(F.linear(h, w1) + b1, approximate="tanh")
    return ((F.linear(h, w2) + b2).float() + y.float()).to(y.dtype)


# ---------------------------------------------------------------------------
# the kernel chains on the card
# ---------------------------------------------------------------------------


def attention_chain(x, w_qkv, w_out, ln_s, ln_b, *, b_out=None, n_keys=None):
    """Four launches: ``layernorm_rows``, ``gemm_bf16[qkv]`` (no bias),
    ``attention_rows`` (``[n_keys]`` when it masks keys),
    ``gemm_bf16[block_out]`` (+ b_out, + x, one cast)."""
    heads = heads_of(w_out)
    h = fb.layernorm_rows(x, ln_s, ln_b, eps=EPS)
    qkv = fb.gemm_bf16(h, w_qkv, "qkv")
    m = fb.attention_rows(qkv, heads=heads, dim_head=D, scale=D**-0.5, n_keys=n_keys)
    return fb.gemm_bf16(m, w_out, "block_out", bias=b_out, residual=x)


def ff_chain(y, w1, b1, w2, b2, ln_s, ln_b):
    """Three launches: ``layernorm_rows``, ``gemm_bf16[fc1_f32]``,
    ``gemm_bf16[block_out]`` (+ b2, + y, one cast)."""
    h = fb.layernorm_rows(y, ln_s, ln_b, eps=EPS)
    a = fb.gemm_bf16(h, w1, "fc1_f32", bias=b1)
    return fb.gemm_bf16(a, w2, "block_out", bias=b2, residual=y)


def layer_chain(x, w_qkv, w_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, *, n_keys=None):
    """Seven launches: the attention chain, then the FF chain; the layer
    chain of ``ops/fused_block.py`` with the tools' epilogues, which
    ``stack_layers[tools]`` matches bit for bit."""
    return fb._layer_forward(fb.KERNELS, x, w_qkv, None, w_out, None, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
                             heads_of(w_out), D, D**-0.5, EPS, "tools", n_keys)[0]


def check_padded(name: str, x, n_pad: int, n_real: int) -> None:
    if x.shape[1] != n_pad or not 1 <= n_real <= n_pad:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not padded to n_pad={n_pad} rows, n_real={n_real}")


# ---------------------------------------------------------------------------
# the card and its clock, for the tools' main()
# ---------------------------------------------------------------------------


def card(device=None) -> torch.device:
    """The device a tool's main() measures on: the CUDA card unless told
    otherwise; no card raises, since a time from the CPU is no card time."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the bench tools time a CUDA card; {dev} is not one")
    return dev


def print_card(dev) -> None:
    """The card's name and power limit (nvidia-smi), before any number."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"device: {torch.cuda.get_device_name(dev)}; {smi[dev.index or 0]}", flush=True)


def timeit(name: str, fn, *args, iters: int, layers: int = 1, label: str = "ms/layer"):
    """Device ms of one call of ``fn(*args)``: ``iters`` chained calls
    between CUDA events after a warm-up, the best of 3 (the JAX tools'
    ``timeit`` takes the best of 3 loops); printed as the JAX tool prints
    it, with the ms over ``layers`` beside it."""
    fn(*args)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    per_call = best / iters
    print(f"{name:52s} {per_call:8.3f} ms/call ({per_call / layers:.3f} {label})", flush=True)
    return per_call


def max_delta(out, ref):
    """(max|out - ref|, that over max|ref|), in f32."""
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()
