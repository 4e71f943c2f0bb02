"""The options of the port's ``nn/`` (vit_pytorch_tpu_torch/nn/blocks.py,
nn/patch.py) against the JAX package on the CPU, fp32, at a small size
(dim 128, heads 2, dim_head 64, depth 2): the same parameters on both sides
(numpy draws at the shapes ``jax.eval_shape`` gives the JAX init), the same
inputs (numpy seed).

Tolerances: outputs within 5e-5 absolute (the JAX package's fp32 parity bar)
and 1e-4 relative; gradients (of ``sum(out * g)`` for a fixed numpy ``g``,
to the input and every parameter) within 5e-5 + 1e-3 relative.  The
patchify functions are equal bit for bit.

The kernel-route tests force the port's kernel predicates (the device test
and the kernels' gates taken as true), so that the Transformer runs
``fused_transformer_layer`` or ``fused_attention_block`` on their plain
twins, with a qkv bias and a scale as operands; the whole-layer route is
held to the JAX Transformer on its own whole-layer kernels in interpret
mode (both compute the tanh GELU there), the block route to the JAX
composite.  A strided x reaches the attention block's operands contiguous,
with the result of a contiguous x, bit for bit."""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.nn import blocks as jax_blocks
from vit_pytorch_tpu.nn import patch as jax_patch
from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.nn import patch as torch_patch
from vit_pytorch_tpu_torch.ops import fused_block as port_fb

ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
DIM, HEADS, DH, MLP, DEPTH = 128, 2, 64, 256, 2
B, N, M = 2, 9, 5  # batch, tokens, context tokens
SCALE = 0.1  # a logits' scale other than dim_head**-0.5 = 0.125


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(shape, seed, scale=1.0):
    return (scale * _rng(seed).standard_normal(shape)).astype(np.float32)


def _draw(init_fn, seed=5):
    """Parameters of the shapes of the flax ``init_fn`` (``jax.eval_shape``,
    nothing compiled), drawn with numpy: Dense kernels N(0, 1 / fan_in),
    LayerNorm scales 1 + 0.1 N(0, 1), every other leaf 0.1 N(0, 1)."""
    rng = _rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.float32(np.sqrt(leaf.shape[0]))
        return 1 + 0.1 * z if name == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init_fn)["params"])


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_sd(params, renames=()):
    """A JAX params tree -> a torch state_dict: module paths renamed by
    ``renames`` ((regex, template) on the "/"-joined path) and joined by
    dots, Dense kernels transposed, ``scale``/``kernel`` as ``weight``."""
    out = {}
    for path, value in _flat(params):
        module, leaf = "/".join(path[:-1]), path[-1]
        for pattern, template in renames:
            module = re.sub(pattern, template, module)
        array = np.asarray(value, np.float32)
        if leaf == "kernel":
            array = array.T
        key = ".".join(p for p in (module.replace("/", "."), {"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
                       if p)
        out[key] = torch.from_numpy(np.array(array))  # a writable copy
    return out


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def _check(jmod, params, tmod, renames, inputs, *, call=lambda m, *xs: m(*xs), jcall=None, train=False):
    """Output, input gradients and every parameter gradient of ``sum(out *
    g)`` of the JAX module and the port's, the port loaded with the same
    parameters."""
    tmod.load_state_dict(_torch_sd(params, renames), strict=True)
    tmod.train(train)
    jcall = jcall or (lambda m, p, *xs: m.apply({"params": p}, *xs))
    want = jax.jit(lambda p, *xs: jcall(jmod, p, *xs))(params, *map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(x).requires_grad_() for x in inputs]
    got = call(tmod, *leaves)
    _close(got, want, msg="output")
    g = _normal(want.shape, 99)

    def loss(p, *xs):
        return jnp.sum(jcall(jmod, p, *xs) * g)

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs) + 1))))(params, *map(jnp.asarray, inputs))
    (got * torch.from_numpy(g)).sum().backward()
    for i, (x, jg) in enumerate(zip(leaves, jgrads[1:])):
        _close(x.grad, jg, rtol=GRAD_RTOL, msg=f"input {i} grad")
    want_p = _torch_sd(jax.tree.map(np.asarray, jgrads[0]), renames)
    for k, p in tmod.named_parameters():
        _close(p.grad, want_p[k].numpy(), rtol=GRAD_RTOL, msg=f"grad {k}")


# -- LayerNorms, activations, FeedForward -------------------------------------

def test_layer_norms_match_jax():
    x = _normal((B, N, DIM), 1)
    for use_bias in (True, False):
        jln = jax_blocks.LayerNorm(use_bias=use_bias)
        params = _draw(lambda: jln.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        _check(jln, params, torch_blocks.LayerNorm(DIM, use_bias), (("^ln$", ""),), [x])
    jln = jax_blocks.UnitOffsetLayerNorm()
    params = _draw(lambda: jln.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    _check(jln, params, torch_blocks.UnitOffsetLayerNorm(DIM), (), [x])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(jax_blocks._ACTIVATIONS))
def test_activations_match_jax(name, dtype):
    """Every entry of the activation table, the dtype-adaptive GELU in both
    dtypes (tanh in bf16, erf in fp32): within one bf16 ulp in bf16."""
    x = _normal((4, 64), 2, 3.0)
    want = np.asarray(jax_blocks._ACTIVATIONS[name](jnp.asarray(x, dtype)).astype(jnp.float32))
    got = torch_blocks.ACTIVATIONS[name](torch.from_numpy(x).to(getattr(torch, dtype))).float()
    if dtype == "float32":
        _close(got, want, atol=1e-6, rtol=1e-6)
    else:
        _close(got, want, atol=1e-2, rtol=2.0**-7)


FF_RENAMES = (("^norm$", "net.0"), ("^fc1$", "net.1"), ("^fc2$", "net.4"))
FF_CASES = [dict(activation=a, glu=g) for a in sorted(jax_blocks._ACTIVATIONS) for g in (False, True)] + [
    dict(pre_norm=False), dict(use_bias=False), dict(norm_bias=False), dict(glu=True, use_bias=False, pre_norm=False),
]


@pytest.mark.parametrize("kw", FF_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_feedforward_matches_jax(kw):
    """Each activation with and without the GLU, no pre-norm, bias-free
    Linears and LayerNorm: output and gradients; fc1 stays at ``net.1``
    and fc2 at ``net.4`` in every form."""
    x = _normal((B, N, DIM), 3)
    jff = jax_blocks.FeedForward(dim=DIM, hidden_dim=MLP, **kw)
    params = _draw(lambda: jff.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tff = torch_blocks.FeedForward(DIM, MLP, **kw)
    assert isinstance(tff.net[1], torch.nn.Linear) and isinstance(tff.net[4], torch.nn.Linear)
    _check(jff, params, tff, FF_RENAMES, [x])


# -- Attention -----------------------------------------------------------------

def _rotary_tables(n, dh):
    inv = 1.0 / (10000 ** (np.arange(0, dh, 2) / dh))
    ang = np.arange(n)[:, None] * inv[None]
    ang = np.concatenate([ang, ang], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


COS, SIN = _rotary_tables(N, DH)


def jax_rotary(t):
    """A fixed rotate-half rotary on (b, h, n, dh), the JAX side."""
    x1, x2 = jnp.split(t, 2, axis=-1)
    return t * COS + jnp.concatenate([-x2, x1], axis=-1) * SIN


def torch_rotary(t):
    """The same rotary, the port's side."""
    x1, x2 = t.chunk(2, dim=-1)
    return t * torch.from_numpy(COS) + torch.cat([-x2, x1], dim=-1) * torch.from_numpy(SIN)


ATTN_RENAMES = (("^to_out$", "to_out.0"),)
# (constructor options, call: context / bias / rotary)
ATTN_CASES = {
    "qkv_bias": (dict(qkv_bias=True), ()),
    "scale": (dict(scale=SCALE), ()),
    "qkv_bias_scale_qk_norm": (dict(qkv_bias=True, scale=SCALE, qk_norm=True), ()),
    "no_pre_norm": (dict(pre_norm=False), ()),
    "project_out_off": (dict(heads=2, dim_head=DIM // 2, project_out=False), ()),
    "one_head_projected": (dict(heads=1, dim_head=DIM, project_out=True), ()),
    "cross_norm_context": (dict(norm_context=True, qkv_bias=True), ("context",)),
    "cross_kv_include_self": (dict(norm_context=True, kv_include_self=True), ("context",)),
    "bias": (dict(), ("bias",)),
    "rotary": (dict(), ("rotary",)),
    "rotary_qk_norm": (dict(qk_norm=True, qk_norm_gamma_init=0.5), ("rotary",)),
    "rotary_bias_scale": (dict(scale=SCALE), ("rotary", "bias")),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(case):
    """Every new option of ``Attention`` and of its call, with the residual
    keyword, against the JAX ``Attention``."""
    opts, calls = ATTN_CASES[case]
    opts = {"heads": HEADS, "dim_head": DH, **opts}
    x, res = _normal((B, N, DIM), 4), _normal((B, N, DIM), 5)
    inputs = [x, res] + ([_normal((B, M, DIM), 6)] if "context" in calls else [])
    bias = _normal((opts["heads"], N, N), 7) if "bias" in calls else None
    jattn = jax_blocks.Attention(dim=DIM, **{k: v for k, v in opts.items() if k != "force_split_qkv"})

    def jcall(m, p, x, res, *ctx):
        return m.apply({"params": p}, x, *ctx, residual=res, bias=None if bias is None else jnp.asarray(bias),
                       rotary=jax_rotary if "rotary" in calls else None)

    def call(m, x, res, *ctx):
        return m(x, *ctx, residual=res, bias=None if bias is None else torch.from_numpy(bias),
                 rotary=torch_rotary if "rotary" in calls else None)

    params = _draw(lambda: jattn.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, [inputs[0], *inputs[2:]]), residual=jnp.asarray(res),
        bias=None if bias is None else jnp.asarray(bias), rotary=jax_rotary if "rotary" in calls else None))
    tattn = torch_blocks.Attention(DIM, **opts)
    assert not tattn.fuses(torch.from_numpy(x)), "the CPU never takes the kernels"
    _check(jattn, params, tattn, ATTN_RENAMES, inputs, call=call, jcall=jcall)


def test_fused_block_eligible_refusals(monkeypatch):
    """The kernel predicate with the device test and the gate forced true:
    a qkv bias, a scale and qk-norm keep the attention-block kernels; no
    pre-norm, a rotary, a bias, a context, a mask and recording refuse
    them."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    x = torch.zeros(B, N, DIM)
    for kw in (dict(), dict(qkv_bias=True, scale=SCALE), dict(qk_norm=True)):
        assert torch_blocks.Attention(DIM, HEADS, DH, **kw).fuses(x), kw
    assert not torch_blocks.Attention(DIM, HEADS, DH, pre_norm=False).fuses(x)
    attn = torch_blocks.Attention(DIM, HEADS, DH)
    for refusal in ("has_rotary", "has_bias", "has_mask", "has_segments"):
        assert not attn.fuses(x, **{refusal: True}), refusal
    assert not attn.fuses(x, context=x)
    attn.recorded = []
    assert not attn.fuses(x)


# -- Transformer -----------------------------------------------------------------

TRANSFORMER_CASES = {
    "ff_silu": (dict(ff_activation="silu"), ()),
    "ff_glu": (dict(ff_glu=True), ()),
    "ff_glu_relu": (dict(ff_glu=True, ff_activation="relu"), ()),
    "no_final_norm": (dict(final_norm=False), ()),
    "qkv_bias": (dict(qkv_bias=True), ()),
    "bias": (dict(), ("bias",)),
    "rotary": (dict(), ("rotary",)),
    "rotary_qk_norm_glu": (dict(qk_norm=True, ff_glu=True), ("rotary",)),
    "bias_norm_bias_off": (dict(norm_bias=False, attn_out_bias=False), ("bias",)),
}


def _transformer_sd_renames():
    return ((r"^layers_(\d+)_attn", r"layers.\1.0"), (r"^layers_(\d+)_ff/norm$", r"layers.\1.1.net.0"),
            (r"^layers_(\d+)_ff/fc1$", r"layers.\1.1.net.1"), (r"^layers_(\d+)_ff/fc2$", r"layers.\1.1.net.4"),
            (r"^layers\.(\d+)\.0/to_out$", r"layers.\1.0/to_out.0"))


def _jax_transformer(opts, calls, x, bias, *, return_hiddens=False):
    jt = jax_blocks.Transformer(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH, mlp_dim=MLP, **opts)
    kw = dict(bias=None if bias is None else jnp.asarray(bias), rotary=jax_rotary if "rotary" in calls else None)
    params = _draw(lambda: jt.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw))

    def jcall(m, p, x):
        out = m.apply({"params": p}, x, return_hiddens=return_hiddens, **kw)
        return jnp.stack([out[0], *out[1]]) if return_hiddens else out

    return jt, params, jcall


@pytest.mark.parametrize("case", list(TRANSFORMER_CASES))
def test_transformer_matches_jax(case):
    """Each new option of ``Transformer`` and of its call (the composite on
    the CPU), output and every gradient."""
    opts, calls = TRANSFORMER_CASES[case]
    x = _normal((B, N, DIM), 8)
    bias = _normal((B, HEADS, N, N), 9) if "bias" in calls else None
    jt, params, jcall = _jax_transformer(opts, calls, x, bias)
    tt = torch_blocks.Transformer(DIM, DEPTH, HEADS, DH, MLP, **opts)

    def call(m, x):
        return m(x, bias=None if bias is None else torch.from_numpy(bias),
                 rotary=torch_rotary if "rotary" in calls else None)

    _check(jt, params, tt, _transformer_sd_renames(), [x], call=call, jcall=jcall)


def test_transformer_return_hiddens_matches_jax():
    """``return_hiddens``: the normed output and each layer's output."""
    x = _normal((B, N, DIM), 10)
    jt, params, jcall = _jax_transformer(dict(qkv_bias=True), (), x, None, return_hiddens=True)
    tt = torch_blocks.Transformer(DIM, DEPTH, HEADS, DH, MLP, qkv_bias=True)

    def call(m, x):
        out, hiddens = m(x, return_hiddens=True)
        assert len(hiddens) == DEPTH
        return torch.stack([out, *hiddens])

    _check(jt, params, tt, _transformer_sd_renames(), [x], call=call, jcall=jcall)


@pytest.mark.parametrize("scale", [None, SCALE])
@pytest.mark.parametrize("route", ["whole_layer", "block"])
def test_transformer_kernel_routes_match_jax(route, scale, monkeypatch):
    """A ``Transformer`` with a qkv bias on the forced kernel routes (their
    Functions on the plain twins), with the logits' scale ``scale`` given to
    the kernels as in JAX (whose ``Transformer`` has no scale): eval mode on
    the whole-layer route (``b_qkv`` into ``fused_transformer_layer``, the
    scale handed to that op on both sides, against the JAX Transformer on its
    own whole-layer kernels in interpret mode), and with a GLU (which refuses
    the whole layer) on the attention-block route (``b_qkv`` and each
    layer's ``Attention(scale=)`` into ``fused_attention_block``, against the
    JAX composite with ``Attention(scale=)``).  Output and every gradient,
    ``db_qkv`` included."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    opts = dict(qkv_bias=True) if route == "whole_layer" else dict(qkv_bias=True, ff_glu=True)
    names = {"whole_layer": "fused_transformer_layer", "block": "fused_attention_block"}
    fused, calls = getattr(torch_blocks, names[route]), []

    def spy(x, *args, **kwargs):
        calls.append((kwargs["b_qkv"] is not None, kwargs.get("scale")))
        return fused(x, *args, **kwargs)

    if route == "whole_layer":
        monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
        monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
        monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: True)
        monkeypatch.setattr(jax_fb, "whole_layer_supported", lambda *a, **k: True)
        orig = jax_blocks.fused_transformer_layer
        monkeypatch.setattr(jax_blocks, "fused_transformer_layer",
                            lambda *a, **k: orig(*a, **k, scale=scale, interpret=True))
        monkeypatch.setattr(torch_blocks, names[route], lambda *a, **k: spy(*a, **k, scale=scale))
    else:
        monkeypatch.setattr(torch_blocks, names[route], spy)
        if scale is not None:
            monkeypatch.setattr(jax_blocks, "Attention", _with_scale(scale))
            monkeypatch.setattr(torch_blocks, "Attention", _torch_with_scale(scale))
    x = _normal((B, N, DIM), 11)
    jt, params, jcall = _jax_transformer(opts, (), x, None)
    tt = torch_blocks.Transformer(DIM, DEPTH, HEADS, DH, MLP, **opts)
    _check(jt, params, tt, _transformer_sd_renames(), [x], train=route == "block")
    assert calls == [(True, scale)] * DEPTH


def _with_scale(scale):
    """A JAX ``Attention`` whose default ``scale`` is ``scale`` (the JAX
    ``Transformer`` builds its layers' Attention without one)."""
    return type("ScaledAttention", (jax_blocks.Attention,), {"__annotations__": {"scale": float}, "scale": scale})


def _torch_with_scale(scale):
    """The port's ``Attention`` built with ``scale``, for the port's
    ``Transformer`` to build its layers from."""

    class ScaledAttention(torch_blocks.Attention):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs, scale=scale)

    return ScaledAttention


# -- patch embedding, patchify, patch dropout ------------------------------------

@pytest.mark.parametrize("fn,shape,patch", [("patchify_1d", (2, 3, 24), (4,)),
                                             ("patchify_2d", (2, 3, 8, 12), (4, 2)),
                                             ("patchify_3d", (2, 3, 4, 8, 6), (2, 4, 3))])
def test_patchify_equals_jax_bit_for_bit(fn, shape, patch):
    x = _normal(shape, 12)
    want = np.asarray(getattr(jax_patch, fn)(jnp.asarray(x), *patch))
    assert np.array_equal(getattr(torch_patch, fn)(torch.from_numpy(x), *patch).numpy(), want)
    assert np.array_equal(torch_patch.Patchify(*patch)(torch.from_numpy(x)).numpy(), want)


PATCH_RENAMES = (("^norm_pre$", "1"), ("^proj$", "2"), ("^norm_post$", "3"))


@pytest.mark.parametrize("kw", [dict(norm_input=False), dict(norm_output=False), dict(norm_bias=False),
                                dict(norm_input=False, norm_output=False)],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_patch_embedding_options_match_jax(kw):
    """``norm_input``, ``norm_output`` and ``norm_bias`` against the JAX
    ``PatchEmbedding`` (which takes patches: the modules after the first),
    the Linear
    at index 2."""
    patches = _normal((B, N, 48), 13)
    jpe = jax_patch.PatchEmbedding(dim=DIM, **kw)
    params = _draw(lambda: jpe.init(jax.random.PRNGKey(0), jnp.asarray(patches)))
    tpe = torch_patch.PatchEmbedding((4, 4), 48, DIM, **kw)
    assert isinstance(tpe[2], torch.nn.Linear)
    _check(jpe, params, tpe, PATCH_RENAMES, [patches],
           call=lambda m, p: torch.nn.Sequential(*list(m.children())[1:])(p))


@pytest.mark.parametrize("prob,n", [(0.5, 16), (0.25, 9), (0.9, 5), (0.99, 3)])
def test_patch_dropout_keeps_distinct_rows(prob, n):
    """Eval mode and prob 0 are the identity; in training each sample keeps
    ``max(1, int(n (1 - prob)))`` distinct rows of x, in the order of the
    generator's normal scores, and the same generator draws the same."""
    x = torch.from_numpy(_normal((3, n, 8), 14))
    pd = torch_patch.PatchDropout(prob)
    assert pd.eval()(x) is x and torch_patch.PatchDropout(0.0).train()(x) is x
    pd.train()
    out = pd(x, torch.Generator().manual_seed(3))
    keep = max(1, int(n * (1 - prob)))
    assert out.shape == (3, keep, 8)
    idx = pd.keep_indices(3, n, torch.Generator().manual_seed(3))
    scores = torch.randn((3, n), generator=torch.Generator().manual_seed(3))
    for i in range(3):
        assert len(set(idx[i].tolist())) == keep
        assert torch.equal(out[i], x[i, idx[i]])
        assert torch.equal(scores[i, idx[i]], scores[i].sort(descending=True).values[:keep])
    assert torch.equal(pd(x, torch.Generator().manual_seed(3)), out)
    with pytest.raises(ValueError):
        torch_patch.PatchDropout(1.0)


# -- the attention block on a strided x ----------------------------------------------


def _contiguous_only(ops):
    """``ops`` whose every tensor operand must be contiguous, as the kernels'
    operand check requires on the card."""

    def checked(fn):
        def call(*args, **kwargs):
            for t in (*args, *kwargs.values()):
                if isinstance(t, torch.Tensor):
                    assert t.is_contiguous(), f"{fn.__name__}: a strided operand"
            return fn(*args, **kwargs)

        return call

    return SimpleNamespace(**{k: checked(v) for k, v in vars(ops).items()})


@pytest.mark.parametrize("residual", ["none", "x", "other"])
def test_attention_block_takes_a_strided_x(residual):
    """The attention block's Function (forward and backward) and its no-grad
    forward on a strided (b, n, d) view, as the hyper-connection model
    hands it one stream of its mix: every operand reaches the kernels
    contiguous, and the output and gradients equal those of the contiguous
    copy bit for bit."""
    g = torch.Generator().manual_seed(0)
    mix = torch.randn(B, N, 5, DIM, generator=g).to(torch.bfloat16)
    w = [torch.randn(s, generator=g).to(torch.bfloat16) * 0.05 for s in ((3 * HEADS * DH, DIM), (DIM, HEADS * DH))]
    ln = [torch.ones(DIM, dtype=torch.bfloat16), torch.zeros(DIM, dtype=torch.bfloat16)]
    other = torch.randn(B, N, 5, DIM, generator=g).to(torch.bfloat16)[..., 1, :]
    ops = _contiguous_only(port_fb.TWINS)
    kw = dict(heads=HEADS, dim_head=DH, b_qkv=None, b_out=None, gamma_q=None, gamma_k=None, scale=None,
              eps=port_fb.LN_EPS, dropout_rate=0.0, dropout_seed=None)

    def run(x, grad):
        x = x.detach().requires_grad_(grad)
        res = {"none": None, "x": x, "other": other}[residual]
        out = port_fb._attention_block(ops, x, res, *w, *ln, **kw)
        if not grad:
            return out, None
        (dx,) = torch.autograd.grad(out.float().sum(), [x])
        return out, dx

    strided = mix[..., 0, :]
    assert not strided.is_contiguous()
    for grad in (False, True):
        (out, dx), (want, want_dx) = run(strided, grad), run(strided.contiguous(), grad)
        assert torch.equal(out, want)
        assert dx is None or torch.equal(dx, want_dx)
