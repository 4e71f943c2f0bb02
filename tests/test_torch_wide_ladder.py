"""The JAX width ladder's head shapes on the port's kernel routes, on the CPU
in fp32, against the JAX package.

Narrow ViTs (depth 2) with the ladder's heads: ViT-H/14's 80 and ViT-g/14's
88 at patch 14 (257 tokens), ViT-L/14's 64 at 257 tokens, and
``tools/bench_d128.py``'s 32 and 128 at patch 16 (197 tokens).  Their
layers take the whole-layer route on both sides (``tp.force_layer_routes``:
the JAX ``_layer_kernel``, ``_kernel`` and ``_bwd_kernel`` in interpret
mode, the port's Functions on their twins, which the wide kernels are held
to on the card): eval and training logits and every gradient, within
tests/torch_parity.py's bounds.  The attention block at those shapes: at
rate 0 against the JAX ``fused_attention_block(..., interpret=True)``, at
rate 0.1 against a JAX composite fed the port's masks (the JAX kernels'
masks come from the TPU PRNG), plain and qk-norm, every operand gradient;
atol 5e-5, rtol 1e-4 (f32 summation order, exp vs exp2).  The qk-norm
gammas are SimpleViT-qk-norm's init, dim_head**-0.5, times 1 + 0.2 N(0, 1)
(logits of a few units, the root sqrt(dim_head) in full); at 1 + 0.2 N(0, 1)
alone the logits reach ~dim_head and the two packages' f32 summation orders
part by up to 7e-4 in dx at these widths (a softmax that sharp amplifies
them), where tests/test_torch_fused_block.py's dim_head 16 stays under 5e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from vit_pytorch_tpu.models import vit as j_vit
from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu_torch.models import vit
from vit_pytorch_tpu_torch.ops import fused_block as port
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 2, 10
# name: the widths; heads x dim_head as in the ladder's models, 2 heads
LADDER = {
    "vit_h14_heads": dict(image_size=224, patch_size=14, dim=160, heads=2, dim_head=80),  # 257 tokens
    "vit_g14_heads": dict(image_size=224, patch_size=14, dim=176, heads=2, dim_head=88),  # 257 tokens
    "vit_l14_heads": dict(image_size=224, patch_size=14, dim=128, heads=2, dim_head=64),  # 257 tokens
    "d128_heads": dict(image_size=224, patch_size=16, dim=256, heads=2, dim_head=128),  # 197 tokens
    "d32_heads": dict(image_size=224, patch_size=16, dim=64, heads=2, dim_head=32),  # 197 tokens
}
ATOL, RTOL = 5e-5, 1e-4
RATE, SEED = 0.1, 4321


@pytest.mark.parametrize("name", list(LADDER))
def test_ladder_vit_matches_jax_on_the_whole_layer_route(monkeypatch, name):
    """Eval and training logits and every gradient against the JAX ViT, both
    on their whole-layer kernels (the port's on its twins), and the route
    taken by every layer of every call."""
    calls = tp.force_layer_routes(monkeypatch)
    cfg = dict(**LADDER[name], num_classes=CLASSES, depth=2, mlp_dim=2 * LADDER[name]["dim"])
    jmodel = j_vit.ViT(**cfg)
    x = tp.inputs((BATCH, 3, 224, 224))
    params = tp.draw_params(jmodel, jnp.asarray(x))
    model = tp.load(vit.ViT(**cfg, device="cpu"), from_jax.vit_state_dict_from_jax(params))
    tp.check_model(jmodel, params, model, from_jax.vit_state_dict_from_jax, x, tp.labels(BATCH, CLASSES))
    n = (224 // cfg["patch_size"]) ** 2 + 1
    assert calls["layer"] == [(BATCH, n, cfg["dim"])] * 4 and not calls["block"]  # 2 layers x (eval, train)


def test_ladder_gates_take_the_full_width_models():
    """On the card the gates themselves (not forced) take the ladder's
    full-width models at the tools' batches: ViT-H/14 and ViT-g/14 served at
    64 and ViT-H/14 trained at 32 (whole layer; attention block with
    dropout), the d32 / d128 ViT-Bs at 128."""
    bf16 = torch.bfloat16
    for b, n, dim, heads, dh, mlp in ((64, 257, 1280, 16, 80, 5120), (32, 257, 1280, 16, 80, 5120),
                                      (64, 257, 1408, 16, 88, 6144), (128, 197, 768, 24, 32, 3072),
                                      (128, 197, 768, 6, 128, 3072)):
        assert port.whole_layer_supported((b, n, dim), bf16, heads, dh, dim, mlp)
        assert port.fused_dropout_supported((b, n, dim), heads, dh)
        assert not port.stack_attention_supported((b, n, dim), dh)  # the stack keeps ViT-B's head shape


# -- the attention block at the ladder's widest heads ----------------------------

BLOCK_SHAPES = [(257, 2, 80), (257, 2, 88), (197, 2, 128), (197, 4, 32)]  # (n, heads, dim_head)


def _block_arrays(n, heads, dh, seed):
    rng = np.random.default_rng(seed)
    dim = heads * dh
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(
        x=f(BATCH, n, dim), w_qkv=f(dim, 3 * dim, scale=0.05), b_qkv=f(3 * dim, scale=0.05),
        w_out=f(dim, dim, scale=0.05), b_out=f(dim, scale=0.05), ln_s=1.0 + f(dim, scale=0.1),
        ln_b=f(dim, scale=0.1), gq=(1.0 + f(heads, 1, dh, scale=0.2)) * dh**-0.5,
        gk=(1.0 + f(heads, 1, dh, scale=0.2)) * dh**-0.5,
    )


def _names(qk_norm):
    return ["x", "w_qkv", "w_out", "ln_s", "ln_b", "b_qkv", "b_out"] + (["gq", "gk"] if qk_norm else [])


def _port_block(a, names, heads, dh, **kw):
    """Output and gradients of sum(out^2) through the port's block, residual x."""
    kernels = ("w_qkv", "w_out")
    leaves = {n: torch.from_numpy(np.ascontiguousarray(a[n].T) if n in kernels else a[n].copy()).requires_grad_()
              for n in names}
    out = port.fused_attention_block(
        leaves["x"], leaves["x"], leaves["w_qkv"], leaves["w_out"], leaves["ln_s"], leaves["ln_b"], heads=heads,
        dim_head=dh, b_qkv=leaves["b_qkv"], b_out=leaves["b_out"], gamma_q=leaves.get("gq"),
        gamma_k=leaves.get("gk"), **kw,
    )
    grads = torch.autograd.grad((out**2).sum(), [leaves[n] for n in names])
    return out.detach().numpy(), [g.numpy().T if n in kernels else g.numpy() for n, g in zip(names, grads)]


def _check(names, got, want):
    (out, grads), (out_w, grads_w) = got, want
    np.testing.assert_allclose(out, np.asarray(out_w), atol=ATOL, rtol=RTOL, err_msg="out")
    for n, g, w in zip(names, grads, grads_w):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL, err_msg=f"d{n}")


def _jax_grads(loss, a, names):
    grads, out = jax.grad(loss, argnums=tuple(range(len(names))), has_aux=True)(*(jnp.asarray(a[n]) for n in names))
    return out, grads


@pytest.mark.parametrize("n,heads,dh", BLOCK_SHAPES)
@pytest.mark.parametrize("qk_norm", [False, True])
def test_ladder_block_matches_jax_kernel_at_rate_0(n, heads, dh, qk_norm):
    """The block at rate 0 against the JAX block in interpret mode (its
    Pallas ``_kernel`` and ``_bwd_kernel`` at these widths)."""
    a = _block_arrays(n, heads, dh, seed=n + dh + qk_norm)
    names = _names(qk_norm)

    def loss(*values):
        v = dict(zip(names, values))
        out = jax_fb.fused_attention_block(v["x"], v["x"], v["w_qkv"], v["w_out"], v["ln_s"], v["ln_b"], heads=heads,
                                           dim_head=dh, b_qkv=v["b_qkv"], b_out=v["b_out"], gamma_q=v.get("gq"),
                                           gamma_k=v.get("gk"), interpret=True)
        return jnp.sum(out**2), out

    _check(names, _port_block(a, names, heads, dh), _jax_grads(loss, a, names))


def _ref_with_masks(v, heads, dh, akeep, okeep):
    """``_kernel``'s function as an XLA composite with the masks injected
    (tests/test_torch_fused_block.py's, at any width), residual x, both
    biases; with the gammas the qk-norm at sqrt(dh) and scale 1."""
    x = v["x"]
    b, n, dim = x.shape
    inv = 1.0 / (1.0 - RATE)
    mu, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
    ln = (x - mu) * jax.lax.rsqrt(var + 1e-5) * v["ln_s"] + v["ln_b"]
    q, k, vv = jnp.split(ln @ v["w_qkv"] + v["b_qkv"], 3, axis=-1)
    rs = lambda t: t.reshape(b, n, heads, dh).transpose(0, 2, 1, 3)
    q, k, vv = rs(q), rs(k), rs(vv)
    scale = dh**-0.5
    if "gq" in v:
        rms = lambda t, g: (t * jax.lax.rsqrt(jnp.sum(t * t, -1, keepdims=True) + 1e-12) * g.reshape(1, heads, 1, dh)
                            * dh**0.5)
        q, k, scale = rms(q, v["gq"]), rms(k, v["gk"]), 1.0
    p = jax.nn.softmax(jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale, axis=-1)
    p = jnp.where(akeep, p, 0.0) * inv
    o = jnp.einsum("bhnm,bhmd->bhnd", p, vv).transpose(0, 2, 1, 3).reshape(b, n, heads * dh)
    out = jnp.where(okeep, o @ v["w_out"] + v["b_out"], 0.0) * inv
    return out + x


@pytest.mark.parametrize("n,heads,dh", BLOCK_SHAPES[:2])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_ladder_block_with_dropout_matches_jax_composite_with_the_port_masks(n, heads, dh, qk_norm):
    """The block at rate 0.1 (ViT-H/14's training route at dropout 0.1) at
    257 tokens of dh 80 and 88, every gradient against ``jax.grad`` of the
    composite fed the port's two masks."""
    a = _block_arrays(n, heads, dh, seed=7 + n + dh + qk_norm)
    names = _names(qk_norm)
    akeep, okeep = (jnp.asarray(m.numpy().astype(bool))
                    for m in port.dropout_masks(SEED, BATCH, n, heads * dh, heads, RATE, device="cpu"))

    def loss(*values):
        out = _ref_with_masks(dict(zip(names, values)), heads, dh, akeep, okeep)
        return jnp.sum(out**2), out

    _check(names, _port_block(a, names, heads, dh, dropout_rate=RATE, dropout_seed=SEED), _jax_grads(loss, a, names))


@pytest.mark.parametrize("dim_head,n,stacked", [(64, 197, True), (128, 197, False), (64, 257, False)])
def test_stack_keeps_the_narrow_shapes_off_the_cpu(monkeypatch, dim_head, n, stacked):
    """Under ``VIT_TPU_STACK_LAYERS`` a Transformer off the CPU (meta
    tensors here, the card's stand-in) groups its layers into
    ``fused_transformer_stack`` only at the shapes ``stack_layers`` takes
    (dim_head 64, n <= 208); the wide shapes run a whole layer a call."""
    from vit_pytorch_tpu_torch.nn import blocks as torch_blocks

    calls = []
    monkeypatch.setenv("VIT_TPU_STACK_LAYERS", "4")
    monkeypatch.delenv("VIT_TPU_DISABLE_STACK", raising=False)
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "fused_transformer_stack", lambda x, layers, **k: calls.append(len(layers)) or x)
    monkeypatch.setattr(torch_blocks, "fused_transformer_layer", lambda x, *a, **k: calls.append(1) or x)
    dim = 2 * dim_head
    model = torch_blocks.Transformer(dim=dim, depth=4, heads=2, dim_head=dim_head, mlp_dim=2 * dim, device="meta")
    with torch.no_grad():
        model.to(torch.bfloat16).eval()(torch.empty(2, n, dim, device="meta", dtype=torch.bfloat16))
    assert calls == ([4] if stacked else [1, 1, 1, 1])
