"""The port's ``Attention`` called with a context, built with the JAX
package's own keywords (vit_pytorch_tpu_torch/nn/blocks.py): an option that
acts only on a context (``kv_include_self``, ``norm_context``) builds the
split ``to_q`` / ``to_kv`` projections, as the JAX module builds them at its
first call with a context (vit_pytorch_tpu/nn/blocks.py:451-458), with no
``force_split_qkv``.  Held against the JAX ``Attention`` at fp32 on the
CPU at the three call sites that build it so (the JAX models/cross_vit.py,
xcit.py and simple_vit_attn_residual.py), the weights drawn at the JAX
init's shapes and carried over by ``utils/from_jax.py``'s key names; output
within 5e-5 and every gradient within 5e-5 + 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from vit_pytorch_tpu.nn import blocks as jax_blocks
from vit_pytorch_tpu_torch.models import simple_vit_attn_residual
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.utils import from_jax

DIM, HEADS, DH = 64, 2, 32
# (keywords as the JAX call site passes them, the query's and the context's
# token counts, the port's layout of to_out)
SITES = {
    # cross_vit.py:74-99, each branch's cls token attending the other's patches
    "cross_vit": (dict(heads=HEADS, dim_head=DH, dropout=0.0, kv_include_self=True, project_out=True), 1, 9),
    # xcit.py:201-209, the class-attention layers: the cls token over the patches
    "xcit": (dict(heads=HEADS, dim_head=DH, dropout=0.0, kv_include_self=True, project_out=True), 1, 16),
    # simple_vit_attn_residual.py:42-50, a query per token over its history
    "attn_residual_pool": (dict(heads=HEADS, dim_head=DH, norm_context=True, out_bias=False, project_out=True), 1, 5),
}
MODULES = ((r"(norm|norm_context|to_q|to_kv)", r"\1"), (r"to_out", "to_out.0"))


@pytest.mark.parametrize("site", list(SITES))
def test_context_call_matches_jax(site):
    """The port's module of the call site's keywords, called with a
    context: output and every gradient against the JAX module's, in eval
    and training mode."""
    opts, n, m = SITES[site]
    x, ctx = tp.inputs((3, n, DIM), 1), tp.inputs((3, m, DIM), 2)
    g = tp.inputs((3, n, DIM), 3)
    jattn = jax_blocks.Attention(dim=DIM, **opts)
    params = tp.draw_params(jattn, jnp.asarray(x), context=jnp.asarray(ctx))
    assert "to_q" in params and "to_kv" in params and "to_qkv" not in params
    tattn = torch_blocks.Attention(DIM, **opts, device="cpu")
    assert tattn.split_qkv and not tattn.force_split_qkv
    tattn.load_state_dict(from_jax._state_dict(params, MODULES, ()), strict=True)

    def jloss(p, x, ctx):
        return jnp.sum(jattn.apply({"params": p}, x, context=ctx, train=True) * jnp.asarray(g))

    want = jattn.apply({"params": params}, jnp.asarray(x), context=jnp.asarray(ctx))
    jgrads, jdx, jdctx = jax.grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(x), jnp.asarray(ctx))
    tx, tctx = (torch.from_numpy(a).requires_grad_() for a in (x, ctx))
    tp.assert_close(tattn.eval()(tx, context=tctx), want)
    out = tattn.train()(tx, context=tctx)
    tp.assert_close(out, want)
    (out * torch.from_numpy(g)).sum().backward()
    want_grads = from_jax._state_dict(jax.tree.map(np.asarray, jgrads), MODULES, ())
    for k, p in tattn.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=tp.ATOL, rtol=tp.GRAD_RTOL, err_msg=k)
    for got, want in ((tx.grad, jdx), (tctx.grad, jdctx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tp.ATOL, rtol=tp.GRAD_RTOL)


def test_context_needs_split_projections():
    """A module built with none of the options that imply the split
    projections still refuses a context, and its message names
    ``force_split_qkv``; with it the call goes through."""
    x, ctx = torch.randn(2, 1, DIM), torch.randn(2, 4, DIM)
    with pytest.raises(ValueError, match="force_split_qkv"):
        torch_blocks.Attention(DIM, heads=HEADS, dim_head=DH, device="cpu")(x, context=ctx)
    attn = torch_blocks.Attention(DIM, heads=HEADS, dim_head=DH, force_split_qkv=True, device="cpu")
    assert attn(x, context=ctx).shape == (2, 1, DIM)
    for opts in (dict(norm_context=True), dict(kv_include_self=True)):
        attn = torch_blocks.Attention(DIM, heads=HEADS, dim_head=DH, **opts, device="cpu")
        assert {"to_q.weight", "to_kv.weight"} <= set(attn.state_dict()) and "to_qkv.weight" not in attn.state_dict()


def test_split_projections_refuse_the_kernels(monkeypatch):
    """The implied split projections refuse the attention-block kernels, as
    ``force_split_qkv`` does (the kernels take one fused to_qkv)."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    x = torch.randn(2, 5, DIM)
    assert torch_blocks.Attention(DIM, heads=HEADS, dim_head=DH, device="cpu").fuses(x)
    for opts in (dict(norm_context=True), dict(kv_include_self=True), dict(force_split_qkv=True)):
        assert not torch_blocks.Attention(DIM, heads=HEADS, dim_head=DH, **opts, device="cpu").fuses(x)


def test_attn_residual_pool_layout_is_unchanged():
    """The attention-residual model's history pools, built with JAX's
    keywords alone now, keep their state_dict keys (``attn.norm``,
    ``attn.norm_context``, ``attn.to_q``, ``attn.to_kv``, ``attn.to_out``)."""
    model = simple_vit_attn_residual.SimpleViTAttnResidual(
        image_size=32, patch_size=8, num_classes=10, dim=DIM, depth=2, heads=HEADS, mlp_dim=128, dim_head=DH,
        device="cpu")
    keys = {k.split("attn.", 1)[1] for k in model.state_dict() if "final_pool.attn." in k}
    assert keys == {"norm.weight", "norm.bias", "norm_context.weight", "norm_context.bias", "to_q.weight",
                    "to_kv.weight", "to_out.weight"}
