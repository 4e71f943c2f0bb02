"""The port's ViViT (vit_pytorch_tpu_torch/models/vivit.py) and the ``mask``
keyword of its Attention and Transformer (nn/blocks.py) against the JAX
package on the CPU, fp32, at tests/test_models_smoke3.py:113-131's size
(32 x 32 frames, patch 8, 4 frames, frame patch 2, dim 32, heads 2,
dim_head 64: heads x dim_head = 128 is not dim), with the same weights on
both sides (JAX init, loaded through ``utils/from_jax.py``) and the same
videos (numpy seed).

Tolerances: logits within 5e-5 absolute (the JAX package's fp32 parity bar)
and 1e-4 relative; gradients within 5e-5 + 1e-3 relative.

On the CPU both sides run their module composites.  The kernel-route test
forces the kernel routes of both packages (the device tests and the
kernels' gates taken as true, the JAX kernels in interpret mode): every
Transformer layer runs the whole-layer Function and every attention of the
factorized self-attention the attention-block Function, the port's on their
plain twins, at inner != dim; a frame mask keeps the temporal attention on
the composite."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.models.vivit import ViViT as JaxViViT
from vit_pytorch_tpu.nn import blocks as jax_blocks
from vit_pytorch_tpu.nn.blocks import Transformer as JaxTransformer
from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu.utils.convert import convert_vivit
from vit_pytorch_tpu_torch.models.vivit import ViViT
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax, vivit_state_dict_from_jax

KW = dict(image_size=32, image_patch_size=8, frames=4, frame_patch_size=2, num_classes=7, dim=32, spatial_depth=1,
          temporal_depth=1, heads=2, mlp_dim=64)
MASK = np.array([[True, True, True, False], [True] * 4])
ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
CASES = [(variant, pool) for variant in ("factorized_encoder", "factorized_self_attention") for pool in ("cls", "mean")]


def _videos(batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 3, 4, 32, 32)).astype(np.float32)


def _labels(batch=2, seed=1):
    return np.random.default_rng(seed).integers(0, KW["num_classes"], batch).astype(np.int32)


def _setup(variant, pool):
    kw = dict(KW, variant=variant, pool=pool)
    jmodel = JaxViViT(**kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(_videos()))["params"])
    model = ViViT(**kw, device="cpu")
    model.load_state_dict(vivit_state_dict_from_jax(params), strict=True)
    return jmodel, params, model


def _check(jmodel, params, model, mask):
    """Logits in evaluation, then every parameter gradient of the mean
    cross-entropy in training mode, with or without the frame mask."""
    vid, labels = _videos(), _labels()
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(vid), mask=jmask))
    got = model.eval()(torch.from_numpy(vid), mask=tmask).detach().numpy()
    assert got.shape == (2, KW["num_classes"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(vid), mask=jmask, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    want_grads = vivit_state_dict_from_jax(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    model.train()
    F.cross_entropy(model(torch.from_numpy(vid), mask=tmask), torch.from_numpy(labels).long()).backward()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)
    return got


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant,pool", CASES)
def test_vivit_matches_jax(variant, pool, masked):
    jmodel, params, model = _setup(variant, pool)
    _check(jmodel, params, model, MASK if masked else None)


def test_mask_changes_the_logits():
    """The frame mask reaches the temporal attention: the masked video's
    logits differ, the all-real one's do not."""
    _, _, model = _setup("factorized_encoder", "cls")
    vid = torch.from_numpy(_videos())
    with torch.no_grad():
        plain, masked = model.eval()(vid), model(vid, mask=torch.from_numpy(MASK))
    assert not torch.allclose(plain[0], masked[0])
    torch.testing.assert_close(plain[1], masked[1])


def _force_kernel_routes(monkeypatch):
    """Take the device tests and the kernels' gates as true on both sides,
    run the JAX kernels in interpret mode, and count the port's calls of the
    whole-layer and attention-block Functions."""
    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_fb, "whole_layer_supported", lambda *a, **k: True)
    for name in ("fused_transformer_layer", "fused_attention_block"):
        orig = getattr(jax_blocks, name)
        monkeypatch.setattr(jax_blocks, name, lambda *a, _orig=orig, **k: _orig(*a, **k, interpret=True))
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    calls = {"layer": [], "block": []}
    layer, block = torch_blocks.fused_transformer_layer, torch_blocks.fused_attention_block

    def layer_spy(x, *args, **kwargs):
        calls["layer"].append(tuple(x.shape))
        return layer(x, *args, **kwargs)

    def block_spy(x, *args, **kwargs):
        calls["block"].append(tuple(x.shape))
        return block(x, *args, **kwargs)

    monkeypatch.setattr(torch_blocks, "fused_transformer_layer", layer_spy)
    monkeypatch.setattr(torch_blocks, "fused_attention_block", block_spy)
    return calls


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", ["factorized_encoder", "factorized_self_attention"])
def test_kernel_route_matches_jax(variant, masked, monkeypatch):
    """With the kernel routes forced, ViViT (cls pool) still matches the JAX
    model on its kernel routes, logits and every gradient; the spies see
    each kernel call: the spatial (b f, 1 + 16, dim) and temporal (b, 1 + 2,
    dim) whole layers, or
    the factorized self-attention's spatial (b f, 17, dim) and temporal
    (b 17, 2, dim) blocks; with the mask, the temporal ones take the
    composite."""
    calls = _force_kernel_routes(monkeypatch)
    jmodel, params, model = _setup(variant, "cls")
    port_fb.reset_launch_counts()
    _check(jmodel, params, model, MASK if masked else None)
    assert not any(port_fb.LAUNCHES.values())  # CPU tensors: the twins
    b, f, n, d = 2, 2, 17, KW["dim"]
    if variant == "factorized_encoder":
        want = {"layer": [(b * f, n, d)] + ([] if masked else [(b, f + 1, d)]), "block": []}
    else:
        want = {"layer": [], "block": [(b * f, n, d)] + ([] if masked else [(b * n, f, d)])}
    # the eval forward, then the training forward
    assert calls == {k: v * 2 for k, v in want.items()}


def test_state_dict_round_trip_is_exact():
    """The ViViT map inverts the JAX package's ``convert_vivit`` (the
    reference layout of the factorized encoder)."""
    _, params, model = _setup("factorized_encoder", "cls")
    got = jax.tree.map(np.asarray, convert_vivit(model.state_dict())["params"])
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


def test_a_mask_refuses_the_kernels(monkeypatch):
    """``fused_block_eligible(has_mask=True)`` and
    ``Transformer.whole_layer_eligible`` with a mask read False where the
    same calls without one read True (the JAX blocks.py:82 and :628)."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    x = torch.zeros(2, 9, 32)
    kw = dict(x=x, heads=2, dim_head=64, dim=32, flash=None, project_out=True)
    assert torch_blocks.fused_block_eligible(**kw)
    assert not torch_blocks.fused_block_eligible(**kw, has_mask=True)
    t = torch_blocks.Transformer(32, 1, 2, 64, 64, device="cpu")
    assert t.whole_layer_eligible(x)
    assert not t.whole_layer_eligible(x, has_mask=True)
    attn = t.layers[0][0]
    assert attn.fuses(x) and not attn.fuses(x, has_mask=True)


@pytest.mark.parametrize("fully_masked_row", [False, True])
def test_masked_transformer_matches_jax(fully_masked_row):
    """``Transformer(x, mask=...)`` against the JAX ``Transformer(mask=...)``
    with a (b, 1, 1, n) key mask: output and every gradient; a row with no
    key attended gives zeros on both sides."""
    dim, depth, heads, dim_head, mlp = 32, 2, 2, 64, 64
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 9, dim)).astype(np.float32)
    mask = rng.random((3, 1, 1, 9)) > 0.4
    mask[:, ..., 0] = True
    if fully_masked_row:
        mask[1] = False
    jt = JaxTransformer(dim=dim, depth=depth, heads=heads, dim_head=dim_head, mlp_dim=mlp)
    params = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    state = {k.removeprefix("transformer."): v for k, v in vit_state_dict_from_jax({"transformer": params}).items()}
    t = torch_blocks.Transformer(dim, depth, heads, dim_head, mlp, device="cpu")
    t.load_state_dict(state, strict=True)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def f(p, xx):
        return jnp.sum(jt.apply({"params": p}, xx, mask=jnp.asarray(mask)) * g)

    want = jt.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask))
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = t(xt, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL, rtol=GRAD_RTOL)
    want_grads = {k.removeprefix("transformer."): v
                  for k, v in vit_state_dict_from_jax({"transformer": jax.tree.map(np.asarray, gp)}).items()}
    for k, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)


def test_entry_point_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViViT(**KW)
