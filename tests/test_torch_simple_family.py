"""The port's simple-ViT family (vit_pytorch_tpu_torch/models/simple_vit_1d.py,
simple_vit_3d.py, simple_vit_with_patch_dropout.py, simple_vit_with_fft.py,
simple_flash_attn_vit.py, simple_flash_attn_vit_3d.py,
simple_vit_orthog_residual_update.py, simple_vit_with_hyper_connections.py,
simple_vit_with_value_residual.py, simple_vit_with_specialized_cls.py,
simple_vit_attn_residual.py) against the JAX package on the CPU, fp32, at a
small size (depth 2, dim 128, heads 2, dim_head 64), with the same weights
on both sides (numpy draws at the JAX init's shapes, ``jax.eval_shape``, so
that the zero-initialised parts act; loaded through ``utils/from_jax.py``)
and the same inputs (numpy seed).

Tolerances: logits within 5e-5 absolute (the JAX package's fp32 parity bar)
and 1e-4 relative; gradients of the mean cross-entropy within 5e-5 + 1e-3
relative.  The from_jax maps invert the JAX converters exactly.

On the CPU both sides run their module composites.  The kernel-route test
forces the port's attention-block route (the device test and the kernels'
gate taken as true), so that every ``Attention`` of the models that fuse on
the card runs the block Function on its plain twins, and holds it to the
JAX models too."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.models import simple_flash_attn_vit as j_flash
from vit_pytorch_tpu.models import simple_flash_attn_vit_3d as j_flash_3d
from vit_pytorch_tpu.models import simple_vit_1d as j_1d
from vit_pytorch_tpu.models import simple_vit_3d as j_3d
from vit_pytorch_tpu.models import simple_vit_attn_residual as j_attn_res
from vit_pytorch_tpu.models import simple_vit_orthog_residual_update as j_orthog
from vit_pytorch_tpu.models import simple_vit_with_fft as j_fft
from vit_pytorch_tpu.models import simple_vit_with_hyper_connections as j_hyper
from vit_pytorch_tpu.models import simple_vit_with_patch_dropout as j_pd
from vit_pytorch_tpu.models import simple_vit_with_specialized_cls as j_spec
from vit_pytorch_tpu.models import simple_vit_with_value_residual as j_value
from vit_pytorch_tpu.nn.posemb import posemb_sincos_2d as jax_posemb_2d
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import (
    simple_flash_attn_vit,
    simple_flash_attn_vit_3d,
    simple_vit_1d,
    simple_vit_3d,
    simple_vit_attn_residual,
    simple_vit_orthog_residual_update,
    simple_vit_with_fft,
    simple_vit_with_hyper_connections,
    simple_vit_with_patch_dropout,
    simple_vit_with_specialized_cls,
    simple_vit_with_value_residual,
)
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.nn.patch import PatchDropout
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.utils import from_jax

ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
BATCH, CLASSES = 3, 10
BODY = dict(num_classes=CLASSES, dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)
IMAGE = dict(image_size=32, patch_size=8)  # 16 tokens
VIDEO = dict(image_size=16, image_patch_size=8, frames=4, frame_patch_size=2)  # 8 tokens

# name: (JAX class, port class, from_jax map, the JAX converter or None, constructor extras, input shape, fuses)
MODELS = {
    "1d": (j_1d.SimpleViT, simple_vit_1d.SimpleViT, from_jax.simple_vit_1d_state_dict_from_jax,
           convert.convert_simple_vit_1d, dict(seq_len=64, patch_size=8), (3, 64), True),
    "3d": (j_3d.SimpleViT, simple_vit_3d.SimpleViT, from_jax.simple_vit_3d_state_dict_from_jax,
           convert.convert_simple_vit_3d, VIDEO, (3, 4, 16, 16), True),
    "patch_dropout": (j_pd.SimpleViT, simple_vit_with_patch_dropout.SimpleViT,
                      from_jax.simple_vit_patch_dropout_state_dict_from_jax,
                      convert.convert_simple_vit_with_patch_dropout, dict(**IMAGE, patch_dropout=0.5),
                      (3, 32, 32), True),
    "fft": (j_fft.SimpleViT, simple_vit_with_fft.SimpleViT, from_jax.simple_vit_fft_state_dict_from_jax,
            convert.convert_simple_vit_with_fft, dict(**IMAGE, freq_patch_size=8), (3, 32, 32), True),
    "flash_attn": (j_flash.SimpleViT, simple_flash_attn_vit.SimpleViT,
                   from_jax.simple_flash_attn_vit_state_dict_from_jax, convert.convert_simple_flash_attn_vit, IMAGE,
                   (3, 32, 32), True),
    "flash_attn_3d": (j_flash_3d.SimpleViT, simple_flash_attn_vit_3d.SimpleViT,
                      from_jax.simple_flash_attn_vit_3d_state_dict_from_jax,
                      convert.convert_simple_flash_attn_vit_3d, VIDEO, (3, 4, 16, 16), True),
    "orthog": (j_orthog.SimpleViT, simple_vit_orthog_residual_update.SimpleViT,
               from_jax.simple_vit_orthog_state_dict_from_jax, convert.convert_simple_vit_orthog_residual, IMAGE,
               (3, 32, 32), True),
    "orthog_learned": (j_orthog.SimpleViT, simple_vit_orthog_residual_update.SimpleViT,
                       from_jax.simple_vit_orthog_state_dict_from_jax, None,
                       dict(**IMAGE, orthog_learned=True, orthog_double_precision=False), (3, 32, 32), True),
    "hyper": (j_hyper.SimpleViT, simple_vit_with_hyper_connections.SimpleViT,
              from_jax.simple_vit_hyper_state_dict_from_jax, convert.convert_simple_vit_with_hyper_connections,
              dict(**IMAGE, num_residual_streams=4), (3, 32, 32), True),
    "value_residual": (j_value.SimpleViT, simple_vit_with_value_residual.SimpleViT,
                       from_jax.simple_vit_value_residual_state_dict_from_jax,
                       convert.convert_simple_vit_with_value_residual, IMAGE, (3, 32, 32), False),
    "specialized_cls": (j_spec.SimpleViT, simple_vit_with_specialized_cls.SimpleViT,
                        from_jax.simple_vit_specialized_cls_state_dict_from_jax,
                        convert.convert_simple_vit_with_specialized_cls, IMAGE, (3, 32, 32), False),
    "specialized_qkv": (j_spec.SimpleViT, simple_vit_with_specialized_cls.SimpleViT,
                        from_jax.simple_vit_specialized_cls_state_dict_from_jax, None,
                        dict(**IMAGE, specialize_qkv_depth=1), (3, 32, 32), False),
    "attn_residual": (j_attn_res.SimpleViTAttnResidual, simple_vit_attn_residual.SimpleViTAttnResidual,
                      from_jax.simple_vit_attn_residual_state_dict_from_jax,
                      convert.convert_simple_vit_attn_residual, IMAGE, (3, 32, 32), False),
    "attn_residual_last_query": (j_attn_res.SimpleViTAttnResidual, simple_vit_attn_residual.SimpleViTAttnResidual,
                                 from_jax.simple_vit_attn_residual_state_dict_from_jax,
                                 convert.convert_simple_vit_attn_residual, dict(**IMAGE, learned_query=False),
                                 (3, 32, 32), False),
}
FUSES = [name for name, spec in MODELS.items() if spec[-1]]
CONVERTERS = [name for name, spec in MODELS.items() if spec[3] is not None]


def _inputs(name, seed=0):
    return np.random.default_rng(seed).standard_normal((BATCH, *MODELS[name][5])).astype(np.float32)


def _labels(seed=1):
    return np.random.default_rng(seed).integers(0, CLASSES, BATCH).astype(np.int32)


def _setup(name):
    """The JAX model, its params (numpy draws at the init's shapes: Dense
    kernels N(0, 1 / fan_in), LayerNorm scales 1 + 0.1 N(0, 1), register
    tokens and queries N(0, 1), the hyper-connections' static alpha and beta
    their init (the identity mix) + 0.1 N(0, 1), every other leaf
    0.1 N(0, 1)), and the port's model loaded with them."""
    jax_cls, port_cls, to_torch, _, extra, _, _ = MODELS[name]
    jmodel = jax_cls(**BODY, **extra)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(_inputs(name))))["params"]
    rng = np.random.default_rng(5)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        key = path[-1].key
        if key == "kernel":
            return z / np.float32(np.sqrt(leaf.shape[0]))
        if key in ("register_tokens", "learned_query"):
            return z
        if key in ("static_alpha", "static_beta"):  # HyperConnection's init (JAX :29-35)
            e = leaf.shape[0]
            layer = int(path[-2].key.split("_")[1])
            init = np.ones(e) if key == "static_beta" else np.eye(e, e + 1, 1)
            if key == "static_alpha":
                init[layer % e, 0] = 1.0
            return (init + 0.1 * z).astype(np.float32)
        return 1 + 0.1 * z if key == "scale" else 0.1 * z

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = port_cls(**BODY, **extra, device="cpu")
    model.load_state_dict(to_torch(params), strict=True)
    return jmodel, params, model


def _jax_logits_and_grads(jmodel, params, x, labels, **call):
    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), **call)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean(), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(logits), jax.tree.map(np.asarray, grads)


def _check(name, jmodel, params, model, *, jax_call=None, port_call=None):
    """Eval-mode logits, then training-mode logits and every parameter
    gradient of the mean cross-entropy."""
    x, labels = _inputs(name), _labels()
    port_call = port_call or (lambda m, img: m(img))
    want = np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x)))(params))
    got = port_call(model.eval(), torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if jax_call is None:
        want, jgrads = _jax_logits_and_grads(jmodel, params, x, labels, train=True)
    else:
        want, jgrads = jax_call(x, labels)
    model.train()
    logits = port_call(model, torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    F.cross_entropy(logits, torch.from_numpy(labels).long()).backward()
    want_grads = MODELS[name][2](jgrads)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)


def _patch_dropout_calls(jmodel, params, generator_seed):
    """The patch-dropout model's training calls on the same kept tokens: the
    port's forward with ``torch.Generator().manual_seed(generator_seed)``,
    and the JAX model's own modules with ``take_along_axis`` (its
    ``PatchDropout``, :87-90) on the indices that generator draws."""
    n = (IMAGE["image_size"] // IMAGE["patch_size"]) ** 2
    p = MODELS["patch_dropout"][4]["patch_dropout"]
    keep = jnp.asarray(PatchDropout(p).keep_indices(BATCH, n, torch.Generator().manual_seed(generator_seed)).numpy())

    def forward(mdl, img, keep):
        x = mdl.patch_embedding(mdl.patchify(img))
        x = x + jax_posemb_2d(*mdl.grid_hw, mdl.dim, dtype=x.dtype)
        x = jnp.take_along_axis(x, keep[..., None], axis=1)
        return mdl.linear_head(mdl.transformer(x, train=True).mean(axis=1))

    def jax_call(x, labels):
        def loss(p):
            logits = jmodel.apply({"params": p}, jnp.asarray(x), keep, method=forward)
            return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean(), logits

        (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        return np.asarray(logits), jax.tree.map(np.asarray, grads)

    return jax_call, (lambda m, img: m(img, torch.Generator().manual_seed(generator_seed)))


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Logits (eval and training mode) and every parameter gradient of each
    model against the JAX model with the same weights; patch dropout in
    training on the kept indices the port draws, given to the JAX model's
    own ``take_along_axis``."""
    jmodel, params, model = _setup(name)
    if name != "patch_dropout":
        _check(name, jmodel, params, model)
        return
    jax_call, port_call = _patch_dropout_calls(jmodel, params, 7)
    _check(name, jmodel, params, model, jax_call=jax_call, port_call=port_call)
    model.train()
    keep = max(1, int(16 * (1 - 0.5)))
    assert model.patch_drop(model.embed(torch.from_numpy(_inputs(name))), torch.Generator()).shape[1] == keep


@pytest.mark.parametrize("name", CONVERTERS)
def test_state_dict_round_trip_is_exact(name):
    """Each from_jax map inverts the JAX package's converter of the
    reference layout: the port's state_dict converts back to the very
    params it was loaded from."""
    _, params, model = _setup(name)
    got = jax.tree.map(np.asarray, MODELS[name][3](model.state_dict())["params"])
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", FUSES)
def test_kernel_route_matches_jax(name, monkeypatch):
    """With the device test and the kernels' gate taken as true, every
    ``Attention`` of the models that fuse on the card takes
    ``fused_attention_block`` (its twins on the CPU), with ``residual=x``
    in the SimpleTransformer's and none in the orthogonal update's and the
    hyper-connections' (a strided stream of the mix there); logits and
    every gradient still match the JAX model."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    block, calls = torch_blocks.fused_attention_block, []

    def spy(x, residual, *args, **kwargs):
        calls.append((residual is x, x.is_contiguous()))
        return block(x, residual, *args, **kwargs)

    monkeypatch.setattr(torch_blocks, "fused_attention_block", spy)
    jmodel, params, model = _setup(name)
    port_fb.reset_launch_counts()
    if name == "patch_dropout":
        jax_call, port_call = _patch_dropout_calls(jmodel, params, 7)
        _check(name, jmodel, params, model, jax_call=jax_call, port_call=port_call)
    else:
        _check(name, jmodel, params, model)
    with_residual = not name.startswith(("orthog", "hyper"))
    assert calls == [(with_residual, not name.startswith("hyper"))] * (2 * BODY["depth"])  # eval, then training
    assert not any(port_fb.LAUNCHES.values())


def test_attn_residual_history_api_matches_jax():
    """``history`` in and ``return_history`` out: the same logits and the
    same history entries as the JAX model."""
    jmodel, params, model = _setup("attn_residual")
    x = _inputs("attn_residual")
    prior = np.random.default_rng(3).standard_normal((BATCH, 16, BODY["dim"])).astype(np.float32)
    want, want_hist = jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x), [jnp.asarray(prior)],
                                                     return_history=True))(params)
    got, hist = model.eval()(torch.from_numpy(x), [torch.from_numpy(prior)], return_history=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert len(hist) == len(want_hist) == 2 + 2 * BODY["depth"]
    for a, b in zip(hist, want_hist):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_flash,flash,want", [(True, None, None), (False, None, False), (False, True, True),
                                                  (True, False, False)])
def test_flash_variants_map_use_flash(use_flash, flash, want):
    """``use_flash`` / ``use_flash_attn`` map to ``flash`` as the JAX
    variants map them; an explicit ``flash`` wins."""
    m2 = simple_flash_attn_vit.SimpleViT(**BODY, **IMAGE, use_flash=use_flash, flash=flash, device="cpu")
    m3 = simple_flash_attn_vit_3d.SimpleViT(**BODY, **VIDEO, use_flash_attn=use_flash, flash=flash, device="cpu")
    for m in (m2, m3):
        assert all(attn.flash is want for attn, _ in m.transformer.layers)
