"""The port's NaViT and nested-tensor NaViT (vit_pytorch_tpu_torch/models/)
against the JAX models on the CPU, fp32, at the sizes of
tests/test_na_vit.py:13-25, with the same weights on both sides (JAX init,
loaded through ``utils/from_jax.py``) and the same packed batch (numpy seed).

Tolerances: logits within 5e-5 absolute (the JAX package's fp32 parity
bar) and 1e-4 relative, readings ~2e-6; gradients within 5e-5 + 1e-3
relative (sums over a whole packed batch, readings ~1e-6); packed against
one image a pack within 1e-4, as tests/test_na_vit.py holds the JAX model.
The train step's loss within 5e-5 and its updated params as
tests/test_torch_train.py compares them (Adam's first step is ~lr * sign(g)).

On the CPU both sides run the materialized attention under the segment
mask.  One test forces the port's flash route (the dispatcher's device test
and the kernels' gate taken as true), so that every attention call runs the
flash Function on its plain twins, and holds it to the JAX model too."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.models.na_vit import NaViT as JaxNaViT
from vit_pytorch_tpu.models.na_vit_nested_tensor import NaViT as JaxNestedNaViT
from vit_pytorch_tpu.ops.packing import pack_images as jax_pack_images
from vit_pytorch_tpu.parallel.train import TrainState as JaxTrainState
from vit_pytorch_tpu.parallel.train import make_train_step as jax_make_train_step
from vit_pytorch_tpu_torch.models import na_vit, na_vit_nested_tensor
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.ops import flash_attention as flash
from vit_pytorch_tpu_torch.ops.packing import pack_images
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.utils.from_jax import na_vit_nested_tensor_state_dict_from_jax, na_vit_state_dict_from_jax

KW = dict(image_size=64, patch_size=16, num_classes=11, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)
SIZES = [(64, 64), (32, 32), (32, 64), (64, 32), (16, 16)]
SEQ = 24
ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
LR = 3e-4

MODELS = {
    "na_vit": (JaxNaViT, na_vit.NaViT, na_vit_state_dict_from_jax),
    "nested": (JaxNestedNaViT, na_vit_nested_tensor.NaViT, na_vit_nested_tensor_state_dict_from_jax),
}


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, h, w)).astype(np.float32) for h, w in SIZES]


def _packs(train=False, seed=1):
    """The same packed batch for both sides (token dropout 0.25 when
    training, from the same numpy seed), 4 query slots a pack."""
    kw = dict(max_seq_len=SEQ, token_dropout_prob=0.25 if train else None, train=train, max_images=4)
    return (jax_pack_images(_images(), 16, rng=np.random.default_rng(seed), **kw),
            pack_images(_images(), 16, rng=np.random.default_rng(seed), device="cpu", **kw))


def _setup(name, **model_kw):
    jax_cls, port_cls, to_torch = MODELS[name]
    jpacked, _ = _packs()
    jmodel = jax_cls(**KW, **model_kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jpacked)["params"])
    model = port_cls(**KW, **model_kw, device="cpu")
    model.load_state_dict(to_torch(params), strict=True)
    return jmodel, params, model


def _labels(packed, seed=2):
    """(b, max_images) labels, -1 on empty slots."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, KW["num_classes"], (packed.image_ids.shape[0], packed.max_images)).astype(np.int32)
    return np.where(np.asarray(packed.is_image), labels, -1).astype(np.int32)


def jax_masked_ce(logits, labels):
    """tools/bench_navit_train.py:97-103."""
    valid = labels >= 0
    ls = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.maximum(labels, 0))
    return jnp.sum(ls * valid) / jnp.maximum(jnp.sum(valid), 1)


def masked_ce(logits, labels):
    """The same masked cross-entropy over the (b, max_images) slots."""
    valid = labels >= 0
    ls = F.cross_entropy(logits.float().flatten(0, 1), labels.clamp_min(0).flatten(), reduction="none")
    return (ls.view(labels.shape) * valid).sum() / valid.sum().clamp_min(1)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(name):
    """Every slot of the (b, max_images, classes) output, empty slots (id
    -2, attending nothing) included."""
    jmodel, params, model = _setup(name)
    jpacked, packed = _packs()
    want = np.asarray(jmodel.apply({"params": params}, jpacked))
    got = model.eval()(packed).detach().numpy()
    assert got.shape == (packed.image_ids.shape[0], 4, KW["num_classes"]) and not np.asarray(jpacked.is_image).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_gradients_match_jax(name):
    """Every parameter's gradient of the masked cross-entropy, training mode
    (token dropout 0.25 in the packing)."""
    jmodel, params, model = _setup(name)
    jpacked, packed = _packs(train=True)
    labels = _labels(packed)

    def loss(p):
        return jax_masked_ce(jmodel.apply({"params": p}, jpacked, train=True), jnp.asarray(labels))

    want = {k: v.numpy() for k, v in MODELS[name][2](jax.tree.map(np.asarray, jax.grad(loss)(params))).items()}
    model.train()
    masked_ce(model(packed), torch.from_numpy(labels).long()).backward()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], atol=ATOL, rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_packed_matches_single(name):
    """Packing several images into one sequence gives each the logits it gets
    alone (the segment mask isolates them), as tests/test_na_vit.py holds
    the JAX models; and the logits match the JAX entry points."""
    jmodel, params, model = _setup(name)
    imgs = _images()
    model.eval()
    if name == "na_vit":
        from vit_pytorch_tpu.models.na_vit import forward_packed as jax_forward

        packed = na_vit.forward_packed(model, imgs, group_max_seq_len=64)
        single = na_vit.forward_packed(model, [[im] for im in imgs], group_max_seq_len=64)
        want = np.asarray(jax_forward(jmodel, {"params": params}, imgs, group_max_seq_len=64))
    else:
        from vit_pytorch_tpu.models.na_vit_nested_tensor import forward_images as jax_forward

        packed = na_vit_nested_tensor.forward_images(model, imgs, max_seq_len=64)
        single = na_vit_nested_tensor.forward_images(model, imgs, max_seq_len=16)
        want = jax_forward(jmodel, {"params": params}, imgs, max_seq_len=64)
    assert packed.shape == (len(imgs), KW["num_classes"])
    np.testing.assert_allclose(packed.detach().numpy(), single.detach().numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(packed.detach().numpy(), want, atol=ATOL, rtol=RTOL)


def test_train_step_matches_jax():
    """One ``make_train_step`` step on a ``PackedImages`` with the masked
    loss against the JAX ``make_train_step``: loss, accuracy, updated
    params."""
    jmodel, params, model = _setup("na_vit", token_dropout_prob=0.25)
    jpacked, packed = _packs(train=True)
    labels = _labels(packed)
    grads = na_vit_state_dict_from_jax(jax.tree.map(np.asarray, jax.grad(
        lambda p: jax_masked_ce(jmodel.apply({"params": p}, jpacked, train=True), jnp.asarray(labels)))(params)))

    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=optax.adam(LR))
    step = jax_make_train_step(jmodel, jax_masked_ce, donate=False)
    state, want = step(state, jpacked, jnp.asarray(labels), jax.random.PRNGKey(1))
    new = na_vit_state_dict_from_jax(jax.tree.map(np.asarray, state.params))

    port_state = port_train.create_train_state(model)
    got = port_train.make_train_step(model, masked_ce)(port_state, packed, torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=ATOL, rtol=RTOL)
    assert float(got["accuracy"]) == pytest.approx(float(want["accuracy"]), abs=1e-6)
    for k, p in model.named_parameters():
        g, upd, w = grads[k].numpy(), p.detach().numpy(), new[k].numpy()
        big = np.abs(g) > 1e-5
        np.testing.assert_allclose(upd[big], w[big], atol=1e-6, rtol=0, err_msg=k)
        assert np.all(np.abs(upd - w) <= 2 * LR), k


def test_packed_input_refuses_grad_accum():
    _, packed = _packs()
    model = na_vit.NaViT(**KW, device="cpu")
    step = port_train.make_train_step(model, masked_ce, grad_accum=2)
    with pytest.raises(ValueError, match="PackedImages"):
        step(port_train.create_train_state(model), packed, torch.zeros(packed.image_ids.shape[0], 4).long())


def test_flash_route_matches_jax(monkeypatch):
    """With the device test and the kernels' gate taken as true, each of the
    depth + 1 attention calls of a forward (the layers and attn_pool) runs
    the flash Function on its twins; logits and gradients still match JAX."""
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    calls, real = [], flash.flash_attention

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(type(out.grad_fn).__name__)
        return out

    monkeypatch.setattr(attention, "flash_attention", spy)
    jmodel, params, model = _setup("na_vit")
    jpacked, packed = _packs(train=True)
    labels = _labels(packed)
    model.train()
    logits = model(packed)
    assert calls == ["_FlashAttentionBackward"] * (KW["depth"] + 1)
    want = np.asarray(jmodel.apply({"params": params}, jpacked, train=True))
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    masked_ce(logits, torch.from_numpy(labels).long()).backward()
    grads = na_vit_state_dict_from_jax(jax.tree.map(np.asarray, jax.grad(
        lambda p: jax_masked_ce(jmodel.apply({"params": p}, jpacked, train=True), jnp.asarray(labels)))(params)))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)


def test_state_dict_maps_cover_every_parameter():
    """The maps name every port parameter, with the JAX module structure:
    the fused to_qkv in the Transformer, split to_q/to_kv in attn_pool."""
    for name in MODELS:
        _, params, model = _setup(name)
        sd = MODELS[name][2](params)
        assert set(sd) == set(model.state_dict())
    keys = set(na_vit.NaViT(**KW, device="cpu").state_dict())
    assert {"transformer.layers.0.0.to_qkv.weight", "attn_pool.to_q.weight", "attn_pool.to_kv.weight",
            "transformer.layers.1.0.q_norm.gamma", "attn_pool.k_norm.gamma"} <= keys
    assert not any(k.endswith("norm.bias") or k == "mlp_head.bias" for k in keys)  # bias-free


def test_block_predicates(monkeypatch):
    """The JAX conditions the port's predicates gained: context and
    segments refuse the attention-block kernels (JAX blocks.py:73-98), and
    qk-norm refuses the whole layer (:647)."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    x = torch.zeros(2, 197, 768, dtype=torch.bfloat16)
    common = dict(x=x, heads=12, dim_head=64, dim=768, flash=None, project_out=True)
    assert torch_blocks.fused_block_eligible(**common)
    assert not torch_blocks.fused_block_eligible(**common, has_context=True)
    assert not torch_blocks.fused_block_eligible(**common, has_segments=True)
    assert not torch_blocks.fused_block_eligible(**common, force_split_qkv=True)
    kw = dict(dim=768, depth=1, heads=12, dim_head=64, mlp_dim=3072, dtype=torch.bfloat16, device="meta")
    assert torch_blocks.Transformer(**kw).whole_layer_eligible(x)
    assert not torch_blocks.Transformer(**kw).whole_layer_eligible(x, has_segments=True)
    assert not torch_blocks.Transformer(**kw, qk_norm=True).whole_layer_eligible(x)


def test_qk_norm_without_segments_names_its_slice(monkeypatch):
    """The case the JAX package fuses and the port could not before its
    qk-norm slice: qk-norm self-attention with no segments or context
    (SimpleViT with qk-norm) takes the attention-block kernels (their twins
    on the CPU), which now run the qk-norm and agree with the module
    composite within 5e-5; with segments the call keeps the flash route."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    block, calls = torch_blocks.fused_attention_block, []
    monkeypatch.setattr(torch_blocks, "fused_attention_block", lambda *a, **k: calls.append(1) or block(*a, **k))
    layer = torch_blocks.Transformer(64, 1, 4, 16, 128, qk_norm=True)
    x = torch.randn(1, 5, 64, generator=torch.Generator().manual_seed(0))
    fused = layer(x)
    assert calls == [1]
    for attn, _ in layer.layers:
        attn.flash = False  # the module composite
    torch.testing.assert_close(fused, layer(x), atol=ATOL, rtol=RTOL)
    assert calls == [1]
    segs = torch.zeros(1, 5, dtype=torch.int32)
    assert layer(torch.zeros(1, 5, 64), q_segment_ids=segs, kv_segment_ids=segs).shape == (1, 5, 64)
