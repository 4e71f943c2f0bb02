"""The port's 3-D NaViT (vit_pytorch_tpu_torch/models/na_vit_nested_tensor_3d.py)
against the JAX model on the CPU, fp32, at the sizes of
tests/test_models_smoke5.py:47-69, with the same weights on both sides (JAX
init, loaded through ``utils/from_jax.py``) and the same packed batch.

``pack_volumes`` gives the JAX function's arrays bit for bit from the same
numpy seed, with and without token dropout.  Logits within 5e-5 absolute
and 1e-4 relative, gradients within 5e-5 + 1e-3 relative (the bars of
tests/test_torch_na_vit.py), on the composite and on the flash route forced
on the CPU (the flash Function on its twins); a video packed with others
gets the logits it gets alone within 1e-4 (the JAX test's bar); one
``make_train_step`` step takes a ``PackedVolumes`` with the masked loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_pytorch_tpu.models.na_vit_nested_tensor_3d import NaViT as JaxNaViT3d
from vit_pytorch_tpu.models.na_vit_nested_tensor_3d import pack_volumes as jax_pack_volumes
from vit_pytorch_tpu_torch.models import na_vit_nested_tensor_3d as navit3d
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.utils.from_jax import na_vit_nested_tensor_3d_state_dict_from_jax as to_torch

KW = dict(image_size=32, max_frames=4, patch_size=16, frame_patch_size=2, num_classes=11, dim=32, depth=2, heads=2,
          dim_head=16, mlp_dim=64, num_registers=2)
SHAPES = [(3, 4, 32, 32), (3, 2, 16, 16), (3, 2, 32, 16), (3, 4, 16, 32), (3, 2, 32, 32)]
SEQ = 12  # two packs of the five videos (8 + 1 + 2 and 4 + 4 patches), an empty query slot
ATOL, RTOL, GRAD_RTOL = 5e-5, 1e-4, 1e-3


def _volumes(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _packs(train=False, max_videos=None, seed=1):
    kw = dict(max_seq_len=SEQ, max_videos=max_videos, token_dropout_prob=0.25 if train else None, train=train)
    return (jax_pack_volumes(_volumes(), 16, 2, rng=np.random.default_rng(seed), **kw),
            navit3d.pack_volumes(_volumes(), 16, 2, rng=np.random.default_rng(seed), device="cpu", **kw))


def _setup():
    jpacked, _ = _packs()
    jmodel = JaxNaViT3d(**KW)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jpacked)["params"])
    model = navit3d.NaViT(**KW, device="cpu")
    model.load_state_dict(to_torch(params), strict=True)
    return jmodel, params, model


def _labels(packed, seed=2):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, KW["num_classes"], (packed.segment_ids.shape[0], packed.max_videos))
    return np.where(np.asarray(packed.is_video), labels, -1).astype(np.int32)


def _jax_masked_ce(logits, labels):
    valid = labels >= 0
    ls = -jnp.take_along_axis(jax.nn.log_softmax(logits, -1), jnp.maximum(labels, 0)[..., None], -1)[..., 0]
    return jnp.sum(ls * valid) / jnp.maximum(jnp.sum(valid), 1)


def _masked_ce(logits, labels):
    valid = labels >= 0
    ls = F.cross_entropy(logits.float().flatten(0, 1), labels.clamp_min(0).flatten(), reduction="none")
    return (ls.view(labels.shape) * valid).sum() / valid.sum().clamp_min(1)


def _force_flash(monkeypatch):
    """The dispatcher's device test and the kernels' gate taken as true:
    every attention call runs the flash Function on its twins."""
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)


@pytest.mark.parametrize("train,max_videos", [(False, None), (True, None), (False, 4)])
def test_pack_volumes_matches_jax(train, max_videos):
    jpacked, packed = _packs(train, max_videos)
    for name in ("patches", "pos_fhw", "segment_ids", "num_videos"):
        want, got = np.asarray(getattr(jpacked, name)), getattr(packed, name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert packed.max_videos == jpacked.max_videos
    assert np.array_equal(packed.is_video.numpy(), np.asarray(jpacked.is_video))
    assert packed.segment_ids.shape[0] > 1 and (packed.segment_ids == -1).any()  # several packs, padding


@pytest.mark.parametrize("route", ["composite", "flash"])
def test_logits_match_jax(monkeypatch, route):
    """Every slot of the (b, max_videos, classes) output, empty slots (id
    -2) included."""
    if route == "flash":
        _force_flash(monkeypatch)
    jmodel, params, model = _setup()
    jpacked, packed = _packs()
    want = np.asarray(jmodel.apply({"params": params}, jpacked))
    got = model.eval()(packed).detach().numpy()
    assert got.shape == (packed.segment_ids.shape[0], packed.max_videos, KW["num_classes"])
    assert not np.asarray(jpacked.is_video).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("route", ["composite", "flash"])
def test_gradients_match_jax(monkeypatch, route):
    """Every parameter's gradient of the masked cross-entropy, training mode
    (token dropout 0.25 in the packing)."""
    if route == "flash":
        _force_flash(monkeypatch)
    jmodel, params, model = _setup()
    jpacked, packed = _packs(train=True)
    labels = _labels(packed)
    grads = jax.grad(lambda p: _jax_masked_ce(jmodel.apply({"params": p}, jpacked, train=True),
                                              jnp.asarray(labels)))(params)
    want = {k: v.numpy() for k, v in to_torch(jax.tree.map(np.asarray, grads)).items()}
    model.train()
    _masked_ce(model(packed), torch.from_numpy(labels).long()).backward()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], atol=ATOL, rtol=GRAD_RTOL, err_msg=k)


def test_packed_matches_single():
    """tests/test_models_smoke5.py:64-69: a video packed with others gets the
    logits it gets alone, on both sides; ``forward_volumes`` returns the real
    videos' rows in order."""
    jmodel, params, model = _setup()
    model.eval()
    vols = _volumes()
    together = navit3d.forward_volumes(model, vols, max_seq_len=SEQ)
    assert together.shape == (len(vols), KW["num_classes"])
    alone = torch.cat([navit3d.forward_volumes(model, [v], max_seq_len=SEQ) for v in vols])
    np.testing.assert_allclose(together.detach().numpy(), alone.detach().numpy(), atol=1e-4, rtol=1e-4)
    jpacked = jax_pack_volumes(vols, 16, 2, max_seq_len=SEQ)
    want = np.asarray(jmodel.apply({"params": params}, jpacked))[np.asarray(jpacked.is_video)]
    np.testing.assert_allclose(together.detach().numpy(), want, atol=ATOL, rtol=RTOL)


def test_train_step_takes_packed_volumes():
    """One ``make_train_step`` step on a ``PackedVolumes``: the loss of the
    JAX model and the gradients it used; ``grad_accum`` > 1 refuses a packed
    batch."""
    jmodel, params, model = _setup()
    jpacked, packed = _packs(train=True)
    labels = _labels(packed)
    loss, grads = jax.value_and_grad(lambda p: _jax_masked_ce(jmodel.apply({"params": p}, jpacked, train=True),
                                                              jnp.asarray(labels)))(params)
    want = to_torch(jax.tree.map(np.asarray, grads))
    metrics = port_train.make_train_step(model, _masked_ce)(port_train.create_train_state(model), packed,
                                                            torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), atol=ATOL, rtol=RTOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)
    step = port_train.make_train_step(model, _masked_ce, grad_accum=2)
    with pytest.raises(ValueError, match="PackedVolumes"):
        step(port_train.create_train_state(model), packed, torch.from_numpy(labels).long())


def test_state_dict_map_covers_every_parameter():
    _, params, model = _setup()
    assert set(to_torch(params)) == set(model.state_dict())
    keys = set(model.state_dict())
    assert {"pos_embed_frame", "register_tokens", "attn_pool.to_k.weight", "transformer.layers.1.0.q_norm.weight",
            "patch_norm_pre.bias"} <= keys


def test_entry_points_build_on_the_card_unless_told(monkeypatch):
    """The model and the packer take the CUDA card when the caller names no
    device, and raise on a machine without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        navit3d.NaViT(**KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        navit3d.pack_volumes(_volumes(), 16, 2, max_seq_len=SEQ)
    assert navit3d.pack_volumes(_volumes(), 16, 2, max_seq_len=SEQ, device="cpu").device.type == "cpu"
