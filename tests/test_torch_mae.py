"""The port's MAE (vit_pytorch_tpu_torch/ssl/mae.py) and the encoder
protocol of its ViT against the JAX package on the CPU, fp32, at
tests/test_models_smoke.py:139-140's size (ViT 64 x 64, patch 16, dim 32,
depth 2, heads 2, dim_head 64; decoder_dim 24, depth 1, masking 0.75), and
with ``decoder_dim == dim`` (no ``enc_to_dec``) and ``pool="mean"``, with
the same weights on both sides (JAX init, loaded through
``utils/from_jax.py``), the same images (numpy seed) and the same
``rand_indices``.

Tolerances: the loss within 5e-5 absolute (the JAX package's fp32 parity
bar) and 1e-4 relative; gradients within 5e-5 + 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pytorch_tpu_torch
from vit_pytorch_tpu import ViT as JaxViT
from vit_pytorch_tpu.nn import blocks as jax_blocks
from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu.ssl.mae import MAE as JaxMAE
from vit_pytorch_tpu.utils.convert import convert_mae
from vit_pytorch_tpu_torch import MAE, ViT
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.utils.from_jax import mae_state_dict_from_jax

ENC = dict(image_size=64, patch_size=16, num_classes=10, dim=32, depth=2, heads=2, mlp_dim=64)
CASES = {
    "enc_to_dec": (dict(), dict(decoder_dim=24, masking_ratio=0.75, decoder_depth=1)),
    "equal_dims_mean": (dict(pool="mean"), dict(decoder_dim=32, masking_ratio=0.75, decoder_depth=1)),
}
ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
N_PATCHES = 16


def _images(batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 3, 64, 64)).astype(np.float32)


def _rand_indices(batch=2, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(N_PATCHES) for _ in range(batch)]).astype(np.int32)


def _setup(case):
    enc_kw, mae_kw = CASES[case]
    jmae = JaxMAE(encoder=JaxViT(**ENC, **enc_kw), **mae_kw)
    params = jmae.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, jnp.asarray(_images()))
    params = jax.tree.map(np.asarray, params["params"])
    mae = MAE(encoder=ViT(**ENC, **enc_kw, device="cpu"), **mae_kw, device="cpu")
    missing, unexpected = mae.load_state_dict(mae_state_dict_from_jax(params), strict=False)
    # MAE never calls the encoder's head, so the JAX tree has none
    assert sorted(missing) == ["encoder.mlp_head.bias", "encoder.mlp_head.weight"] and not unexpected
    return jmae, params, mae


def _check(jmae, params, mae):
    img, idx = _images(), _rand_indices()
    loss_fn = lambda p: jmae.apply({"params": p}, jnp.asarray(img), rand_indices=jnp.asarray(idx))
    want, grads = jax.value_and_grad(loss_fn)(params)
    got = mae(torch.from_numpy(img), rand_indices=torch.from_numpy(idx))
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=RTOL)
    got.backward()
    want_grads = mae_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    checked = 0
    for k, p in mae.named_parameters():
        if k.startswith("encoder.mlp_head"):
            assert p.grad is None
            continue
        checked += 1
        if p.grad is None:  # the cls token, which MAE never reads: zeros on the JAX side
            assert k == "encoder.cls_token" and not want_grads[k].any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)
    assert checked == len(want_grads)


@pytest.mark.parametrize("case", list(CASES))
def test_mae_matches_jax(case):
    """The loss and every gradient, with the same ``rand_indices``; the
    ``enc_to_dec`` projection exists only where the widths differ."""
    jmae, params, mae = _setup(case)
    assert (mae.enc_to_dec is None) == (case == "equal_dims_mean") == ("enc_to_dec" not in params)
    _check(jmae, params, mae)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_route_matches_jax(case, monkeypatch):
    """The encoder's and decoder's Transformers on the forced whole-layer
    route of both packages (the device tests and the gates taken as true,
    the JAX kernels in interpret mode; the port's Function on its plain
    twins, inner 128 against dims 32 and 24): the loss and every gradient
    match, and each layer of both took the whole-layer Function, on the
    encoder's contiguous (b, 4, 32) unmasked tokens and the decoder's (b,
    16, decoder_dim) sequence."""
    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_fb, "whole_layer_supported", lambda *a, **k: True)
    orig = jax_blocks.fused_transformer_layer
    monkeypatch.setattr(jax_blocks, "fused_transformer_layer", lambda *a, **k: orig(*a, **k, interpret=True))
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    calls, layer = [], torch_blocks.fused_transformer_layer

    def spy(x, *args, **kwargs):
        calls.append((tuple(x.shape), x.is_contiguous()))
        return layer(x, *args, **kwargs)

    monkeypatch.setattr(torch_blocks, "fused_transformer_layer", spy)
    jmae, params, mae = _setup(case)
    _check(jmae, params, mae)
    dec = CASES[case][1]["decoder_dim"]
    assert calls == [((2, 4, 32), True)] * ENC["depth"] + [((2, N_PATCHES, dec), True)]


def test_mae_is_exported_from_the_package():
    assert vit_pytorch_tpu_torch.MAE is MAE and "MAE" in vit_pytorch_tpu_torch.__all__


def test_state_dict_round_trip_is_exact():
    """The MAE map inverts the JAX package's ``convert_mae`` (the encoder
    under ``encoder/``): the port's state_dict converts back to the params
    it was loaded from, the encoder's head aside."""
    _, params, mae = _setup("enc_to_dec")
    state = {k: v for k, v in mae.state_dict().items() if not k.startswith("encoder.mlp_head")}
    got = jax.tree.map(np.asarray, convert_mae(state)["params"])
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


def test_encoder_protocol():
    """The port ViT exposes what MAE reads, on its own modules: patchify is
    ``to_patch_embedding[0]``, patch_embedding ``[1:]``, and patchify then
    patch_embedding is the ViT's own patch embedding."""
    vit = ViT(**ENC, device="cpu")
    assert (vit.dim, vit.patch_size, vit.image_size, vit.channels, vit.pool) == (32, 16, 64, 3, "cls")
    img = torch.from_numpy(_images())
    patches = vit.patchify(img)
    assert patches.shape == (2, N_PATCHES, 3 * 16 * 16)
    assert all(a is b for a, b in zip(vit.patch_embedding, list(vit.to_patch_embedding)[1:]))
    assert torch.equal(vit.patch_embedding(patches), vit.to_patch_embedding(img))
    assert not any(k.startswith("patch_embedding") for k in vit.state_dict())


def test_generator_draws_the_permutation():
    """Without ``rand_indices`` the permutation comes from the generator:
    the same seed gives the same loss, another seed another; the loss with
    the generator's own permutation passed in is the same."""
    _, _, mae = _setup("enc_to_dec")
    img = torch.from_numpy(_images())
    with torch.no_grad():
        a = mae(img, generator=torch.Generator().manual_seed(5))
        b = mae(img, generator=torch.Generator().manual_seed(5))
        c = mae(img, generator=torch.Generator().manual_seed(6))
        idx = torch.rand((2, N_PATCHES), generator=torch.Generator().manual_seed(5)).argsort(dim=-1)
        d = mae(img, rand_indices=idx)
    assert torch.equal(a, b) and torch.equal(a, d) and not torch.equal(a, c)


def test_masking_ratio_is_checked():
    with pytest.raises(ValueError, match="masking ratio"):
        MAE(encoder=ViT(**ENC, device="cpu"), decoder_dim=24, masking_ratio=1.0, device="cpu")
