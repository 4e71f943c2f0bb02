"""The port's introspection wrappers (vit_pytorch_tpu_torch/wrappers/)
against the JAX package's on the CPU, fp32: Recorder and Extractor on the
ViT (ViT 32 x 32, patch 8, dim 32, depth 2, heads 2), AcceptVideoWrapper
on the ViT and on a small two-output image net, and with MOSS over the
ViT's patch tokens (the patch size given, the net's, the net's ViT's;
causal or not), with the same weights on
both sides (JAX init, loaded through ``utils/from_jax.py``) and the same
inputs (numpy seed).  Also the recording predicate: while a Recorder
records, the attention-block and whole-layer kernels are refused, with the
device test taken as true.

Tolerances: 5e-5 absolute (the JAX package's fp32 parity bar) and 1e-4
relative; gradients 5e-5 + 1e-3 relative."""

from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vit_pytorch_tpu import ViT as JaxViT
from vit_pytorch_tpu.models.vivit_with_moss import MOSS as JaxMOSS
from vit_pytorch_tpu.wrappers.accept_video_wrapper import AcceptVideoWrapper as JaxAVW
from vit_pytorch_tpu.wrappers.extractor import Extractor as JaxExtractor
from vit_pytorch_tpu.wrappers.recorder import Recorder as JaxRecorder
from vit_pytorch_tpu_torch import ViT
from vit_pytorch_tpu_torch.models.vivit_with_moss import MOSS
from vit_pytorch_tpu_torch.nn import blocks
from vit_pytorch_tpu_torch.utils.from_jax import accept_video_wrapper_state_dict_from_jax, vit_state_dict_from_jax
from vit_pytorch_tpu_torch.wrappers.accept_video_wrapper import AcceptVideoWrapper
from vit_pytorch_tpu_torch.wrappers.extractor import Extractor
from vit_pytorch_tpu_torch.wrappers.recorder import Recorder

ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3
VIT = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=2, mlp_dim=64)


def _images(shape=(2, 3, 32, 32), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _vits():
    jvit = JaxViT(**VIT)
    variables = jax.jit(lambda: jvit.init(jax.random.PRNGKey(0), jnp.asarray(_images())))()
    variables = {"params": jax.tree.map(np.asarray, variables["params"])}
    tvit = ViT(**VIT, device="cpu")
    tvit.load_state_dict(vit_state_dict_from_jax(variables["params"]))
    return jvit, variables, tvit


def test_recorder_matches_jax():
    """preds and the (b, depth, heads, n, n) maps; eject returns the model,
    which then runs without recording."""
    jvit, variables, tvit = _vits()
    img = _images()
    want_preds, want_attns = JaxRecorder(jvit)(variables, jnp.asarray(img))
    rec = Recorder(tvit)
    preds, attns = rec(torch.from_numpy(img))
    assert attns.shape == (2, VIT["depth"], VIT["heads"], 17, 17) == want_attns.shape
    _close(preds, want_preds)
    _close(attns, want_attns)
    assert all(m.recorded is None for m in tvit.modules() if isinstance(m, blocks.Attention))
    assert rec.eject() is tvit
    with pytest.raises(AssertionError):
        rec(torch.from_numpy(img))
    _close(tvit(torch.from_numpy(img)), want_preds)


def test_recorder_without_attention_gives_none():
    preds, attns = Recorder(nn.Linear(4, 3))(torch.zeros(2, 4))
    assert preds.shape == (2, 3) and attns is None


@pytest.fixture
def kernel_gates_open(monkeypatch):
    """The device test and the kernels' shape gates taken as true, each
    kernel route spied: on CPU tensors the kernel Functions run their plain
    twins."""
    monkeypatch.setattr(blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(blocks, "whole_layer_supported", lambda *a, **k: True)
    calls = []
    for name in ("fused_transformer_layer", "fused_attention_block"):
        orig = getattr(blocks, name)
        monkeypatch.setattr(blocks, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    return calls


def test_recording_refuses_the_kernels(kernel_gates_open):
    """``Attention.fuses`` and ``Transformer.whole_layer_eligible`` refuse
    every kernel while recording; the Recorder's call takes the composite
    everywhere and an unwrapped call the whole-layer kernels again."""
    _, _, tvit = _vits()
    tvit.eval()
    x = torch.zeros(2, 17, VIT["dim"])
    attn = tvit.transformer.layers[0][0]
    assert attn.fuses(x) and tvit.transformer.whole_layer_eligible(x)
    attn.recorded = []
    assert not attn.fuses(x) and not tvit.transformer.whole_layer_eligible(x)
    attn.recorded = None
    img = torch.from_numpy(_images())
    rec = Recorder(tvit)
    _, attns = rec(img)
    assert kernel_gates_open == [] and attns.shape[1] == VIT["depth"]
    rec.eject()(img)
    assert kernel_gates_open == ["fused_transformer_layer"] * VIT["depth"]


@pytest.mark.parametrize("how", ["default", "name", "object", "embeddings_only"])
def test_extractor_matches_jax(how):
    jvit, variables, tvit = _vits()
    img = _images()
    want_preds, want_emb = JaxExtractor(jvit)(variables, jnp.asarray(img))
    kw = {"name": dict(layer="transformer"), "object": dict(layer=tvit.transformer),
          "embeddings_only": dict(return_embeddings_only=True)}.get(how, {})
    ex = Extractor(tvit, **kw)
    out = ex(torch.from_numpy(img))
    if how == "embeddings_only":
        _close(out, want_emb)
        return
    preds, emb = out
    assert emb.shape == (2, 17, VIT["dim"])
    _close(preds, want_preds)
    _close(emb, want_emb)
    assert ex.eject() is tvit


def test_extractor_gives_the_layer_output_itself(kernel_gates_open):
    """The hook keeps the kernels (the whole layers run) and returns the
    transformer's own output tensor."""
    _, _, tvit = _vits()
    tvit.eval()
    seen = []
    tvit.transformer.register_forward_hook(lambda m, a, out: seen.append(out))
    _, emb = Extractor(tvit)(torch.from_numpy(_images()))
    assert emb is seen[0] and kernel_gates_open == ["fused_transformer_layer"] * VIT["depth"]


@pytest.mark.parametrize("layer", ["no_such_layer", nn.Linear(2, 2)])
def test_extractor_missing_layer_raises(layer):
    _, _, tvit = _vits()
    with pytest.raises(ValueError, match="not found"):
        Extractor(tvit, layer=layer)(torch.from_numpy(_images()))


class JaxTwoOut(fnn.Module):
    """An image net with two outputs: a pooled (b, 6) embedding and (b, 6,
    h, w) channel-first features."""

    @fnn.compact
    def __call__(self, x, *, train: bool = False):
        b, c, h, w = x.shape
        f = fnn.Dense(6, name="proj")(x.reshape(b, c, h * w).swapaxes(1, 2))
        return f.mean(axis=1), f.swapaxes(1, 2).reshape(b, 6, h, w)


class TwoOut(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(3, 6)

    def forward(self, x):
        b, c, h, w = x.shape
        f = self.proj(x.reshape(b, c, h * w).transpose(1, 2))
        return f.mean(dim=1), f.transpose(1, 2).reshape(b, 6, h, w)


def two_out_from_jax(params):
    return {"proj.weight": torch.from_numpy(np.ascontiguousarray(np.asarray(params["proj"]["kernel"]).T)),
            "proj.bias": torch.from_numpy(np.array(params["proj"]["bias"]))}


# (image net, wrapper kwargs)
AVW_CASES = {
    "vit_time_pos_emb": ("vit", dict(add_time_pos_emb=True, time_seq_len=12, dim_emb=10)),
    "vit_proj": ("vit", dict(add_time_pos_emb=True, time_seq_len=12, dim_emb=10, proj_embed_to_dim=16)),
    "vit_plain": ("vit", dict()),
    "channel_first_second_output": ("two_out", dict(add_time_pos_emb=True, time_seq_len=8, dim_emb=6,
                                                    output_pos_add_pos_emb=1, embed_is_channel_first=True)),
    "first_output_proj": ("two_out", dict(add_time_pos_emb=True, time_seq_len=8, dim_emb=6, proj_embed_to_dim=5)),
}


def _avw_pair(case):
    net, kw = AVW_CASES[case]
    video = _images((2, 3, 5, 32, 32) if net == "vit" else (2, 3, 5, 4, 4), seed=1)
    if net == "vit":
        jnet, tnet, net_map = JaxViT(**VIT), ViT(**VIT, device="cpu"), vit_state_dict_from_jax
    else:
        jnet, tnet, net_map = JaxTwoOut(), TwoOut(), two_out_from_jax
    jw = JaxAVW(image_net=jnet, **kw)
    params = jax.jit(lambda: jw.init(jax.random.PRNGKey(0), jnp.asarray(video)))()["params"]
    rng = np.random.default_rng(2)  # move pos_emb off its 1e-2 scale so that it shows
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    tw = AcceptVideoWrapper(tnet, **kw, device="cpu")
    tw.load_state_dict(accept_video_wrapper_state_dict_from_jax(params, net_map))
    return jw, params, tw, video


@pytest.mark.parametrize("case", list(AVW_CASES))
def test_accept_video_wrapper_matches_jax(case):
    jw, params, tw, video = _avw_pair(case)
    want = jax.jit(lambda p: jw.apply({"params": p}, jnp.asarray(video)))(params)
    got = tw(torch.from_numpy(video))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape[:2] == (2, 5)
        _close(g, w)


def test_accept_video_wrapper_eval_with_no_grad():
    """The image net gets no gradient (JAX's ``stop_gradient`` on its
    outputs), the wrapper's own parameters theirs."""
    jw, params, tw, video = _avw_pair("vit_proj")
    loss = lambda p: jnp.sum(jw.apply({"params": p}, jnp.asarray(video), True) ** 2)
    want, grads = jax.jit(jax.value_and_grad(loss))(params)
    got = tw(torch.from_numpy(video), eval_with_no_grad=True).square().sum()
    _close(got, want)
    got.backward()
    assert all(p.grad is None for p in tw.image_net.parameters())
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(grads["image_net"]))
    want_grads = accept_video_wrapper_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    for k in ("embed_proj.weight", "embed_proj.bias", "pos_emb"):
        np.testing.assert_allclose(dict(tw.named_parameters())[k].grad.numpy(), want_grads[k].numpy(), atol=ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)


class JaxVitHolder(fnn.Module):
    """An image net holding a ViT at ``vit`` and no ``patch_size`` of its
    own (an Extractor-style wrapper)."""

    vit: Any

    @fnn.compact
    def __call__(self, x, *, train: bool = False):
        return self.vit(x, train=train)


class VitHolder(nn.Module):
    def __init__(self, vit):
        super().__init__()
        self.vit = vit

    def forward(self, x):
        return self.vit(x)


# where MOSS finds the patch size, and whether it is causal
MOSS_CASES = {
    "patch_size_given": dict(patch_size=8),
    "image_net_patch_size": dict(),
    "image_net_vit_patch_size": dict(),
    "non_causal": dict(),
}


def _moss_pair(case):
    """The JAX wrapper with a MOSS module (the JAX wrapper's dict form does not
    build: flax freezes the dict into a FrozenDict, which it does not take
    for a dict), the port's built from the dict, around ViTs that return
    their tokens, the same weights (the JAX init moved by 0.1 N(0, 1))."""
    kw = MOSS_CASES[case]
    moss_kw = dict(dim=VIT["dim"], hidden_dim=8, causal=case != "non_causal")
    holder = case == "image_net_vit_patch_size"
    cfg = {**VIT, "num_classes": 0}
    jnet, tnet = JaxViT(**cfg), ViT(**cfg, device="cpu")
    if holder:
        jnet, tnet = JaxVitHolder(jnet), VitHolder(tnet)
    jw = JaxAVW(image_net=jnet, moss=JaxMOSS(**moss_kw), **kw)
    video = _images((2, 3, 4, 32, 32), seed=1)
    params = jax.jit(lambda: jw.init(jax.random.PRNGKey(0), jnp.asarray(video)))()["params"]
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    tw = AcceptVideoWrapper(tnet, moss=moss_kw, **kw, device="cpu")
    net_map = (lambda p: {f"vit.{k}": v for k, v in vit_state_dict_from_jax(p["vit"]).items()}) if holder \
        else vit_state_dict_from_jax
    tw.load_state_dict(accept_video_wrapper_state_dict_from_jax(params, net_map))
    return jw, params, tw, video, net_map


@pytest.mark.parametrize("case", list(MOSS_CASES))
def test_accept_video_wrapper_moss_matches_jax(case):
    """MOSS over the (b, t, 4, 4, d) patch grid of the ViT's tokens, the class
    token split off and put back: the (b, t, 17, d) output and every
    gradient of a weighted sum of it (MOSS's, the ViT's) against the JAX
    wrapper; the class tokens are the ViT's own."""
    jw, params, tw, video, net_map = _moss_pair(case)
    w = _images((2, 4, 17, VIT["dim"]), seed=3)
    loss = lambda p: jnp.sum(jw.apply({"params": p}, jnp.asarray(video)) * w)
    want, grads = jax.jit(jax.value_and_grad(loss))(params)
    out = tw(torch.from_numpy(video))
    assert out.shape == (2, 4, 17, VIT["dim"])
    got = (out * torch.from_numpy(w)).sum()
    _close(got, want, atol=1e-3)
    got.backward()
    want_grads = accept_video_wrapper_state_dict_from_jax(jax.tree.map(np.asarray, grads), net_map)
    assert any(k.startswith("moss.") for k in want_grads)
    for k, p in tw.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)
    with torch.no_grad():
        frames = torch.from_numpy(video).transpose(1, 2).reshape(8, 3, 32, 32)
        _close(out[:, :, 0].reshape(8, -1), tw.image_net(frames)[:, 0].numpy())


def test_accept_video_wrapper_moss_module_or_dict():
    """A MOSS module is taken as it is (its weights under ``moss.``), a dict
    builds one on the wrapper's device; without a patch size anywhere MOSS
    refuses."""
    moss = MOSS(6, hidden_dim=4, device="cpu")
    tw = AcceptVideoWrapper(TwoOut(), moss=moss, patch_size=1, device="cpu")
    assert tw.moss is moss and "moss.to_out.weight" in tw.state_dict()
    built = AcceptVideoWrapper(TwoOut(), moss=dict(dim=6, hidden_dim=4), device="cpu")
    own = {k for k in built.state_dict() if not k.startswith("image_net.")}
    assert isinstance(built.moss, MOSS) and own == {f"moss.{k}" for k in moss.state_dict()}
    with pytest.raises(ValueError, match="patch_size"):
        built(torch.zeros(1, 3, 2, 4, 4))
