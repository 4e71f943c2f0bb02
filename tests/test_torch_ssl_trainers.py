"""The port's EsViT, LeJEPA, SimMIM, MPP and MP3 (vit_pytorch_tpu_torch/ssl/)
against the JAX package on the CPU, fp32, at tests/test_ssl2.py's ViT size
at depth 2 (32 x 32, patch 8, dim 32, heads 2, mlp 64; K = 64, projector
hidden 32, 3 layers), with the same weights on both sides (JAX init, loaded
through the ``utils/from_jax.py`` maps) and the same injected views, slice
directions, masked indices, masked positions and permutations.

Tolerances: the loss (and EsViT's new centres) within 5e-5 absolute and
1e-4 relative, every gradient within 5e-5 + 1e-3 relative (the JAX
package's fp32 parity bar, as tests/test_torch_mae.py); EsViT's EMA bit for
bit, in fp32 and in bf16 (its centres float32, as JAX's); EsViT's bf16
float32 loss within 1e-2 relative of JAX's, whose bf16 ViT rounds
differently."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu import ViT as JaxViT
from vit_pytorch_tpu.nn import blocks as jax_blocks
from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu.ssl.es_vit import EsViTTrainer as JaxEsViT
from vit_pytorch_tpu.ssl.es_vit import esvit_forward
from vit_pytorch_tpu.ssl.lejepa import LeJEPA as JaxLeJEPA
from vit_pytorch_tpu.ssl.lejepa import lejepa_forward
from vit_pytorch_tpu.ssl.lejepa import sigreg_loss as jax_sigreg_loss
from vit_pytorch_tpu.ssl.mp3 import MP3 as JaxMP3
from vit_pytorch_tpu.ssl.mp3 import ViT as JaxMP3ViT
from vit_pytorch_tpu.ssl.mpp import MPP as JaxMPP
from vit_pytorch_tpu.ssl.simmim import SimMIM as JaxSimMIM
from vit_pytorch_tpu.utils.convert import convert_lejepa, convert_mp3, convert_mpp, convert_simmim
from vit_pytorch_tpu_torch import ViT
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ssl.es_vit import EsViTTrainer
from vit_pytorch_tpu_torch.ssl.lejepa import LeJEPA, sigreg_loss
from vit_pytorch_tpu_torch.ssl.mp3 import MP3
from vit_pytorch_tpu_torch.ssl.mp3 import ViT as MP3ViT
from vit_pytorch_tpu_torch.ssl.mpp import MPP, get_mask_subset_with_prob
from vit_pytorch_tpu_torch.ssl.simmim import SimMIM
from vit_pytorch_tpu_torch.utils import from_jax

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=2, heads=2, mlp_dim=64)
MP3_KW = dict(num_classes=10, image_size=32, patch_size=8, dim=32, depth=2, heads=2, mlp_dim=64)
WRAP = dict(image_size=32, num_classes_K=64, projection_hidden_size=32, projection_layers=3)
ATOL, RTOL, GRAD_RTOL = 5e-5, 1e-4, 1e-3
N = 16  # patches of a 32 x 32 image at patch 8
SLICES = 24


def _images(batch=2, seed=0, count=1):
    rng = np.random.default_rng(seed)
    out = tuple(rng.random((batch, 3, 32, 32), dtype=np.float32) for _ in range(count))
    return out if count > 1 else out[0]


def _tree(variables):
    return jax.tree.map(np.asarray, variables["params"])


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a * 0.9 + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params)


def _load(module, state_dict, missing=()):
    got_missing, unexpected = module.load_state_dict(state_dict, strict=False)
    assert sorted(got_missing) == sorted(missing) and not unexpected, (got_missing, unexpected)
    return module


def _slices(seed=4):
    p = np.random.default_rng(seed).standard_normal((SLICES, WRAP["num_classes_K"])).astype(np.float32)
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


# -- each case: the JAX loss of the params, the port module and its loss, the params map, the
# -- parameters whose gradient is None on the port side (zeros on the JAX side)

def _esvit():
    views = _images(count=4)
    jm = JaxEsViT(net=JaxViT(**KW), **WRAP)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(views[0]))
    params = _tree(variables)
    rng = np.random.default_rng(9)
    centers = [rng.standard_normal((1, 64)).astype(np.float32) for _ in range(4)]
    state = jm.create_state(variables).replace(
        teacher_params={"params": _perturbed(params, 7)}, teacher_view_centers=jnp.asarray(centers[0]),
        last_teacher_view_centers=jnp.asarray(centers[1]), teacher_region_centers=jnp.asarray(centers[2]),
        last_teacher_region_centers=jnp.asarray(centers[3]))
    module = EsViTTrainer(ViT(**KW, device="cpu"), **WRAP, device="cpu")
    names = ("teacher_view_centers", "last_teacher_view_centers", "teacher_region_centers",
             "last_teacher_region_centers")
    _load(module, from_jax.esvit_state_dict_from_jax(params, state.teacher_params), names)
    for name, c in zip(names, centers):
        getattr(module, name).copy_(torch.from_numpy(c))
    jviews = tuple(map(jnp.asarray, views))

    def jax_loss(p):
        return esvit_forward(jm, {"params": p}, state, None, views=jviews)

    return dict(jax_loss=jax_loss, aux=True, module=module, state=state, jm=jm, params=params,
                loss=lambda: module(None, views=tuple(map(torch.from_numpy, views))),
                map=from_jax.esvit_state_dict_from_jax,
                no_grad=("student_encoder.net.mlp_head.weight", "student_encoder.net.mlp_head.bias"))


def _lejepa():
    views, projs = _images(count=4), _slices()
    jm = JaxLeJEPA(net=JaxViT(**KW), **WRAP, sigreg_num_slices=SLICES)
    params = _tree(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(views[0])))
    module = _load(LeJEPA(ViT(**KW, device="cpu"), **WRAP, sigreg_num_slices=SLICES, device="cpu"),
                   from_jax.lejepa_state_dict_from_jax(params))
    jviews = tuple(map(jnp.asarray, views))
    return dict(jax_loss=lambda p: lejepa_forward(jm, {"params": p}, None, views=jviews,
                                                  sigreg_projs=jnp.asarray(projs)),
                module=module, params=params, map=from_jax.lejepa_state_dict_from_jax,
                loss=lambda: module(None, views=tuple(map(torch.from_numpy, views)),
                                    sigreg_projs=torch.from_numpy(projs)),
                no_grad=("encoder.net.mlp_head.weight", "encoder.net.mlp_head.bias"))


def _simmim(pool="cls"):
    img = _images()
    idx = np.stack([np.random.default_rng(s).permutation(N)[: N // 2] for s in (1, 2)]).astype(np.int32)
    jm = JaxSimMIM(encoder=JaxViT(**KW, pool=pool), masking_ratio=0.5)
    params = _tree(jm.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, jnp.asarray(img)))
    module = _load(SimMIM(encoder=ViT(**KW, pool=pool, device="cpu"), masking_ratio=0.5, device="cpu"),
                   from_jax.simmim_state_dict_from_jax(params), ("encoder.mlp_head.weight", "encoder.mlp_head.bias"))
    return dict(jax_loss=lambda p: jm.apply({"params": p}, jnp.asarray(img), masked_indices=jnp.asarray(idx)),
                module=module, params=params, map=from_jax.simmim_state_dict_from_jax,
                loss=lambda: module(torch.from_numpy(img), masked_indices=torch.from_numpy(idx)),
                no_grad=("encoder.mlp_head.weight", "encoder.mlp_head.bias", "encoder.cls_token"))


def _mpp(replace_prob, mean_std=False):
    img = _images()
    mask = np.random.default_rng(5).random((2, N)) < 0.4
    kw = dict(patch_size=8, dim=32, mask_prob=0.15, replace_prob=replace_prob, random_patch_prob=0.0)
    if mean_std:
        kw.update(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
    jm = JaxMPP(JaxViT(**KW), **kw)
    params = _tree(jm.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, jnp.asarray(img)))
    module = _load(MPP(ViT(**KW, device="cpu"), **kw, device="cpu"), from_jax.mpp_state_dict_from_jax(params),
                   ("transformer.mlp_head.weight", "transformer.mlp_head.bias"))

    def jax_loss(p):
        return jm.apply({"params": p}, jnp.asarray(img), masked_positions=jnp.asarray(mask),
                        rngs={"mask": jax.random.PRNGKey(3)})

    return dict(jax_loss=jax_loss, module=module, params=params, map=from_jax.mpp_state_dict_from_jax,
                loss=lambda: module(torch.from_numpy(img), masked_positions=torch.from_numpy(mask)),
                no_grad=("transformer.mlp_head.weight", "transformer.mlp_head.bias")
                + (("mask_token",) if replace_prob == 0 else ()))


def _mp3():
    img = _images()
    idx = np.stack([np.random.default_rng(s).permutation(N) for s in (1, 2)]).astype(np.int32)
    jm = JaxMP3(vit=JaxMP3ViT(**MP3_KW), masking_ratio=0.75)
    params = _tree(jm.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, jnp.asarray(img)))
    module = _load(MP3(vit=MP3ViT(**MP3_KW, device="cpu"), masking_ratio=0.75, device="cpu"),
                   from_jax.mp3_state_dict_from_jax(params),
                   ("vit.linear_head.0.weight", "vit.linear_head.0.bias", "vit.linear_head.1.weight",
                    "vit.linear_head.1.bias"))
    return dict(jax_loss=lambda p: jm.apply({"params": p}, jnp.asarray(img), rand_indices=jnp.asarray(idx)),
                module=module, params=params, map=from_jax.mp3_state_dict_from_jax,
                loss=lambda: module(torch.from_numpy(img), rand_indices=torch.from_numpy(idx)),
                no_grad=("vit.linear_head.0.weight", "vit.linear_head.0.bias", "vit.linear_head.1.weight",
                         "vit.linear_head.1.bias"))


CASES = {
    "esvit": _esvit,
    "lejepa": _lejepa,
    "simmim_cls": _simmim,
    "simmim_mean": lambda: _simmim("mean"),
    "mpp_no_replace": lambda: _mpp(0.0),
    "mpp_replace_all": lambda: _mpp(1.0),
    "mpp_replace_all_mean_std": lambda: _mpp(1.0, mean_std=True),
    "mp3": _mp3,
}


def _check(case):
    """The loss and every gradient of the port against ``jax.value_and_grad``."""
    if case.get("aux"):
        (want, aux), grads = jax.value_and_grad(case["jax_loss"], has_aux=True)(case["params"])
    else:
        (want, grads), aux = jax.value_and_grad(case["jax_loss"])(case["params"]), None
    module = case["module"]
    got = case["loss"]()
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=RTOL)
    got.backward()
    want_grads = case["map"](jax.tree.map(np.asarray, grads))
    checked = 0
    for k, p in module.named_parameters():
        if not p.requires_grad:  # EsViT's teacher
            assert k.startswith("teacher_encoder.") and p.grad is None, k
            continue
        checked += 1
        if p.grad is None:
            assert k in case["no_grad"], k
            assert k not in want_grads or not want_grads[k].any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)
    assert checked == len([k for k in want_grads if not k.startswith("teacher_encoder.")]) + sum(
        k not in want_grads for k in case["no_grad"])
    return aux


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_matches_jax(name):
    """Each trainer's loss and every gradient with the same injected views,
    slices, indices, positions or permutation: EsViT with its teacher apart
    from the student and non-zero centres (and the new centres), LeJEPA
    with injected slice directions, SimMIM cls- and mean-pooled, MPP with
    nothing replaced, every masked patch the mask token, and the
    de-normalised target, MP3 on its own ViT."""
    case = CASES[name]()
    aux = _check(case)
    if name == "esvit":
        module = case["module"]
        for got, want in zip((module.last_teacher_view_centers, module.last_teacher_region_centers), aux):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["esvit", "lejepa", "simmim_cls", "mpp_replace_all"])
def test_kernel_route_matches_jax(name, monkeypatch):
    """The ViT's Transformer on the forced whole-layer route of both
    packages (the JAX kernels in interpret mode, the port's Function on its
    plain twins): the loss and every gradient match, and every call of the
    encoder took the Function, with gradients where the trainer takes them
    (EsViT's student, LeJEPA's locals) and without (the teacher, LeJEPA's
    globals)."""
    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_fb, "whole_layer_supported", lambda *a, **k: True)
    orig = jax_blocks.fused_transformer_layer
    monkeypatch.setattr(jax_blocks, "fused_transformer_layer", lambda *a, **k: orig(*a, **k, interpret=True))
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    case = CASES[name]()
    calls, layer = [], torch_blocks.fused_transformer_layer

    def spy(x, *args, **kwargs):
        calls.append((tuple(x.shape), torch.is_grad_enabled()))
        return layer(x, *args, **kwargs)

    monkeypatch.setattr(torch_blocks, "fused_transformer_layer", spy)
    _check(case)
    depth = KW["depth"]
    want = {
        "esvit": [((2, 17, 32), True)] * (2 * depth) + [((2, 17, 32), False)] * (2 * depth),
        "lejepa": [((4, 17, 32), True)] * depth + [((4, 17, 32), False)] * depth,
        "simmim_cls": [((2, 16, 32), True)] * depth,
        "mpp_replace_all": [((2, 17, 32), True)] * depth,
    }[name]
    assert calls == want


def test_esvit_update_moving_average_matches_jax_bitwise():
    """EsViT's teacher EMA toward a changed student and both centres'."""
    case = _esvit()
    jm, state, module = case["jm"], case["state"], case["module"]
    student = _perturbed(case["params"], 11)
    module.load_state_dict({k: v for k, v in from_jax.esvit_state_dict_from_jax(student).items()
                            if k.startswith("student_encoder.")}, strict=False)
    want = jm.update_moving_average({"params": student}, state)
    module.update_moving_average()
    want_sd = from_jax.esvit_state_dict_from_jax(student, jax.tree.map(np.asarray, want.teacher_params))
    for k, v in module.teacher_encoder.state_dict(prefix="teacher_encoder.").items():
        assert torch.equal(v, want_sd[k]), k
    assert torch.equal(module.teacher_view_centers, torch.from_numpy(np.array(want.teacher_view_centers)))
    assert torch.equal(module.teacher_region_centers, torch.from_numpy(np.array(want.teacher_region_centers)))


def test_esvit_in_bf16_keeps_float32_centres_as_jax():
    """Cast to bf16, EsViT keeps its four centre buffers float32 (JAX's
    ``create_state``), so its loss is float32 on both sides, within 1e-2
    relative of JAX's (the two bf16 ViTs round differently); the new last
    centres are bf16 values, as JAX returns them; the EMA in bf16, JAX's
    state holding those bf16 last centres, is JAX's bit for bit."""
    case = _esvit()
    jm, state, module, params = case["jm"], case["state"], case["module"], case["params"]
    bf16 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    params, state = bf16(params), state.replace(teacher_params=bf16(state.teacher_params))
    module.to(torch.bfloat16)
    names = ("teacher_view_centers", "last_teacher_view_centers", "teacher_region_centers",
             "last_teacher_region_centers")
    assert all(getattr(module, n).dtype == torch.float32 for n in names)
    views = tuple(jnp.asarray(v).astype(jnp.bfloat16) for v in _images(count=4))
    want, want_last = esvit_forward(jm, {"params": params}, state, None, views=views)
    got = module(None, views=tuple(torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) for v in views))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-2)
    for name, w in zip(names[1::2], want_last):
        last = getattr(module, name)
        assert w.dtype == jnp.bfloat16 and torch.equal(last, last.bfloat16().float()), name
    state = state.replace(last_teacher_view_centers=jnp.asarray(module.last_teacher_view_centers.numpy()).astype(
        jnp.bfloat16), last_teacher_region_centers=jnp.asarray(module.last_teacher_region_centers.numpy()).astype(
        jnp.bfloat16))
    student = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    want = jm.update_moving_average({"params": params}, state)
    module.update_moving_average()
    want_sd = from_jax.esvit_state_dict_from_jax(student, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                                       want.teacher_params))
    for k, v in module.teacher_encoder.state_dict(prefix="teacher_encoder.").items():
        assert v.dtype == torch.bfloat16 and torch.equal(v.float(), want_sd[k]), k
    for name in names[::2]:
        assert torch.equal(getattr(module, name), torch.from_numpy(np.array(getattr(want, name)))), name


def test_sigreg_loss_matches_jax_and_draws_from_the_generator():
    """SIGReg on given slice directions against JAX's; without them the
    directions come from the generator (a seed repeats)."""
    x = np.random.default_rng(0).standard_normal((6, 64)).astype(np.float32)
    projs = _slices()
    want = jax_sigreg_loss(None, jnp.asarray(x), num_slices=SLICES, projs=jnp.asarray(projs))
    got = sigreg_loss(torch.from_numpy(x), SLICES, projs=torch.from_numpy(projs))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-5)
    a = sigreg_loss(torch.from_numpy(x), SLICES, generator=torch.Generator().manual_seed(1))
    b = sigreg_loss(torch.from_numpy(x), SLICES, generator=torch.Generator().manual_seed(1))
    c = sigreg_loss(torch.from_numpy(x), SLICES, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name,convert", [
    ("lejepa", functools.partial(convert_lejepa, projection_layers=WRAP["projection_layers"])),
    ("simmim_cls", convert_simmim), ("mpp_replace_all", convert_mpp), ("mp3", convert_mp3),
], ids=["lejepa", "simmim", "mpp", "mp3"])
def test_state_dict_round_trip_is_exact(name, convert):
    """Each map inverts its ``convert_*``: the port's state_dict (less the
    encoder's head, which the JAX tree lacks) converts back to the params it
    was loaded from."""
    case = CASES[name]()
    heads = ("encoder.mlp_head", "transformer.mlp_head")
    state = {k: v for k, v in case["module"].state_dict().items() if not k.startswith(heads)}
    got = jax.tree.map(np.asarray, convert(state)["params"])
    assert jax.tree.structure(got) == jax.tree.structure(case["params"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(case["params"])):
        assert np.array_equal(a, b)


def test_mp3_vit_matches_jax():
    """MP3's own ViT (a sincos table, no final norm, a LayerNorm + Linear
    head) alone: its logits against the JAX one's."""
    img = _images()
    jvit = JaxMP3ViT(**MP3_KW)
    params = _tree(jvit.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img)))
    sd = {k[len("vit."):]: v for k, v in from_jax.mp3_state_dict_from_jax({"vit": params}).items()}
    vit = _load(MP3ViT(**MP3_KW, device="cpu"), sd)
    np.testing.assert_allclose(vit(torch.from_numpy(img)).detach().numpy(),
                               np.asarray(jvit.apply({"params": params}, jnp.asarray(img))), atol=ATOL, rtol=RTOL)


def test_mpp_random_patches_come_from_the_same_image():
    """The random-patch path (replace 0, random patch 1: every masked patch
    is drawn from the same image's patches) by its properties: unmasked
    patches pass unchanged, each masked one equals some patch of its image,
    a seed repeats its loss; the mask of ``get_mask_subset_with_prob`` has
    ceil(prob n) positions a row."""
    img = torch.from_numpy(_images())
    mpp = MPP(ViT(**KW, device="cpu"), patch_size=8, dim=32, replace_prob=0.0, random_patch_prob=1.0, device="cpu")
    seen = []
    handle = mpp.transformer.to_patch_embedding[1].register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    mask = torch.from_numpy(np.random.default_rng(5).random((2, N)) < 0.5)
    with torch.no_grad():
        a = mpp(img, masked_positions=mask, generator=torch.Generator().manual_seed(1))
        b = mpp(img, masked_positions=mask, generator=torch.Generator().manual_seed(1))
    handle.remove()
    patches = mpp.transformer.patchify(img)
    got = seen[0]
    assert torch.equal(a, b) and torch.isfinite(a)
    assert torch.equal(got[~mask], patches[~mask])
    for i in range(2):
        for j in torch.nonzero(mask[i]).flatten().tolist():
            assert any(torch.equal(got[i, j], patches[i, k]) for k in range(N))
    m = get_mask_subset_with_prob(3, N, 0.15, generator=torch.Generator().manual_seed(0))
    assert m.shape == (3, N) and m.sum(dim=1).tolist() == [3, 3, 3]


def test_masks_come_from_the_generator():
    """Without injected indices SimMIM, MPP and MP3 draw from the generator:
    a seed repeats its loss, and SimMIM's equals the loss with the drawn
    indices passed in."""
    img = torch.from_numpy(_images())
    simmim = SimMIM(encoder=ViT(**KW, device="cpu"), masking_ratio=0.5, device="cpu")
    mpp = MPP(ViT(**KW, device="cpu"), patch_size=8, dim=32, device="cpu")
    mp3 = MP3(vit=MP3ViT(**MP3_KW, device="cpu"), masking_ratio=0.75, device="cpu")
    with torch.no_grad():
        for model in (simmim, mpp, mp3):
            losses = [model(img, generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
            assert torch.equal(losses[0], losses[1]) and torch.isfinite(losses[0]).all()
        idx = torch.rand((2, N), generator=torch.Generator().manual_seed(5)).argsort(dim=-1, descending=True)[:, :8]
        assert torch.equal(simmim(img, masked_indices=idx), simmim(img, generator=torch.Generator().manual_seed(5)))


ENTRY_POINTS = {
    "EsViTTrainer": lambda kw: EsViTTrainer(ViT(**KW, device="cpu"), **WRAP, **kw),
    "LeJEPA": lambda kw: LeJEPA(ViT(**KW, device="cpu"), **WRAP, **kw),
    "SimMIM": lambda kw: SimMIM(encoder=ViT(**KW, device="cpu"), **kw),
    "MPP": lambda kw: MPP(ViT(**KW, device="cpu"), patch_size=8, dim=32, **kw),
    "MP3 ViT": lambda kw: MP3ViT(**MP3_KW, **kw),
    "MP3": lambda kw: MP3(vit=MP3ViT(**MP3_KW, device="cpu"), masking_ratio=0.75, **kw),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]({})
    model = ENTRY_POINTS[name]({"device": "cpu"})
    assert all(p.device.type == "cpu" for p in model.parameters())
