"""The port's ViT-1D, ViT-3D, ViT-ND, ViT-ND-rotary and ViT-ND-PoPE
(vit_pytorch_tpu_torch/models/vit_1d.py, vit_3d.py, vit_nd.py,
vit_nd_rotary.py, vit_nd_pope.py) against the JAX package on the CPU, fp32,
at a small size (depth 2, dim 128, heads 2, dim_head 64; PoPE also at
dim_head 32), the same weights on both sides (numpy draws at the JAX init's
shapes, loaded through ``utils/from_jax.py``) and the same inputs (numpy
seed): logits and every gradient (tests/torch_parity.py's bounds), the
maps against the JAX converters, and the kernel routes each model takes on
the card, forced on the CPU (the device test and the gates taken as true)
so that the kernels' Functions run on their plain twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from vit_pytorch_tpu.models import vit_1d as j_1d
from vit_pytorch_tpu.models import vit_3d as j_3d
from vit_pytorch_tpu.models import vit_nd as j_nd
from vit_pytorch_tpu.models import vit_nd_pope as j_pope
from vit_pytorch_tpu.models import vit_nd_rotary as j_rotary
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import vit_1d, vit_3d, vit_nd, vit_nd_pope, vit_nd_rotary
from vit_pytorch_tpu_torch.ops import flash_attention as flash
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.ops import short_attention as short
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 3, 10
BODY = dict(num_classes=CLASSES, dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)
ND = dict(ndim=3, input_shape=(4, 8, 8), patch_size=(2, 4, 4))  # 8 patches

# name: (JAX class, port class, from_jax map, converter, constructor extras, input shape past the batch)
MODELS = {
    "1d": (j_1d.ViT, vit_1d.ViT, from_jax.vit_1d_state_dict_from_jax, convert.convert_vit_1d,
           dict(seq_len=64, patch_size=8), (3, 64)),
    "3d_cls": (j_3d.ViT, vit_3d.ViT, from_jax.vit_3d_state_dict_from_jax, convert.convert_vit_3d,
               dict(image_size=16, image_patch_size=8, frames=4, frame_patch_size=2), (3, 4, 16, 16)),
    "3d_mean": (j_3d.ViT, vit_3d.ViT, from_jax.vit_3d_state_dict_from_jax, convert.convert_vit_3d,
                dict(image_size=16, image_patch_size=8, frames=4, frame_patch_size=2, pool="mean"), (3, 4, 16, 16)),
    "nd_cls": (j_nd.ViTND, vit_nd.ViTND, from_jax.vit_nd_state_dict_from_jax, convert.convert_vit_nd, ND,
               (3, 4, 8, 8)),
    "nd_mean": (j_nd.ViTND, vit_nd.ViTND, from_jax.vit_nd_state_dict_from_jax, convert.convert_vit_nd,
                dict(ND, pool="mean", channels=2), (2, 4, 8, 8)),
    "rotary": (j_rotary.ViTND, vit_nd_rotary.ViTND, from_jax.vit_nd_rotary_state_dict_from_jax,
               convert.convert_vit_nd_rotary, ND, (3, 4, 8, 8)),
    "rotary_zero_freqs": (j_rotary.ViTND, vit_nd_rotary.ViTND, from_jax.vit_nd_rotary_state_dict_from_jax,
                          convert.convert_vit_nd_rotary, dict(ND, rope_p_zero_freqs=0.25, rope_max_freq=100.0),
                          (3, 4, 8, 8)),
    "pope": (j_pope.ViTND, vit_nd_pope.ViTND, from_jax.vit_nd_pope_state_dict_from_jax, convert.convert_vit_nd_pope,
             ND, (3, 4, 8, 8)),
    "pope_uniform_bias": (j_pope.ViTND, vit_nd_pope.ViTND, from_jax.vit_nd_pope_state_dict_from_jax,
                          convert.convert_vit_nd_pope, dict(ND, init_learned_bias_uniform=True), (3, 4, 8, 8)),
    "pope_dim_head_32": (j_pope.ViTND, vit_nd_pope.ViTND, from_jax.vit_nd_pope_state_dict_from_jax,
                         convert.convert_vit_nd_pope, dict(ND, dim_head=32), (3, 4, 8, 8)),
}


def _special(key, leaf, z):
    if key == "learned_bias":  # the clamp's range [-2 pi, 0] and past it on both sides
        return -np.pi + 4.0 * z
    return None


def _setup(name, **overrides):
    jax_cls, port_cls, to_torch, _, extra, shape = MODELS[name]
    cfg = {**BODY, **extra, **overrides}
    jmodel = jax_cls(**cfg)
    x = tp.inputs((BATCH, *shape))
    params = tp.draw_params(jmodel, jnp.asarray(x), special=_special)
    model = tp.load(port_cls(**cfg, device="cpu"), to_torch(params))
    return jmodel, params, model, x


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Logits (eval and training mode) and every parameter gradient against
    the JAX model with the same weights."""
    jmodel, params, model, x = _setup(name)
    tp.check_model(jmodel, params, model, MODELS[name][2], x, tp.labels(BATCH, CLASSES))


@pytest.mark.parametrize("name", [n for n in MODELS if not n.startswith("pope_")])
def test_state_dict_round_trip_is_exact(name):
    """Each map inverts the JAX converter of the reference layout."""
    _, params, model, _ = _setup(name)
    tp.assert_round_trip(MODELS[name][3], model, params)


@pytest.mark.parametrize("name", ["rotary", "pope"])
def test_return_embed_matches_jax(name):
    """``return_embed``: the normed tokens on their grid (b, *grid, dim)."""
    jmodel, params, model, x = _setup(name)
    want = jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x), True))(params)
    got = model.eval()(torch.from_numpy(x), return_embed=True)
    assert got.shape == (BATCH, 2, 2, 2, BODY["dim"])
    tp.assert_close(got, want)


def test_rotary_tables_match_jax():
    """The directions and frequency tables bit for bit (scipy's erfinv in
    float64 on both sides, then float32), the angles within a float32 ulp
    of their largest summand (the einsum's summation order is XLA's choice:
    bitwise under the default flags, not under this suite's), and the rotation
    within 1e-5 on the models' 2 x 2 x 2 grid (on a 4 x 4 x 4 one, angles
    up to ~5e4, an ulp of the angle is 4e-3 rad and the rotations part by
    as much)."""
    for n, d in ((64, 3), (96, 4), (7, 1)):
        np.testing.assert_array_equal(vit_nd_rotary.make_directions(n, d), j_rotary.make_directions(n, d))
    np.testing.assert_array_equal(vit_nd_rotary.golden_gate_freqs(4, 8, 64, 1.0, 1e4, 0.25).numpy(),
                                  np.asarray(j_rotary.golden_gate_freqs(4, 8, 64, 1.0, 1e4, 0.25)))
    np.testing.assert_array_equal(vit_nd_pope.pope_freqs(4, 8, 32).numpy(), np.asarray(j_pope.pope_freqs(4, 8, 32)))
    freqs = j_rotary.golden_gate_freqs(3, 8, 64)
    for grid in ((4, 4, 4), (2, 2, 2)):
        pos = vit_nd_rotary.grid_positions(grid)
        theta = vit_nd_rotary.rope_angles(torch.from_numpy(np.array(freqs)), pos)
        want = jax.jit(lambda f, p: jnp.einsum("hfp,bnp->bhnf", f, p))(freqs, jnp.asarray(pos.numpy()[None]))
        ulp = np.spacing(np.float32(np.abs(np.asarray(freqs)).max() * (max(grid) - 1)))
        np.testing.assert_allclose(theta.numpy(), np.asarray(want)[0], rtol=0, atol=2 * ulp)
    t = np.random.default_rng(2).standard_normal((2, 8, 8, 64)).astype(np.float32)
    want = jax.jit(j_rotary.apply_golden_gate_rope)(freqs, jnp.asarray(t), jnp.asarray(np.broadcast_to(pos, (2, 8, 3))))
    tp.assert_close(vit_nd_rotary.apply_golden_gate_rope(theta, torch.from_numpy(t)), want, atol=1e-5, rtol=1e-5)


def test_tables_stay_float32_in_bf16():
    """The model cast to bf16 keeps its frequency table in float32, as the
    JAX model's numpy table stays."""
    model = vit_nd_rotary.ViTND(**BODY, **ND, device="cpu").to(torch.bfloat16)
    assert model.freqs.dtype == np.float32
    assert model.pos_emb(torch.device("cpu")).dtype == torch.float32


@pytest.mark.parametrize("name", ["1d", "3d_cls"])
def test_whole_layer_route_matches_jax(name, monkeypatch):
    """ViT-1D and ViT-3D with the whole-layer routes forced on both sides
    (the JAX kernel in interpret mode, the port's Function on its twins):
    every layer runs ``fused_transformer_layer``, logits and gradients still
    the JAX model's."""
    calls = tp.force_layer_routes(monkeypatch)
    jmodel, params, model, x = _setup(name)
    port_fb.reset_launch_counts()
    tp.check_model(jmodel, params, model, MODELS[name][2], x, tp.labels(BATCH, CLASSES))
    n = 9  # 8 patches and the cls token
    assert calls == {"layer": [(BATCH, n, BODY["dim"])] * 2 * BODY["depth"], "block": []}  # eval, then training
    assert not any(port_fb.LAUNCHES.values())


# ViT-ND at 1,024 patches + the cls token (the card's tail tile), the
# rotary at exactly 1,024 (the short route's last m), PoPE at 1,056
ROUTE_SHAPES = {
    "nd_cls": (dict(ndim=2, input_shape=(32, 32), patch_size=1, channels=1, depth=1, dim=64, mlp_dim=64), (1, 32, 32),
               "flash"),
    "rotary": (dict(ndim=2, input_shape=(32, 32), patch_size=1, channels=1, depth=1, dim=64, mlp_dim=64), (1, 32, 32),
               "short"),
    "pope_dim_head_32": (dict(ndim=2, input_shape=(32, 33), patch_size=1, channels=1, depth=1, dim=64, mlp_dim=64),
                         (1, 32, 33), None),
    "pope": (dict(ndim=2, input_shape=(32, 32), patch_size=1, channels=1, depth=1, dim=64, mlp_dim=64), (1, 32, 32),
             None),
}


@pytest.mark.parametrize("name", list(ROUTE_SHAPES))
def test_kernel_routes_match_jax(name, monkeypatch):
    """On the dispatcher's forced kernel routes at the card's token counts:
    ViT-ND at 1,025 tokens on the flash Function, the rotary at 1,024 on the
    short Function (its twins here); PoPE's q and k twice v's width refused
    by both gates (at dim_head 32 a q and k of 64 beside a v of 32 must not
    reach the flash kernels, which read v as 64 wide) and taking the
    composite.  Logits and every gradient against the JAX model."""
    calls = tp.force_attention_routes(monkeypatch)
    cfg, shape, route = ROUTE_SHAPES[name]
    jax_cls, port_cls, to_torch, *_ = MODELS[name]
    cfg = {**BODY, **MODELS[name][4], **cfg}
    jmodel = jax_cls(**cfg)
    x = tp.inputs((2, *shape))
    params = tp.draw_params(jmodel, jnp.asarray(x), special=_special)
    model = tp.load(port_cls(**cfg, device="cpu"), to_torch(params))
    tp.check_model(jmodel, params, model, to_torch, x, tp.labels(2, CLASSES))
    if route is None:
        assert calls == {"short": [], "flash": []}
    else:
        assert len(calls[route]) == 2 * cfg["depth"] and not calls["short" if route == "flash" else "flash"]


def test_flash_gate_refuses_a_narrower_v():
    """The flash kernels' gate looks at v: 64-wide q and k beside a v of 32
    (PoPE at dim_head 32) are refused, as ``short_supported`` refuses them."""
    bf16 = torch.bfloat16
    q = (2, 8, 1056, 64)
    assert flash.flash_supported(q, q, q, bf16)
    assert not flash.flash_supported(q, q, (2, 8, 1056, 32), bf16)
    assert not flash.flash_supported(q, q, (2, 8, 1000, 64), bf16)
    assert not short.short_supported(q[:2] + (1024, 64), q[:2] + (1024, 64), q[:2] + (1024, 32), bf16)


def test_rotary_dropout_takes_the_flash_route(monkeypatch):
    """Training at attention dropout 0.1 leaves the short route at 1,024
    tokens for the flash Function's dropout (its twins here): each call
    carries the rate, the same global seed gives the same logits, the
    gradients are finite, and eval mode goes back to the short route."""
    calls = tp.force_attention_routes(monkeypatch)
    cfg = {**BODY, **ROUTE_SHAPES["rotary"][0], "dropout": 0.1}
    model = vit_nd_rotary.ViTND(**cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(tp.inputs((2, 1, 32, 32)))
    torch.manual_seed(3)
    a = model(x)
    torch.manual_seed(3)
    b = model(x)
    assert torch.equal(a, b)
    a.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert [c[3] for c in calls["flash"]] == [0.1, 0.1] and not calls["short"]
    model.eval()(x)
    assert len(calls["short"]) == 1


def test_entry_points_build_on_the_card_by_default():
    """Without ``device`` each model builds on the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("1d", "3d_cls", "nd_cls", "rotary", "pope"):
        _, port_cls, _, _, extra, _ = MODELS[name]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_cls(**BODY, **extra)
