"""The port's LocalViT, small-dataset ViT, RvT, NesT and MobileViT
(vit_pytorch_tpu_torch/models/local_vit.py, vit_for_small_dataset.py,
rvt.py, nest.py, mobile_vit.py) against the JAX package on the CPU, fp32, at
a small size (depth 1-2, dim <= 128, images <= 64 x 64), the same weights
and BatchNorm statistics on both sides (numpy draws at the JAX init's
shapes, loaded through ``utils/from_jax.py``) and the same inputs (numpy
seed): logits and every gradient (tests/torch_parity.py's bounds) at
dropout 0, the maps against the JAX converters, MobileViT's updated
BatchNorm statistics, and the pieces the models are built from: SPT's
shifts, LSA's tensor scale and its temperature's gradient, the hard-swish,
RvT's rotary tables and NesT's padded max-pool."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import flax.linen as fnn

import torch_parity as tp
from vit_pytorch_tpu.models import local_vit as j_local_vit
from vit_pytorch_tpu.models import mobile_vit as j_mobile_vit
from vit_pytorch_tpu.models import nest as j_nest
from vit_pytorch_tpu.models import rvt as j_rvt
from vit_pytorch_tpu.models import vit_for_small_dataset as j_small
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import local_vit, mobile_vit, nest, rvt, vit_for_small_dataset
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 2, 10
VIT = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)
# dim = heads * dim_head: the converter maps no cls_proj
RVT = VIT
RVT_CLS_PROJ = {**VIT, "dim_head": 64}
RVT_PLAIN = {**VIT, "use_rotary": False, "use_ds_conv": False, "use_glu": False}
# three levels at 16 x 16 (16 blocks of 4 x 4, dims 16, 32, 64, heads 2, 4, 8), 8 x 8, 4 x 4
NEST = dict(image_size=32, patch_size=2, num_classes=CLASSES, dim=16, heads=2, num_hierarchies=3,
            block_repeats=(1, 1, 2))
NEST_TWO = {**NEST, "num_hierarchies": 2, "block_repeats": 1}
# at 64 x 64: the stem at 32 and 16, the trunk's transformers at 8, 4 and 2
MOBILE = dict(image_size=(64, 64), dims=(16, 24, 32), channels=(8, 8, 16, 16, 16, 16, 24, 24, 32, 32, 64),
              num_classes=CLASSES, depths=(1, 2, 1))
MOBILE_NO_EXPANSION = {**MOBILE, "expansion": 1}

# name: (JAX class, port class, constructor, from_jax map, converter or None, input shape past the batch)
MODELS = {
    "local_vit": (j_local_vit.LocalViT, local_vit.LocalViT, VIT, from_jax.local_vit_state_dict_from_jax,
                  convert.convert_local_vit, (3, 32, 32)),
    "small_dataset_cls": (j_small.ViT, vit_for_small_dataset.ViT, VIT, from_jax.small_dataset_vit_state_dict_from_jax,
                          convert.convert_small_dataset_vit, (3, 32, 32)),
    "small_dataset_mean": (j_small.ViT, vit_for_small_dataset.ViT, {**VIT, "pool": "mean"},
                           from_jax.small_dataset_vit_state_dict_from_jax, convert.convert_small_dataset_vit,
                           (3, 32, 32)),
    "rvt": (j_rvt.RvT, rvt.RvT, RVT, from_jax.rvt_state_dict_from_jax, convert.convert_rvt, (3, 32, 32)),
    # the converter has no rule for SpatialConv's cls_proj, nor for a Linear to_q
    "rvt_cls_proj": (j_rvt.RvT, rvt.RvT, RVT_CLS_PROJ, from_jax.rvt_state_dict_from_jax, None, (3, 32, 32)),
    "rvt_plain": (j_rvt.RvT, rvt.RvT, RVT_PLAIN, from_jax.rvt_state_dict_from_jax, None, (3, 32, 32)),
    "nest": (j_nest.NesT, nest.NesT, NEST, from_jax.nest_state_dict_from_jax, convert.convert_nest, (3, 32, 32)),
    "nest_two_levels": (j_nest.NesT, nest.NesT, NEST_TWO, from_jax.nest_state_dict_from_jax, convert.convert_nest,
                        (3, 32, 32)),
    "mobile_vit": (j_mobile_vit.MobileViT, mobile_vit.MobileViT, MOBILE, from_jax.mobile_vit_state_dict_from_jax,
                   convert.convert_mobile_vit, (3, 64, 64)),
    # the converter reads only blocks with an expansion
    "mobile_vit_no_expansion": (j_mobile_vit.MobileViT, mobile_vit.MobileViT, MOBILE_NO_EXPANSION,
                                from_jax.mobile_vit_state_dict_from_jax, None, (3, 64, 64)),
}
BATCH_NORM_MODELS = ("mobile_vit", "mobile_vit_no_expansion")


def _setup(name):
    """The JAX model, its params (and moved statistics), the port's model
    loaded from them, the input."""
    jax_cls, port_cls, cfg, to_torch, _, shape = MODELS[name]
    return tp.setup_model(jax_cls, port_cls, cfg, to_torch, shape, batch=BATCH, batch_norm=name in BATCH_NORM_MODELS)


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Logits (eval and training mode) and every parameter gradient against
    the JAX model with the same weights and statistics."""
    jmodel, params, stats, model, x = _setup(name)
    jax_call = tp.stats_call(jmodel, stats) if stats is not None else None
    tp.check_model(jmodel, params, model, MODELS[name][3], x, tp.labels(BATCH, CLASSES), jax_call=jax_call)


@pytest.mark.parametrize("name", [n for n in MODELS if MODELS[n][4] is not None])
def test_state_dict_round_trip_is_exact(name):
    """Each map inverts the JAX converter of the reference layout (RvT's
    rotary scales are no buffer of the port's, as the converter drops the
    reference's), MobileViT's BatchNorm statistics included."""
    _, params, stats, model, _ = _setup(name)
    tp.assert_round_trip(MODELS[name][4], model, params, stats)


@pytest.mark.parametrize("name", BATCH_NORM_MODELS)
def test_batch_stats_match_jax(name):
    """A training-mode forward moves every BatchNorm's running mean and
    variance as JAX's ``mutable=["batch_stats"]`` does."""
    jmodel, params, stats, model, x = _setup(name)
    assert tp.check_batch_stats(jmodel, params, stats, model, MODELS[name][3], x) == len(jax.tree.leaves(stats))


@pytest.mark.parametrize("shift", vit_for_small_dataset.SHIFTS)
def test_spt_shift_matches_jax(shift):
    """``F.pad`` with a negative pad crops, as the JAX ``_pad_shift``."""
    x = tp.inputs((2, 3, 8, 8))
    tp.assert_close(F.pad(torch.from_numpy(x), shift), j_small._pad_shift(jnp.asarray(x), *shift), atol=0, rtol=0)


def test_lsa_scale_is_a_tensor(monkeypatch):
    """LSA hands the dispatcher ``exp(temperature)`` as a 0-d tensor in the
    autograd graph (no host sync, its gradient kept) and the mask of each
    query's own key."""
    seen = []
    orig = vit_for_small_dataset.dot_product_attention

    def spy(q, k, v, **kw):
        seen.append(kw)
        return orig(q, k, v, **kw)

    monkeypatch.setattr(vit_for_small_dataset, "dot_product_attention", spy)
    model = vit_for_small_dataset.ViT(**VIT, device="cpu")
    model(torch.from_numpy(tp.inputs((2, 3, 32, 32))))
    assert len(seen) == VIT["depth"]
    for kw in seen:
        assert isinstance(kw["scale"], torch.Tensor) and kw["scale"].dim() == 0 and kw["scale"].requires_grad
        assert torch.equal(kw["mask"], ~torch.eye(17, dtype=torch.bool))


def test_lsa_temperature_gradient_matches_jax():
    """The learned temperatures' gradients of the mean cross-entropy, at
    temperatures off their init value, against JAX's (nonzero)."""
    jmodel = j_small.ViT(**VIT)
    x, y = tp.inputs((BATCH, 3, 32, 32)), tp.labels(BATCH, CLASSES)
    params = tp.draw_params(jmodel, jnp.asarray(x),
                            special=lambda key, leaf, z: np.log(32**-0.5) + 0.2 * z if key == "temperature" else None)
    model = tp.load(vit_for_small_dataset.ViT(**VIT, device="cpu"),
                    from_jax.small_dataset_vit_state_dict_from_jax(params))
    _, grads = tp.jax_loss_and_grads(lambda p: jmodel.apply({"params": p}, jnp.asarray(x)), params, y)
    F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y).long()).backward()
    for i, (attn, _) in enumerate(model.transformer.layers):
        want = grads[f"layers_{i}_attn"]["temperature"]
        assert want != 0
        tp.assert_close(attn.temperature.grad, want, rtol=tp.GRAD_RTOL)


def test_hardswish_matches_flax():
    """torch's hard-swish is flax's at fp32 within two ulps (the two round
    x * relu6(x + 3) / 6 in their own orders), across its kinks at -3 and
    3, and exactly zero below -3."""
    x = np.linspace(-5, 5, 1001, dtype=np.float32)
    got, want = F.hardswish(torch.from_numpy(x)), fnn.activation.hard_swish(jnp.asarray(x))
    tp.assert_close(got, want, atol=1e-9, rtol=2.4e-7)
    assert not got[x < -3].any() and not np.asarray(want)[x < -3].any()


@pytest.mark.parametrize("dim_head, n, max_freq", [(32, 4, 32), (64, 8, 256)])
def test_rotary_tables_match_jax(dim_head, n, max_freq):
    """The axial sine and cosine tables, bit for bit the JAX module's."""
    got = rvt.axial_rotary_embedding(dim_head, n, max_freq)
    want = j_rvt.axial_rotary_embedding(dim_head, n, max_freq)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


def test_rotate_every_two_matches_jax():
    x = tp.inputs((2, 3, 5, 8))
    tp.assert_close(rvt.rotate_every_two(torch.from_numpy(x)), j_rvt.rotate_every_two(jnp.asarray(x)), atol=0, rtol=0)


def test_rvt_tables_stay_float32_outside_the_buffers():
    """The rotary's tables are constants, not buffers: the state_dict holds
    none, and a bf16 cast of the model leaves them float32."""
    model = rvt.RvT(**RVT, device="cpu").to(torch.bfloat16)
    assert not any("sin" in k or "cos" in k or "scales" in k for k in model.state_dict())
    sin, cos = model.tables(torch.device("cpu"))
    assert sin.dtype == cos.dtype == torch.float32
    want = j_rvt.axial_rotary_embedding(32, 4, 32)
    assert np.array_equal(sin.numpy(), np.asarray(want[0])) and np.array_equal(cos.numpy(), np.asarray(want[1]))
    out = model(torch.from_numpy(tp.inputs((1, 3, 32, 32))).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_nest_aggregate_pads_with_minus_infinity():
    """The aggregation's max-pool on a map of negative values: the padding
    never wins, as flax's ``max_pool`` pads with -inf."""
    x = -np.abs(tp.inputs((2, 4, 6, 6))) - 1
    got = nest.Aggregate(4, 4, device="cpu")[2](torch.from_numpy(x))
    want = fnn.max_pool(jnp.asarray(x.transpose(0, 2, 3, 1)), (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
    tp.assert_close(got, np.asarray(want).transpose(0, 3, 1, 2), atol=0, rtol=0)
    assert (got < 0).all()


def test_entry_points_build_on_the_card_by_default():
    """Without ``device`` each model builds on the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("local_vit", "small_dataset_cls", "rvt", "nest", "mobile_vit"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MODELS[name][1](**MODELS[name][2])
