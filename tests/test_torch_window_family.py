"""The port's SepViT, LeViT, CrossFormer, RegionViT and ScalableViT
(vit_pytorch_tpu_torch/models/sep_vit.py, levit.py, crossformer.py,
regionvit.py, scalable_vit.py) against the JAX package on the CPU, fp32, at
a small size (depth 1-2, dim <= 64, images <= 96 x 96), the same weights and
BatchNorm statistics on both sides (numpy draws at the JAX init's shapes,
loaded through ``utils/from_jax.py``) and the same inputs (numpy seed):
logits and every gradient (tests/torch_parity.py's bounds) at dropout 0, the
maps against the JAX converters, LeViT's updated BatchNorm statistics, and
the per-head bias tables each model hands the dispatcher (LeViT's divided
by the scale, RegionViT's padded for the region token, CrossFormer's
broadcast dynamic position bias) bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_parity as tp
from vit_pytorch_tpu.models import crossformer as j_crossformer
from vit_pytorch_tpu.models import levit as j_levit
from vit_pytorch_tpu.models import regionvit as j_regionvit
from vit_pytorch_tpu.models import scalable_vit as j_scalable
from vit_pytorch_tpu.models import sep_vit as j_sep_vit
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import crossformer, levit, regionvit, scalable_vit, sep_vit
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 2, 10
# two stages at 8 x 8 and 4 x 4, 4 windows each; with windows of 4 the second stage has one window, where the
# JAX model builds no window-token projection
SEP = dict(num_classes=CLASSES, dim=16, depth=(1, 1), heads=(1, 2), window_size=(4, 2), dim_head=16)
SEP_ONE_WINDOW = {**SEP, "window_size": 4}
# stages at 4 x 4, 2 x 2 and 1 x 1 (the downsampling attention's queries every second position), at bs=8
# every BatchNorm over 8 or more values a channel
LEVIT = dict(image_size=64, num_classes=CLASSES, dim=(32, 48, 64), depth=1, heads=(2, 3, 4), mlp_mult=2,
             dim_key=16, dim_value=32)
LEVIT_DISTILL = {**LEVIT, "stages": 2, "dim": (32, 48), "heads": (2, 3), "num_distill_classes": 5}
# stages at 16, 8, 4 and 2: short windows of 4, 4, 2, 2 and long windows over 4, 2, 2, 1 positions;
# the first embedding at three kernel sizes
CROSS = dict(dim=(32, 32, 64, 64), depth=1, global_window_size=(4, 2, 2, 1), local_window_size=(4, 4, 2, 2),
             cross_embed_kernel_sizes=((2, 4, 8), (2, 4), (2, 4), (2, 4)), cross_embed_strides=2,
             num_classes=CLASSES)
# at 96 x 96: local tokens 24 -> 12 -> 6 -> 3 a side, region tokens 8 -> 4 -> 2 -> 1, windows of 3 x 3
REGION = dict(dim=(16, 32, 32, 64), depth=1, window_size=3, num_classes=CLASSES)
REGION_OPTIONS = {**REGION, "use_peg": True, "tokenize_local_3_conv": True}
# at 64 x 64: stages at 16, 8 and 4, windows of 4 and 2 then the whole map, keys reduced by 4, 2, 1
SCALABLE = dict(num_classes=CLASSES, dim=16, depth=(2, 1, 1), heads=(1, 2, 2), reduction_factor=(4, 2, 1),
                window_size=(4, 2, None), ssa_dim_key=(8, 8, 16), iwsa_dim_key=8, ssa_dim_value=8,
                iwsa_dim_value=16)

# name: (JAX class, port class, constructor, from_jax map, converter or None, input shape past the batch, batch)
MODELS = {
    "sep_vit": (j_sep_vit.SepViT, sep_vit.SepViT, SEP, from_jax.sep_vit_state_dict_from_jax, convert.convert_sep_vit,
                (3, 32, 32), BATCH),
    # the converter reads the window-token projections the JAX model does not build here
    "sep_vit_one_window": (j_sep_vit.SepViT, sep_vit.SepViT, SEP_ONE_WINDOW, from_jax.sep_vit_state_dict_from_jax,
                           None, (3, 32, 32), BATCH),
    "levit": (j_levit.LeViT, levit.LeViT, LEVIT, from_jax.levit_state_dict_from_jax, convert.convert_levit,
              (3, 64, 64), 8),
    # the converter has no rule for the distillation head
    "levit_distill": (j_levit.LeViT, levit.LeViT, LEVIT_DISTILL, from_jax.levit_state_dict_from_jax, None,
                      (3, 64, 64), 8),
    "crossformer": (j_crossformer.CrossFormer, crossformer.CrossFormer, CROSS,
                    from_jax.crossformer_state_dict_from_jax, convert.convert_crossformer, (3, 32, 32), BATCH),
    "regionvit": (j_regionvit.RegionViT, regionvit.RegionViT, REGION, from_jax.regionvit_state_dict_from_jax,
                  convert.convert_regionvit, (3, 96, 96), BATCH),
    # the converter maps neither the position generators nor the three-convolution tokenizer
    "regionvit_peg_3_conv": (j_regionvit.RegionViT, regionvit.RegionViT, REGION_OPTIONS,
                             from_jax.regionvit_state_dict_from_jax, None, (3, 96, 96), BATCH),
    "scalable_vit": (j_scalable.ScalableViT, scalable_vit.ScalableViT, SCALABLE,
                     from_jax.scalable_vit_state_dict_from_jax, convert.convert_scalable_vit, (3, 64, 64), BATCH),
}
BATCH_NORM_MODELS = ("levit", "levit_distill")


def _setup(name):
    """The JAX model, its params (and moved statistics), the port's model
    loaded from them (its parameters the JAX tree lacks at zero), the
    input."""
    jax_cls, port_cls, cfg, to_torch, _, shape, batch = MODELS[name]
    jmodel = jax_cls(**cfg)
    x = tp.inputs((batch, *shape))
    params = tp.draw_params(jmodel, jnp.asarray(x))
    stats = tp.moved_stats(jmodel, jnp.asarray(x)) if name in BATCH_NORM_MODELS else None
    model = port_cls(**cfg, device="cpu")
    to_torch = tp.with_absent_zeros(to_torch, model)
    tp.load(model, to_torch(params) if stats is None else to_torch(params, stats))
    return jmodel, params, stats, model, x, to_torch


def _both_heads(call):
    """A model's call with its logits and its distillation logits side by
    side, for one cross-entropy over both."""

    def joined(*args):
        out = call(*args)
        cat = torch.cat if isinstance(out[0], torch.Tensor) else jnp.concatenate
        return cat(out, -1)

    return joined


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Logits (eval and training mode) and every parameter gradient against
    the JAX model with the same weights and statistics."""
    jmodel, params, stats, model, x, to_torch = _setup(name)
    jax_call = tp.stats_call(jmodel, stats) if stats is not None else None
    port_call = None
    if name == "levit_distill":
        jax_call, port_call = _both_heads(jax_call), _both_heads(lambda m, x: m(x))
    tp.check_model(jmodel, params, model, to_torch, x, tp.labels(x.shape[0], CLASSES), jax_call=jax_call,
                   port_call=port_call)


@pytest.mark.parametrize("name", [n for n in MODELS if MODELS[n][4] is not None])
def test_state_dict_round_trip_is_exact(name):
    """Each map inverts the JAX converter of the reference layout, LeViT's
    BatchNorm statistics included."""
    _, params, stats, model, _, _ = _setup(name)
    tp.assert_round_trip(MODELS[name][4], model, params, stats)


@pytest.mark.parametrize("name", BATCH_NORM_MODELS)
def test_batch_stats_match_jax(name):
    """A training-mode forward moves every BatchNorm's running mean and
    variance as JAX's ``mutable=["batch_stats"]`` does: q, k, v and the
    output's, a layer."""
    jmodel, params, stats, model, x, to_torch = _setup(name)
    stages = LEVIT.get("stages", 3) if name == "levit" else 2
    assert tp.check_batch_stats(jmodel, params, stats, model, to_torch, x) == 2 * 4 * (2 * stages - 1)


@pytest.mark.parametrize("fmap_size, downsample", [(4, False), (4, True), (7, False), (7, True), (14, True)])
def test_levit_pos_indices_match_jax(fmap_size, downsample):
    got = levit.levit_pos_indices(fmap_size, downsample)
    assert np.array_equal(got, j_levit.levit_pos_indices(fmap_size, downsample))
    assert got.shape == (((fmap_size + 1) // 2 if downsample else fmap_size) ** 2, fmap_size**2)


def test_levit_init_zeroes_the_output_batch_norms():
    """As the JAX init (and the reference, levit.py:124): every attention's
    output BatchNorm scale at zero, the others at one; the downsampling
    attention has no residual and the convolutions' biases start at zero,
    so the logits at init are zero on both sides."""
    model = levit.LeViT(**LEVIT, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    attns = [m for m in model.modules() if isinstance(m, levit.Attention)]
    assert len(attns) == 5
    for attn in attns:
        assert not attn.to_out[2].weight.any()
        assert all(bool((proj[1].weight == 1).all()) for proj in (attn.to_q, attn.to_k, attn.to_v))
    x = tp.inputs((2, 3, 64, 64))
    jmodel = j_levit.LeViT(**LEVIT)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scales = [v for k, v in flatten_dict(variables["params"]).items() if k[-2] == "out_bn" and k[-1] == "scale"]
    assert len(scales) == 5 and not any(np.asarray(s).any() for s in scales)
    assert not np.asarray(jmodel.apply(variables, jnp.asarray(x))).any()
    with torch.no_grad():
        assert not model(torch.from_numpy(x)).any()


@pytest.mark.parametrize("name", ["levit", "regionvit", "crossformer"])
def test_attention_biases_match_jax(name, monkeypatch):
    """Every bias table the model hands the dispatcher in one eval forward
    against the JAX model's: LeViT's gathered rows over the scale and
    RegionViT's table at ``rel[0] * 1 + rel[1] * (2w - 1)`` with the zero row
    and column of the region token bit for bit; CrossFormer's dynamic
    position bias, one table for every head, within the fp32 bound (its MLP's
    products sum in another order: the gather and broadcast are held bit for
    bit by ``test_crossformer_broadcast_matches_jax``)."""
    jmodel, params, stats, model, x, _ = _setup(name)
    modules = {"levit": (j_levit, levit), "regionvit": (j_regionvit, regionvit),
               "crossformer": (j_crossformer, crossformer)}[name]
    seen = {"jax": [], "port": []}
    for side, module in zip(seen, modules):
        orig = module.dot_product_attention

        def spy(q, k, v, *, _orig=orig, _seen=seen[side], **kw):
            if kw.get("bias") is not None:
                _seen.append(np.asarray(kw["bias"].detach() if isinstance(kw["bias"], torch.Tensor) else kw["bias"]))
            return _orig(q, k, v, **kw)

        monkeypatch.setattr(module, "dot_product_attention", spy)
    variables = {"params": params} if stats is None else {"params": params, "batch_stats": stats}
    jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        model.eval()(torch.from_numpy(x))
    assert len(seen["port"]) == len(seen["jax"]) > 0
    for got, want in zip(seen["port"], seen["jax"]):
        assert got.shape == want.shape and got.ndim == 3
        if name == "crossformer":
            tp.assert_close(got, want)
            assert (got == got[:1]).all()
        else:
            assert np.array_equal(got, want)
        if name == "regionvit":
            assert not got[:, 0].any() and not got[:, :, 0].any()


@pytest.mark.parametrize("window_size, heads", [(2, 1), (4, 3), (7, 2)])
def test_crossformer_broadcast_matches_jax(window_size, heads):
    """One dynamic-position-bias value an offset gathered at the window's
    pairs and broadcast over the heads, bit for bit the JAX module's
    ``jnp.broadcast_to(biases[idx], (h,) + idx.shape)``."""
    biases = tp.inputs(((2 * window_size + 1) ** 2,))
    idx = j_crossformer.rel_pos_indices(window_size)
    want = jnp.broadcast_to(jnp.asarray(biases)[idx], (heads,) + idx.shape)
    got = crossformer.broadcast_position_bias(torch.from_numpy(biases),
                                              torch.from_numpy(crossformer.rel_pos_indices(window_size)), heads)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_region_rel_pos_indices_match_the_jax_formula():
    """The index formula as the JAX module writes it, on a window of 3 x 2:
    every pair's (dy + w - 1) + (dx + w - 1) * (2w - 1)."""
    idx = regionvit.region_rel_pos_indices(3, 2, 4)
    pos = [(i, j) for i in range(3) for j in range(2)]
    want = [[(a[0] - b[0] + 3) + (a[1] - b[1] + 3) * 7 for b in pos] for a in pos]
    assert np.array_equal(idx, np.array(want))


def test_entry_points_build_on_the_card_by_default():
    """Without ``device`` each model builds on the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("sep_vit", "levit", "crossformer", "regionvit", "scalable_vit"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MODELS[name][1](**MODELS[name][2])
