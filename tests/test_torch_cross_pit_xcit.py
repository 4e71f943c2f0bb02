"""The port's CrossViT, PiT, XCiT, CvT and Twins-SVT
(vit_pytorch_tpu_torch/models/cross_vit.py, pit.py, xcit.py, cvt.py,
twins_svt.py) against the JAX package on the CPU, fp32, at a small size
(depth 1-2, dim <= 128, images <= 64 x 64), the same weights and BatchNorm
statistics on both sides (numpy draws at the JAX init's shapes, loaded
through ``utils/from_jax.py``) and the same inputs (numpy seed): logits and
every gradient (tests/torch_parity.py's bounds) with dropout and layer
dropout at rate 0, the maps against the JAX converters, the BatchNorms'
updated statistics, the kernel routes CrossViT and PiT take on the card
forced on both sides (the JAX kernels in interpret mode, the port's
Functions on their twins), and the train-time randomness by its
behaviour."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from vit_pytorch_tpu.models import cross_vit as j_cross_vit
from vit_pytorch_tpu.models import cvt as j_cvt
from vit_pytorch_tpu.models import pit as j_pit
from vit_pytorch_tpu.models import twins_svt as j_twins
from vit_pytorch_tpu.models import xcit as j_xcit
from vit_pytorch_tpu.nn.patch import unfold_2d
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import cross_vit, cvt, pit, twins_svt, xcit
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 2, 10
# the small branch 64 wide at 17 tokens, the large 128 wide at 5
CROSS = dict(image_size=32, num_classes=CLASSES, sm_dim=64, lg_dim=128, sm_patch_size=8, sm_enc_depth=1,
             sm_enc_heads=2, sm_enc_mlp_dim=128, sm_enc_dim_head=64, lg_patch_size=16, lg_enc_depth=1,
             lg_enc_heads=2, lg_enc_mlp_dim=128, lg_enc_dim_head=64, cross_attn_depth=1, cross_attn_heads=2,
             cross_attn_dim_head=32, depth=2, dropout=0.0, emb_dropout=0.0)
CROSS_EQUAL = {**CROSS, "lg_dim": 64}  # no projections in and out
# 50, 17 and 5 tokens, 32, 64 and 128 wide
PIT = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=32, depth=(1, 1, 1), heads=2, mlp_dim=64,
           dim_head=64)
PIT_HEADS = {**PIT, "depth": (2, 1), "heads": (1, 2)}
XCIT = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=64, depth=2, cls_depth=1, heads=2, mlp_dim=128,
            dim_head=32)
# three stages at 16, 8 and 4 (keys 8, 4 and 2 wide: every BatchNorm over 8 or more values a channel)
CVT = dict(num_classes=CLASSES, s1_emb_dim=16, s1_heads=1, s1_depth=1, s2_emb_dim=32, s2_heads=1, s2_depth=1,
           s3_emb_dim=64, s3_heads=2, s3_depth=1)
# stages at 8, 4, 2 and 1: local windows of 4, 2, 2 and keys subsampled by 4, 2, 2, 1
TWINS = dict(num_classes=CLASSES, s1_emb_dim=16, s1_local_patch_size=4, s1_global_k=4, s2_emb_dim=32,
             s2_local_patch_size=2, s2_global_k=2, s3_emb_dim=48, s3_local_patch_size=2, s3_global_k=2, s3_depth=1,
             s4_emb_dim=64, s4_global_k=1, s4_depth=1)

# name: (JAX class, port class, constructor, from_jax map, converter, input shape past the batch)
MODELS = {
    "cross_vit": (j_cross_vit.CrossViT, cross_vit.CrossViT, CROSS, from_jax.cross_vit_state_dict_from_jax,
                  convert.convert_cross_vit, (3, 32, 32)),
    "cross_vit_equal_dims": (j_cross_vit.CrossViT, cross_vit.CrossViT, CROSS_EQUAL,
                             from_jax.cross_vit_state_dict_from_jax, convert.convert_cross_vit, (3, 32, 32)),
    "pit": (j_pit.PiT, pit.PiT, PIT, from_jax.pit_state_dict_from_jax, convert.convert_pit, (3, 32, 32)),
    "pit_stage_heads": (j_pit.PiT, pit.PiT, PIT_HEADS, from_jax.pit_state_dict_from_jax, convert.convert_pit,
                        (3, 32, 32)),
    "xcit": (j_xcit.XCiT, xcit.XCiT, XCIT, from_jax.xcit_state_dict_from_jax, convert.convert_xcit, (3, 32, 32)),
    "cvt": (j_cvt.CvT, cvt.CvT, CVT, from_jax.cvt_state_dict_from_jax, convert.convert_cvt, (3, 64, 64)),
    "twins_svt": (j_twins.TwinsSVT, twins_svt.TwinsSVT, TWINS, from_jax.twins_svt_state_dict_from_jax,
                  convert.convert_twins_svt, (3, 32, 32)),
}
BATCH_NORM_MODELS = ("xcit", "cvt")


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


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_round_trip_is_exact(name):
    """Each map inverts the JAX converter of the reference layout, the
    BatchNorms' statistics included."""
    _, params, stats, model, _ = _setup(name)
    tp.assert_round_trip(MODELS[name][4], model, params, stats)


@pytest.mark.parametrize("name", BATCH_NORM_MODELS)
def test_batch_stats_match_jax(name):
    """A training-mode forward moves every BatchNorm's running mean and
    variance as JAX's ``mutable=["batch_stats"]`` does."""
    jmodel, params, stats, model, x = _setup(name)
    n = tp.check_batch_stats(jmodel, params, stats, model, MODELS[name][3], x)
    assert n == 2 * (2 if name == "xcit" else 2 * 3)  # XCiT: one a layer; CvT: q's and kv's a layer, 3 stages


@pytest.mark.parametrize("name", ["cross_vit", "pit"])
def test_layer_kernel_routes_match_jax(name, monkeypatch):
    """With the layer kernels' routes forced on both sides, every
    ``Transformer`` layer (CrossViT's two branches, PiT's three stages) on
    the whole-layer Function and CrossViT's cls-only cross-attention on the
    composite; logits and every gradient still the JAX model's."""
    calls = tp.force_layer_routes(monkeypatch)
    jmodel, params, _, model, x = _setup(name)
    port_fb.reset_launch_counts()
    tp.check_model(jmodel, params, model, MODELS[name][3], x, tp.labels(BATCH, CLASSES))
    assert not any(port_fb.LAUNCHES.values())
    if name == "cross_vit":
        one_pass = [(BATCH, 17, 64), (BATCH, 5, 128)] * CROSS["depth"]
    else:
        one_pass = [(BATCH, 50, 32), (BATCH, 17, 64), (BATCH, 5, 128)]
    assert calls == {"layer": one_pass * 2, "block": []}  # eval, training


@pytest.mark.parametrize("name", ["cross_vit", "pit"])
def test_dropout_on_the_attention_block_route(name, monkeypatch):
    """Training at dropout 0.1 with the routes forced: every ``Transformer``
    layer's attention on the attention-block Function (the whole layer
    refuses dropout in training), the same seeds give the same logits, the
    gradients are finite, and dropout moves the logits off the eval ones."""
    calls = tp.force_layer_routes(monkeypatch)
    cfg = {**MODELS[name][2], "dropout": 0.1}
    model = MODELS[name][1](**cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(tp.inputs((BATCH, *MODELS[name][5])))
    runs = []
    for _ in range(2):
        torch.manual_seed(3)
        runs.append(model(x))
    assert torch.equal(runs[0], runs[1])
    runs[0].sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    assert calls["layer"] == [] and len(calls["block"]) == 2 * (2 * CROSS["depth"] if name == "cross_vit" else 3)
    with torch.no_grad():
        assert not torch.allclose(runs[0], model.eval()(x))
    assert calls["layer"]  # served, the whole layer again


def test_pit_unfold_matches_jax():
    """PiT's overlapping patches: ``nn.Unfold`` at stride p/2 then the
    transpose give the JAX ``unfold_2d``'s (b, L, c k k), channel slowest."""
    x = tp.inputs((2, 3, 32, 32))
    model = pit.PiT(**PIT, device="cpu")
    got = model.to_patch_embedding[:2](torch.from_numpy(x))
    tp.assert_close(got, unfold_2d(jnp.asarray(x), 8, 4, 0), atol=0, rtol=0)


def test_pit_pool_matches_jax():
    """The pool alone: the cls token through its Linear, the grid through
    the stride-2 grouped convolution (groups gcd(dim_in, dim_out)) and the
    1x1 one, the grid's order kept."""
    jpool = j_pit.Pool(dim=32)
    x = tp.inputs((2, 50, 32))
    params = tp.draw_params(jpool, jnp.asarray(x))
    pool = pit.Pool(32, device="cpu")
    state = from_jax.pit_state_dict_from_jax({"stage_0_transformer": {}, "stage_0_pool": params})
    pool.load_state_dict({k.removeprefix("layers.1."): v for k, v in state.items()})
    assert pool.downsample.net[0].groups == 32
    got = pool(torch.from_numpy(x))
    assert got.shape == (2, 17, 64)
    tp.assert_close(got, jpool.apply({"params": params}, jnp.asarray(x)))


def test_layer_keep_mask_keeps_one_layer():
    """At rate 1 every layer's uniform falls under the rate and exactly one
    drawn layer stays; at rate 0 all stay; the draw is the generator's."""
    for seed in range(8):
        keep = xcit.layer_keep_mask(5, 1.0, torch.Generator().manual_seed(seed))
        assert sum(keep) == 1
    assert xcit.layer_keep_mask(5, 0.0, torch.Generator().manual_seed(0)) == [True] * 5
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert xcit.layer_keep_mask(6, 0.5, g1) == xcit.layer_keep_mask(6, 0.5, g2)
    assert xcit.layer_keep_mask(0, 0.5) == []


def test_layer_keep_mask_rate():
    """Over 4,000 draws of 4 layers at rate 0.3 a layer is kept 0.7 of the
    time (the forced layer adds 0.3^4 / 4 = 0.002), every layer alike."""
    g = torch.Generator().manual_seed(0)
    keep = np.array([xcit.layer_keep_mask(4, 0.3, g) for _ in range(4000)], dtype=np.float64)
    assert abs(keep.mean() - 0.702) < 0.01
    assert np.all(np.abs(keep.mean(axis=0) - 0.702) < 0.03)
    assert keep.sum(axis=1).min() >= 1


def test_xcit_layer_dropout_forward_is_the_kept_layers():
    """In training at layer dropout 0.5 the forward equals the kept layers
    alone (the patch layers' mask drawn first, then the class layers'),
    and a dropped layer's BatchNorm still moves its statistics, as the JAX
    model computes every local patch interaction; eval mode keeps every
    layer."""
    cfg = {**XCIT, "depth": 3, "cls_depth": 2, "layer_dropout": 0.5}
    model = xcit.XCiT(**cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(tp.inputs((2, 3, 32, 32)))
    seed = next(s for s in range(100)
                if not all(model.train().keep(torch.Generator().manual_seed(s))[0]))
    keep, keep_cls = model.keep(torch.Generator().manual_seed(seed))
    stats = [m.running_mean.clone() for m in model.modules() if isinstance(m, xcit.BatchNorm)]
    with torch.no_grad():
        got = model(x, torch.Generator().manual_seed(seed))
    moved = [m.running_mean for m in model.modules() if isinstance(m, xcit.BatchNorm)]
    assert all(not torch.equal(a, b) for a, b in zip(stats, moved))
    model.eval()
    with torch.no_grad():
        h = model.to_patch_embedding(x) + model.pos_embedding
        for (attn, lpi, ff), k in zip(model.xcit_transformer.layers, keep):
            if k:
                h = attn(h) + h
                lpi.fn.net[3].train()  # the training forward's batch statistics
                h = lpi(h) + h
                lpi.fn.net[3].eval()
                h = ff(h) + h
        h = model.final_norm(h)
        c = model.cls_token.expand(2, 1, -1)
        for (attn, ff), k in zip(model.cls_transformer.layers, keep_cls):
            if k:
                c = attn(c, context=h) + c
                c = ff(c) + c
        torch.testing.assert_close(got, model.mlp_head(c[:, 0]))
    assert model.keep() == ([True] * 3, [True] * 2)


def test_xcit_attention_matches_jax():
    """The cross-covariance attention alone, at a temperature off one:
    the (d, d) similarity of the tokens' L2-normalised q and k."""
    jattn = j_xcit.XCAttention(dim=64, heads=2, dim_head=32)
    x = tp.inputs((2, 16, 64))
    params = tp.draw_params(jattn, jnp.asarray(x), special=lambda key, leaf, z: 1 + 0.3 * z if key == "temperature"
                            else None)
    attn = xcit.XCAttention(64, 2, 32, device="cpu")
    state = from_jax.xcit_state_dict_from_jax({"xca_0_attn": params})
    attn.load_state_dict({k.removeprefix("xcit_transformer.layers.0.0.fn."): v for k, v in state.items()})
    tp.assert_close(attn(torch.from_numpy(x)), jattn.apply({"params": params}, jnp.asarray(x)))


def test_cvt_keys_per_stage():
    """At 224 x 224 and the constructor's defaults the three stages attend
    3,136, 784 and 196 queries to 784, 196 and 49 keys."""
    model = cvt.CvT(num_classes=CLASSES, device="meta")
    shapes = []

    def spy(module, args, out):
        shapes.append((args[0].shape[-2] * args[0].shape[-1], out.shape[-2] * out.shape[-1]))

    for stage in model.layers:
        stage[2].layers[0][0].to_kv.register_forward_hook(spy)
    model(torch.empty(1, 3, 224, 224, device="meta"))
    assert shapes == [(3136, 784), (784, 196), (196, 49)]


def test_twins_windows_match_jax():
    """Twins-SVT's local attention alone on 4 x 4 windows of an 8 x 8 map
    and its global attention on keys subsampled by 4: the JAX modules'."""
    x = tp.inputs((2, 8, 8, 32))  # NHWC, the JAX modules' layout
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    for jcls, pcls, kw, name in ((j_twins.LocalAttention, twins_svt.LocalAttention, {"patch_size": 4}, "local_attn"),
                                 (j_twins.GlobalAttention, twins_svt.GlobalAttention, {"k": 4}, "global_attn")):
        jm = jcls(dim=32, heads=2, dim_head=16, **kw)
        params = tp.draw_params(jm, jnp.asarray(x))
        pm = pcls(32, 2, 16, 0.0, *kw.values(), device="cpu")
        state = from_jax.twins_svt_state_dict_from_jax({"s1_transformer": {f"layers_0_{name}": params}})
        idx = 0 if name == "local_attn" else 2
        pm.load_state_dict({k.removeprefix(f"layers.0.3.layers.0.{idx}.fn."): v for k, v in state.items()})
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x))).transpose(0, 3, 1, 2)
        tp.assert_close(pm(xt), want)


def test_entry_points_build_on_the_card_by_default():
    """Without ``device`` each model builds on the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("cross_vit", "pit", "xcit", "cvt", "twins_svt"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MODELS[name][1](**MODELS[name][2])
