"""The port's DeepViT, CaiT, ParallelViT, T2T-ViT, CCT, CCT-3D and the
efficient-ViT shell (vit_pytorch_tpu_torch/models/deepvit.py, cait.py,
parallel_vit.py, t2t.py, cct.py, cct_3d.py, efficient.py) against the JAX
package on the CPU, fp32, at a small size (depth 2, dim 128, heads 2,
dim_head 64), the same weights on both sides (numpy draws at the JAX init's
shapes, loaded through ``utils/from_jax.py``) and the same inputs (numpy
seed): logits and every gradient (tests/torch_parity.py's bounds) with
dropout, stochastic depth and layer dropout at rate 0, the maps against the
JAX converters, the kernel routes the models take on the card forced on
both sides (the JAX kernels in interpret mode, the port's Functions on
their twins; CCT-3D's flash route on the port's side), and the train-time
randomness by its behaviour."""

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from vit_pytorch_tpu.models import cait as j_cait
from vit_pytorch_tpu.models import cct as j_cct
from vit_pytorch_tpu.models import cct_3d as j_cct_3d
from vit_pytorch_tpu.models import deepvit as j_deepvit
from vit_pytorch_tpu.models import efficient as j_efficient
from vit_pytorch_tpu.models import parallel_vit as j_parallel
from vit_pytorch_tpu.models import t2t as j_t2t
from vit_pytorch_tpu.nn import blocks as jax_blocks
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import cait, cct, cct_3d, deepvit, efficient, parallel_vit, t2t
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 3, 10
BODY = dict(num_classes=CLASSES, dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)
IMAGE = dict(image_size=32, patch_size=8)  # 16 patches
NO_DROP = dict(dropout_rate=0.0, attention_dropout=0.0, stochastic_depth_rate=0.0)
CCT_BODY = dict(embedding_dim=128, num_layers=2, num_heads=2, mlp_ratio=1.0, num_classes=CLASSES, **NO_DROP)
CCT_2D = dict(img_size=32, n_conv_layers=2, kernel_size=3, stride=1, padding=1, **CCT_BODY)  # 64 tokens
CCT_3D = dict(img_size=16, num_frames=4, n_conv_layers=1, kernel_size=3, stride=1, padding=1, **CCT_BODY)
# 8 frames strided and pooled to 2
CCT_3D_STRIDED = {**CCT_3D, "num_frames": 8, "frame_stride": 2, "frame_pooling_kernel_size": 3,
                  "frame_pooling_stride": 2}


def _transformer_pair(**kw):
    """A JAX ``Transformer`` and the port's of the same widths."""
    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256, **kw)
    return jax_blocks.Transformer(**cfg), torch_blocks.Transformer(**cfg, device="cpu")


def _efficient(kind):
    """A factory of the efficient shell around the JAX or the port's
    ``Transformer`` (a new one a call)."""
    cfg = dict(**IMAGE, num_classes=CLASSES, dim=128)
    if kind == "jax":
        return lambda: j_efficient.ViT(**cfg, transformer=_transformer_pair()[0])
    return lambda **kw: efficient.ViT(**cfg, transformer=_transformer_pair()[1], **kw)


# name: (JAX model factory, port model factory, from_jax map, converter or None, input shape past the batch)
MODELS = {
    "deepvit_cls": (lambda: j_deepvit.DeepViT(**BODY, **IMAGE), lambda **kw: deepvit.DeepViT(**BODY, **IMAGE, **kw),
                    from_jax.deepvit_state_dict_from_jax, convert.convert_deepvit, (3, 32, 32)),
    "deepvit_mean": (lambda: j_deepvit.DeepViT(**BODY, **IMAGE, pool="mean"),
                     lambda **kw: deepvit.DeepViT(**BODY, **IMAGE, pool="mean", **kw),
                     from_jax.deepvit_state_dict_from_jax, convert.convert_deepvit, (3, 32, 32)),
    "cait": (lambda: j_cait.CaiT(**BODY, **IMAGE, cls_depth=1), lambda **kw: cait.CaiT(**BODY, **IMAGE, cls_depth=1, **kw),
             from_jax.cait_state_dict_from_jax, convert.convert_cait, (3, 32, 32)),
    "parallel_vit": (lambda: j_parallel.ViT(**BODY, **IMAGE), lambda **kw: parallel_vit.ViT(**BODY, **IMAGE, **kw),
                     from_jax.parallel_vit_state_dict_from_jax, convert.convert_parallel_vit, (3, 32, 32)),
    "parallel_vit_3_mean": (lambda: j_parallel.ViT(**BODY, **IMAGE, num_parallel_branches=3, pool="mean"),
                            lambda **kw: parallel_vit.ViT(**BODY, **IMAGE, num_parallel_branches=3, pool="mean", **kw),
                            from_jax.parallel_vit_state_dict_from_jax, convert.convert_parallel_vit, (3, 32, 32)),
    # one channel: the stem transformers 49 and 441 wide, the projection from 3,969
    "t2t": (lambda: j_t2t.T2TViT(**{**BODY, "image_size": 32}, channels=1),
            lambda **kw: t2t.T2TViT(**{**BODY, "image_size": 32}, channels=1, **kw),
            from_jax.t2t_state_dict_from_jax, convert.convert_t2t, (1, 32, 32)),
    "cct_sine": (lambda: j_cct.CCT(**CCT_2D), lambda **kw: cct.CCT(**CCT_2D, **kw), from_jax.cct_state_dict_from_jax,
                 convert.convert_cct, (3, 32, 32)),
    "cct_learnable_cls": (lambda: j_cct.CCT(**CCT_2D, positional_embedding="learnable", seq_pool=False),
                          lambda **kw: cct.CCT(**CCT_2D, positional_embedding="learnable", seq_pool=False, **kw),
                          from_jax.cct_state_dict_from_jax, convert.convert_cct, (3, 32, 32)),
    "cct_none": (lambda: j_cct.CCT(**CCT_2D, positional_embedding="none"),
                 lambda **kw: cct.CCT(**CCT_2D, positional_embedding="none", **kw), from_jax.cct_state_dict_from_jax,
                 convert.convert_cct, (3, 32, 32)),
    "cct_3d": (lambda: j_cct_3d.CCT(**CCT_3D), lambda **kw: cct_3d.CCT(**CCT_3D, **kw),
               from_jax.cct_3d_state_dict_from_jax, convert.convert_cct_3d, (3, 4, 16, 16)),
    "cct_3d_learnable_strided": (
        lambda: j_cct_3d.CCT(**CCT_3D_STRIDED, positional_embedding="learnable"),
        lambda **kw: cct_3d.CCT(**CCT_3D_STRIDED, positional_embedding="learnable", **kw),
        from_jax.cct_3d_state_dict_from_jax, convert.convert_cct_3d, (3, 8, 16, 16)),
    "efficient": (_efficient("jax"), _efficient("port"), from_jax.efficient_vit_state_dict_from_jax, None,
                  (3, 32, 32)),
}


def _setup(name):
    jax_factory, port_factory, to_torch, *_, shape = MODELS[name]
    jmodel = jax_factory()
    x = tp.inputs((BATCH, *shape))
    params = tp.draw_params(jmodel, jnp.asarray(x))
    model = tp.load(port_factory(device="cpu"), to_torch(params))
    return jmodel, params, model, x


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Logits (eval and training mode) and every parameter gradient against
    the JAX model with the same weights."""
    jmodel, params, model, x = _setup(name)
    tp.check_model(jmodel, params, model, MODELS[name][2], x, tp.labels(BATCH, CLASSES))


@pytest.mark.parametrize("name", [n for n in MODELS if MODELS[n][3] is not None])
def test_state_dict_round_trip_is_exact(name):
    """Each map inverts the JAX converter of the reference layout (the sine
    table is a buffer outside the port's state_dict, as the converter's
    ``sine_pos`` drops the reference's)."""
    _, params, model, _ = _setup(name)
    tp.assert_round_trip(MODELS[name][3], model, params)


def test_efficient_round_trip_with_the_transformer_rules():
    """The efficient shell's map with the shared Transformer's inverts
    ``convert_efficient_vit`` given ``transformer_rules``."""
    _, params, model, _ = _setup("efficient")
    tp.assert_round_trip(convert.convert_efficient_vit, model, params,
                         transformer_rules_list=convert.transformer_rules())


def test_conv_kernels_keep_the_token_order():
    """The NHWC / NDHWC JAX kernels transposed to NCHW / NCDHW weights give
    the same tokens in the same (h, w) and (f, h, w) order, through the
    pooling's padding."""
    cases = (("cct_sine", j_cct.Tokenizer(n_input_channels=3, n_output_channels=128, kernel_size=3, stride=1,
                                          padding=1, n_conv_layers=2)),
             ("cct_3d_learnable_strided", j_cct_3d.Tokenizer3D(
                 n_input_channels=3, n_output_channels=128, frame_kernel_size=3, kernel_size=3, stride=1, padding=1,
                 frame_stride=2, frame_pooling_kernel_size=3, frame_pooling_stride=2)))
    for name, tokenizer in cases:
        _, params, model, x = _setup(name)
        want = jax.jit(lambda p: tokenizer.apply({"params": p}, jnp.asarray(x)))(params["tokenizer"])
        tp.assert_close(model.tokenizer(torch.from_numpy(x)), want)


@pytest.mark.parametrize("name", ["cct_sine", "cct_3d", "cct_3d_learnable_strided"])
def test_sequence_length_is_the_tokens(name):
    """The analytic sequence length is the tokenizer's token count."""
    _, _, model, x = _setup(name)
    n = model.tokenizer(torch.from_numpy(x)).shape[1]
    assert n == model.tokenizer.sequence_length(*x.shape[2:])


@pytest.mark.parametrize("name", ["parallel_vit", "t2t", "efficient"])
def test_layer_kernel_routes_match_jax(name, monkeypatch):
    """With the layer kernels' routes forced on both sides: ParallelViT's
    attention branches on the attention-block Function (no residual, as the
    JAX model calls them), T2T's trunk and the efficient shell's
    Transformer on the whole-layer Function (T2T's one-head stem
    transformers, without a projection out, refused); logits and every
    gradient still the JAX model's."""
    calls = tp.force_layer_routes(monkeypatch)
    jmodel, params, model, x = _setup(name)
    port_fb.reset_launch_counts()
    tp.check_model(jmodel, params, model, MODELS[name][2], x, tp.labels(BATCH, CLASSES))
    assert not any(port_fb.LAUNCHES.values())
    d = BODY["depth"]
    if name.startswith("parallel"):
        want = {"layer": [], "block": [(BATCH, 17, 128)] * 2 * d * 2}  # branches x layers x (eval, training)
    else:
        want = {"layer": [(BATCH, 17 if name == "efficient" else 5, 128)] * d * 2, "block": []}
    assert calls == want


# CCT-3D at 8 frames of 28 x 28 (one conv, stride 1, pooled to 14 x 14): the
# card's 1,568 tokens, the flash route
CCT_3D_ROUTE = dict(img_size=28, num_frames=8, n_conv_layers=1, kernel_size=3, stride=1, padding=1, embedding_dim=128,
                    num_layers=1, num_heads=2, mlp_ratio=1.0, num_classes=CLASSES, **NO_DROP)


def _cct_3d_route():
    jmodel = j_cct_3d.CCT(**CCT_3D_ROUTE)
    x = tp.inputs((2, 3, 8, 28, 28))
    params = tp.draw_params(jmodel, jnp.asarray(x))
    model = tp.load(cct_3d.CCT(**CCT_3D_ROUTE, device="cpu"), from_jax.cct_3d_state_dict_from_jax(params))
    return jmodel, params, model, x


def test_cct_3d_flash_route_matches_jax(monkeypatch):
    """CCT-3D at 1,568 tokens on the dispatcher's forced flash route (its
    twins here): logits and every gradient against the JAX model."""
    calls = tp.force_attention_routes(monkeypatch)
    jmodel, params, model, x = _cct_3d_route()
    assert model.tokenizer.sequence_length(8, 28, 28) == 1568
    tp.check_model(jmodel, params, model, from_jax.cct_3d_state_dict_from_jax, x, tp.labels(2, CLASSES))
    assert [c[:3] for c in calls["flash"]] == [((2, 2, 1568, 64),) * 3] * 2 and not calls["short"]


def test_cct_3d_dropout_on_the_flash_route(monkeypatch):
    """Training at attention dropout 0.1 and stochastic depth: the flash
    Function takes the rate (its twins' dropout), the same seed and
    generator give the same logits, the gradients are finite, and dropout
    moves the logits off the eval ones."""
    calls = tp.force_attention_routes(monkeypatch)
    cfg = {**CCT_3D_ROUTE, "attention_dropout": 0.1, "stochastic_depth_rate": 0.5, "num_layers": 2}
    model = cct_3d.CCT(**cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(tp.inputs((2, 3, 8, 28, 28)))
    runs = []
    for _ in range(2):
        torch.manual_seed(3)
        runs.append(model(x, torch.Generator().manual_seed(4)))
    assert torch.equal(runs[0], runs[1])
    runs[0].sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    assert [c[3] for c in calls["flash"]] == [0.1] * 4
    assert not torch.allclose(runs[0], model.eval()(x))


def test_drop_path_per_sample():
    """DropPath keeps or zeroes each sample's branch whole, scales the kept
    by 1 / keep, draws from the generator given, and is the identity in
    eval mode or at rate 0."""
    dp = cct.DropPath(0.5).train()
    x = torch.ones(64, 5, 7)
    y = dp(x, torch.Generator().manual_seed(1))
    kept = y[:, 0, 0] != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0)) and torch.equal(y[~kept], torch.zeros_like(y[~kept]))
    assert 16 < int(kept.sum()) < 48
    assert torch.equal(y, dp(x, torch.Generator().manual_seed(1)))
    assert torch.equal(dp.eval()(x), x) and torch.equal(cct.DropPath(0.0).train()(x), x)


def test_cait_layer_dropout():
    """CaiT's layer dropout: one uniform a layer from the generator, the
    layers under the rate dropped, one drawn layer kept when all would
    drop; none dropped in eval mode; a training forward equals the forward
    of the kept layers alone."""
    model = cait.CaiT(**BODY, **IMAGE, cls_depth=1, layer_dropout=0.5, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tr = model.patch_transformer.train()
    g = torch.Generator().manual_seed(7)
    keep = tr.keep(g)
    g = torch.Generator().manual_seed(7)
    u = torch.rand(2, generator=g)
    assert keep == [bool(v >= 0.5) for v in u] or (not any(v >= 0.5 for v in u) and sum(keep) == 1)
    tr.layer_dropout = 1.0
    for seed in range(5):
        assert sum(tr.keep(torch.Generator().manual_seed(seed))) == 1
    assert tr.eval().keep() == [True, True]
    model.train()
    model.patch_transformer.layer_dropout = model.cls_transformer.layer_dropout = 0.5
    x = torch.from_numpy(tp.inputs((2, 3, 32, 32)))
    got = model(x, torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(11)
    keep_p, keep_c = model.patch_transformer.keep(g), model.cls_transformer.keep(g)
    h = model.to_patch_embedding(x) + model.pos_embedding
    for (attn, ff), k in zip(model.patch_transformer.layers, keep_p):
        if k:
            h = attn(h) + h
            h = ff(h) + h
    c = model.cls_token.expand(2, -1, -1)
    for (attn, ff), k in zip(model.cls_transformer.layers, keep_c):
        if k:
            c = attn(c, context=h) + c
            c = ff(c) + c
    torch.testing.assert_close(got, model.mlp_head(c[:, 0]))


def test_cct_factories_match_jax():
    """The cct_* factories build the JAX factories' models (layers, heads,
    ratio, width; kernel 3 with the derived stride and padding)."""
    for fn in ("cct_2", "cct_4", "cct_6", "cct_7", "cct_8", "cct_14", "cct_16"):
        for port_mod, jax_mod in ((cct, j_cct), (cct_3d, j_cct_3d)):
            jm = getattr(jax_mod, fn)(img_size=32, num_classes=CLASSES)
            pm = getattr(port_mod, fn)(img_size=32, num_classes=CLASSES, device="meta")
            conv = pm.tokenizer.conv_layers[0][0]
            assert len(pm.classifier.blocks) == jm.num_layers
            assert pm.classifier.blocks[0].self_attn.heads == jm.num_heads
            assert pm.classifier.blocks[0].linear1.out_features == int(jm.embedding_dim * jm.mlp_ratio)
            assert conv.out_channels == jm.embedding_dim and conv.kernel_size[-1] == jm.kernel_size
            assert conv.stride[-1] == jm.stride and conv.padding[-1] == jm.padding


def test_entry_points_build_on_the_card_by_default():
    """Without ``device`` each model builds on the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("deepvit_cls", "cait", "parallel_vit", "t2t", "cct_sine", "cct_3d"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MODELS[name][1]()
