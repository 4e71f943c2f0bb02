"""The port's ViViT with MOSS, decorrelation ViT, KEEL post-LN ViT and
patch-dropout ViT (vit_pytorch_tpu_torch/models/vivit_with_moss.py,
vit_with_decorr.py, vit_with_keel_post_ln.py, vit_with_patch_dropout.py)
against the JAX package on the CPU, fp32, at a small size (depth 2, dim <=
64), the same weights on both sides (numpy draws at the JAX init's shapes,
loaded through ``utils/from_jax.py``) and the same inputs (numpy seed):
logits and every gradient (tests/torch_parity.py's bounds), the maps
against the JAX converters; MOSS streamed frame by frame through its caches
against the whole clip and against the JAX MOSS's cached continuation; the
causal KV cache at n != m; the decorrelation loss (sampled with the same
scores on both sides, in subspaces, across depth) in the loss and its
gradients, and one ``make_train_step(aux_loss_weight=)`` step of each
package; the patch-dropout ViT with the same kept tokens on both sides; the
KEEL ViT's and the patch-dropout ViT's kernel routes with both packages'
gates asked as for bf16 (the JAX kernels in interpret mode, the port's
Functions on their twins)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import torch_parity as tp
from vit_pytorch_tpu.models import vit_with_decorr as j_decorr
from vit_pytorch_tpu.models import vit_with_keel_post_ln as j_keel
from vit_pytorch_tpu.models import vit_with_patch_dropout as j_pd
from vit_pytorch_tpu.models import vivit_with_moss as j_moss
from vit_pytorch_tpu.parallel.train import TrainState as JaxTrainState
from vit_pytorch_tpu.parallel.train import make_train_step as jax_make_train_step
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import vit_with_decorr, vit_with_keel_post_ln, vit_with_patch_dropout, vivit_with_moss
from vit_pytorch_tpu_torch.nn import patch as port_patch
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 2, 10
SHAPE = (3, 32, 32)
VIT = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)
# 3 x 3 patches a frame, 3 frame patches
VIVIT = dict(image_size=24, image_patch_size=8, frames=6, frame_patch_size=2, num_classes=CLASSES, dim=32,
             spatial_depth=2, temporal_depth=2, heads=2, mlp_dim=64, dim_head=16, moss_hidden_dim=8)
VIDEO = (3, 6, 24, 24)
PATCH_DROPOUT = 0.25  # 12 of 16 patches kept
AUX_WEIGHT = 0.5

# name: (JAX class, port class, constructor, from_jax map, converter, input shape past the batch)
MODELS = {
    "vit_with_patch_dropout": (j_pd.ViT, vit_with_patch_dropout.ViT, {**VIT, "patch_dropout": PATCH_DROPOUT},
                               from_jax.vit_with_patch_dropout_state_dict_from_jax,
                               convert.convert_vit_with_patch_dropout, SHAPE),
    "vit_with_keel_post_ln": (j_keel.ViT, vit_with_keel_post_ln.ViT, VIT,
                              from_jax.vit_with_keel_post_ln_state_dict_from_jax,
                              convert.convert_vit_with_keel_post_ln, SHAPE),
    "vit_with_keel_mean": (j_keel.ViT, vit_with_keel_post_ln.ViT, {**VIT, "pool": "mean", "keel_residual_scale": 3.0},
                           from_jax.vit_with_keel_post_ln_state_dict_from_jax, convert.convert_vit_with_keel_post_ln,
                           SHAPE),
    "vit_with_decorr": (j_decorr.ViT, vit_with_decorr.ViT, VIT, from_jax.vit_with_decorr_state_dict_from_jax,
                        convert.convert_vit_with_decorr, SHAPE),
    "vivit_with_moss": (j_moss.ViViT, vivit_with_moss.ViViT, VIVIT, from_jax.vivit_moss_state_dict_from_jax,
                        convert.convert_vivit_moss, VIDEO),
    "vivit_with_moss_mean": (j_moss.ViViT, vivit_with_moss.ViViT, {**VIVIT, "pool": "mean", "moss_causal": False},
                             from_jax.vivit_moss_state_dict_from_jax, convert.convert_vivit_moss, VIDEO),
}


def _setup(name, **kw):
    jax_cls, port_cls, cfg, to_torch, _, shape = MODELS[name]
    return tp.setup_model(jax_cls, port_cls, {**cfg, **kw}, to_torch, shape, batch=BATCH)


def _keep(n=16):
    """The kept patches of each sample, (b, int(n * (1 - PATCH_DROPOUT)))."""
    rng = np.random.default_rng(6)
    return np.stack([rng.permutation(n)[: int(n * (1 - PATCH_DROPOUT))] for _ in range(BATCH)]).astype(np.int32)


class FixedKeep(fnn.Module):
    """The JAX PatchDropout keeping :func:`_keep`'s patches in training."""

    prob: float

    @fnn.compact
    def __call__(self, x, *, train: bool = False):
        if not train or self.prob == 0.0:
            return x
        return jnp.take_along_axis(x, jnp.asarray(_keep(x.shape[1]))[..., None], axis=1)


def _same_kept_patches(monkeypatch):
    """Both sides keep :func:`_keep`'s patches in training."""
    monkeypatch.setattr(j_pd, "PatchDropout", FixedKeep)
    monkeypatch.setattr(port_patch.PatchDropout, "keep_indices",
                        lambda self, b, n, generator=None, device=None: torch.from_numpy(_keep(n)).long())


def _calls(name):
    """The two sides' calls: the decorrelation ViT's logits, ViViT's video."""
    if name == "vit_with_decorr":
        jmodel = j_decorr.ViT(**VIT)
        return lambda p, x, train: jmodel.apply({"params": p}, x, train=train)[0], lambda m, x: m(x)[0]
    return None, None


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(monkeypatch, name):
    """Logits (eval and training mode) and every parameter gradient against
    the JAX model with the same weights (the patch-dropout ViT keeping the
    same patches in training)."""
    _same_kept_patches(monkeypatch)
    jmodel, params, _, model, x = _setup(name)
    jax_call, port_call = _calls(name)
    tp.check_model(jmodel, params, model, MODELS[name][3], x, tp.labels(BATCH, CLASSES), jax_call=jax_call,
                   port_call=port_call)


def test_vivit_moss_frame_mask_matches_jax():
    """The non-causal ViViT with a frame mask (two frames of the second clip
    masked out of the temporal attention): logits and every gradient."""
    jmodel, params, _, model, x = _setup("vivit_with_moss_mean")
    mask = np.ones((BATCH, VIVIT["frames"]), bool)
    mask[1, :2] = False
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    tp.check_model(jmodel, params, model, MODELS["vivit_with_moss_mean"][3], x, tp.labels(BATCH, CLASSES),
                   jax_call=lambda p, x, train: jmodel.apply({"params": p}, x, mask=jm, train=train),
                   port_call=lambda m, x: m(x, mask=tm))


@pytest.mark.parametrize("name", [n for n in MODELS if not n.endswith("_mean")])
def test_state_dict_round_trip_is_exact(name):
    """Each map inverts the JAX converter of the reference layout."""
    _, params, _, model, _ = _setup(name)
    tp.assert_round_trip(MODELS[name][4], model, params)


def _moss_pair(**kw):
    jmoss = j_moss.MOSS(dim=16, hidden_dim=8, orders=2, causal=True, **kw)
    x = tp.inputs((2, 4, 6, 6, 16), seed=7)
    params = tp.draw_params(jmoss, jnp.asarray(x))
    moss = vivit_with_moss.MOSS(16, hidden_dim=8, orders=2, causal=True, **kw, device="cpu")
    return jmoss, params, tp.load(moss, from_jax.moss_state_dict_from_jax(params)), x


def test_moss_streams_frame_by_frame():
    """The causal MOSS on a whole clip against JAX; the port's frame by frame
    through its caches equals its whole clip; a cached continuation (the
    JAX ``test_moss_streaming_cache``) equals JAX's and the whole clip's
    last frame."""
    jmoss, params, moss, x = _moss_pair()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        whole = moss(xt)
        tp.assert_close(whole, jmoss.apply({"params": params}, jnp.asarray(x)))
        caches, frames = None, []
        for t in range(x.shape[1]):
            out, caches = moss(xt[:, t: t + 1], caches, return_cache=True)
            frames.append(out)
        tp.assert_close(torch.cat(frames, dim=1), whole.numpy(), atol=1e-5, rtol=1e-5)
        assert all(c.shape == (2, 16, 2, 6, 6) for c in caches)

        x_next = tp.inputs((2, 1, 6, 6, 16), seed=8)
        _, jcaches = jmoss.apply({"params": params}, jnp.asarray(x), return_cache=True)
        want, _ = jmoss.apply({"params": params}, jnp.asarray(x_next), jcaches, return_cache=True)
        got, _ = moss(torch.from_numpy(x_next), caches, return_cache=True)
        tp.assert_close(got, want)
        full = moss(torch.cat([xt, torch.from_numpy(x_next)], dim=1))
    tp.assert_close(got[:, 0], full[:, -1].numpy(), atol=1e-5, rtol=1e-5)


def test_moss_gradients_match_jax():
    """The non-causal MOSS's output and every parameter gradient of a
    weighted sum of it against JAX."""
    jmoss = j_moss.MOSS(dim=16, hidden_dim=8, orders=2, causal=False)
    x = tp.inputs((2, 4, 6, 6, 16), seed=7)
    params = tp.draw_params(jmoss, jnp.asarray(x))
    moss = tp.load(vivit_with_moss.MOSS(16, hidden_dim=8, orders=2, device="cpu"),
                   from_jax.moss_state_dict_from_jax(params))
    w = tp.inputs((2, 4, 6, 6, 16), seed=9)
    loss = lambda p: (jmoss.apply({"params": p}, jnp.asarray(x)) * w).sum()
    want, grads = jax.value_and_grad(loss)(params)
    got = (moss(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
    tp.assert_close(got, want, atol=1e-4)
    got.backward()
    want_grads = from_jax.moss_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    for k, p in moss.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=tp.ATOL, rtol=tp.GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("cached, n", [(3, 2), (3, 1), (0, 4)])
def test_causal_attention_kv_cache_matches_jax(cached, n):
    """The causal attention with ``cached`` keys and values put before the
    call's ``n`` (the mask ``tril(ones(n, m))``, top-left aligned, as the JAX
    dispatcher builds it; one query sees every key): the output and the
    returned cache against JAX."""
    jattn = j_moss.CausalAttention(dim=32, heads=2, dim_head=16, causal=True)
    x = tp.inputs((2, n, 32), seed=10)
    params = tp.draw_params(jattn, jnp.asarray(x))
    attn = vivit_with_moss.CausalAttention(32, heads=2, dim_head=16, causal=True)
    state = from_jax.vivit_moss_state_dict_from_jax({"spatial_transformer": {"layers_0_attn": params}})
    tp.load(attn, {k.removeprefix("spatial_transformer.layers.0.0."): v for k, v in state.items()})
    cache = tuple(tp.inputs((2, 2, cached, 16), seed=s) for s in (11, 12)) if cached else None
    want, (wk, wv) = jattn.apply({"params": params}, jnp.asarray(x), cache=None if cache is None else tuple(
        map(jnp.asarray, cache)), return_cache=True)
    with torch.no_grad():
        got, (gk, gv) = attn(torch.from_numpy(x), cache=None if cache is None else tuple(map(torch.from_numpy, cache)),
                             return_cache=True)
    tp.assert_close(got, want)
    tp.assert_close(gk, wk)
    tp.assert_close(gv, wv)
    assert gk.shape == (2, 2, cached + n, 16)


DECORR = {
    "default": {},
    "sampled": dict(decorr_sample_frac=0.5, decorr_mean_center=True),
    "subspace": dict(decorr_use_subspace=True, decorr_dim_subspace=8, decorr_num_subspaces=2),
    "across_depth": dict(decorr_layer_outputs_across_depth=True),
}
SCORES = tp.inputs((4 * VIT["depth"] * BATCH, 17), seed=13)  # one row of token scores a Gram matrix


def _decorr_pair(monkeypatch, case):
    """The JAX and port decorrelation ViTs of ``case``, the same weights,
    subspace projections and token scores; returns both, the JAX
    variables, the input and the labels."""
    cfg = {**VIT, **DECORR[case]}
    jmodel = j_decorr.ViT(**cfg)
    x = tp.inputs((BATCH, *SHAPE))
    variables = dict(jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))())
    variables["params"] = tp.draw_params(jmodel, jnp.asarray(x))
    model = tp.load(vit_with_decorr.ViT(**cfg, device="cpu"),
                    from_jax.vit_with_decorr_state_dict_from_jax(variables["params"]))
    if "buffers" in variables:
        model.decorr_loss.proj.copy_(torch.from_numpy(np.array(variables["buffers"]["decorr_loss"]["proj"])))
    # after the init, whose orthogonal projections draw from jax.random.normal too
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(SCORES[: shape[0]]))
    monkeypatch.setattr(vit_with_decorr, "sample_scores", lambda shape, gen, device: torch.from_numpy(
        SCORES[: shape[0]]))
    return jmodel, variables, model, x, tp.labels(BATCH, CLASSES)


@pytest.mark.parametrize("case", list(DECORR))
def test_decorrelation_loss_matches_jax(monkeypatch, case):
    """In training: the logits, the auxiliary loss and every gradient of
    cross-entropy + 0.5 x the auxiliary loss against JAX (the sampled
    tokens from the same scores on both sides); in eval mode the loss is 0,
    with ``return_decorr_aux_loss=True`` it is JAX's with the first tokens."""
    jmodel, variables, model, x, y = _decorr_pair(monkeypatch, case)
    xj = jnp.asarray(x)

    def loss(p):
        logits, aux = jmodel.apply({**variables, "params": p}, xj, train=True, rngs={"decorr": jax.random.PRNGKey(1)})
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return ce + AUX_WEIGHT * aux, (logits, aux)

    (want, (want_logits, want_aux)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    logits, aux = model.train()(torch.from_numpy(x))
    got = F.cross_entropy(logits, torch.from_numpy(y).long()) + AUX_WEIGHT * aux
    tp.assert_close(logits, want_logits)
    tp.assert_close(aux, want_aux, atol=1e-6, rtol=1e-5)
    tp.assert_close(got, want)
    assert float(aux.detach()) > 0
    got.backward()
    want_grads = from_jax.vit_with_decorr_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=tp.ATOL, rtol=tp.GRAD_RTOL, err_msg=k)
    with torch.no_grad():
        assert float(model.eval()(torch.from_numpy(x))[1]) == 0.0
        _, eval_aux = model(torch.from_numpy(x), True)
    _, want_eval = jmodel.apply(variables, xj, True)
    tp.assert_close(eval_aux, want_eval, atol=1e-6, rtol=1e-5)


def test_decorr_train_step_matches_jax(monkeypatch):
    """One ``make_train_step(aux_loss_weight=0.5)`` step of each package on
    the sampled case: the same loss and updated params."""
    jmodel, variables, model, x, y = _decorr_pair(monkeypatch, "sampled")
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"], tx=optax.adam(3e-4))
    jstate, jmetrics = jax_make_train_step(jmodel, aux_loss_weight=AUX_WEIGHT, donate=False)(
        state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))
    new = from_jax.vit_with_decorr_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    pstate = port_train.create_train_state(model)
    metrics = port_train.make_train_step(model, aux_loss_weight=AUX_WEIGHT)(
        pstate, torch.from_numpy(x), torch.from_numpy(y).long(), torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=tp.ATOL, rtol=tp.RTOL)
    for k, p in model.named_parameters():
        g = p.grad.numpy()
        got, want = p.detach().numpy(), new[k].numpy()
        big = np.abs(g) > 1e-6  # Adam's first step is lr * sign(g) where |g| is well over its eps
        np.testing.assert_allclose(got[big], want[big], atol=1e-6, rtol=0, err_msg=k)
        assert np.all(np.abs(got - want) <= 2 * 3e-4), k


def test_decorr_sampling_draws_from_the_generator():
    """In training the sampled tokens come from the caller's generator: the
    same seed the same loss, another seed another; the logits do not
    depend on the draw."""
    cfg = {**VIT, **DECORR["sampled"]}
    model = vit_with_decorr.ViT(**cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(tp.inputs((BATCH, *SHAPE)))
    with torch.no_grad():
        runs = [model(x, generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert torch.equal(runs[0][1], runs[1][1]) and not torch.equal(runs[0][1], runs[2][1])
    assert torch.equal(runs[0][0], runs[2][0])


def test_patch_dropout_draws_from_the_generator():
    """In training the kept patches come from the caller's generator (the
    same seed the same logits); eval mode keeps every patch."""
    model = vit_with_patch_dropout.ViT(**MODELS["vit_with_patch_dropout"][2], device="cpu",
                                       generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(tp.inputs((BATCH, *SHAPE)))
    with torch.no_grad():
        runs = [model(x, torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
        assert model.patch_dropout.keep_indices(BATCH, 16, torch.Generator().manual_seed(3)).shape == (BATCH, 12)


def _kernel_gates_as_bf16(monkeypatch):
    """Both packages' whole-layer and attention-block gates asked as for
    bf16 (the port's, the H100 kernels' shapes), the rest of the routes
    forced on both sides."""
    from vit_pytorch_tpu.nn import blocks as jax_blocks
    from vit_pytorch_tpu.ops import fused_block as jax_fb
    from vit_pytorch_tpu_torch.nn import blocks as torch_blocks

    calls = tp.force_layer_routes(monkeypatch)
    block = lambda shape, dtype, *a: port_fb.fused_block_supported(tuple(shape), torch.bfloat16, *a)
    layer = lambda shape, dtype, *a: port_fb.whole_layer_supported(tuple(shape), torch.bfloat16, *a)
    for mod in (jax_blocks, torch_blocks):
        monkeypatch.setattr(mod, "fused_block_supported", block)
        monkeypatch.setattr(mod, "whole_layer_supported", layer)
    monkeypatch.setattr(jax_fb, "whole_layer_supported", layer)
    return calls


ROUTE = {**VIT, "dim": 128, "dim_head": 64}  # 2 heads of 64


def test_patch_dropout_routes_match_jax(monkeypatch):
    """With the routes forced and the gates asked as for bf16, every layer
    takes the whole-layer Function (the JAX ``_layer_kernel`` in interpret
    mode), at 17 tokens in eval mode and at the kept 13 in training, the same
    patches kept on both sides: logits and every gradient the JAX model's."""
    calls = _kernel_gates_as_bf16(monkeypatch)
    _same_kept_patches(monkeypatch)
    jmodel, params, _, model, x = _setup("vit_with_patch_dropout", dim=128, dim_head=64)
    port_fb.reset_launch_counts()
    tp.check_model(jmodel, params, model, MODELS["vit_with_patch_dropout"][3], x, tp.labels(BATCH, CLASSES))
    assert not any(port_fb.LAUNCHES.values())
    depth = ROUTE["depth"]
    assert calls == {"layer": [(BATCH, 17, 128)] * depth + [(BATCH, 13, 128)] * depth, "block": []}


def test_keel_routes_match_jax(monkeypatch):
    """With the routes forced and the gates asked as for bf16, every
    attention call of the KEEL ViT takes the attention-block Function with
    no residual and a zero LayerNorm bias (the JAX ``_kernel`` in interpret
    mode, fed ``jnp.zeros``), the post-LNs outside: logits and every
    gradient the JAX model's."""
    calls = _kernel_gates_as_bf16(monkeypatch)
    jmodel, params, _, model, x = _setup("vit_with_keel_post_ln", dim=128, dim_head=64)
    port_fb.reset_launch_counts()
    tp.check_model(jmodel, params, model, MODELS["vit_with_keel_post_ln"][3], x, tp.labels(BATCH, CLASSES))
    assert not any(port_fb.LAUNCHES.values())
    assert calls == {"layer": [], "block": [(BATCH, 17, 128)] * ROUTE["depth"] * 2}  # eval, training


@pytest.mark.parametrize("name", ["vit_with_patch_dropout", "vit_with_keel_post_ln"])
def test_block_dropout_on_the_kernel_route(monkeypatch, name):
    """Training at dropout 0.1 with the routes forced: every attention call
    on the attention-block Function with its in-kernel dropout (the
    patch-dropout ViT's at the kept 13 tokens), the same seeds the same
    logits, finite gradients, the logits moved off eval mode's."""
    calls = _kernel_gates_as_bf16(monkeypatch)
    cfg = {**MODELS[name][2], "dim": 128, "dim_head": 64, "dropout": 0.1}
    model = MODELS[name][1](**cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(tp.inputs((BATCH, *SHAPE)))
    runs = []
    for _ in range(2):
        torch.manual_seed(3)
        runs.append(model(x))
    assert torch.equal(runs[0], runs[1])
    runs[0].sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    n = 13 if name == "vit_with_patch_dropout" else 17
    assert calls == {"layer": [], "block": [(BATCH, n, 128)] * cfg["depth"] * 2}
    with torch.no_grad():
        assert not torch.allclose(runs[0], model.eval()(x))


@pytest.mark.parametrize("name", [n for n in MODELS if not n.endswith("_mean")])
def test_entry_points_build_on_the_card_by_default(name):
    """Without ``device`` each model builds on the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MODELS[name][1](**MODELS[name][2])
