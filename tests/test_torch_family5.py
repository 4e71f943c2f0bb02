"""The port's nViT, JumboViT, SimpleUViT, ViTDetPool, JetViT and WWT
(vit_pytorch_tpu_torch/models/normalized_vit.py, jumbo_vit.py,
simple_uvit.py, vit_detpool.py, jet_vit.py, wwt.py) against the JAX package
on the CPU, fp32, at a small size (depth 1-3, dim <= 64, images 32 x 32),
the same weights on both sides (numpy draws at the JAX init's shapes,
loaded through ``utils/from_jax.py``) and the same inputs (numpy seed):
logits and every gradient (tests/torch_parity.py's bounds), the maps
against the JAX converters; ``normalize_weights`` against the JAX function
(within 4 float32 ulps); ViTDetPool with a pixel mask, a token mask and none, and its
frozen mask generator; JetViT with every branch of its random layer forced
on both sides, and one ``make_train_step`` step of each package, which run
a tuple's first kind; SimpleUViT's and JumboViT's attention-block routes
with both packages' gates asked as for bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from vit_pytorch_tpu.models import jet_vit as j_jet
from vit_pytorch_tpu.models import jumbo_vit as j_jumbo
from vit_pytorch_tpu.models import normalized_vit as j_nvit
from vit_pytorch_tpu.models import simple_uvit as j_uvit
from vit_pytorch_tpu.models import vit_detpool as j_detpool
from vit_pytorch_tpu.models import wwt as j_wwt
from vit_pytorch_tpu.parallel.train import TrainState as JaxTrainState
from vit_pytorch_tpu.parallel.train import make_train_step as jax_make_train_step
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import jet_vit, jumbo_vit, normalized_vit, simple_uvit, vit_detpool, wwt
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 2, 10
SHAPE = (3, 32, 32)
NVIT = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=32, depth=2, heads=2, mlp_dim=48, dim_head=16)
# patch FF hidden dim * mlp_dim = 128; jumbo cls dim 64, its FF 64 * 128 wide
JUMBO = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=32, depth=2, heads=2, mlp_dim=4, dim_head=16,
             jumbo_cls_k=2, jumbo_ff_mult=2)
UVIT = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=32, depth=3, heads=2, mlp_dim=64, dim_head=16,
            num_register_tokens=2)
DETPOOL = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=32, depth=2, heads=2, mlp_dim=64, dim_head=16)
# an 8 x 8 grid of 4 x 4 windows; layer 3 a random choice of the three kinds
JET_LAYERS = ("WA", "LA", ("FA", "WA", "LA"))
JET = dict(image_size=32, patch_size=4, num_classes=CLASSES, dim=32, depth=3, heads=2, mlp_dim=64, dim_head=16,
           window_size=4, attn_layers=JET_LAYERS)
WWT = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=32, depth=2, num_slots=(4, 2), heads=2, dim_head=16,
           mlp_dim=48, num_register_tokens=1, num_register_slots=(1, 2))
# the token-softmax groups projected by mask_project, the l1 norm, the token head
WWT_GROUPS = {**WWT, "interactions": ((0, 1), (0, 2), (1, 2)), "l1norm_after_tokens_softmax": True,
              "token_softmax_over_slots": True, "project_mask_groups": True, "return_tokens": True}

# name: (JAX class, port class, constructor, from_jax map, converter)
MODELS = {
    "normalized_vit": (j_nvit.nViT, normalized_vit.nViT, NVIT, from_jax.normalized_vit_state_dict_from_jax,
                       convert.convert_normalized_vit),
    "jumbo_vit": (j_jumbo.JumboViT, jumbo_vit.JumboViT, JUMBO, from_jax.jumbo_vit_state_dict_from_jax,
                  convert.convert_jumbo_vit),
    "simple_uvit": (j_uvit.SimpleUViT, simple_uvit.SimpleUViT, UVIT, from_jax.simple_uvit_state_dict_from_jax,
                    convert.convert_simple_uvit),
    "vit_detpool": (j_detpool.ViTDetPool, vit_detpool.ViTDetPool, DETPOOL, from_jax.vit_detpool_state_dict_from_jax,
                    convert.convert_vit_detpool),
    "jet_vit": (j_jet.JetViT, jet_vit.JetViT, JET, from_jax.jet_vit_state_dict_from_jax,
                lambda sd: convert.convert_jet_vit(sd, attn_layers=JET_LAYERS)),
    "wwt": (j_wwt.WWT, wwt.WWT, WWT, from_jax.wwt_state_dict_from_jax, convert.convert_wwt),
    "wwt_groups": (j_wwt.WWT, wwt.WWT, WWT_GROUPS, from_jax.wwt_state_dict_from_jax, None),
}


def _setup(name):
    jax_cls, port_cls, cfg, to_torch, _ = MODELS[name]
    return tp.setup_model(jax_cls, port_cls, cfg, to_torch, SHAPE, batch=BATCH)


def _object_masks(kind):
    """A (b, 32, 32) pixel mask (each sample's boxes), a (b, 16) token mask,
    or none."""
    if kind == "pixel":
        m = np.zeros((BATCH, 32, 32), bool)
        m[0, 3:13, 5:30] = True
        m[1, 20:31, 0:9] = True
        return m
    if kind == "tokens":
        return np.random.default_rng(3).random((BATCH, 16)) < 0.5
    return None


def _calls(name, mask=None):
    """The two sides' calls: logits (WWT's token logits added to its slot
    logits), ViTDetPool with ``mask``."""
    if name == "wwt_groups":
        return (lambda p, x, train: sum(MODELS[name][0](**WWT_GROUPS).apply({"params": p}, x, train=train)),
                lambda m, x: sum(m(x)))
    if name == "vit_detpool" and mask is not None:
        jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
        return (lambda p, x, train: j_detpool.ViTDetPool(**DETPOOL).apply({"params": p}, x, jm, train=train),
                lambda m, x: m(x, tm))
    return None, None


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Logits (eval and training mode) and every parameter gradient against
    the JAX model with the same weights (JetViT's random layer runs its
    first kind on both sides: no layer_select rng, no generator)."""
    jmodel, params, _, model, x = _setup(name)
    jax_call, port_call = _calls(name)
    tp.check_model(jmodel, params, model, MODELS[name][3], x, tp.labels(BATCH, CLASSES), jax_call=jax_call,
                   port_call=port_call)


@pytest.mark.parametrize("kind", ["pixel", "tokens"])
def test_detpool_object_masks_match_jax(kind):
    """ViTDetPool with a pixel mask max-pooled to the tokens, and with a
    token mask: the attention's key mask and the masked mean, logits and
    every gradient against JAX; the mask moves the logits."""
    jmodel, params, _, model, x = _setup("vit_detpool")
    mask = _object_masks(kind)
    jax_call, port_call = _calls("vit_detpool", mask)
    tp.check_model(jmodel, params, model, MODELS["vit_detpool"][3], x, tp.labels(BATCH, CLASSES), jax_call=jax_call,
                   port_call=port_call)
    with torch.no_grad():
        assert not torch.allclose(model.eval()(torch.from_numpy(x)), port_call(model, torch.from_numpy(x)))


def test_detpool_mask_generator_is_frozen():
    """A mask generator (a module) makes the mask when none is given, under
    no_grad: the same logits as its mask handed in, no gradient to it, and
    its weights stay out of the model's state_dict."""
    _, _, _, model, x = _setup("vit_detpool")
    gen_net = torch.nn.Sequential(torch.nn.Conv2d(3, 1, 1), torch.nn.Flatten(1, 2))  # (b, 32, 32)
    make_mask = lambda img: gen_net(img) > 0
    with_gen = vit_detpool.ViTDetPool(**DETPOOL, mask_generator=gen_net, device="cpu")
    with_gen.load_state_dict(model.state_dict())
    img = torch.from_numpy(x)
    with_gen(img).sum().backward()
    assert gen_net[0].weight.grad is None and not any(k.startswith("_mask") for k in with_gen.state_dict())
    gen_net_mask = vit_detpool.ViTDetPool(**DETPOOL, mask_generator=make_mask, device="cpu")
    gen_net_mask.load_state_dict(model.state_dict())
    with torch.no_grad():
        tp.assert_close(gen_net_mask(img), model(img, make_mask(img)).numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("name", [n for n, m in MODELS.items() if m[4] is not None])
def test_state_dict_round_trip_is_exact(name):
    """Each map inverts the JAX converter of the reference layout."""
    _, params, _, model, _ = _setup(name)
    tp.assert_round_trip(MODELS[name][4], model, params)


def test_normalize_weights_matches_jax():
    """The port's in-place ``normalize_weights`` on the params the JAX
    ``normalize_weights`` reads: the same weights re-projected along the same
    axes (every NormLinear weight and the position embedding), each within
    4 float32 ulps of JAX's (the two libraries sum the squares of a norm in
    different orders, so a norm can differ in its last bits), every other
    parameter bit for bit unchanged."""
    _, params, _, model, _ = _setup("normalized_vit")
    want = from_jax.normalized_vit_state_dict_from_jax(jax.tree.map(np.asarray, j_nvit.normalize_weights(params)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    normalized_vit.normalize_weights(model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        changed = not np.array_equal(want[k].numpy(), before[k].numpy())
        assert changed == k.endswith("original") == (not torch.equal(got[k], before[k])), k
        np.testing.assert_array_max_ulp(got[k].numpy(), want[k].numpy(), maxulp=4)


def test_normalize_weights_projects_onto_the_sphere():
    """After ``normalize_weights`` every raw weight has unit norm along the
    axis its forward normalises, and the forward's weights are unchanged."""
    _, _, _, model, _ = _setup("normalized_vit")
    linears = [m for m in model.modules() if isinstance(m, normalized_vit.NormLinear)]
    assert len(linears) == 3 + 2 * 7
    before = [m.weight.detach().clone() for m in linears]
    normalized_vit.normalize_weights(model)
    for m, w in zip(linears, before):
        norms = m.raw_weight.norm(dim=m.norm_dim)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
        assert torch.allclose(m.weight, w, atol=1e-6)


@pytest.mark.parametrize("branch", [0, 1, 2])
def test_jet_vit_forced_branch_matches_jax(monkeypatch, branch):
    """The random layer's kind forced to ``branch`` on both sides (JAX's
    ``randint`` of the layer_select rng, the port's ``draw_branch`` of its
    generator), in training: logits and every gradient; the kinds not run
    get no gradient."""
    jmodel, params, _, model, x = _setup("jet_vit")
    monkeypatch.setattr(j_jet.jax.random, "randint", lambda *a, **k: jnp.int32(branch))
    monkeypatch.setattr(jet_vit, "draw_branch", lambda num, gen: branch)
    key, gen = jax.random.PRNGKey(4), torch.Generator().manual_seed(4)
    jax_call = lambda p, x, train: jmodel.apply({"params": p}, x, train=train, rngs={"layer_select": key})
    tp.check_model(jmodel, params, model, MODELS["jet_vit"][3], x, tp.labels(BATCH, CLASSES), jax_call=jax_call,
                   port_call=lambda m, x: m(x, layer_select=gen))
    kinds = JET_LAYERS[2]
    for i, kind in enumerate(kinds):
        grads = [p.grad for p in model.transformer.layers[2][0].options[kind].parameters()]
        assert all(g is not None for g in grads) == (i == branch), kind


def test_jet_vit_draws_from_its_generator():
    """In training with a generator the layer's kind is drawn from it (the
    same seed the same logits, some seed each kind); in eval mode, or
    without one, the first kind runs."""
    _, _, _, model, x = _setup("jet_vit")
    x = torch.from_numpy(x)
    with torch.no_grad():
        first = model.eval()(x, layer_select=torch.Generator().manual_seed(0))
        model.train()
        tp.assert_close(model(x), first.numpy(), atol=0, rtol=0)
        outs = {s: model(x, layer_select=torch.Generator().manual_seed(s)) for s in range(12)}
    assert torch.equal(outs[3], model(x, layer_select=torch.Generator().manual_seed(3)))
    kinds = {jet_vit.draw_branch(3, torch.Generator().manual_seed(s)) for s in range(12)}
    assert kinds == {0, 1, 2}
    assert any(torch.equal(o, first) for o in outs.values()) and not all(torch.equal(o, first) for o in outs.values())


def test_jet_vit_train_step_runs_the_first_kind():
    """One ``make_train_step`` step of each package (the JAX step passes no
    layer_select rng, the port's no generator): the same loss, gradients
    and updated params, the random layer on its first kind."""
    jmodel, params, _, model, x = _setup("jet_vit")
    y = tp.labels(BATCH, CLASSES)
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=optax.adam(3e-4))
    jstate, jmetrics = jax_make_train_step(jmodel, donate=False)(state, jnp.asarray(x), jnp.asarray(y),
                                                                 jax.random.PRNGKey(1))
    _, want_grads = tp.jax_loss_and_grads(lambda p: jmodel.apply({"params": p}, jnp.asarray(x), train=True), params, y)
    want_grads = from_jax.jet_vit_state_dict_from_jax(want_grads)
    new = from_jax.jet_vit_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    pstate = port_train.create_train_state(model)
    metrics = port_train.make_train_step(model)(pstate, torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=tp.ATOL, rtol=tp.RTOL)
    for k, p in model.named_parameters():
        kind = k.split(".options.")[1].split(".")[0] if ".options." in k else None
        if k.startswith("transformer.layers.2.0.") and kind != "FA":
            assert p.grad is None and torch.equal(p.detach(), new[k]), k
            continue
        g = want_grads[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, atol=tp.ATOL, rtol=tp.GRAD_RTOL, err_msg=k)
        got, want = p.detach().numpy(), new[k].numpy()
        big = np.abs(g) > 1e-6  # Adam's first step is lr * sign(g) where |g| is well over its eps
        np.testing.assert_allclose(got[big], want[big], atol=1e-6, rtol=0, err_msg=k)
        assert np.all(np.abs(got - want) <= 2 * 3e-4), k


def test_wwt_embeddings_and_autoencoding_head_match_jax():
    """WWT's ``return_embeddings`` (slots, tokens, the masks without the
    registers) and an AutoencodingHead of two pathways, up and down the
    hierarchy, against JAX."""
    cfg = {**WWT_GROUPS, "num_slots": (4, 2, 1), "interactions": ((0, 1), (0, 2), (1, 2), (2, 3)),
           "num_register_slots": (1, 1, 1), "project_mask_groups": False}
    kw = dict(image_size=32, patch_size=8, pathways=((3, 2, 0), (0, 2, 3)))
    jmodel = j_wwt.WWT(**cfg, task_heads=(j_wwt.AutoencodingHead(**kw),))
    x = tp.inputs((BATCH, *SHAPE))
    params = tp.draw_params(jmodel, jnp.asarray(x))
    model = tp.load(wwt.WWT(**cfg, task_heads=(wwt.AutoencodingHead(**kw),), device="cpu"),
                    from_jax.wwt_state_dict_from_jax(params))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        emb, want = model(xt, True), jmodel.apply({"params": params}, jnp.asarray(x), True)
        for got, ref in zip(jax.tree.leaves((emb.slots, emb.tokens, emb.masks)), jax.tree.leaves(want)):
            tp.assert_close(got, ref)
        (logits, maps), (want_logits, want_maps) = model(xt), jmodel.apply({"params": params}, jnp.asarray(x))
    tp.assert_close(logits.slot_logits, want_logits.slot_logits)
    assert maps[0].shape == (BATCH, 4, 4, 32) and maps[1].shape == (BATCH, 1, 32)
    for got, ref in zip(maps, want_maps):
        tp.assert_close(got, ref)


def _gates_as_bf16(monkeypatch):
    """Both packages' attention-block gate asked as for bf16 (the port's, the
    H100 kernels' shapes), the rest of the route forced on both sides."""
    from vit_pytorch_tpu.nn import blocks as jax_blocks
    from vit_pytorch_tpu_torch.nn import blocks as torch_blocks

    calls = tp.force_layer_routes(monkeypatch)
    gate = lambda shape, dtype, *a: port_fb.fused_block_supported(tuple(shape), torch.bfloat16, *a)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", gate)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", gate)
    return calls


# dim_head 64, the kernels' width: (constructor, tokens, object mask)
ROUTES = {
    "simple_uvit": ({**UVIT, "dim": 64, "dim_head": 64}, 16 + 2, None),  # 16 patches + 2 registers
    "jumbo_vit": ({**JUMBO, "dim": 64, "dim_head": 64, "jumbo_ff_mult": 0.5}, 2 + 16, None),  # 2 jumbo tokens
    "vit_detpool": ({**DETPOOL, "dim": 64, "dim_head": 64}, 1 + 16, None),
    "vit_detpool_mask": ({**DETPOOL, "dim": 64, "dim_head": 64}, 1 + 16, "pixel"),  # the mask refuses the block
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_attention_block_routes_match_jax(monkeypatch, route):
    """With the routes forced and the gates asked as for bf16, every
    attention call takes the attention-block Function (the JAX ``_kernel``
    in interpret mode on the other side), none with ViTDetPool's object
    mask: logits and every gradient still the JAX model's."""
    calls = _gates_as_bf16(monkeypatch)
    name = route.removesuffix("_mask")
    jax_cls, port_cls, _, to_torch, _ = MODELS[name]
    cfg, n, mask = ROUTES[route]
    jmodel, params, _, model, x = tp.setup_model(jax_cls, port_cls, cfg, to_torch, SHAPE, batch=BATCH)
    jax_call, port_call = None, None
    if mask is not None:
        jm, tm = jnp.asarray(_object_masks(mask)), torch.from_numpy(_object_masks(mask))
        jax_call = lambda p, x, train: jmodel.apply({"params": p}, x, jm, train=train)
        port_call = lambda m, x: m(x, tm)
    port_fb.reset_launch_counts()
    tp.check_model(jmodel, params, model, to_torch, x, tp.labels(BATCH, CLASSES), jax_call=jax_call,
                   port_call=port_call)
    assert not any(port_fb.LAUNCHES.values())
    blocks = [] if mask is not None else [(BATCH, n, 64)] * cfg["depth"] * 2  # eval, training
    assert calls == {"layer": [], "block": blocks}


@pytest.mark.parametrize("name", list(MODELS)[:-1])
def test_entry_points_build_on_the_card_by_default(name):
    """Without ``device`` each model builds on the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MODELS[name][1](**MODELS[name][2])
