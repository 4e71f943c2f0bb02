"""The port's VAT family (vit_pytorch_tpu_torch/ssl/vat.py, vaat.py,
vat_siglip.py) against the JAX package on the CPU, fp32, at
tests/test_vat_family.py's sizes: the same weights on both sides (numpy
draws at the JAX init's shapes, so that the zero-initialised FiLMs act,
loaded through ``utils/from_jax.py``), the same inputs (numpy seed).

Tolerances: outputs and losses within 5e-5 absolute (the JAX package's
fp32 parity bar) and 1e-4 relative; gradients within 5e-5 + 1e-3
relative.  Also ``load_siglip`` on one synthetic HF dict through both
packages, and the flash and short Functions on their plain twins at the
VLA cross-attention shapes (54 and 13 queries against 1,536 and 1,024
keys) against the materialized composite."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ssl import vaat as jvaat
from vit_pytorch_tpu.ssl import vat as jvat
from vit_pytorch_tpu.ssl import vat_siglip as jsig
from vit_pytorch_tpu_torch.ops import attention
from vit_pytorch_tpu_torch.ops.flash_attention import flash_attention
from vit_pytorch_tpu_torch.ops.short_attention import short_attention
from vit_pytorch_tpu_torch.ssl import vaat as tvaat
from vit_pytorch_tpu_torch.ssl import vat as tvat
from vit_pytorch_tpu_torch.ssl import vat_siglip as tsig
from vit_pytorch_tpu_torch.utils.from_jax import vat_family_state_dict_from_jax

ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3

VIT = dict(image_size=32, patch_size=8, num_classes=10, dim=32, heads=2, depth=2, mlp_dim=64)
VAT_KW = dict(dim=48, heads=2, dim_head=16, mlp_dim=96, dim_action=5, action_chunk_len=4)
AST_KW = dict(dim=24, depth=2, mlp_dim=48, patch_size=8, heads=2, dim_head=12, spec_n_fft=32, spec_win_length=16)
SIGLIP_VAT_KW = dict(dim=48, depth=2, heads=2, dim_head=16, dim_action=5, mlp_dim=96, action_chunk_len=4,
                     siglip_image_size=28, siglip_patch_size=7, siglip_dim=48, siglip_depth=2, siglip_heads=4,
                     siglip_mlp_dim=96)
# VAT with each option: (ViT extras, VAT extras, image shape, call kwargs)
VAT_CASES = {
    "every_option": (dict(num_register_tokens=2),
                     dict(depth=3, time_seq_len=2, num_views=2, num_tasks=3, num_advantage_bins=2, dim_extra_token=7,
                          vit_layer_indices=(0, 1, 2)),
                     (2, 2, 3, 2, 32, 32), ("tasks", "extra", "advantages")),
    "int_advantage": (dict(), dict(depth=2, num_advantage_bins=3), (2, 1, 3, 32, 32), ("int_advantage",)),
    "image_no_self_attn": (dict(pool="mean"), dict(depth=2, add_self_attn=False, num_register_tokens=0),
                           (2, 3, 32, 32), ()),
    "final_embedding_only": (dict(), dict(depth=2, vit_layer_indices=(2, 2), num_tasks=2), (2, 3, 32, 32),
                             ("tasks",)),
}


def _jit(fn, *args):
    """``fn(*args)`` compiled once as a whole: far fewer compiles than the
    op-by-op eager dispatch of flax's init and apply."""
    return jax.jit(fn)(*args)


def _rng(seed):
    return np.random.default_rng(seed)


def _init(init_fn, seed=5):
    """Parameters of the shapes the flax ``init_fn`` gives (``jax.eval_shape``
    traces it without compiling it), drawn with numpy from a seed: Dense
    kernels N(0, 1 / fan_in), LayerNorm scales 1 + 0.02 N(0, 1), every other
    leaf 0.02 N(0, 1), so that the zero-initialised FiLMs act."""
    rng = _rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.float32(np.sqrt(leaf.shape[0]))
        return 1 + 0.02 * z if name == "scale" else 0.02 * z

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init_fn)["params"])


def _load(model, params, allowed_missing=()):
    missing, unexpected = model.load_state_dict(vat_family_state_dict_from_jax(params), strict=False)
    assert not unexpected and sorted(missing) == sorted(allowed_missing), (missing, unexpected)
    return model


def _call_kwargs(names, batch=2):
    rng = _rng(3)
    kw = {}
    if "tasks" in names:
        kw["tasks"] = np.array([0, 1])
    if "extra" in names:
        kw["extra"] = rng.standard_normal((batch, 7)).astype(np.float32)
    if "advantages" in names:
        kw["advantages"] = np.array([0, 1])
    return kw


def _both(kw):
    """The kwargs for JAX (numpy arrays) and for the port (tensors)."""
    return kw, {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def _check_grads(model, jax_grads, frozen=()):
    """Every gradient of the port against the JAX one; a frozen backbone's
    parameters have none (zeros on the JAX side)."""
    want = vat_family_state_dict_from_jax(jax.tree.map(np.asarray, jax_grads))
    checked = 0
    for k, p in model.named_parameters():
        if k not in want:  # the VAT ViT's head, which VAT never calls
            assert ".mlp_head." in f".{k}" and p.grad is None, k
            continue
        if k.split(".")[0] in frozen:
            assert p.grad is None and not want[k].any(), k
            continue
        assert p.grad is not None, k
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)
        checked += 1
    assert checked > 0


def _vat_pair(case):
    vit_kw, vat_kw, shape, names = VAT_CASES[case]
    jmodel = jvat.VAT(vit=jvat.ViT(**VIT, **vit_kw), **VAT_KW, **vat_kw)
    imgs = _rng(1).standard_normal(shape).astype(np.float32)
    jkw = _call_kwargs(names)
    if "int_advantage" in names:
        jkw["advantages"] = 1
    params = _init(lambda: jmodel.init(jax.random.PRNGKey(0), imgs, **jkw))
    tmodel = tvat.VAT(vit=tvat.ViT(**VIT, **vit_kw, device="cpu"), **VAT_KW, **vat_kw, device="cpu")
    _load(tmodel, params, ["vit.mlp_head.weight", "vit.mlp_head.bias"])
    return jmodel, params, tmodel, imgs, jkw


@pytest.mark.parametrize("case", list(VAT_CASES))
def test_vat_matches_jax(case):
    """Predicted actions, the token states of ``return_hiddens``, the L1
    loss and every gradient."""
    jmodel, params, tmodel, imgs, jkw = _vat_pair(case)
    jkw, tkw = _both(jkw)
    x = torch.from_numpy(imgs)
    actions = _rng(4).standard_normal((2, 4, 5)).astype(np.float32)
    apply = lambda p, **kw: jmodel.apply({"params": p}, imgs, **jkw, **kw)
    (jp, jh), (loss, grads) = _jit(lambda p: (
        apply(p, return_hiddens=True), jax.value_and_grad(lambda q: apply(q, actions=actions))(p)), params)
    _close(tmodel(x, **tkw), jp, msg="pred_action")
    tp, th = tmodel(x, return_hiddens=True, **tkw)
    assert th.shape == jh.shape == (tmodel.depth + 1, *th.shape[1:])
    _close(tp, jp)
    _close(th, jh, msg="hiddens")
    got = tmodel(x, actions=torch.from_numpy(actions), **tkw)
    assert got.shape == ()
    _close(got, loss, msg="loss")
    got.backward()
    _check_grads(tmodel, grads)


def test_vat_freeze_vit_gives_the_backbone_no_gradient():
    jmodel, params, tmodel, imgs, jkw = _vat_pair("every_option")
    jkw, tkw = _both(jkw)
    actions = _rng(4).standard_normal((2, 4, 5)).astype(np.float32)
    loss, grads = _jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, imgs, actions=actions, freeze_vit=True, **jkw)), params)
    got = tmodel(torch.from_numpy(imgs), actions=torch.from_numpy(actions), freeze_vit=True, **tkw)
    _close(got, loss)
    got.backward()
    _check_grads(tmodel, grads, frozen=("vit",))


def test_vat_vit_alone_and_from_a_dict():
    """The VAT ViT's logits (registers before the cls token, the position
    embedding added before them), and a VAT built from a dict of the ViT's
    kwargs holds a ViT of those kwargs."""
    jvit = jvat.ViT(**VIT, num_register_tokens=3)
    imgs = _rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    params = _init(lambda: jvit.init(jax.random.PRNGKey(0), imgs))
    tvit = _load(tvat.ViT(**VIT, num_register_tokens=3, device="cpu"), params)
    _close(tvit(torch.from_numpy(imgs)), _jit(lambda p: jvit.apply({"params": p}, imgs), params))
    model = tvat.VAT(vit=dict(VIT), depth=2, **VAT_KW, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model.vit, tvat.ViT) and model.vit.dim == VIT["dim"] and len(model.vit.layers) == VIT["depth"]


def _ast_pair(accept_spec=False, num_classes=13):
    kw = dict(AST_KW, num_classes=num_classes, accept_spec=accept_spec)
    if accept_spec:
        kw.update(depth=1, num_classes=5)
        x = _rng(2).standard_normal((2, 64, 17)).astype(np.float32)  # (b t f)
    else:
        x = _rng(2).uniform(-1, 1, (2, 4096)).astype(np.float32)
    jast = jvaat.AST(**kw)
    params = _init(lambda: jast.init(jax.random.PRNGKey(1), x))
    return jast, params, _load(tvaat.AST(**kw, device="cpu"), params), x


@pytest.mark.parametrize("accept_spec", [False, True])
def test_ast_matches_jax(accept_spec):
    """Logits from raw audio (the spectrogram cropped to the patch grid)
    and from a (b, t, f) spectrogram; the trajectory with its two trailing
    LayerNorms."""
    jast, params, tast, x = _ast_pair(accept_spec)
    want, (je, jh) = _jit(lambda p: (jast.apply({"params": p}, x), jast.apply({"params": p}, x, return_hiddens=True)),
                          params)
    _close(tast(torch.from_numpy(x)), want)
    te, th = tast(torch.from_numpy(x), return_hiddens=True)
    _close(te, je)
    _close(th, jh)


def test_ast_pools_without_a_head():
    jast, params, tast, x = _ast_pair(num_classes=None)
    assert tast.mlp_head is None
    _close(tast(torch.from_numpy(x)), _jit(lambda p: jast.apply({"params": p}, x), params))


@pytest.mark.parametrize("audio_views", [1, 2])
def test_vaat_matches_jax(audio_views):
    """Both trajectories: the predicted actions, the loss and every
    gradient; with ``freeze_vit`` and ``freeze_ast`` neither backbone gets
    a gradient."""
    extra_kw = dict(num_audio_views=2) if audio_views == 2 else {}
    jmodel = jvaat.VAAT(vit=jvat.ViT(**VIT), ast=jvaat.AST(**AST_KW), depth=2, num_tasks=3, dim_extra_token=7,
                        num_image_views=2, **VAT_KW, **extra_kw)
    imgs = _rng(1).standard_normal((2, 2, 3, 32, 32)).astype(np.float32)
    shape = (2, 4096) if audio_views == 1 else (2, 2, 4096)
    audio = _rng(2).uniform(-1, 1, shape).astype(np.float32)
    jkw, tkw = _both(_call_kwargs(("tasks", "extra")))
    params = _init(lambda: jmodel.init(jax.random.PRNGKey(0), imgs, audio, **jkw))
    tmodel = tvaat.VAAT(vit=tvat.ViT(**VIT, device="cpu"), ast=tvaat.AST(**AST_KW, device="cpu"), depth=2,
                        num_tasks=3, dim_extra_token=7, num_image_views=2, **VAT_KW, **extra_kw, device="cpu")
    _load(tmodel, params, ["vit.mlp_head.weight", "vit.mlp_head.bias"])
    ti, ta = torch.from_numpy(imgs), torch.from_numpy(audio)
    actions = _rng(4).standard_normal((2, 4, 5)).astype(np.float32)
    apply = lambda p, **kw: jmodel.apply({"params": p}, imgs, audio, **jkw, **kw)
    want, *steps = _jit(lambda p: (apply(p), *(jax.value_and_grad(lambda q, f=f: apply(
        q, actions=actions, freeze_vit=f, freeze_ast=f))(p) for f in (False, True))), params)
    _close(tmodel(ti, ta, **tkw), want)
    for freeze, (loss, grads) in zip((False, True), steps):
        tmodel.zero_grad(set_to_none=True)
        fk = dict(freeze_vit=freeze, freeze_ast=freeze)
        got = tmodel(ti, ta, actions=torch.from_numpy(actions), **fk, **tkw)
        _close(got, loss)
        got.backward()
        _check_grads(tmodel, grads, frozen=("vit", "ast") if freeze else ())


def test_vaat_refuses_a_wrong_number_of_audio_views():
    model = tvaat.VAAT(vit=tvat.ViT(**VIT, device="cpu"), ast=tvaat.AST(**AST_KW, device="cpu"), depth=2,
                       num_audio_views=2, **VAT_KW, device="cpu")
    with pytest.raises(AssertionError, match="audio has 3 view"):
        model(torch.zeros(2, 3, 32, 32), torch.zeros(2, 3, 4096))


def test_siglip_matches_jax():
    """The tower alone: no cls token, dim_head = dim / heads, tanh GELU,
    LayerNorm eps 1e-6; its tokens and trajectory."""
    kw = dict(image_size=28, patch_size=7, dim=48, depth=2, heads=4, mlp_dim=96)
    jmodel = jsig.SigLIP(**kw)
    x = _rng(1).standard_normal((2, 3, 28, 28)).astype(np.float32)
    params = _init(lambda: jmodel.init(jax.random.PRNGKey(0), x))
    tmodel = _load(tsig.SigLIP(**kw, device="cpu"), params)
    je, jh = _jit(lambda p: jmodel.apply({"params": p}, x, return_hiddens=True), params)
    _close(tmodel(torch.from_numpy(x)), je)
    te, th = tmodel(torch.from_numpy(x), return_hiddens=True)
    _close(te, je)
    _close(th, jh)


def test_siglip_feedforward_is_tanh_gelu_in_fp32():
    """``jax.nn.gelu(approximate=True)`` in every dtype, unlike the
    dtype-adaptive GELU of nn/blocks.py, which is erf in fp32."""
    ff = tsig.SigLIPFeedForward(8, 16, device="cpu")
    x = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(0))
    h = ff.fc1(ff.norm(x))
    want = ff.fc2(torch.nn.functional.gelu(h, approximate="tanh"))
    assert torch.equal(ff(x), want)
    assert not torch.equal(ff(x), ff.fc2(torch.nn.functional.gelu(h)))


@pytest.mark.parametrize("freeze_vit", [False, True])
def test_siglip_vat_matches_jax(freeze_vit):
    jkw, tkw = _both(_call_kwargs(("tasks", "extra")))
    jmodel = jsig.SigLIPVAT(**SIGLIP_VAT_KW, num_tasks=3, dim_extra_token=7, num_views=2, time_seq_len=2)
    imgs = _rng(1).standard_normal((2, 2, 3, 2, 28, 28)).astype(np.float32)
    params = _init(lambda: jmodel.init(jax.random.PRNGKey(0), imgs, **jkw))
    tmodel = _load(tsig.SigLIPVAT(**SIGLIP_VAT_KW, num_tasks=3, dim_extra_token=7, num_views=2, time_seq_len=2,
                                  device="cpu"), params)
    x = torch.from_numpy(imgs)
    actions = _rng(4).standard_normal((2, 4, 5)).astype(np.float32)
    apply = lambda p, **kw: jmodel.apply({"params": p}, imgs, **jkw, **kw)
    want, (loss, grads) = _jit(lambda p: (apply(p), jax.value_and_grad(
        lambda q: apply(q, actions=actions, freeze_vit=freeze_vit))(p)), params)
    _close(tmodel(x, **tkw), want)
    got = tmodel(x, actions=torch.from_numpy(actions), freeze_vit=freeze_vit, **tkw)
    _close(got, loss)
    got.backward()
    _check_grads(tmodel, grads, frozen=("vit",) if freeze_vit else ())


# -- load_siglip ---------------------------------------------------------------

SIG_DIM, SIG_MLP, SIG_DEPTH = 32, 64, 2
SIG_KW = dict(image_size=28, patch_size=7, dim=SIG_DIM, depth=SIG_DEPTH, heads=4, mlp_dim=SIG_MLP)


def _hf_siglip(prefix="vision_model."):
    """A synthetic HF SigLIP vision tower at SIG_KW's shapes."""
    rng = _rng(0)
    f = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    hf = {
        "embeddings.patch_embedding.weight": f(SIG_DIM, 3, 7, 7, s=0.05),
        "embeddings.patch_embedding.bias": f(SIG_DIM, s=0.1),
        "embeddings.position_embedding.weight": f(16, SIG_DIM),
        "post_layernorm.weight": 1 + f(SIG_DIM, s=0.1),
        "post_layernorm.bias": f(SIG_DIM, s=0.1),
    }
    for i in range(SIG_DEPTH):
        for nm in ("layer_norm1", "layer_norm2"):
            hf[f"encoder.layers.{i}.{nm}.weight"] = 1 + f(SIG_DIM, s=0.1)
            hf[f"encoder.layers.{i}.{nm}.bias"] = f(SIG_DIM, s=0.1)
        for nm, shp in (("self_attn.q_proj", (SIG_DIM, SIG_DIM)), ("self_attn.k_proj", (SIG_DIM, SIG_DIM)),
                        ("self_attn.v_proj", (SIG_DIM, SIG_DIM)), ("self_attn.out_proj", (SIG_DIM, SIG_DIM)),
                        ("mlp.fc1", (SIG_MLP, SIG_DIM)), ("mlp.fc2", (SIG_DIM, SIG_MLP))):
            hf[f"encoder.layers.{i}.{nm}.weight"] = f(*shp, s=0.1)
            hf[f"encoder.layers.{i}.{nm}.bias"] = f(shp[0], s=0.1)
    return {prefix + k: v for k, v in hf.items()}


def _check_loaded(state, jax_params):
    """The port's load_siglip equals the JAX one's params through the VAT
    family map, bit for bit, and the two towers agree."""
    want = vat_family_state_dict_from_jax(jax_params)
    assert sorted(state) == sorted(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    x = _rng(1).standard_normal((2, 3, 28, 28)).astype(np.float32)
    tower = tsig.SigLIP(**SIG_KW, device="cpu")
    tower.load_state_dict(state)
    _close(tower(torch.from_numpy(x)), jsig.SigLIP(**SIG_KW).apply({"params": jax_params}, x))


@pytest.mark.parametrize("prefix", ["vision_model.", tsig._PALIGEMMA, ""])
@pytest.mark.parametrize("as_tensors", [False, True])
def test_load_siglip_matches_jax(prefix, as_tensors):
    hf = _hf_siglip(prefix)
    source = {k: torch.from_numpy(v) for k, v in hf.items()} if as_tensors else hf
    _check_loaded(tsig.load_siglip(source, depth=SIG_DEPTH), jsig.load_siglip(hf, depth=SIG_DEPTH))


def test_load_siglip_from_a_safetensors_file(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    hf = _hf_siglip()
    path = tmp_path / "model.safetensors"
    st.save_file(hf, str(path))
    _check_loaded(tsig.load_siglip(str(path), depth=SIG_DEPTH), jsig.load_siglip(hf, depth=SIG_DEPTH))


def test_load_siglip_mistyped_local_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tsig.load_siglip(str(tmp_path / "no" / "such" / "model.safetensors"))


def test_load_siglip_hub_path_mocked(tmp_path, monkeypatch):
    """An HF repo id goes through download_siglip with the reference's
    snapshot_download arguments (mocked: no network), then the safetensors
    route; a second call finds the file and downloads nothing."""
    huggingface_hub = pytest.importorskip("huggingface_hub")
    st = pytest.importorskip("safetensors.numpy")
    hf = _hf_siglip()
    fake_hub = tmp_path / "hub_model.safetensors"
    st.save_file(hf, str(fake_hub))
    calls = {}

    def fake_snapshot_download(repo_id, local_dir, allow_patterns):
        calls.update(repo_id=repo_id, allow_patterns=allow_patterns)
        os.makedirs(local_dir, exist_ok=True)
        shutil.copy(fake_hub, os.path.join(local_dir, "model.safetensors"))

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot_download)
    monkeypatch.chdir(tmp_path)
    state = tsig.load_siglip("google/siglip-so400m-patch14-224", depth=SIG_DEPTH)
    assert calls["repo_id"] == "google/siglip-so400m-patch14-224"
    assert "model.safetensors" in calls["allow_patterns"]
    _check_loaded(state, jsig.load_siglip(hf, depth=SIG_DEPTH))
    calls.clear()
    tsig.load_siglip("google/siglip-so400m-patch14-224", depth=SIG_DEPTH)
    assert not calls


# -- the kernel Functions at the VLA shapes, on their plain twins ------------------

# (b, heads, n, m): SigLIPVAT's cross-attention at (3 views, 2 frames), VAT_B's
# 13 queries at 2 views x 4 frames x 197 tokens, and 54 queries at 1,024 keys
FLASH_SHAPES = ((2, 2, 54, 1536), (1, 2, 13, 1576), (2, 2, 56, 1536))
SHORT_SHAPES = ((2, 2, 54, 1024), (1, 2, 13, 1024))


def _qkv(b, h, n, m, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, r, 64, generator=g, requires_grad=True) for r in (n, m, m)]


def _against_composite(fn, shape):
    """o and dq, dk, dv of ``fn`` (the Function on its twins) against
    autograd through the materialized composite, fp32."""
    q, k, v = _qkv(*shape)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    o = fn(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    qc, kc, vc = (t.detach().clone().requires_grad_() for t in (q, k, v))
    oc = attention.xla_attention(qc, kc, vc)
    want = torch.autograd.grad(oc, (qc, kc, vc), do)
    np.testing.assert_allclose(o.detach().numpy(), oc.detach().numpy(), atol=ATOL, rtol=RTOL)
    for name, g, w in zip("qkv", grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_function_at_vla_shapes(shape):
    """The padded last query tile (54 of 64 rows) adds nothing to dk, dv."""
    _against_composite(flash_attention, shape)


@pytest.mark.parametrize("shape", SHORT_SHAPES)
def test_short_function_at_vla_shapes(shape):
    _against_composite(short_attention, shape)


@pytest.mark.parametrize("m,route", [(1023, "composite"), (1024, "short"), (1025, "flash")])
def test_dispatcher_routes_at_the_vla_edge(m, route, monkeypatch):
    """With the device test taken as true, 54 queries against m keys take
    the composite below 1,024 keys, the short route at 1,024 and the flash
    route above, as the JAX dispatcher routes them (attention.py:235-288)."""
    taken = []
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "short_supported", lambda *a: True)
    monkeypatch.setattr(attention, "flash_supported", lambda *a: True)
    for name in ("short_attention", "flash_attention", "xla_attention"):
        orig = getattr(attention, name)
        monkeypatch.setattr(attention, name, lambda *a, _o=orig, _n=name, **k: taken.append(_n) or _o(*a, **k))
    q, k, v = (t.detach() for t in _qkv(1, 2, 54, m))
    attention.dot_product_attention(q, k, v)
    assert taken == [{"composite": "xla_attention", "short": "short_attention", "flash": "flash_attention"}[route]]
