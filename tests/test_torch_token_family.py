"""The port's patch-merger ViT, learnable-memory ViT and its Adapter,
ATS-ViT and LookViT (vit_pytorch_tpu_torch/models/vit_with_patch_merger.py,
learnable_memory_vit.py, ats_vit.py, look_vit.py) against the JAX package
on the CPU, fp32, at a small size (depth 2-4, dim <= 128, images <= 64 x
64), the same weights on both sides (numpy draws at the JAX init's shapes,
loaded through ``utils/from_jax.py``) and the same inputs (numpy seed):
logits and every gradient (tests/torch_parity.py's bounds) at dropout 0 and
ATS-ViT without sampling, the maps against the JAX converters; the
patch-merger ViT's kernel routes with both packages' gates asked as for
bf16 (the JAX kernels in interpret mode, the port's Functions on their
twins): every layer, the 256-token ones before the merge (the wide
attention kernels') and the 8-token ones after it, on the attention block;
ATS-ViT's static-shape ``unique_sorted_with_pad`` bit for bit and its
sampling by its invariants; LookViT's bilinear resize; the Adapter's mask
keeping the ViT's own tokens as they were."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from vit_pytorch_tpu.models import ats_vit as j_ats
from vit_pytorch_tpu.models import learnable_memory_vit as j_memory
from vit_pytorch_tpu.models import look_vit as j_look
from vit_pytorch_tpu.models import vit_with_patch_merger as j_merger
from vit_pytorch_tpu.utils import convert
from vit_pytorch_tpu_torch.models import ats_vit, learnable_memory_vit, look_vit, vit_with_patch_merger
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 2, 10
# 256 tokens (the wide attention kernels' since they came; over the narrow ones' 208) in layers 1-2,
# merged to 8 for layers 3-4; 2 heads of 64
MERGER = dict(image_size=64, patch_size=4, num_classes=CLASSES, dim=128, depth=4, heads=2, mlp_dim=128,
              patch_merge_layer=2, patch_merge_num_tokens=8)
MEMORY = dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
ADAPTER = dict(num_memories_per_layer=3, num_classes=4)
# 64 patches; the second layer samples 16 of them, the third 8
ATS = dict(image_size=32, patch_size=4, num_classes=CLASSES, dim=64, depth=3, max_tokens_per_depth=(64, 16, 8),
           heads=2, mlp_dim=128, dim_head=32)
# highres tokens 16 x 16, main tokens 4 x 4
LOOK = dict(dim=64, image_size=32, num_classes=CLASSES, depth=2, patch_size=8, heads=2, dim_head=32,
            highres_patch_size=2, cross_attn_heads=2, cross_attn_dim_head=32, patch_conv_kernel_size=3, dropout=0.0)

# name: (JAX class, port class, constructor, from_jax map, converter, input shape past the batch)
MODELS = {
    "patch_merger": (j_merger.ViT, vit_with_patch_merger.ViT, MERGER,
                     from_jax.vit_with_patch_merger_state_dict_from_jax, convert.convert_vit_with_patch_merger,
                     (3, 64, 64)),
    "learnable_memory_vit": (j_memory.ViT, learnable_memory_vit.ViT, MEMORY,
                             from_jax.learnable_memory_vit_state_dict_from_jax,
                             convert.convert_learnable_memory_vit, (3, 32, 32)),
    "ats_vit": (j_ats.ViT, ats_vit.ViT, ATS, from_jax.ats_vit_state_dict_from_jax, convert.convert_ats_vit,
                (3, 32, 32)),
    "look_vit": (j_look.LookViT, look_vit.LookViT, LOOK, from_jax.look_vit_state_dict_from_jax,
                 convert.convert_look_vit, (3, 32, 32)),
}
# ATS-ViT: sampling off on the port's side, as the JAX model without a "sampling" rng
PORT_CALLS = {"ats_vit": lambda m, x: m(x, sample=False)}


def _setup(name):
    jax_cls, port_cls, cfg, to_torch, _, shape = MODELS[name]
    return tp.setup_model(jax_cls, port_cls, cfg, to_torch, shape, batch=BATCH)


def _setup_adapter():
    """The JAX Adapter around a ViT, its params, the port's Adapter loaded
    from them (the wrapped ViT's unused head at zero) and the input."""
    jmodel = j_memory.Adapter(vit=j_memory.ViT(**MEMORY), **ADAPTER)
    x = tp.inputs((BATCH, 3, 32, 32))
    params = tp.draw_params(jmodel, jnp.asarray(x))
    model = learnable_memory_vit.Adapter(vit=learnable_memory_vit.ViT(**MEMORY, device="cpu"), **ADAPTER)
    to_torch = tp.with_absent_zeros(from_jax.adapter_state_dict_from_jax, model)
    return jmodel, params, tp.load(model, to_torch(params)), x, to_torch


@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name):
    """Logits (eval and training mode) and every parameter gradient against
    the JAX model with the same weights."""
    jmodel, params, _, model, x = _setup(name)
    tp.check_model(jmodel, params, model, MODELS[name][3], x, tp.labels(BATCH, CLASSES),
                   port_call=PORT_CALLS.get(name))


def test_adapter_matches_jax():
    """The Adapter's logits and every gradient, the wrapped ViT's too, against
    the JAX Adapter (whose tree holds no head of the wrapped ViT: the port's
    has no gradient)."""
    jmodel, params, model, x, to_torch = _setup_adapter()
    tp.check_model(jmodel, params, model, to_torch, x, tp.labels(BATCH, ADAPTER["num_classes"]))
    assert all(p.grad is None for k, p in model.named_parameters() if k.startswith("vit.mlp_head"))


@pytest.mark.parametrize("name", [*MODELS, "adapter"])
def test_state_dict_round_trip_is_exact(name):
    """Each map inverts the JAX converter of the reference layout
    (``convert_adapter`` drops the wrapped ViT's head)."""
    if name == "adapter":
        _, params, model, _, _ = _setup_adapter()
        tp.assert_round_trip(convert.convert_adapter, model, params)
    else:
        _, params, _, model, _ = _setup(name)
        tp.assert_round_trip(MODELS[name][4], model, params)


def test_adapter_keeps_the_vit_tokens_and_freezes():
    """The mask keeps the ViT's tokens from the memory class token and the
    memories: through the Adapter they come out as the ViT alone gives them;
    the Adapter shares the ViT's modules, and ``freeze_all_layers_`` leaves
    only the memories and the new head trainable."""
    vit = learnable_memory_vit.ViT(**MEMORY, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    adapter = learnable_memory_vit.Adapter(vit=vit, **ADAPTER, generator=torch.Generator().manual_seed(1)).eval()
    assert adapter.vit is vit and adapter.attn_mask.shape == (1, 1, 18, 18 + 3)
    x = torch.from_numpy(tp.inputs((BATCH, 3, 32, 32)))
    with torch.no_grad():
        tokens = vit.img_to_tokens(x)
        alone = vit.transformer(tokens)
        mem_cls = adapter.memory_cls_token.expand(BATCH, 1, -1)
        adapted = vit.transformer(torch.cat([mem_cls, tokens], 1), attn_mask=adapter.attn_mask,
                                  memories=adapter.memories_per_layer)
    tp.assert_close(adapted[:, 1:], alone.numpy(), atol=1e-5, rtol=1e-5)
    assert not torch.allclose(adapted[:, 0], alone[:, 0])
    learnable_memory_vit.freeze_all_layers_(vit)
    trainable = sorted(k for k, p in adapter.named_parameters() if p.requires_grad)
    assert trainable == ["memories_per_layer", "memory_cls_token", "mlp_head.0.bias", "mlp_head.0.weight",
                         "mlp_head.1.bias", "mlp_head.1.weight"]


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


def _merger_blocks():
    """The attention-block calls of one forward: the 256-token layers before
    the merge (2 heads of 64 at 256 tokens, on the wide attention kernels on
    the card), then the 8-token layers after it."""
    before = MERGER["patch_merge_layer"]
    return ([(BATCH, 256, MERGER["dim"])] * before
            + [(BATCH, MERGER["patch_merge_num_tokens"], MERGER["dim"])] * (MERGER["depth"] - before))


def test_patch_merger_kernel_routes_match_jax(monkeypatch):
    """With the routes forced and the gates asked as for bf16, every layer
    takes the attention-block Function (the JAX ``_kernel`` in interpret
    mode on the other side): the 256-token layers before the merge, which
    the gate admits since the wide attention kernels, and the 8-token
    layers after it; logits and every gradient still the JAX model's."""
    calls = _gates_as_bf16(monkeypatch)
    jmodel, params, _, model, x = _setup("patch_merger")
    port_fb.reset_launch_counts()
    tp.check_model(jmodel, params, model, MODELS["patch_merger"][3], x, tp.labels(BATCH, CLASSES))
    assert not any(port_fb.LAUNCHES.values())
    assert calls == {"layer": [], "block": _merger_blocks() * 2}  # eval, training


def test_patch_merger_dropout_on_the_block_route(monkeypatch):
    """Training at dropout 0.1 with the routes forced: every layer (before
    and after the merge) on the attention-block Function with its in-kernel
    dropout, the same seeds give the same logits, the gradients are finite,
    and dropout moves the logits off the eval ones."""
    calls = _gates_as_bf16(monkeypatch)
    cfg = {**MERGER, "dropout": 0.1}
    model = vit_with_patch_merger.ViT(**cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(tp.inputs((BATCH, 3, 64, 64)))
    runs = []
    for _ in range(2):
        torch.manual_seed(3)
        runs.append(model(x))
    assert torch.equal(runs[0], runs[1])
    runs[0].sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    assert calls["block"] == _merger_blocks() * 2
    with torch.no_grad():
        assert not torch.allclose(runs[0], model.eval()(x))


def test_unique_sorted_with_pad_matches_jax():
    """Seeded ids with duplicates: the sorted unique ids then zeros, and the
    validity mask, bit for bit the JAX function's."""
    ids = np.random.default_rng(4).integers(1, 12, (6, 10)).astype(np.int64)
    ids[0] = 5  # one id only
    ids[1] = np.arange(1, 11)  # no duplicate
    got, mask = ats_vit.unique_sorted_with_pad(torch.from_numpy(ids))
    want, want_mask = j_ats.unique_sorted_with_pad(jnp.asarray(ids.astype(np.int32)))
    assert np.array_equal(got.numpy(), np.asarray(want)) and np.array_equal(mask.numpy(), np.asarray(want_mask))
    for row, m, src in zip(got.numpy(), mask.numpy(), ids):
        assert list(row[m]) == sorted(set(src)) and not row[~m].any() and m.sum() == len(set(src))


def test_ats_sampling_invariants():
    """Sampling on (training, the Gumbel noise from the caller's generator):
    each sampling layer keeps at most its budget of tokens, each once, in
    order, padding after them; the padding never sampled again; the same
    generator seed gives the same draw, the gradients are finite; sampling
    off draws the argmax, one token."""
    model = ats_vit.ViT(**ATS, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(tp.inputs((4, 3, 32, 32)))
    draws = [model(x, True, generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    logits, ids = draws[0]
    assert torch.equal(ids, draws[1][1]) and torch.equal(logits, draws[1][0]) and not torch.equal(ids, draws[2][1])
    assert ids.shape == (4, ATS["max_tokens_per_depth"][-1])
    for row in ids.tolist():
        kept = [i for i in row if i >= 0]
        assert kept == sorted(set(kept)) and row == kept + [-1] * (len(row) - len(kept))
        assert kept and all(0 <= i < 64 for i in kept)
    logits.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    _, argmax_ids = model(x, True, sample=False)
    assert ((argmax_ids >= 0).sum(-1) == 1).all()


def test_adaptive_token_sampling_masks_the_padding():
    """The sampler on a map whose last keys are padding: the class token
    kept first, the mask true exactly where an id is, ids unique, sorted and
    within the budget, no padded token drawn, the rows gathered."""
    b, h, n, k = 3, 2, 12, 5
    rng = np.random.default_rng(9)
    attn = torch.softmax(torch.from_numpy(rng.standard_normal((b, h, n, n)).astype(np.float32)), -1)
    value = torch.from_numpy(rng.standard_normal((b, h, n, 4)).astype(np.float32))
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[:, -4:] = False
    sampler = ats_vit.AdaptiveTokenSampling(k)
    new_attn, new_mask, ids = sampler(attn, value, mask, sample=True, generator=torch.Generator().manual_seed(3))
    assert new_attn.shape == (b, h, k + 1, n) and new_mask.shape == ids.shape == (b, k + 1)
    assert new_mask[:, 0].all() and (ids[:, 0] == 0).all()
    assert torch.equal(new_mask[:, 1:], ids[:, 1:] > 0) and (ids < n - 4).all()
    for row, m in zip(ids[:, 1:].tolist(), new_mask[:, 1:].tolist()):
        kept = [i for i, keep in zip(row, m) if keep]
        assert kept == sorted(set(kept))
    assert torch.equal(new_attn, torch.gather(attn, 2, ids[:, None, :, None].expand(b, h, k + 1, n)))


@pytest.mark.parametrize("size, out", [(16, 4), (16, 2), (12, 4), (32, 8), (8, 3), (4, 8)])
def test_look_vit_resize_matches_jax(size, out):
    """``F.interpolate`` bilinear without align_corners or antialias against
    ``jax.image.resize(..., "bilinear", antialias=False)``, down and up."""
    a = tp.inputs((2, size, size, 5))
    want = jax.image.resize(jnp.asarray(a), (2, out, out, 5), method="bilinear", antialias=False)
    got = look_vit.resize_bilinear(torch.from_numpy(a).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    tp.assert_close(got, want, atol=5e-7, rtol=1e-6)


def test_entry_points_build_on_the_card_by_default():
    """Without ``device`` each model builds on the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in MODELS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MODELS[name][1](**MODELS[name][2])
