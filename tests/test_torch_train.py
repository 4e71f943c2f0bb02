"""The port's train step (vit_pytorch_tpu_torch/parallel/train.py) against the
JAX ``make_train_step`` on the CPU, fp32: the small ViT of
tests/test_torch_vit.py with the same weights on both sides (JAX init, loaded
through ``vit_state_dict_from_jax``), the same batch (numpy seed).

Tolerances: loss and gradients within 5e-5 absolute (the JAX package's fp32
parity bar) and 1e-4 relative; the readings are about 1e-6.  Adam's first
update is lr * g / (|g| + eps), about -lr * sign(g), so where |g| is tiny
the two sides' gradients, equal to ~1e-7, may give updates of either sign:
the updated params are compared at 1e-6 where |g| > 1e-5 (there the update
is lr * (1 - eps/|g|) up to 1e-3 of lr), and elsewhere only to within the
largest step, 2 * lr."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vit_pytorch_tpu.nn.blocks as jax_blocks
from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.ops import fused_block as jax_fb
from vit_pytorch_tpu.parallel.train import TrainState as JaxTrainState
from vit_pytorch_tpu.parallel.train import make_train_step as jax_make_train_step
from vit_pytorch_tpu_torch import ViT
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.parallel import train as port_train
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)
LR = 3e-4
ATOL, RTOL = 5e-5, 1e-4
PARAM_ATOL, G_MIN = 1e-6, 1e-5


def _setup(batch=4, **model_kw):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)
    labels = rng.integers(0, KW["num_classes"], batch).astype(np.int32)
    jmodel = JaxViT(**KW, **model_kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"])
    model = ViT(**KW, **model_kw, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params))
    return jmodel, params, model, img, labels


def _jax_grads(jmodel, params, img, labels):
    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(img), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    return jax.tree.map(np.asarray, jax.grad(loss)(params))


def _jax_step(jmodel, params, img, labels, grad_accum):
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=optax.adam(LR))
    step = jax_make_train_step(jmodel, donate=False, grad_accum=grad_accum)
    state, metrics = step(state, jnp.asarray(img), jnp.asarray(labels), jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, state.params), {k: float(v) for k, v in metrics.items()}


def _port_step(model, img, labels, grad_accum):
    state = port_train.create_train_state(model)
    step = port_train.make_train_step(model, grad_accum=grad_accum)
    metrics = step(state, torch.from_numpy(img), torch.from_numpy(labels).long())
    assert state.step == 1
    return {k: float(v) for k, v in metrics.items()}


def _check_step(jmodel, params, model, img, labels, grad_accum):
    want_grads = vit_state_dict_from_jax(_jax_grads(jmodel, params, img, labels))
    want_params, want_metrics = _jax_step(jmodel, params, img, labels, grad_accum)
    got_metrics = _port_step(model, img, labels, grad_accum)

    np.testing.assert_allclose(got_metrics["loss"], want_metrics["loss"], atol=ATOL, rtol=RTOL)
    assert got_metrics["accuracy"] == pytest.approx(want_metrics["accuracy"], abs=1e-6)
    new = vit_state_dict_from_jax(want_params)
    for name, p in model.named_parameters():
        g, w = want_grads[name].numpy(), p.grad.numpy()
        np.testing.assert_allclose(w, g, atol=ATOL, rtol=RTOL, err_msg=f"grad {name}")
        got, want = p.detach().numpy(), new[name].numpy()
        big = np.abs(g) > G_MIN
        np.testing.assert_allclose(got[big], want[big], atol=PARAM_ATOL, rtol=0, err_msg=f"param {name}")
        assert np.all(np.abs(got - want) <= 2 * LR), name


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    """One ``make_train_step`` step, and one with two microbatches, against
    the JAX step: loss, accuracy, gradients and the updated params."""
    _check_step(*_setup(), grad_accum=grad_accum)


def test_whole_layer_function_step_matches_jax(monkeypatch):
    """The port's whole-layer Function forced on (eligibility monkeypatched;
    on CPU tensors its wrappers run their twins), against JAX autodiff
    through the whole model with the JAX whole-layer kernel forced on too,
    in interpret mode: both sides then run the tanh GELU of the kernels."""
    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: True)
    jax_layer, jax_calls = jax_fb.fused_transformer_layer, []

    def jax_spy(*args, **kwargs):
        jax_calls.append(1)
        return jax_layer(*args, **kwargs, interpret=True)

    monkeypatch.setattr(jax_blocks, "fused_transformer_layer", jax_spy)

    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    backward_fns = []
    port_layer = torch_blocks.fused_transformer_layer

    def spy(*args, **kwargs):
        out = port_layer(*args, **kwargs)
        backward_fns.append(type(out.grad_fn).__name__)
        return out

    monkeypatch.setattr(torch_blocks, "fused_transformer_layer", spy)
    port_fb.reset_launch_counts()
    _check_step(*_setup(), grad_accum=1)
    assert backward_fns == ["_FusedLayerBackward"] * KW["depth"]
    assert jax_calls  # the JAX side traced its whole-layer kernel
    assert not any(port_fb.LAUNCHES.values())


@pytest.mark.parametrize("option", ["remat", "flash_false"])
def test_vit_options_match_default(option):
    """``ViT(remat=True)`` and ``ViT(flash=False)`` construct and give the
    logits and gradients of the default model exactly (on the CPU both run
    the composite; remat replays the same operations)."""
    _, params, model, img, labels = _setup()
    other = ViT(**KW, **({"remat": True} if option == "remat" else {"flash": False}), device="cpu")
    other.load_state_dict(vit_state_dict_from_jax(params))
    assert other.transformer.remat == (option == "remat")
    outs = []
    for m in (model, other):
        m.train()
        logits = m(torch.from_numpy(img))
        loss = port_train.cross_entropy_loss(logits, torch.from_numpy(labels).long())
        outs.append((logits.detach(), torch.autograd.grad(loss, list(m.parameters()))))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for g1, g0 in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(g1, g0, rtol=0, atol=0)


def test_flash_false_opts_out_of_the_kernels(monkeypatch):
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    x = torch.zeros(2, 197, 768, dtype=torch.bfloat16)
    kw = dict(dim=768, depth=1, heads=12, dim_head=64, mlp_dim=3072, dtype=torch.bfloat16, device="meta")
    assert torch_blocks.Transformer(**kw).whole_layer_eligible(x)
    assert not torch_blocks.Transformer(**kw, flash=False).whole_layer_eligible(x)


def test_generator_seeds_dropout():
    """With dropout, the step's ``generator`` decides the masks: the same
    seed gives the same loss, another seed another."""

    def loss(seed):
        torch.manual_seed(123)
        _, _, model, img, labels = _setup(dropout=0.5)
        step = port_train.make_train_step(model)
        return float(step(port_train.create_train_state(model), torch.from_numpy(img), torch.from_numpy(labels).long(),
                          torch.Generator().manual_seed(seed))["loss"])

    assert loss(0) == loss(0)
    assert loss(0) != loss(1)


def _force_attention_block_route(monkeypatch):
    """On CPU tensors in fp32, send every layer through the port's
    attention-block Function (whose wrappers run their twins), as a CUDA
    bf16 model with the whole layer refused would go; returns the list the
    spy fills with each call's grad_fn name."""
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: False)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(torch_blocks, "fused_dropout_supported", lambda *a, **k: True)
    calls, block = [], torch_blocks.fused_attention_block

    def spy(*args, **kwargs):
        out = block(*args, **kwargs)
        calls.append(type(out.grad_fn).__name__ if out.grad_fn is not None else None)
        return out

    monkeypatch.setattr(torch_blocks, "fused_attention_block", spy)
    return calls


def test_attention_block_route_step_matches_jax(monkeypatch):
    """At dropout 0 the attention-block route (forced on both sides: the
    port's Function on its twins, the JAX ``fused_attention_block`` in
    interpret mode with the whole layer refused) gives the JAX step's loss,
    gradients and updated params."""
    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: False)
    jax_block, jax_calls = jax_blocks.fused_attention_block, []

    def jax_spy(*args, **kwargs):
        jax_calls.append(1)
        return jax_block(*args, **kwargs, interpret=True)

    monkeypatch.setattr(jax_blocks, "fused_attention_block", jax_spy)
    calls = _force_attention_block_route(monkeypatch)
    port_fb.reset_launch_counts()
    _check_step(*_setup(), grad_accum=1)
    assert calls == ["_FusedAttentionBlockBackward"] * KW["depth"]
    assert jax_calls  # the JAX side traced its attention-block kernel
    assert not any(port_fb.LAUNCHES.values())


DROPOUT_KW = dict(dropout=0.1, emb_dropout=0.1)


def _dropout_step(seed, monkeypatch=None, **model_kw):
    """Loss and gradients of one dropout step of the small ViT with the
    step's generator seeded by ``seed``."""
    torch.manual_seed(123)
    _, _, model, img, labels = _setup(**DROPOUT_KW, **model_kw)
    step = port_train.make_train_step(model)
    loss = step(port_train.create_train_state(model), torch.from_numpy(img), torch.from_numpy(labels).long(),
                torch.Generator().manual_seed(seed))["loss"]
    return float(loss), [p.grad.clone() for p in model.parameters()]


def test_dropout_route_is_taken_and_remat_wraps_only_the_ff(monkeypatch):
    """With dropout 0.1 in training and ``remat=True``, every layer's
    attention runs the attention-block Function and checkpoint wraps only
    the FF calls (JAX blocks.py:655-658)."""
    calls = _force_attention_block_route(monkeypatch)
    wrapped, real = [], torch_blocks.checkpoint

    def checkpoint_spy(fn, *args, **kwargs):
        wrapped.append(type(fn).__name__)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(torch_blocks, "checkpoint", checkpoint_spy)
    loss, grads = _dropout_step(0, remat=True)
    assert calls == ["_FusedAttentionBlockBackward"] * KW["depth"]
    assert wrapped == ["FeedForward"] * KW["depth"]
    assert np.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)


def test_dropout_route_generator_decides_the_masks(monkeypatch):
    """The same generator gives the same loss and gradients bit for bit
    (attention masks from the seeds the CPU generator draws, FF and
    embedding masks from torch's RNG in the same order); another generator
    gives others."""
    calls = _force_attention_block_route(monkeypatch)
    loss0, grads0 = _dropout_step(0, remat=True)
    again, grads_again = _dropout_step(0, remat=True)
    other, grads_other = _dropout_step(1, remat=True)
    assert len(calls) == 3 * KW["depth"]
    assert loss0 == again and all(torch.equal(a, b) for a, b in zip(grads0, grads_again))
    assert loss0 != other and not all(torch.equal(a, b) for a, b in zip(grads0, grads_other))


def test_dropout_route_eval_logits_match_jax(monkeypatch):
    """In eval mode dropout is off: the model with dropout 0.1 gives the JAX
    ViT's ``train=False`` logits, through the attention-block route."""
    calls = _force_attention_block_route(monkeypatch)
    jmodel, params, model, img, _ = _setup(**DROPOUT_KW)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img), train=False))
    model.eval()
    got = model(torch.from_numpy(img)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert len(calls) == KW["depth"]


def test_cross_entropy_matches_optax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 6)
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits), jnp.asarray(labels)).mean()
    got = port_train.cross_entropy_loss(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)  # bf16 logits in, f32 loss out
    got32 = port_train.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got32), float(want), rtol=1e-6)
