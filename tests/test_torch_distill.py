"""The port's distillation (vit_pytorch_tpu_torch/ssl/distill.py) against
the JAX package's (vit_pytorch_tpu/ssl/distill.py) on the CPU, fp32, at a
small size (depth 2, dim 128, heads 2, dim_head 64): the distillable ViT,
T2T-ViT and efficient ViT with and without the distillation token (logits,
the token's output and every gradient), ``to_vit``, and the
``DistillWrapper``'s loss (soft and hard, with and without the head's
LayerNorm, temperature and alpha given at the call) and every gradient of
the wrapper's parameters, the teacher frozen, against ``distill_forward``.
The same weights on both sides (numpy draws at the JAX init's shapes,
loaded through ``utils/from_jax.py``); bounds of tests/torch_parity.py.
The embedding dropout, which the distillation token goes through too, is
held by its behaviour."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from vit_pytorch_tpu.models import vit as j_vit
from vit_pytorch_tpu.nn import blocks as jax_blocks
from vit_pytorch_tpu.ssl import distill as j_distill
from vit_pytorch_tpu_torch.models import efficient, t2t
from vit_pytorch_tpu_torch.models.vit import ViT
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.ops import fused_block as port_fb
from vit_pytorch_tpu_torch.ssl import distill
from vit_pytorch_tpu_torch.utils import from_jax

BATCH, CLASSES = 3, 10
BODY = dict(num_classes=CLASSES, dim=128, depth=2, heads=2, mlp_dim=256)
VIT = dict(image_size=32, patch_size=8, **BODY)


def _efficient_pair():
    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)
    return (dict(image_size=32, patch_size=8, num_classes=CLASSES, dim=128),
            jax_blocks.Transformer(**cfg), torch_blocks.Transformer(**cfg, device="cpu"))


def _students():
    """name: (JAX student, port student, its from_jax map, input channels)."""
    eff, jt, pt = _efficient_pair()
    return {
        "vit": (j_distill.DistillableViT(**VIT), distill.DistillableViT(**VIT, device="cpu"),
                from_jax.distillable_vit_state_dict_from_jax, 3),
        "vit_mean": (j_distill.DistillableViT(**VIT, pool="mean"),
                     distill.DistillableViT(**VIT, pool="mean", device="cpu"),
                     from_jax.distillable_vit_state_dict_from_jax, 3),
        "t2t": (j_distill.DistillableT2TViT(image_size=32, channels=1, **BODY),
                distill.DistillableT2TViT(image_size=32, channels=1, **BODY, device="cpu"),
                from_jax.distillable_t2t_state_dict_from_jax, 1),
        "efficient": (j_distill.DistillableEfficientViT(**eff, transformer=jt),
                      distill.DistillableEfficientViT(**eff, transformer=pt, device="cpu"),
                      from_jax.distillable_efficient_vit_state_dict_from_jax, 3),
    }


def _student(name):
    jmodel, model, to_torch, c = _students()[name]
    x = tp.inputs((BATCH, c, 32, 32))
    token = tp.inputs((1, 128), 9)
    params = tp.draw_params(jmodel, jnp.asarray(x), jnp.asarray(token))
    return jmodel, params, tp.load(model, to_torch(params)), x, token


@pytest.mark.parametrize("name", ["vit", "vit_mean", "t2t", "efficient"])
def test_distillable_models_match_jax(name):
    """With the token: the logits and the token's output, and every
    gradient of a loss on both (the token's gradient too); without it, the
    logits and every gradient (tests/torch_parity.py's check)."""
    jmodel, params, model, x, token = _student(name)
    g = tp.inputs((BATCH, 128), 8)
    y = tp.labels(BATCH, CLASSES)

    def jloss(p, tok):
        logits, d = jmodel.apply({"params": p}, jnp.asarray(x), tok, train=True)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(y)[:, None], axis=1).mean()
        return ce + jnp.sum(d * jnp.asarray(g)), (logits, d)

    (_, (want, want_d)), (jgrads, jtok) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(token))
    tok = torch.from_numpy(token).requires_grad_()
    logits, d = model.train()(torch.from_numpy(x), distill_token=tok)
    tp.assert_close(logits, want)
    tp.assert_close(d, want_d)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long()) + (d * torch.from_numpy(g)).sum()
    loss.backward()
    want_grads = _students()[name][2](jax.tree.map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=tp.ATOL, rtol=tp.GRAD_RTOL, err_msg=k)
    np.testing.assert_allclose(tok.grad.numpy(), np.asarray(jtok), atol=tp.ATOL, rtol=tp.GRAD_RTOL)
    model.zero_grad()
    tp.check_model(jmodel, params, model, _students()[name][2], x, y)


@pytest.mark.parametrize("name", ["vit", "t2t", "efficient"])
def test_to_vit_is_the_plain_model(name):
    """``to_vit()``: the plain model of the same keywords and state_dict,
    whose logits are the distillable model's without the token."""
    _, _, model, x, _ = _student(name)
    plain = model.to_vit()
    assert type(plain) is {"vit": ViT, "t2t": t2t.T2TViT, "efficient": efficient.ViT}[name]
    assert plain.state_dict().keys() == model.state_dict().keys()
    for k, v in plain.state_dict().items():
        assert torch.equal(v, model.state_dict()[k])
    xt = torch.from_numpy(x)
    torch.testing.assert_close(plain.eval()(xt), model.eval()(xt), rtol=0, atol=0)


def test_distillation_token_goes_through_the_embedding_dropout():
    """The embedding dropout runs after the token is appended (reference
    distill.py:33-34, 64-66): in training the token's row reaching the
    transformer is each element of it scaled by 1 / (1 - p) or zeroed."""
    model = distill.DistillableViT(**VIT, emb_dropout=0.5, device="cpu").train()
    seen = []
    model.transformer.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach()))
    token = torch.randn(1, 128)
    torch.manual_seed(0)
    model(torch.randn(2, 3, 32, 32), distill_token=token)
    row = seen[0][:, -1]
    kept = row != 0
    torch.testing.assert_close(row[kept], (2 * token).expand(2, -1)[kept])
    assert 0 < int(kept.sum()) < row.numel()


def _wrapper_pair(student, *, hard=False, mlp_layernorm=False, temperature=3.0, alpha=0.5):
    """The JAX and the port's wrappers around the student, a ViT teacher
    with the same weights on both sides, and the inputs."""
    jstudent, params_s, pstudent, x, _ = _student(student)
    c = x.shape[1]
    jteacher = j_vit.ViT(**VIT, channels=c)
    tparams = tp.draw_params(jteacher, jnp.asarray(x), seed=11)
    pteacher = tp.load(ViT(**VIT, channels=c, device="cpu"), from_jax.vit_state_dict_from_jax(tparams))
    kw = dict(temperature=temperature, alpha=alpha, hard=hard, mlp_layernorm=mlp_layernorm)
    jwrap = j_distill.DistillWrapper(teacher=jteacher, student=jstudent, **kw)
    y = tp.labels(BATCH, CLASSES)
    params = tp.draw_params(jwrap, jnp.asarray(x), jnp.asarray(y), teacher_logits=jnp.zeros((BATCH, CLASSES)), seed=7)
    params = {**params, "student": params_s}
    pwrap = distill.DistillWrapper(teacher=pteacher, student=pstudent, **kw)
    student_map = _students()[student][2]
    missing, unexpected = pwrap.load_state_dict(from_jax.distill_wrapper_state_dict_from_jax(params, student_map),
                                                strict=False)
    assert not unexpected and all(k.startswith("teacher.") for k in missing)
    return jwrap, params, {"params": tparams}, pwrap, x, y, student_map


@pytest.mark.parametrize("student,hard,mlp_layernorm", [("vit", False, False), ("vit", True, False),
                                                        ("vit", False, True), ("t2t", False, False),
                                                        ("efficient", True, True)])
def test_distill_wrapper_matches_jax(student, hard, mlp_layernorm):
    """The loss of ``distill_forward`` (the teacher frozen) and every
    gradient of the wrapper's parameters against the JAX ``distill_forward``
    and ``jax.grad`` through it; the teacher gets no gradient."""
    jwrap, params, tvars, pwrap, x, y, student_map = _wrapper_pair(student, hard=hard, mlp_layernorm=mlp_layernorm)

    def jloss(p):
        return j_distill.distill_forward(jwrap, {"params": p}, tvars, jnp.asarray(x), jnp.asarray(y), train=True)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = distill.distill_forward(pwrap.train(), torch.from_numpy(x), torch.from_numpy(y).long())
    tp.assert_close(loss, want)
    loss.backward()
    want_grads = from_jax.distill_wrapper_state_dict_from_jax(jax.tree.map(np.asarray, jgrads), student_map)
    for k, p in pwrap.named_parameters():
        if k.startswith("teacher."):
            assert p.grad is None, k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=tp.ATOL, rtol=tp.GRAD_RTOL, err_msg=k)
    assert pwrap.teacher.training, "the teacher's mode is restored"


def test_distill_wrapper_call_overrides_match_jax():
    """Temperature and alpha given at the call, and teacher logits handed
    over, as the JAX wrapper takes them."""
    jwrap, params, tvars, pwrap, x, y, _ = _wrapper_pair("vit")
    tl = tp.inputs((BATCH, CLASSES), 4) * 3
    want = jwrap.apply({"params": params}, jnp.asarray(x), jnp.asarray(y), 2.0, 0.25, teacher_logits=jnp.asarray(tl))
    got = pwrap.eval()(torch.from_numpy(x), torch.from_numpy(y).long(), 2.0, 0.25, teacher_logits=torch.from_numpy(tl))
    tp.assert_close(got, want)


def test_distill_wrapper_whole_layer_route_matches_jax(monkeypatch):
    """The layer kernels' routes forced on both sides: the teacher and the
    student run every layer on the whole-layer Function (its twins here:
    the student's two layers of 18 tokens with the distillation token, the
    teacher's of 17), and the loss and the gradients still match JAX's."""
    calls = tp.force_layer_routes(monkeypatch)
    jwrap, params, tvars, pwrap, x, y, student_map = _wrapper_pair("vit")

    def jloss(p):
        return j_distill.distill_forward(jwrap, {"params": p}, tvars, jnp.asarray(x), jnp.asarray(y), train=True)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    port_fb.reset_launch_counts()
    loss = distill.distill_forward(pwrap.train(), torch.from_numpy(x), torch.from_numpy(y).long())
    tp.assert_close(loss, want)
    loss.backward()
    want_grads = from_jax.distill_wrapper_state_dict_from_jax(jax.tree.map(np.asarray, jgrads), student_map)
    for k, p in pwrap.named_parameters():
        if not k.startswith("teacher."):
            np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=tp.ATOL, rtol=tp.GRAD_RTOL,
                                       err_msg=k)
    assert calls == {"layer": [(BATCH, 17, 128)] * 2 + [(BATCH, 18, 128)] * 2, "block": []}
    assert not any(port_fb.LAUNCHES.values())
