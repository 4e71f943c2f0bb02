"""Shared helpers of the port's model tests against the JAX package
(tests/test_torch_vit_nd_family.py, test_torch_family2.py,
test_torch_distill.py, test_torch_cross_pit_xcit.py,
test_torch_local_conv_family.py, test_torch_window_family.py,
test_torch_token_family.py): parameters drawn with numpy at the JAX
init's shapes (``jax.eval_shape``, so that the zero-initialised parts act),
BatchNorm statistics moved off their init values, the JAX model's logits
and gradients of the mean cross-entropy, and the comparison of a port model
loaded through its ``utils/from_jax.py`` map.

Tolerances: logits within 5e-5 absolute (the JAX package's fp32 parity bar)
and 1e-4 relative; gradients within 5e-5 + 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

ATOL, RTOL = 5e-5, 1e-4
GRAD_RTOL = 1e-3


def inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def labels(batch, classes, seed=1):
    return np.random.default_rng(seed).integers(0, classes, batch).astype(np.int32)


def draw_params(jmodel, *args, seed=5, special=None, **kwargs):
    """The JAX model's params, drawn at the init's shapes: Dense and Conv
    kernels N(0, 1 / fan_in), LayerNorm scales 1 + 0.1 N(0, 1), every other
    leaf 0.1 N(0, 1), unless ``special(key, leaf, z)`` returns a value."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args, **kwargs))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        key = path[-1].key
        if special is not None:
            got = special(key, leaf, z)
            if got is not None:
                return np.asarray(got, np.float32)
        if key == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return 1 + 0.1 * z if key == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def load(model, state_dict, strict=True):
    model.load_state_dict(state_dict, strict=strict)
    return model


def with_absent_zeros(to_torch, model):
    """``to_torch`` with zeros for the port's parameters that the JAX tree
    does not hold (modules the JAX model builds only where it calls them):
    their gradients must then be None, which ``check_model`` holds against
    these zeros."""

    def convert(params, *stats):
        out = to_torch(params, *stats)
        return {**{k: torch.zeros_like(v) for k, v in model.state_dict().items() if k not in out}, **out}

    return convert


def jax_loss_and_grads(apply, params, y):
    """``apply(params) -> logits``: the logits and the gradients of the mean
    cross-entropy against the integer labels ``y``."""

    def loss(p):
        logits = apply(p)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean(), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(logits), jax.tree.map(np.asarray, grads)


def assert_close(got, want, atol=ATOL, rtol=RTOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=err_msg)


def check_model(jmodel, params, model, to_torch, x, y, *, jax_call=None, port_call=None, train_call=True):
    """Eval-mode logits, then training-mode logits and every parameter
    gradient of the mean cross-entropy, against the JAX model.
    ``jax_call(params, x, train)`` and ``port_call(model, x)`` default to
    the models' own calls."""
    jax_call = jax_call or (lambda p, x, train: jmodel.apply({"params": p}, x, train=train))
    port_call = port_call or (lambda m, x: m(x))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jax.jit(lambda p: jax_call(p, xj, False))(params))
    assert_close(port_call(model.eval(), xt), want)
    want, jgrads = jax_loss_and_grads(lambda p: jax_call(p, xj, train_call), params, y)
    model.train()
    logits = port_call(model, xt)
    assert_close(logits, want)
    F.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    want_grads = to_torch(jgrads)
    for k, p in model.named_parameters():
        if p.grad is None:
            assert not np.any(want_grads[k].numpy()), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=ATOL, rtol=GRAD_RTOL, err_msg=k)


def assert_round_trip(convert, model, params, stats=None, **kw):
    """The JAX converter of the reference layout maps the port's
    state_dict back onto the very params (and ``batch_stats``) it was
    loaded from."""
    converted = convert(model.state_dict(), **kw)
    for col, want in (("params", params), ("batch_stats", stats)):
        if want is None:
            continue
        got = jax.tree.map(np.asarray, converted[col])
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(a, b)


def force_layer_routes(monkeypatch):
    """Take the device tests and the layer kernels' gates as true on both
    sides (the JAX whole-layer and attention-block kernels run in interpret
    mode, the port's Functions on their twins), and spy on the port's calls
    of the whole-layer and attention-block Functions."""
    from vit_pytorch_tpu.nn import blocks as jax_blocks
    from vit_pytorch_tpu.ops import fused_block as jax_fb
    from vit_pytorch_tpu_torch.nn import blocks as torch_blocks

    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_fb, "whole_layer_supported", lambda *a, **k: True)
    for name in ("fused_transformer_layer", "fused_attention_block"):
        orig = getattr(jax_blocks, name)
        monkeypatch.setattr(jax_blocks, name, lambda *a, _orig=orig, **k: _orig(*a, **k, interpret=True))
    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    monkeypatch.setattr(torch_blocks, "whole_layer_supported", lambda *a, **k: True)
    monkeypatch.setattr(torch_blocks, "fused_block_supported", lambda *a, **k: True)
    calls = {"layer": [], "block": []}
    layer, block = torch_blocks.fused_transformer_layer, torch_blocks.fused_attention_block

    def layer_spy(x, *args, **kwargs):
        calls["layer"].append(tuple(x.shape))
        return layer(x, *args, **kwargs)

    def block_spy(x, *args, **kwargs):
        calls["block"].append(tuple(x.shape))
        return block(x, *args, **kwargs)

    monkeypatch.setattr(torch_blocks, "fused_transformer_layer", layer_spy)
    monkeypatch.setattr(torch_blocks, "fused_attention_block", block_spy)
    return calls


def force_attention_routes(monkeypatch):
    """Take the port dispatcher's device test as true and ask both kernels'
    gates as for bf16 (so that they still refuse what the kernels cannot
    read), with spies on the short and flash Functions (their twins on the
    CPU); returns the calls, {"short": [(q, k, v shapes)], "flash": [(q, k,
    v shapes, dropout rate)]}."""
    from vit_pytorch_tpu_torch.ops import attention
    from vit_pytorch_tpu_torch.ops import flash_attention as flash
    from vit_pytorch_tpu_torch.ops import short_attention as short

    calls = {"short": [], "flash": []}
    monkeypatch.setattr(attention, "on_cuda", lambda x: True)
    monkeypatch.setattr(attention, "short_supported", lambda *a: short.short_supported(*a[:-1], torch.bfloat16))
    monkeypatch.setattr(attention, "flash_supported", lambda *a: flash.flash_supported(*a[:-1], torch.bfloat16))
    sa, fa = attention.short_attention, attention.flash_attention

    def spy_short(q, k, v, **kw):
        calls["short"].append((q.shape, k.shape, v.shape))
        return sa(q, k, v, **kw)

    def spy_flash(q, k, v, **kw):
        calls["flash"].append((q.shape, k.shape, v.shape, kw["dropout_rate"]))
        return fa(q, k, v, **kw)

    monkeypatch.setattr(attention, "short_attention", spy_short)
    monkeypatch.setattr(attention, "flash_attention", spy_flash)
    return calls


def setup_model(jax_cls, port_cls, cfg, to_torch, shape, *, batch=2, batch_norm=False):
    """A JAX model of ``cfg``, its params drawn at the init's shapes (and
    moved BatchNorm statistics), the port's model loaded from them through
    ``to_torch``, and a numpy input of ``shape`` past the batch."""
    jmodel = jax_cls(**cfg)
    x = inputs((batch, *shape))
    params = draw_params(jmodel, jnp.asarray(x))
    stats = moved_stats(jmodel, jnp.asarray(x)) if batch_norm else None
    model = load(port_cls(**cfg, device="cpu"), to_torch(params) if stats is None else to_torch(params, stats))
    return jmodel, params, stats, model, x


def moved_stats(jmodel, *args, seed=2, **kwargs):
    """The JAX model's ``batch_stats`` at the init's shapes, moved off their
    init values (mean 0, var 1): means 0.1 N(0, 1), variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args, **kwargs))["batch_stats"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        v = rng.uniform(0.5, 1.5, leaf.shape) if path[-1].key == "var" else 0.1 * rng.standard_normal(leaf.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def stats_call(jmodel, stats):
    """``check_model``'s ``jax_call`` for a model with BatchNorms: the given
    statistics, updated (and dropped) in training as flax's ``mutable``."""

    def call(params, x, train):
        variables = {"params": params, "batch_stats": stats}
        return jmodel.apply(variables, x, train=True, mutable=["batch_stats"])[0] if train else jmodel.apply(variables, x)

    return call


def check_batch_stats(jmodel, params, stats, model, to_torch, x):
    """One training-mode forward on both sides: every running mean and
    variance of the port's BatchNorms against JAX's updated
    ``batch_stats`` (flax momentum 0.9, the biased f32 variance), each moved
    off the loaded one.  Returns the number of statistics compared."""
    _, updates = jax.jit(lambda p: jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                                                mutable=["batch_stats"]))(params)
    want = to_torch(params, jax.tree.map(np.asarray, updates["batch_stats"]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.train()(torch.from_numpy(x))
    state = model.state_dict()
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    for k in keys:
        assert_close(state[k], want[k], err_msg=k)
        assert not torch.equal(state[k], before[k]), k
    return len(keys)
