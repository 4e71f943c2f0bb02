"""The port's ViT against the JAX ViT on the CPU, fp32: same weights (JAX
init from PRNGKey(0), loaded through ``vit_state_dict_from_jax``), same
inputs (numpy seed), logits within the JAX package's parity bar (atol 5e-5,
docs/ARCHITECTURE.md "Testing strategy"); the state_dict round trip through
``convert_vit``; and the whole-layer predicate against the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pytorch_tpu.nn.blocks as jax_blocks
from vit_pytorch_tpu.models.vit import ViT as JaxViT
from vit_pytorch_tpu.nn.blocks import Transformer as JaxTransformer
from vit_pytorch_tpu.utils.convert import convert_vit
from vit_pytorch_tpu_torch import ViT
from vit_pytorch_tpu_torch.nn import blocks as torch_blocks
from vit_pytorch_tpu_torch.utils.from_jax import vit_state_dict_from_jax

KW = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)
ATOL = 5e-5  # the JAX package's fp32 parity bar
# predicate checks: dim_head 64, the head width the port's attention kernel takes
DIM_P, HEADS_P = 128, 2


def _jax_and_port(pool):
    jmodel = JaxViT(**KW, pool=pool)
    img = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    params = jax.tree.map(np.asarray, variables["params"])
    port = ViT(**KW, pool=pool, device="cpu").eval()
    port.load_state_dict(vit_state_dict_from_jax(params))
    return jmodel, variables, params, port, img


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_logits_match_jax(pool):
    jmodel, variables, _, port, img = _jax_and_port(pool)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img)))
    with torch.no_grad():
        got = port(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_state_dict_round_trip_is_exact(pool):
    _, _, params, port, _ = _jax_and_port(pool)
    back = convert_vit(port.state_dict())["params"]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path], err_msg=str(path))
        assert np.asarray(leaf).dtype == flat_want[path].dtype


def test_num_classes_zero_returns_tokens():
    port = ViT(**{**KW, "num_classes": 0}, device="cpu").eval()
    with torch.no_grad():
        out = port(torch.zeros(2, 3, 32, 32))
    assert out.shape == (2, 17, 64)


def _jax_takes_whole_layer(monkeypatch, dtype, *, dropout, train):
    """Trace the JAX Transformer (nn/blocks.py:618-653) with on_tpu taken as
    true and record whether it calls the whole-layer kernel."""
    calls = []

    def spy_layer(x, *args, **kwargs):
        calls.append("whole_layer")
        return x

    model = JaxTransformer(dim=DIM_P, depth=1, heads=HEADS_P, dim_head=64, mlp_dim=2 * DIM_P, dropout=dropout)
    # init records attention maps (every collection is mutable there), which
    # keeps it off the kernels; the predicate is read in apply
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 17, DIM_P), dtype))
    monkeypatch.setattr(jax_blocks, "on_tpu", lambda: True)
    monkeypatch.setattr(jax_blocks, "fused_transformer_layer", spy_layer)
    monkeypatch.setattr(jax_blocks, "fused_attention_block", lambda x, *a, **k: x)
    x = jax.ShapeDtypeStruct((2, 17, DIM_P), dtype)
    jax.eval_shape(
        lambda v, x: model.apply(v, x, train=train, rngs={"dropout": jax.random.PRNGKey(1)}), variables, x
    )
    return bool(calls)


@pytest.mark.parametrize(
    "case",
    ["bf16", "fp32", "bf16_dropout_train", "bf16_dropout_eval", "bf16_grad_required"],
)
def test_whole_layer_predicate_matches_jax(monkeypatch, case):
    """Device test taken as true on both sides.  Both layers are
    differentiable, so an input that requires grad takes the whole layer on
    both sides too."""
    dtype = jnp.float32 if case == "fp32" else jnp.bfloat16
    dropout = 0.1 if "dropout" in case else 0.0
    train = case.endswith("_train")
    want = _jax_takes_whole_layer(monkeypatch, dtype, dropout=dropout, train=train)
    if case == "bf16_grad_required":
        assert want

    monkeypatch.setattr(torch_blocks, "on_cuda", lambda x: True)
    tdtype = torch.float32 if case == "fp32" else torch.bfloat16
    port = torch_blocks.Transformer(DIM_P, 1, HEADS_P, 64, 2 * DIM_P, dropout, dtype=tdtype).train(train)
    x = torch.zeros(2, 17, DIM_P, dtype=tdtype, requires_grad=case == "bf16_grad_required")
    if case != "bf16_grad_required":
        port.requires_grad_(False)
    assert port.whole_layer_eligible(x) == want
