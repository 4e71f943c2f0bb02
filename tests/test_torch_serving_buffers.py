"""The port's ``Predictor`` casts the floating persistent buffers to the
serving dtype, as the JAX ``Predictor`` casts every floating leaf of the
variables, ``batch_stats`` included (vit_pytorch_tpu/serving.py:40-46), and
leaves non-persistent buffers (outside the JAX tree) and integer buffers as
they are.  SimpleViT, whose sincos table is a non-persistent buffer, serves
bitwise the logits of a Predictor that casts the parameters alone.  MaxViT
served against the JAX Predictor: tests/test_torch_max_vit.py."""

import copy

import pytest
import torch
from torch import nn

from vit_pytorch_tpu_torch import SimpleViT
from vit_pytorch_tpu_torch.serving import Predictor

SIMPLE = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)


class Buffers(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 3)
        self.register_buffer("stat", torch.full((3,), 0.1))
        self.register_buffer("table", torch.full((3,), 0.1), persistent=False)
        self.register_buffer("count", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        return self.lin(x) * self.stat + self.table.float()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_casts_persistent_floating_buffers_only(dtype):
    model = Buffers()
    pred = Predictor(model, example_shape=(4,), batch_sizes=(2,), param_dtype=dtype, device="cpu")
    served = pred.model
    assert served.lin.weight.dtype == dtype and served.stat.dtype == dtype
    assert served.table.dtype == torch.float32 and served.count.dtype == torch.long
    assert model.stat.dtype == torch.float32  # the caller's module keeps its dtypes
    assert pred(torch.ones(3, 4)).shape == (3, 3)


def _params_only(model, dtype):
    """The served copy as a Predictor that casts the parameters alone makes it."""
    served = copy.deepcopy(model)
    for p in served.parameters():
        p.requires_grad_(False)
        p.data = p.data.to(dtype)
    return served.eval()


def test_simple_vit_served_logits_are_bitwise_unchanged():
    """SimpleViT's sincos table is a non-persistent buffer: the Predictor
    leaves it in f32, and the served bf16 logits are bitwise those of the
    parameters-only cast, for a padded and a full bucket."""
    model = SimpleViT(**SIMPLE, device="cpu", generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, example_shape=(3, 32, 32), batch_sizes=(4,), device="cpu")
    assert pred.model.pos_embedding.dtype == torch.float32
    old = _params_only(model, torch.bfloat16)
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    with torch.inference_mode():
        want = old(x)
    assert torch.equal(pred(x), want)
    assert torch.equal(pred(x[:3]), want[:3])
