"""The port's Predictor on a model whose output is a tuple with a ``None``
in it, against the JAX Predictor with the same buckets on the same inputs:
every tensor of the output is sliced back to the request and joined across
chunks, and the ``None`` is kept (the JAX ``jax.tree.map``,
vit_pytorch_tpu/serving.py:223, :240)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vit_pytorch_tpu.serving import Predictor as JaxPredictor
from vit_pytorch_tpu_torch.serving import Predictor

EXAMPLE = (4, 6)
CLASSES, AUX = 10, 3
BUCKETS = (8,)
ATOL = RTOL = 5e-5  # fp32 on the CPU


class JaxTupleHead(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = x.reshape(x.shape[0], -1)
        return fnn.Dense(CLASSES, name="logits")(x), None, jnp.tanh(fnn.Dense(AUX, name="aux")(x))


class TupleHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.logits = nn.Linear(EXAMPLE[0] * EXAMPLE[1], CLASSES)
        self.aux = nn.Linear(EXAMPLE[0] * EXAMPLE[1], AUX)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.logits(x), None, torch.tanh(self.aux(x))


def _models():
    jmodel = JaxTupleHead()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *EXAMPLE), jnp.float32))
    model = TupleHead()
    with torch.no_grad():
        for name in ("logits", "aux"):
            p = variables["params"][name]
            getattr(model, name).weight.copy_(torch.from_numpy(np.array(p["kernel"]).T))
            getattr(model, name).bias.copy_(torch.from_numpy(np.array(p["bias"])))
    return jmodel, variables, model


@pytest.mark.parametrize("k", [1, 3, 9])
def test_predictor_tuple_output_matches_jax(k):
    jmodel, variables, model = _models()
    jpred = JaxPredictor(jmodel, variables, example_shape=EXAMPLE, batch_sizes=BUCKETS, param_dtype=jnp.float32)
    pred = Predictor(model, example_shape=EXAMPLE, batch_sizes=BUCKETS, param_dtype=torch.float32, device="cpu")
    x = np.random.default_rng(k).standard_normal((k, *EXAMPLE)).astype(np.float32)
    want = jpred(x)
    got = pred(torch.from_numpy(x))
    assert isinstance(got, tuple) and len(got) == len(want) == 3
    assert got[1] is None and want[1] is None
    for g, w, width in ((got[0], want[0], CLASSES), (got[2], want[2], AUX)):
        assert tuple(g.shape) == tuple(w.shape) == (k, width)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
