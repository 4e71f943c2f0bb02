"""SimpleViT with query-key RMSNorm (reference simple_vit_with_qk_norm.py:
101-141), port of ``vit_pytorch_tpu/models/simple_vit_with_qk_norm.py``.

The JAX model's quirks are kept: every attention normalises q and k per head
with a learned gamma initialised to ``dim_head**-0.5`` and runs at scale 1
(the norm carries sqrt(dim_head) * gamma, reference :29-37); the residual is
added outside the attention call (:44-64); and the "head" is a LayerNorm over
the mean-pooled tokens (reference :129), so the output is ``dim`` wide.

The state_dict keeps the reference's layout (``transformer.layers.N.0.
q_norm.gamma``, ``...0.to_out`` bare, ``...1.net.0|1|3``,
``transformer.norm``, ``linear_head`` a LayerNorm), which
``utils/convert.py::convert_simple_vit_with_qk_norm`` maps onto the JAX
params.  On the card in bf16 every attention call runs the attention-block
kernels with the qk-norm variants ``attention_rows[qknorm]`` and
``attention_bwd_rows[qknorm]``.
"""

from __future__ import annotations

from torch import nn

from ..nn.blocks import LN_EPS
from .simple_vit import SimpleViT as _SimpleViT


class SimpleViT(_SimpleViT):
    """reference simple_vit_with_qk_norm.py:101 — same constructor
    (``num_classes`` is accepted and unused: the head is a LayerNorm), with
    ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/simple_vit.py``."""

    qk_norm = True

    def _head(self, dim: int, num_classes: int, **kw) -> nn.Module:
        return nn.LayerNorm(dim, eps=LN_EPS, **kw)
