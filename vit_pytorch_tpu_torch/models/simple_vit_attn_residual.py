"""SimpleViT with an attention-pooled residual stream (reference
simple_vit_attn_residual.py:89-243), port of
``vit_pytorch_tpu/models/simple_vit_attn_residual.py``: every block's input
is an attention pool, token by token, over the history of the embedded
tokens and every block's output so far (a cross-attention of one query,
learned or the last entry, with a LayerNorm on the context); the first
attention block takes the last entry itself.  The history can be passed in
and returned (``history``, ``return_history``).

The state_dict keeps the reference's layout: the blocks under ``fn``
(``transformer.layers.N.0.fn`` the attention with split ``to_q``/``to_kv``,
``.1.fn.net.0|1|3`` the FF), the pools beside them
(``transformer.layers.N.0|1.learned_query`` and ``.attn.norm|norm_context|
to_q|to_kv|to_out``; layer 0's attention has none), and
``transformer.final_pool`` with the final LayerNorm as its ``fn``, which
``utils/convert.py::convert_simple_vit_attn_residual`` maps.  No call takes
a kernel: the blocks' split projections and the pools' context refuse the
attention-block kernels, and the pools' few keys take the dispatcher's
composite.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..nn.blocks import Attention, FeedForward, LayerNorm
from ..utils.helpers import default_device
from .simple_vit import SimpleViTBase, image_grid


class AttentionResidual(nn.Module):
    """A block ``fn`` and the history pool that feeds it (reference :89-118,
    the JAX ``HistoryPool``): with ``pool`` a learned query (unit normal) or
    the history's last entry attends, per token, over the stacked history."""

    def __init__(self, fn: nn.Module, dim: int, heads: int, dim_head: int, *, learned_query: bool = True,
                 pool: bool = True, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.fn = fn
        if pool:
            self.learned_query = nn.Parameter(torch.empty(dim, **kw)) if learned_query else None
            self.attn = Attention(dim, heads=heads, dim_head=dim_head, norm_context=True, out_bias=False,
                                  simple=True, **kw)

    def pool(self, history: List[torch.Tensor]):
        b, n, d = history[0].shape
        context = torch.stack(history, dim=2).reshape(b * n, len(history), d)
        if self.learned_query is not None:
            q = self.learned_query.to(context.dtype).expand(b * n, 1, d)
        else:
            q = history[-1].reshape(b * n, 1, d)
        return self.attn(q, context=context).reshape(b, n, d)


class AttnResidualTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *, learned_query: bool,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        res = lambda fn, pool=True: AttentionResidual(fn, dim, heads, dim_head, learned_query=learned_query,
                                                      pool=pool, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                res(Attention(dim, heads=heads, dim_head=dim_head, out_bias=False, simple=True,
                              force_split_qkv=True, **kw), pool=i > 0),
                res(FeedForward(dim, mlp_dim, simple=True, **kw)),
            ])
            for i in range(depth)
        )
        self.final_pool = res(LayerNorm(dim, **kw))

    def forward(self, history: List[torch.Tensor]):
        for i, (attn, ff) in enumerate(self.layers):
            # the first attention acts on the last entry (reference :178)
            history.append(attn.fn(history[-1] if i == 0 else attn.pool(history)))
            history.append(ff.fn(ff.pool(history)))
        return self.final_pool.fn(self.final_pool.pool(history))


class SimpleViTAttnResidual(SimpleViTBase):
    """reference simple_vit_attn_residual.py:156 — same constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/simple_vit.py``
    (the learned queries drawn from a unit normal).  ``history``: entries to
    pool over before the embedded tokens; ``return_history=True`` returns
    ``(logits, history)``."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 channels: int = 3, dim_head: int = 64, learned_query: bool = True, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        device = default_device(device)
        transformer = AttnResidualTransformer(dim, depth, heads, dim_head, mlp_dim, learned_query=learned_query,
                                              device=device, dtype=dtype)
        super().__init__(*image_grid(image_size, patch_size), channels=channels, num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, dim_head=dim_head, flash=None,
                         transformer=transformer, device=device, dtype=dtype, generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, AttentionResidual) and getattr(m, "learned_query", None) is not None:
                m.learned_query.normal_(generator=generator)

    def forward(self, img, history: Optional[List[torch.Tensor]] = None, return_history: bool = False):
        history = [*(history or ()), self.embed(img)]
        logits = self.linear_head(self.pool(self.transformer(history)))
        return (logits, history) if return_history else logits
