"""JetViT: an attention kind chosen per layer (reference jet_vit.py:292-359),
port of ``vit_pytorch_tpu/models/jet_vit.py``.

Each layer's attention is full (``"FA"``, :class:`JetFullAttention`,
through ``ops/attention.py::dot_product_attention``: the composite below
1,024 keys, as in JAX), windowed (``"WA"``, :class:`JetWindowAttention`:
non-overlapping windows with a per-head relative position bias, the
table gathered with ``models/max_vit.py::rel_pos_indices``) or linear
with a dynamic convolution (``"LA"``, :class:`JetLinearAttention`: ReLU
linear attention plus :class:`SqueezeDynamicConv`, a depthwise 3 x 3
convolution whose weights an MLP makes from each image's mean value, run as
one grouped ``F.conv2d`` with ``groups = b * inner``).  A tuple of kinds
is a random choice per forward: in training, with a ``layer_select``
generator, an index is drawn for the layer (``draw_branch``), else the
first kind runs; the JAX model computes every kind and takes one with
``lax.switch`` under the same conditions, and its ``make_train_step``
passes no ``layer_select`` rng, so there a tuple runs its first kind, as
the port's ``make_train_step`` (which passes no generator) does.  Only the
chosen kind is computed here: its output is the same.  No kernel of the
port runs in this model.

Only the kinds a layer lists are built, as in the JAX model (the reference
builds all three in a ModuleDict, and the JAX converter drops the others).
The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding`` (num_patches, dim), ``transformer.layers.N.0.options.FA|
WA|LA``, ``transformer.layers.N.1``, ``transformer.norm``, ``mlp_head``):
``utils/convert.py::convert_jet_vit`` with the same ``attn_layers``,
``utils/from_jax.py::jet_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ..nn.blocks import FeedForward, LayerNorm
from ..nn.patch import PatchEmbedding
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device, pair, table_device
from .max_vit import rel_pos_indices
from .vit import init_modules_like_jax


def linear_attn(q, k, v):
    """ReLU linear attention (reference jet_vit.py:23-30)."""
    q, k = F.relu(q), F.relu(k)
    context = torch.einsum("bhnd,bhne->bhde", k, v)
    normalizer = torch.einsum("bhnd,bhd->bhn", q, k.sum(dim=2))
    return torch.einsum("bhnd,bhde->bhne", q, context) / normalizer[..., None].clamp_min(1e-6)


def draw_branch(num: int, generator: torch.Generator) -> int:
    """The index of the kind a layer runs, uniform over ``num``, from
    ``generator`` (the JAX ``jax.random.randint`` of the layer_select
    rng)."""
    return int(torch.randint(0, num, (), generator=generator, device=generator.device))


def _split_heads(t, heads: int):
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


class SqueezeDynamicConv(nn.Module):
    """A depthwise convolution whose k x k kernel each image's mean value
    makes through an MLP (reference jet_vit.py:48-77)."""

    def __init__(self, dim: int, h_s: int, w_s: int, kernel_size: int = 3, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.dim, self.h_s, self.w_s, self.kernel_size = dim, h_s, w_s, kernel_size
        self.mlp = nn.Sequential(nn.Linear(dim, dim // 4, **kw), nn.SiLU(),
                                 nn.Linear(dim // 4, dim * kernel_size * kernel_size, **kw))

    def forward(self, v):
        b, heads, n, d = v.shape
        k = self.kernel_size
        weight = self.mlp(rearrange(v, "b h n d -> b (h d) n").mean(dim=-1)).reshape(b * self.dim, 1, k, k)
        v_spatial = rearrange(v, "b h (hs ws) d -> 1 (b h d) hs ws", hs=self.h_s, ws=self.w_s)
        out = F.conv2d(v_spatial, weight.to(v.dtype), padding=k // 2, groups=b * self.dim)
        return rearrange(out, "1 (b h d) hs ws -> b h (hs ws) d", b=b, h=heads)


class JetWindowAttention(nn.Module):
    """reference jet_vit.py:79-153: ``dim // dim_head`` heads within each
    window of ``window_size``^2 tokens, logits in f32 with the per-head
    bias."""

    def __init__(self, dim: int, h_s: int, w_s: int, dim_head: int = 64, dropout: float = 0.0,
                 window_size: int = 7, *, device=None, dtype=None):
        super().__init__()
        assert dim % dim_head == 0
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dim_head, self.h_s, self.w_s, self.window_size = dim // dim_head, dim_head, h_s, w_s, \
            window_size
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False, **kw)
        self.rel_pos_bias = nn.Embedding((2 * window_size - 1) ** 2, self.heads, **kw)
        idx = torch.from_numpy(rel_pos_indices(window_size)).to(table_device(kw["device"]))
        self.register_buffer("rel_pos_indices", idx, persistent=False)
        self.attn_dropout = nn.Dropout(dropout)
        self.to_out = nn.Sequential(nn.Linear(dim, dim, bias=False, **kw), nn.Dropout(dropout))

    def forward(self, x):
        w, gx, gy = self.window_size, self.h_s // self.window_size, self.w_s // self.window_size
        x = self.norm(x)
        xw = rearrange(x, "b (x w1 y w2) d -> (b x y) (w1 w2) d", x=gx, w1=w, y=gy, w2=w)
        q, k, v = (_split_heads(t, self.heads) for t in self.to_qkv(xw).chunk(3, dim=-1))
        q = q * self.dim_head**-0.5
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        bias = self.rel_pos_bias.weight[self.rel_pos_indices].permute(2, 0, 1)
        attn = self.attn_dropout(torch.softmax(sim + bias.float(), dim=-1).to(v.dtype))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(xw.shape)
        return rearrange(self.to_out(out), "(b x y) (w1 w2) d -> b (x w1 y w2) d", x=gx, y=gy, w1=w, w2=w)


class JetLinearAttention(nn.Module):
    """reference jet_vit.py:156-188: ReLU linear attention plus the dynamic
    convolution of v."""

    def __init__(self, dim: int, h_s: int, w_s: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 kernel_size: int = 3, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads = heads
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.dynamic_conv = SqueezeDynamicConv(inner, h_s, w_s, kernel_size, **kw)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def forward(self, x):
        x = self.norm(x)
        q, k, v = (_split_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        out = linear_attn(q, k, v) + self.dynamic_conv(v)
        return self.to_out(rearrange(out, "b h n d -> b n (h d)"))


class JetFullAttention(nn.Module):
    """reference jet_vit.py:191-225."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dropout = heads, dropout
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim, **kw), nn.Dropout(dropout))

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (_split_heads(t, self.heads) for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        out = dot_product_attention(q, k, v, dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class JetViT(nn.Module):
    """reference jet_vit.py:292 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``.  ``attn_layers``:
    one entry a layer, ``"FA"``, ``"WA"``, ``"LA"`` or a tuple of them (all
    ``"FA"`` by default)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 channels: int = 3, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 window_size: int = 7, attn_layers: Optional[Sequence] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        h_s, w_s = image_height // patch_height, image_width // patch_width
        self.num_classes = num_classes
        attn_layers = attn_layers or ("FA",) * depth
        self.kinds = [tuple(attn_layers[i]) if isinstance(attn_layers[i], (tuple, list)) else (attn_layers[i],)
                      for i in range(depth)]
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), channels * patch_height * patch_width,
                                                 dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(h_s * w_s, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)

        def make(kind):
            if kind == "WA":
                return JetWindowAttention(dim, h_s, w_s, dim_head, dropout, window_size, **kw)
            if kind == "LA":
                return JetLinearAttention(dim, h_s, w_s, heads, dim_head, dropout, **kw)
            return JetFullAttention(dim, heads, dim_head, dropout, **kw)

        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList()
        for kinds in self.kinds:
            attn = nn.Module()
            attn.options = nn.ModuleDict({kind: make(kind) for kind in kinds})
            self.transformer.layers.append(nn.ModuleList([attn, FeedForward(dim, mlp_dim, dropout, **kw)]))
        self.transformer.norm = LayerNorm(dim, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, **kw) if num_classes > 0 else None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        for m in self.modules():
            if isinstance(m, JetWindowAttention):
                m.rel_pos_bias.weight.normal_(generator=generator)

    def forward(self, img, layer_select: Optional[torch.Generator] = None):
        """``layer_select``: the generator of the layers' random kinds, drawn
        from in training only; without it a tuple runs its first kind."""
        x = self.to_patch_embedding(img)
        x = self.dropout(x + self.pos_embedding.to(x.dtype))
        for kinds, (attn, ff) in zip(self.kinds, self.transformer.layers):
            index = 0
            if len(kinds) > 1 and self.training and layer_select is not None:
                index = draw_branch(len(kinds), layer_select)
            x = attn.options[kinds[index]](x) + x
            x = ff(x) + x
        x = self.transformer.norm(x)
        if self.mlp_head is None:
            return x
        return self.mlp_head(x.mean(dim=1))
