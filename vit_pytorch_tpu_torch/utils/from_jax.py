"""JAX params -> the port's ``state_dict``.

For the ViT it is the exact inverse of
``vit_pytorch_tpu/utils/convert.py::vit_rules``, so that
``convert_vit(vit_state_dict_from_jax(p)) == {"params": p}``; for the
SimpleViTs the inverse of ``transformer_rules(simple=True)`` and
``patch_embed_rules`` (``convert_simple_vit``) and of
``convert_simple_vit_with_qk_norm``, whose JAX module names
(``transformer_layers_{i}_attn/q_norm``, ``transformer_norm``, a LayerNorm
``linear_head``) it reads.  The NaViT maps keep the JAX module structure
(the fused ``to_qkv`` in the Transformer, split ``to_q``/``to_kv`` in
``attn_pool``); the JAX ``convert_na_vit`` fuses the reference's q/kv, so
these maps are held by model outputs (tests/test_torch_na_vit.py), not by a
round trip.  ``tool_layer_from_jax`` carries the weight tuples of the JAX
package's layer prototypes in ``tools/`` over to the port's bench tools
(``vit_pytorch_tpu_torch/tools/``).

Dense kernels (in, out) become Linear weights (out, in); LayerNorm
``scale``/``bias`` become ``weight``/``bias``; RMSNorm ``gamma`` stays
``gamma``.  No JAX import: the caller hands over the tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, variables["params"])``).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# JAX module path (joined by "/") -> torch module prefix
_VIT_MODULES = (
    (r"patch_embedding/norm_pre", "to_patch_embedding.1"),
    (r"patch_embedding/proj", "to_patch_embedding.2"),
    (r"patch_embedding/norm_post", "to_patch_embedding.3"),
    (r"transformer/layers_(\d+)_attn/norm", r"transformer.layers.\1.0.norm"),
    (r"transformer/layers_(\d+)_attn/to_qkv", r"transformer.layers.\1.0.to_qkv"),
    (r"transformer/layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
    (r"transformer/layers_(\d+)_ff/norm", r"transformer.layers.\1.1.net.0"),
    (r"transformer/layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.1"),
    (r"transformer/layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.4"),
    (r"transformer/norm", "transformer.norm"),
    (r"mlp_head", "mlp_head"),
)
_NAVIT_LAYER = (
    (r"transformer/layers_(\d+)_attn/(norm|to_qkv|to_q|to_k|to_v|q_norm|k_norm)", r"transformer.layers.\1.0.\2"),
    (r"transformer/layers_(\d+)_ff/norm", r"transformer.layers.\1.1.net.0"),
    (r"transformer/layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.1"),
    (r"transformer/layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.4"),
    (r"transformer/norm", "transformer.norm"),
    (r"(patch_norm_pre|patch_proj|patch_norm_post|head_norm|mlp_head)", r"\1"),
)
# models/na_vit.py: Attention keeps its projection out in to_out.0
_NAVIT_MODULES = (
    (r"transformer/layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
    (r"attn_pool/(norm|to_q|to_kv|q_norm|k_norm)", r"attn_pool.\1"),
    (r"attn_pool/to_out", "attn_pool.to_out.0"),
) + _NAVIT_LAYER
# models/na_vit_nested_tensor.py: NestedAttention's to_out is a bare Linear
_NAVIT_NT_MODULES = (
    (r"transformer/layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out"),
    (r"attn_pool/(norm|to_q|to_k|to_v|q_norm|k_norm|to_out)", r"attn_pool.\1"),
) + _NAVIT_LAYER
_PATCH_EMBEDDING = _VIT_MODULES[:3]
# models/simple_vit.py: bare to_out, FF net.0|1|3 (transformer_rules(simple=True))
_SIMPLE_VIT_MODULES = _PATCH_EMBEDDING + (
    (r"transformer/layers_(\d+)_attn/(norm|to_qkv|to_out)", r"transformer.layers.\1.0.\2"),
    (r"transformer/layers_(\d+)_ff/norm", r"transformer.layers.\1.1.net.0"),
    (r"transformer/layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.1"),
    (r"transformer/layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.3"),
    (r"transformer/norm", "transformer.norm"),
    (r"linear_head", "linear_head"),
)
# models/simple_vit_with_qk_norm.py: the JAX model's flat module names
_SIMPLE_VIT_QK_NORM_MODULES = _PATCH_EMBEDDING + (
    (r"transformer_layers_(\d+)_attn/(norm|to_qkv|to_out|q_norm|k_norm)", r"transformer.layers.\1.0.\2"),
    (r"transformer_layers_(\d+)_ff/norm", r"transformer.layers.\1.1.net.0"),
    (r"transformer_layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.1"),
    (r"transformer_layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.3"),
    (r"transformer_norm", "transformer.norm"),
    (r"linear_head", "linear_head"),  # a LayerNorm: scale/bias
)
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "gamma": "gamma"}
_TOP_LEVEL = ("cls_token", "pos_embedding")
_NAVIT_TOP_LEVEL = ("pos_embed_height", "pos_embed_width", "attn_pool_queries")
_NAVIT_3D_TOP_LEVEL = ("pos_embed_frame", *_NAVIT_TOP_LEVEL, "register_tokens")


def _flatten(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def _torch_key(path: str, modules, top_level) -> str:
    if path in top_level:
        return path
    module, _, leaf = path.rpartition("/")
    if leaf in _LEAVES:
        for pattern, template in modules:
            m = re.fullmatch(pattern, module)
            if m:
                return f"{m.expand(template)}.{_LEAVES[leaf]}"
    raise ValueError(f"no torch key for JAX param {path!r}")


def _state_dict(params: Mapping, modules, top_level) -> dict[str, torch.Tensor]:
    out = {}
    for path, value in _flatten(params):
        array = np.array(value)  # a writable copy torch may own
        if path.endswith("/kernel"):
            array = np.ascontiguousarray(array.T)
        out[_torch_key(path, modules, top_level)] = torch.from_numpy(array)
    return out


def vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ViT``'s ``params`` tree -> the port ``ViT``'s ``state_dict``."""
    return _state_dict(params, _VIT_MODULES, _TOP_LEVEL)


def na_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/na_vit.py::NaViT``'s ``params`` tree -> the port
    ``NaViT``'s ``state_dict``."""
    return _state_dict(params, _NAVIT_MODULES, _NAVIT_TOP_LEVEL)


def na_vit_nested_tensor_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/na_vit_nested_tensor.py::NaViT``'s ``params`` tree
    -> the port's ``state_dict``."""
    return _state_dict(params, _NAVIT_NT_MODULES, _NAVIT_TOP_LEVEL)


def na_vit_nested_tensor_3d_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/na_vit_nested_tensor_3d.py::NaViT``'s ``params``
    tree -> the port's ``state_dict`` (the 2-D nested variant's modules, the
    frame table and the register tokens)."""
    return _state_dict(params, _NAVIT_NT_MODULES, _NAVIT_3D_TOP_LEVEL)


def simple_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit.py::SimpleViT``'s ``params`` tree -> the
    port ``SimpleViT``'s ``state_dict``."""
    return _state_dict(params, _SIMPLE_VIT_MODULES, ())


def simple_vit_qk_norm_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_with_qk_norm.py::SimpleViT``'s ``params``
    tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_VIT_QK_NORM_MODULES, ())


def simple_vit_register_tokens_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_with_register_tokens.py::SimpleViT``'s
    ``params`` tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_VIT_MODULES, ("register_tokens",))


def tool_layer_from_jax(weights) -> tuple[torch.Tensor, ...]:
    """A JAX tool's weight tuple (``tools/bench_layer_fused.py``,
    ``bench_stack_fusion.py``, ``fused_block_proto.py``,
    ``bench_fused_tuning.py``) as numpy arrays -> the port's tuple, in the
    same order: a matrix (in, out) becomes an ``nn.Linear`` weight (out,
    in), a row vector (1, d) or a vector (d,) becomes (d,).  float32 stays
    float32 and bfloat16 (numpy's ``ml_dtypes`` type) becomes
    ``torch.bfloat16``, exactly."""
    out = []
    for w in weights:
        w = np.asarray(w)
        bf16 = w.dtype.name == "bfloat16"
        w = np.asarray(w, np.float32)
        w = np.ascontiguousarray(w.T) if w.ndim == 2 and w.shape[0] > 1 else w.reshape(-1).copy()
        t = torch.from_numpy(w)
        out.append(t.to(torch.bfloat16) if bf16 else t)
    return tuple(out)
