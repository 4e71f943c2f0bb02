"""JAX params -> the port's ``state_dict``: the exact inverse of
``vit_pytorch_tpu/utils/convert.py::vit_rules``, so that
``convert_vit(vit_state_dict_from_jax(p)) == {"params": p}``.

Dense kernels (in, out) become Linear weights (out, in); LayerNorm
``scale``/``bias`` become ``weight``/``bias``.  No JAX import: the caller
hands over the tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables["params"])``).
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
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_TOP_LEVEL = ("cls_token", "pos_embedding")


def _flatten(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def _torch_key(path: str) -> str:
    if path in _TOP_LEVEL:
        return path
    module, _, leaf = path.rpartition("/")
    if leaf in _LEAVES:
        for pattern, template in _VIT_MODULES:
            m = re.fullmatch(pattern, module)
            if m:
                return f"{m.expand(template)}.{_LEAVES[leaf]}"
    raise ValueError(f"no torch key for JAX param {path!r}")


def vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ViT``'s ``params`` tree -> the port ``ViT``'s ``state_dict``."""
    out = {}
    for path, value in _flatten(params):
        array = np.array(value)  # a writable copy torch may own
        if path.endswith("/kernel"):
            array = np.ascontiguousarray(array.T)
        out[_torch_key(path)] = torch.from_numpy(array)
    return out
