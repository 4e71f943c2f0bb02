"""JAX params -> the port's ``state_dict``.

For the ViT it is the exact inverse of
``vit_pytorch_tpu/utils/convert.py::vit_rules``, so that
``convert_vit(vit_state_dict_from_jax(p)) == {"params": p}``; for the
SimpleViTs the inverse of ``transformer_rules(simple=True)`` and
``patch_embed_rules`` (``convert_simple_vit``, which the 1-D, 3-D and
patch-dropout variants share), of ``convert_simple_vit_with_qk_norm``, whose
JAX module names (``transformer_layers_{i}_attn/q_norm``,
``transformer_norm``, a LayerNorm ``linear_head``) it reads, and of the
family's other converters (``convert_simple_flash_attn_vit`` and its 3-D
one, ``convert_simple_vit_with_fft``, ``convert_simple_vit_orthog_residual``,
``convert_simple_vit_with_hyper_connections``,
``convert_simple_vit_with_value_residual``,
``convert_simple_vit_with_specialized_cls`` and
``convert_simple_vit_attn_residual``); where the JAX model has parameters
its converter does not map (the orthogonal update's learned gates, the
specialized qkv projections), the maps name them in the port's layout.  The NaViT maps keep the JAX module structure
(the fused ``to_qkv`` in the Transformer, split ``to_q``/``to_kv`` in
``attn_pool``); the JAX ``convert_na_vit`` fuses the reference's q/kv, so
these maps are held by model outputs (tests/test_torch_na_vit.py), not by a
round trip.  The ViViT map covers both variants (for ``factorized_encoder``
the inverse of ``convert_vivit``); the MAE map is the inverse of
``convert_mae`` (the encoder under ``encoder/``); the MaxViT maps, the
inverses of ``convert_max_vit`` and ``convert_max_vit_with_registers``,
take the ``batch_stats`` tree too, whose ``mean``/``var`` leaves become the
BatchNorms' ``running_mean``/``running_var``.  The SSL trainers' maps are
the inverses of ``convert_dino`` (the student; the teacher from the JAX
``DinoState.teacher_params``), ``convert_lejepa``, ``convert_simmim``,
``convert_mpp`` and ``convert_mp3``; EsViT, which has no converter, takes
Dino's names with ``view_projector`` and ``region_projector``.
The VAT family's map (``vat_family_state_dict_from_jax``) renames the JAX
module paths into the port's, which keeps the JAX module tree;
``accept_video_wrapper_state_dict_from_jax`` takes the wrapped net's map.
Item 9's family 3a has the inverses of ``convert_local_vit``,
``convert_small_dataset_vit``, ``convert_pit``, ``convert_cross_vit``,
``convert_xcit``, ``convert_rvt``, ``convert_nest``,
``convert_mobile_vit``, ``convert_cvt`` and ``convert_twins_svt`` (XCiT's,
MobileViT's and CvT's with their ``batch_stats``; NesT's, CvT's and
Twins-SVT's LayerNorms the channel norms' ``g`` and ``b`` of shape (1, c,
1, 1)).  Item 9's families 3b and 4 have the inverses of
``convert_sep_vit`` (the qkv and window q, k projections 1x1 Conv1d
weights), ``convert_levit`` (with its ``batch_stats``; the distillation
head, which it does not map, at ``distill_head``), ``convert_crossformer``,
``convert_regionvit``, ``convert_scalable_vit``,
``convert_vit_with_patch_merger``, ``convert_learnable_memory_vit``,
``convert_adapter``, ``convert_ats_vit`` and ``convert_look_vit``.  Item
9's families 5 and 6 have the inverses of
``convert_vit_with_patch_dropout``, ``convert_vit_with_keel_post_ln``,
``convert_simple_uvit``, ``convert_jumbo_vit``, ``convert_vit_detpool``,
``convert_normalized_vit`` (each NormLinear's raw weight at the key the
reference's parametrization gives it), ``convert_jet_vit`` (the kinds a
layer builds), ``convert_vit_with_decorr``, ``convert_wwt`` and
``convert_vivit_moss`` (MOSS's channel LayerNorm gains as (1, c, 1, 1)
``gamma``s); the AcceptVideoWrapper's map also takes its ``moss``.
``tool_layer_from_jax``
carries the weight tuples of the JAX package's layer prototypes in
``tools/`` over to the port's bench tools (``vit_pytorch_tpu_torch/tools/``).

Dense kernels (in, out) become Linear weights (out, in) and Conv kernels
(kh, kw, in, out) Conv2d weights (out, in, kh, kw); LayerNorm and BatchNorm
``scale``/``bias`` become ``weight``/``bias``; RMSNorm ``gamma`` stays
``gamma``; an Embed's ``embedding`` becomes the Embedding's ``weight``.  No
JAX import: the caller hands over the tree as nested dicts of numpy arrays
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
# models/simple_flash_attn_vit.py: no transformer norm; the head
# Sequential(LayerNorm, Linear) after the pool
_SIMPLE_FLASH_MODULES = _SIMPLE_VIT_MODULES[:-2] + (
    (r"head_norm", "linear_head.0"),
    (r"linear_head", "linear_head.1"),
)
# models/simple_vit_with_fft.py: the second patch embedding on the spectrum
_SIMPLE_FFT_MODULES = _SIMPLE_VIT_MODULES + (
    (r"freq_embedding/norm_pre", "to_freq_embedding.1"),
    (r"freq_embedding/proj", "to_freq_embedding.2"),
    (r"freq_embedding/norm_post", "to_freq_embedding.3"),
)
# models/simple_vit_orthog_residual_update.py: the blocks under .block, the
# learned gates beside them
_SIMPLE_ORTHOG_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn/(norm|to_qkv|to_out)", r"transformer.layers.\1.0.block.\2"),
    (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.1.block.net.0"),
    (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.block.net.1"),
    (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.block.net.3"),
    (r"layers_(\d+)_attn_orthog/to_modulation", r"transformer.layers.\1.0.to_modulation"),
    (r"layers_(\d+)_ff_orthog/to_modulation", r"transformer.layers.\1.1.to_modulation"),
    (r"norm", "transformer.norm"),
    (r"linear_head", "linear_head"),
)
# models/simple_vit_with_hyper_connections.py: [attn_hyper, attn, ff_hyper, ff]
_HYPER_PARAMS = "static_beta|static_alpha|dynamic_alpha_fn|dynamic_alpha_scale|dynamic_beta_fn|dynamic_beta_scale"
_SIMPLE_HYPER_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn_hyper/norm", r"transformer.layers.\1.0.norm"),
    (r"layers_(\d+)_attn/(norm|to_qkv|to_out)", r"transformer.layers.\1.1.\2"),
    (r"layers_(\d+)_ff_hyper/norm", r"transformer.layers.\1.2.norm"),
    (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.3.net.0"),
    (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.3.net.1"),
    (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.3.net.3"),
    (r"norm", "transformer.norm"),
    (r"linear_head", "linear_head"),
)
_SIMPLE_HYPER_TOP_LEVEL = (
    "register_tokens",
    (rf"layers_(\d+)_attn_hyper/({_HYPER_PARAMS})", r"transformer.layers.\1.0.\2"),
    (rf"layers_(\d+)_ff_hyper/({_HYPER_PARAMS})", r"transformer.layers.\1.2.\2"),
)
# models/simple_vit_with_value_residual.py: the FF a bare Sequential
_SIMPLE_VALUE_RESIDUAL_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn/(norm|to_qkv|to_out)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/to_residual_mix", r"transformer.layers.\1.0.to_residual_mix.0"),
    (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.1.0"),
    (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.1"),
    (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.3"),
    (r"norm", "transformer.norm"),
    (r"linear_head", "linear_head"),
)
# models/simple_vit_with_specialized_cls.py: fns.0 the cls token's, fns.1 the patches'
_SIMPLE_SPECIALIZED_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn/norm_cls", r"transformer.layers.\1.0.norm.fns.0"),
    (r"layers_(\d+)_attn/norm_patch", r"transformer.layers.\1.0.norm.fns.1"),
    (r"layers_(\d+)_attn/(to_qkv|to_out)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/to_qkv_cls", r"transformer.layers.\1.0.to_qkv.fns.0"),
    (r"layers_(\d+)_attn/to_qkv_patch", r"transformer.layers.\1.0.to_qkv.fns.1"),
    (r"layers_(\d+)_ff/norm_cls", r"transformer.layers.\1.1.norm.fns.0"),
    (r"layers_(\d+)_ff/norm_patch", r"transformer.layers.\1.1.norm.fns.1"),
    (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.0"),
    (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.2"),
    (r"final_norm_cls", "transformer.norm.fns.0"),
    (r"final_norm_patch", "transformer.norm.fns.1"),
    (r"linear_head", "linear_head"),
)
# models/simple_vit_attn_residual.py: the blocks under .fn, the pools beside
# them, the final LayerNorm the final pool's fn
_ATTN_POOL = r"attn/(norm|norm_context|to_q|to_kv|to_out)"
_SIMPLE_ATTN_RESIDUAL_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn/(norm|to_q|to_kv|to_out)", r"transformer.layers.\1.0.fn.\2"),
    (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.1.fn.net.0"),
    (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.fn.net.1"),
    (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.fn.net.3"),
    (rf"layers_(\d+)_attn_pool/{_ATTN_POOL}", r"transformer.layers.\1.0.attn.\2"),
    (rf"layers_(\d+)_ff_pool/{_ATTN_POOL}", r"transformer.layers.\1.1.attn.\2"),
    (rf"final_pool/{_ATTN_POOL}", r"transformer.final_pool.attn.\1"),
    (r"final_norm", "transformer.final_pool.fn"),
    (r"linear_head", "linear_head"),
)
_SIMPLE_ATTN_RESIDUAL_TOP_LEVEL = (
    (r"layers_(\d+)_attn_pool/learned_query", r"transformer.layers.\1.0.learned_query"),
    (r"layers_(\d+)_ff_pool/learned_query", r"transformer.layers.\1.1.learned_query"),
    (r"final_pool/learned_query", "transformer.final_pool.learned_query"),
)
# models/vivit.py: the reference's layout, both variants
_VIVIT_MODULES = (
    (r"patch_norm_pre", "to_patch_embedding.1"),
    (r"patch_proj", "to_patch_embedding.2"),
    (r"patch_norm_post", "to_patch_embedding.3"),
    *((p.replace("transformer", f"{t}_transformer", 1), v.replace("transformer", f"{t}_transformer", 1))
      for t in ("spatial", "temporal") for p, v in _VIT_MODULES[3:10]),
    (r"factorized_transformer/layers_(\d+)_spatial_attn/(norm|to_qkv)", r"factorized_transformer.layers.\1.0.\2"),
    (r"factorized_transformer/layers_(\d+)_spatial_attn/to_out", r"factorized_transformer.layers.\1.0.to_out.0"),
    (r"factorized_transformer/layers_(\d+)_temporal_attn/(norm|to_qkv)", r"factorized_transformer.layers.\1.1.\2"),
    (r"factorized_transformer/layers_(\d+)_temporal_attn/to_out", r"factorized_transformer.layers.\1.1.to_out.0"),
    (r"factorized_transformer/layers_(\d+)_ff/norm", r"factorized_transformer.layers.\1.2.net.0"),
    (r"factorized_transformer/layers_(\d+)_ff/fc1", r"factorized_transformer.layers.\1.2.net.1"),
    (r"factorized_transformer/layers_(\d+)_ff/fc2", r"factorized_transformer.layers.\1.2.net.4"),
    (r"factorized_transformer/norm", "factorized_transformer.norm"),
    (r"mlp_head", "mlp_head"),
)
# ssl/mae.py: the port ViT under encoder., the decoder Transformer's layers as
# the ViT's transformer's
_MAE_MODULES = (
    *((f"encoder/{p}", f"encoder.{v}") for p, v in _VIT_MODULES[:10]),
    *((p.replace("transformer", "decoder", 1), v.replace("transformer", "decoder", 1)) for p, v in _VIT_MODULES[3:10]),
    (r"(enc_to_dec|decoder_pos_emb|to_pixels)", r"\1"),
)
# ssl/mp3.py: split to_q/to_kv, the reference's LN + Linear heads
_MP3_MODULES = (
    (r"vit/patch_embedding/norm_pre", "vit.to_patch_embedding.1"),
    (r"vit/patch_embedding/proj", "vit.to_patch_embedding.2"),
    (r"vit/patch_embedding/norm_post", "vit.to_patch_embedding.3"),
    (r"vit/transformer/layers_(\d+)_attn/(norm|to_q|to_kv)", r"vit.transformer.layers.\1.0.\2"),
    (r"vit/transformer/layers_(\d+)_attn/to_out", r"vit.transformer.layers.\1.0.to_out.0"),
    (r"vit/transformer/layers_(\d+)_ff/norm", r"vit.transformer.layers.\1.1.net.0"),
    (r"vit/transformer/layers_(\d+)_ff/fc1", r"vit.transformer.layers.\1.1.net.1"),
    (r"vit/transformer/layers_(\d+)_ff/fc2", r"vit.transformer.layers.\1.1.net.4"),
    (r"vit/head_norm", "vit.linear_head.0"),
    (r"vit/linear_head", "vit.linear_head.1"),
    (r"mlp_head_norm", "mlp_head.0"),
    (r"mlp_head", "mlp_head.1"),
)
# models/max_vit.py: the MBConv's children (reference max_vit.py:90-117)
_MBCONV = (
    (r"block_(\d+)_mbconv/conv_expand", r"layers.\1.0.0"),
    (r"block_(\d+)_mbconv/bn1", r"layers.\1.0.1"),
    (r"block_(\d+)_mbconv/conv_depthwise", r"layers.\1.0.3"),
    (r"block_(\d+)_mbconv/bn2", r"layers.\1.0.4"),
    (r"block_(\d+)_mbconv/se/fc1", r"layers.\1.0.6.gate.1"),
    (r"block_(\d+)_mbconv/se/fc2", r"layers.\1.0.6.gate.3"),
    (r"block_(\d+)_mbconv/conv_project", r"layers.\1.0.7"),
    (r"block_(\d+)_mbconv/bn3", r"layers.\1.0.8"),
    (r"conv_stem_(\d)", r"conv_stem.\1"),
    (r"head_norm", "mlp_head.1"),
    (r"mlp_head", "mlp_head.2"),
)


def _max_vit_window(kind: str, attn: str, ff: str):
    """A window attention and its feed-forward: ``attn`` and ``ff`` the
    torch prefixes of ``block_N_{kind}_attn`` and ``block_N_{kind}_ff``."""
    return (
        (rf"block_(\d+)_{kind}_attn/(norm|to_qkv)", rf"{attn}.\2"),
        (rf"block_(\d+)_{kind}_attn/to_out", rf"{attn}.to_out.0"),
        (rf"block_(\d+)_{kind}_attn", attn),  # its rel_pos_bias table
        (rf"block_(\d+)_{kind}_ff/norm", rf"{ff}0"),
        (rf"block_(\d+)_{kind}_ff/fc1", rf"{ff}1"),
        (rf"block_(\d+)_{kind}_ff/fc2", rf"{ff}4"),
    )


_MAX_VIT_MODULES = _MBCONV + _max_vit_window("block", r"layers.\1.2.fn", r"layers.\1.3.fn.net.") + _max_vit_window(
    "grid", r"layers.\1.6.fn", r"layers.\1.7.fn.net.")
# models/max_vit_with_registers.py: attention and a bare Sequential feed-forward a window kind
_MAX_VIT_REGISTERS_MODULES = _MBCONV + _max_vit_window("block", r"layers.\1.1.0", r"layers.\1.1.1.") + _max_vit_window(
    "grid", r"layers.\1.2.0", r"layers.\1.2.1.")
# models/vit_1d.py, vit_3d.py: no transformer norm, the head Sequential(LayerNorm, Linear)
_VIT_1D_MODULES = _VIT_MODULES[:9] + ((r"head_norm", "mlp_head.0"), (r"mlp_head", "mlp_head.1"))
# models/vit_nd.py: the Linear -> LN embedding after the patchify
_ND_PATCH = ((r"patch_proj", "to_patch_embedding.1"), (r"patch_norm", "to_patch_embedding.2"))
_VIT_ND_MODULES = _ND_PATCH + _VIT_MODULES[3:]
# models/vit_nd_rotary.py, vit_nd_pope.py: the JAX layers at the top level, split to_qk / to_v
_VIT_ND_FLAT_MODULES = _ND_PATCH + (
    (r"layers_(\d+)_attn/(norm|to_qk|to_v)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
    (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.1.net.0"),
    (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.1"),
    (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.4"),
    (r"norm", "transformer.norm"),
    (r"mlp_head", "mlp_head"),
)
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "gamma": "gamma", "embedding": "weight",
           "rel_pos_bias": "rel_pos_bias.weight", "mean": "running_mean", "var": "running_var"}
_TOP_LEVEL = ("cls_token", "pos_embedding")
_NAVIT_TOP_LEVEL = ("pos_embed_height", "pos_embed_width", "attn_pool_queries")
_NAVIT_3D_TOP_LEVEL = ("pos_embed_frame", *_NAVIT_TOP_LEVEL, "register_tokens")
# models/deepvit.py: ReAttention's head mix and its LayerNorm over heads
_FF_LAYERS = (
    (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.1.net.0"),
    (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.1"),
    (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.4"),
)
_LN_LINEAR_HEAD = ((r"head_norm", "mlp_head.0"), (r"mlp_head", "mlp_head.1"))
_DEEPVIT_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn/(norm|to_qkv)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/reattn_norm", r"transformer.layers.\1.0.reattn_norm.1"),
    (r"layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
) + _FF_LAYERS + _LN_LINEAR_HEAD
_DEEPVIT_TOP_LEVEL = _TOP_LEVEL + ((r"layers_(\d+)_attn/reattn_weights", r"transformer.layers.\1.0.reattn_weights"),)
# models/cait.py: LayerScale(fn) a layer, in the patch and the class tokens' transformers
_CAIT_MODULES = _PATCH_EMBEDDING + tuple(
    (p.replace("T", t), v.replace("T", t)) for t in ("patch_transformer", "cls_transformer") for p, v in (
        (r"T/layers_(\d+)_attn/(norm|to_q|to_kv)", r"T.layers.\1.0.fn.\2"),
        (r"T/layers_(\d+)_attn/to_out", r"T.layers.\1.0.fn.to_out.0"),
        (r"T/layers_(\d+)_ff/norm", r"T.layers.\1.1.fn.net.0"),
        (r"T/layers_(\d+)_ff/fc1", r"T.layers.\1.1.fn.net.1"),
        (r"T/layers_(\d+)_ff/fc2", r"T.layers.\1.1.fn.net.4"),
    )) + _LN_LINEAR_HEAD
_CAIT_TOP_LEVEL = _TOP_LEVEL + tuple(
    (p.replace("T", t), v.replace("T", t)) for t in ("patch_transformer", "cls_transformer") for p, v in (
        (r"T/layers_(\d+)_attn_scale", r"T.layers.\1.0.scale"),
        (r"T/layers_(\d+)_ff_scale", r"T.layers.\1.1.scale"),
        (r"T/layers_(\d+)_attn/(mix_heads_pre_attn|mix_heads_post_attn)", r"T.layers.\1.0.fn.\2"),
    ))
# models/parallel_vit.py: the branches under fns.J, a bare Linear patch embedding
_PARALLEL_VIT_MODULES = (
    (r"patch_embedding/proj", "to_patch_embedding.1"),
    (r"layers_(\d+)_attn_(\d+)/(norm|to_qkv)", r"transformer.layers.\1.0.fns.\2.\3"),
    (r"layers_(\d+)_attn_(\d+)/to_out", r"transformer.layers.\1.0.fns.\2.to_out.0"),
    (r"layers_(\d+)_ff_(\d+)/norm", r"transformer.layers.\1.1.fns.\2.net.0"),
    (r"layers_(\d+)_ff_(\d+)/fc1", r"transformer.layers.\1.1.fns.\2.net.1"),
    (r"layers_(\d+)_ff_(\d+)/fc2", r"transformer.layers.\1.1.fns.\2.net.4"),
) + _LN_LINEAR_HEAD
# models/cct.py, cct_3d.py: the tokenizer's convolutions, the classifier's blocks
_CCT_MODULES = (
    (r"tokenizer/conv_(\d+)", r"tokenizer.conv_layers.\1.0"),
    (r"classifier/blocks_(\d+)/(pre_norm|norm1|linear1|linear2)", r"classifier.blocks.\1.\2"),
    (r"classifier/blocks_(\d+)/self_attn/(qkv|proj)", r"classifier.blocks.\1.self_attn.\2"),
    (r"classifier/(norm|attention_pool|fc)", r"classifier.\1"),
)
_CCT_TOP_LEVEL = ((r"classifier/(positional_emb|class_emb)", r"classifier.\1"),)
# models/efficient.py: the shell; the caller's transformer's map beside it
_EFFICIENT_MODULES = _PATCH_EMBEDDING + _LN_LINEAR_HEAD

# models/local_vit.py: Residual(Attention), ExcludeCLS(Residual(ConvFeedForward))
_LOCAL_VIT_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn/(norm|to_qkv)", r"transformer.layers.\1.0.fn.\2"),
    (r"layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.fn.to_out.0"),
    (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.1.fn.fn.net.0"),
    (r"layers_(\d+)_ff/conv_in", r"transformer.layers.\1.1.fn.fn.net.1"),
    (r"layers_(\d+)_ff/depthwise", r"transformer.layers.\1.1.fn.fn.net.3.net.0"),
    (r"layers_(\d+)_ff/pointwise", r"transformer.layers.\1.1.fn.fn.net.3.net.1"),
    (r"layers_(\d+)_ff/conv_out", r"transformer.layers.\1.1.fn.fn.net.6"),
) + _LN_LINEAR_HEAD
# models/vit_for_small_dataset.py: SPT's to_patch_tokens, the LSA's temperature
_SMALL_DATASET_MODULES = (
    (r"patch_embedding/norm", "to_patch_embedding.to_patch_tokens.1"),
    (r"patch_embedding/proj", "to_patch_embedding.to_patch_tokens.2"),
    (r"layers_(\d+)_attn/(norm|to_qkv)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
) + _FF_LAYERS + _LN_LINEAR_HEAD
_SMALL_DATASET_TOP_LEVEL = _TOP_LEVEL + ((r"layers_(\d+)_attn/temperature", r"transformer.layers.\1.0.temperature"),)
# models/cross_vit.py: the branches' embedders, transformers and heads, the cross transformers
_CROSS_VIT_MODULES = tuple(
    (p.replace("S", s_), v.replace("S", s_)) for s_ in ("sm", "lg") for p, v in (
        (r"S_image_embedder/patch_embedding/norm_pre", "S_image_embedder.to_patch_embedding.1"),
        (r"S_image_embedder/patch_embedding/proj", "S_image_embedder.to_patch_embedding.2"),
        (r"S_image_embedder/patch_embedding/norm_post", "S_image_embedder.to_patch_embedding.3"),
        (r"S_head_norm", "S_mlp_head.0"),
        (r"S_mlp_head", "S_mlp_head.1"),
    )) + tuple(
    (rf"encoder_(\d+)_{s_}/{p}", rf"multi_scale_encoder.layers.\1.{i}.{v}")
    for i, s_ in enumerate(("sm", "lg")) for p, v in (
        (r"layers_(\d+)_attn/(norm|to_qkv)", r"layers.\2.0.\3"),
        (r"layers_(\d+)_attn/to_out", r"layers.\2.0.to_out.0"),
        (r"layers_(\d+)_ff/norm", r"layers.\2.1.net.0"),
        (r"layers_(\d+)_ff/fc1", r"layers.\2.1.net.1"),
        (r"layers_(\d+)_ff/fc2", r"layers.\2.1.net.4"),
        (r"norm", "norm"),
    )) + tuple(
    (rf"encoder_(\d+)_cross/layers_(\d+)_{a}", rf"multi_scale_encoder.layers.\1.2.layers.\2.{i}.{t}")
    for i, (side, attend) in enumerate((("sm", "sm_attend_lg"), ("lg", "lg_attend_sm"))) for a, t in (
        (f"{side}_proj_in", "project_in"), (f"{side}_proj_out", "project_out"), (f"{attend}/(norm|to_q|to_kv)", r"fn.\3"),
        (f"{attend}/to_out", "fn.to_out.0")))
_CROSS_VIT_TOP_LEVEL = ((r"(sm|lg)_image_embedder/(cls_token|pos_embedding)", r"\1_image_embedder.\2"),)
# models/xcit.py: LayerScale(fn) a branch, the patch layers' and the class layers'
_XCIT_MODULES = _PATCH_EMBEDDING + (
    (r"xca_(\d+)_attn/(norm|to_qkv)", r"xcit_transformer.layers.\1.0.fn.\2"),
    (r"xca_(\d+)_attn/to_out", r"xcit_transformer.layers.\1.0.fn.to_out.0"),
    (r"xca_(\d+)_lpi/norm", r"xcit_transformer.layers.\1.1.fn.net.0"),
    (r"xca_(\d+)_lpi/conv1", r"xcit_transformer.layers.\1.1.fn.net.2"),
    (r"xca_(\d+)_lpi/bn", r"xcit_transformer.layers.\1.1.fn.net.3"),
    (r"xca_(\d+)_lpi/conv2", r"xcit_transformer.layers.\1.1.fn.net.5"),
    (r"xca_(\d+)_ff/norm", r"xcit_transformer.layers.\1.2.fn.net.0"),
    (r"xca_(\d+)_ff/fc1", r"xcit_transformer.layers.\1.2.fn.net.1"),
    (r"xca_(\d+)_ff/fc2", r"xcit_transformer.layers.\1.2.fn.net.4"),
    (r"cls_(\d+)_attn/(norm|to_q|to_kv)", r"cls_transformer.layers.\1.0.fn.\2"),
    (r"cls_(\d+)_attn/to_out", r"cls_transformer.layers.\1.0.fn.to_out.0"),
    (r"cls_(\d+)_ff/norm", r"cls_transformer.layers.\1.1.fn.net.0"),
    (r"cls_(\d+)_ff/fc1", r"cls_transformer.layers.\1.1.fn.net.1"),
    (r"cls_(\d+)_ff/fc2", r"cls_transformer.layers.\1.1.fn.net.4"),
    (r"final_norm", "final_norm"),
) + _LN_LINEAR_HEAD
_XCIT_TOP_LEVEL = _TOP_LEVEL + (
    (r"xca_(\d+)_attn/temperature", r"xcit_transformer.layers.\1.0.fn.temperature"),
    (r"xca_(\d+)_attn_scale", r"xcit_transformer.layers.\1.0.scale"),
    (r"xca_(\d+)_lpi_scale", r"xcit_transformer.layers.\1.1.scale"),
    (r"xca_(\d+)_ff_scale", r"xcit_transformer.layers.\1.2.scale"),
    (r"cls_(\d+)_attn_scale", r"cls_transformer.layers.\1.0.scale"),
    (r"cls_(\d+)_ff_scale", r"cls_transformer.layers.\1.1.scale"),
)
# models/rvt.py: a bare Linear patch embedding, SpatialConv's depthwise pair under to_q.conv
_RVT_MODULES = (
    (r"patch_embedding/proj", "to_patch_embedding.1"),
    (r"layers_(\d+)_attn/(norm|to_q|to_kv)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/to_q/depthwise", r"transformer.layers.\1.0.to_q.conv.net.0"),
    (r"layers_(\d+)_attn/to_q/pointwise", r"transformer.layers.\1.0.to_q.conv.net.1"),
    (r"layers_(\d+)_attn/to_q/cls_proj", r"transformer.layers.\1.0.to_q.cls_proj"),
    (r"layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
) + _FF_LAYERS + _LN_LINEAR_HEAD
# models/nest.py: level l's transformer at layers.l.0, its aggregation at layers.l.1
_NEST_MODULES = (
    (r"patch_norm_pre", "to_patch_embedding.1"),
    (r"patch_proj", "to_patch_embedding.2"),
    (r"patch_norm_post", "to_patch_embedding.3"),
    (r"level_(\d+)_transformer/layers_(\d+)_attn/(norm|to_qkv)", r"layers.\1.0.layers.\2.0.\3"),
    (r"level_(\d+)_transformer/layers_(\d+)_attn/to_out", r"layers.\1.0.layers.\2.0.to_out.0"),
    (r"level_(\d+)_transformer/layers_(\d+)_ff/norm", r"layers.\1.0.layers.\2.1.net.0"),
    (r"level_(\d+)_transformer/layers_(\d+)_ff/conv1", r"layers.\1.0.layers.\2.1.net.1"),
    (r"level_(\d+)_transformer/layers_(\d+)_ff/conv2", r"layers.\1.0.layers.\2.1.net.4"),
    (r"level_(\d+)_aggregate_conv", r"layers.\1.1.0"),
    (r"level_(\d+)_aggregate_norm", r"layers.\1.1.1"),
    (r"head_norm", "mlp_head.0"),
    (r"mlp_head", "mlp_head.2"),
)
_NEST_TOP_LEVEL = ((r"level_(\d+)_transformer/pos_emb", r"layers.\1.0.pos_emb"),)
# models/mobile_vit.py: ConvBN's conv and bn at .0 and .1
_CONV_BN = ((r"(\w+)/conv", r"\1.0"), (r"(\w+)/bn", r"\1.1"))


def _mv2_modules(expansion: bool):
    """An inverted-residual block's ``conv`` indices, with and without the
    expansion."""
    names = ("pw", "pw_bn", "dw", "dw_bn", "pw_linear", "pw_linear_bn")
    return tuple(zip(names, (0, 1, 3, 4, 6, 7) if expansion else (None, None, 0, 1, 3, 4)))


def _mobile_vit_modules(expansion: bool):
    mv2 = tuple((rf"{src}/{name}", rf"{dst}.conv.{i}") for src, dst in ((r"stem_(\d+)", r"stem.\1"),
                                                                     (r"trunk_(\d+)_mv2", r"trunk.\1.0"))
                for name, i in _mv2_modules(expansion) if i is not None)
    return mv2 + (
        (r"conv1/conv", "conv1.0"),
        (r"conv1/bn", "conv1.1"),
        (r"trunk_(\d+)_mvit/(conv\d)/conv", r"trunk.\1.1.\2.0"),
        (r"trunk_(\d+)_mvit/(conv\d)/bn", r"trunk.\1.1.\2.1"),
        (r"trunk_(\d+)_mvit/transformer/layers_(\d+)_attn/(norm|to_qkv)", r"trunk.\1.1.transformer.layers.\2.0.\3"),
        (r"trunk_(\d+)_mvit/transformer/layers_(\d+)_attn/to_out", r"trunk.\1.1.transformer.layers.\2.0.to_out.0"),
        (r"trunk_(\d+)_mvit/transformer/layers_(\d+)_ff/norm", r"trunk.\1.1.transformer.layers.\2.1.net.0"),
        (r"trunk_(\d+)_mvit/transformer/layers_(\d+)_ff/fc1", r"trunk.\1.1.transformer.layers.\2.1.net.1"),
        (r"trunk_(\d+)_mvit/transformer/layers_(\d+)_ff/fc2", r"trunk.\1.1.transformer.layers.\2.1.net.4"),
        (r"to_logits_conv/conv", "to_logits.0.0"),
        (r"to_logits_conv/bn", "to_logits.0.1"),
        (r"to_logits", "to_logits.2"),
    )


# models/cvt.py: stage s (1-based in the JAX names) at layers.{s - 1}
_CVT_MODULES = tuple(
    (p.replace("S", f"s{s + 1}"), v.replace("S", str(s))) for s in range(3) for p, v in (
        (r"S_emb_conv", "layers.S.0"),
        (r"S_emb_norm/ln", "layers.S.1"),
        (r"S_layers_(\d+)_attn/norm/ln", r"layers.S.2.layers.\1.0.norm"),
        (r"S_layers_(\d+)_attn/(to_q|to_kv)/depthwise", r"layers.S.2.layers.\1.0.\2.net.0"),
        (r"S_layers_(\d+)_attn/(to_q|to_kv)/bn", r"layers.S.2.layers.\1.0.\2.net.1"),
        (r"S_layers_(\d+)_attn/(to_q|to_kv)/pointwise", r"layers.S.2.layers.\1.0.\2.net.2"),
        (r"S_layers_(\d+)_attn/to_out", r"layers.S.2.layers.\1.0.to_out.0"),
        (r"S_layers_(\d+)_ff/norm/ln", r"layers.S.2.layers.\1.1.net.0"),
        (r"S_layers_(\d+)_ff/conv1", r"layers.S.2.layers.\1.1.net.1"),
        (r"S_layers_(\d+)_ff/conv2", r"layers.S.2.layers.\1.1.net.4"),
    )) + ((r"to_logits", "to_logits.2"),)
# models/twins_svt.py: stage s at layers.{s - 1}: embedding 0, transformers 1 and 3, the position generator 2
_TWINS_LAYER = (
    (r"local_attn/(norm|to_q|to_kv)", r"0.fn.\2"), (r"local_attn/to_out", "0.fn.to_out.0"),
    (r"ff1/norm", "1.fn.net.0"), (r"ff1/conv1", "1.fn.net.1"), (r"ff1/conv2", "1.fn.net.4"),
    (r"global_attn/(norm|to_q|to_kv)", r"2.fn.\2"), (r"global_attn/to_out", "2.fn.to_out.0"),
    (r"ff2/norm", "3.fn.net.0"), (r"ff2/conv1", "3.fn.net.1"), (r"ff2/conv2", "3.fn.net.4"),
)
_TWINS_MODULES = tuple(
    (p.replace("S", f"s{s + 1}"), v.replace("S", str(s))) for s in range(4) for p, v in (
        (r"S_embed/norm_pre", "layers.S.0.proj.0"),
        (r"S_embed/proj", "layers.S.0.proj.1"),
        (r"S_embed/norm_post", "layers.S.0.proj.2"),
        (r"S_peg/proj", "layers.S.2.proj.fn"),
        *((rf"S_transformer{t}/layers_(\d+)_{p_}", rf"layers.S.{i}.layers.\1.{v_}")
          for t, i in (("_pre", 1), ("", 3)) for p_, v_ in _TWINS_LAYER),
    )) + ((r"head", "layers.6"),)


def _flatten(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def _torch_key(path: str, modules, top_level) -> str:
    """``top_level``: the names (or ``(pattern, template)`` pairs) of
    parameters outside any module."""
    for name in top_level:
        pattern, template = (name, name) if isinstance(name, str) else name
        m = re.fullmatch(pattern, path)
        if m:
            return m.expand(template)
    module, _, leaf = path.rpartition("/")
    if leaf in _LEAVES:
        for pattern, template in modules:
            m = re.fullmatch(pattern, module)
            if m:
                return f"{m.expand(template)}.{_LEAVES[leaf]}"
    raise ValueError(f"no torch key for JAX param {path!r}")


def _state_dict(params: Mapping, modules, top_level, chan_norms=None) -> dict[str, torch.Tensor]:
    """``chan_norms``: a pattern of the JAX module paths of LayerNorms that
    the port holds as ``models/cvt.py::ChanLayerNorm``s, whose ``scale`` and
    ``bias`` (d,) become ``g`` and ``b`` (1, d, 1, 1)."""
    out = {}
    for path, value in _flatten(params):
        array = np.array(value)  # a writable copy torch may own
        if path.endswith("/kernel"):  # Dense (in, out), Conv (kh, kw, in, out) or (kd, kh, kw, in, out)
            axes = (array.ndim - 1, array.ndim - 2, *range(array.ndim - 2))
            array = np.ascontiguousarray(array.transpose(axes))
        key = _torch_key(path, modules, top_level)
        module, _, leaf = path.rpartition("/")
        if chan_norms is not None and leaf in ("scale", "bias") and re.fullmatch(chan_norms, module):
            key = key.rpartition(".")[0] + (".g" if leaf == "scale" else ".b")
            array = array.reshape(1, -1, 1, 1)
        out[key] = torch.from_numpy(array)
    return out


def vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ViT``'s ``params`` tree -> the port ``ViT``'s ``state_dict``."""
    return _state_dict(params, _VIT_MODULES, _TOP_LEVEL)


def vit_1d_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_1d.py::ViT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_vit_1d``)."""
    return _state_dict(params, _VIT_1D_MODULES, _TOP_LEVEL)


# the 3-D model's params are the 1-D model's (convert_vit_3d is convert_vit_1d)
vit_3d_state_dict_from_jax = vit_1d_state_dict_from_jax


def vit_nd_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_nd.py::ViTND``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_vit_nd``)."""
    return _state_dict(params, _VIT_ND_MODULES, _TOP_LEVEL)


def vit_nd_rotary_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_nd_rotary.py::ViTND``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_vit_nd_rotary``)."""
    return _state_dict(params, _VIT_ND_FLAT_MODULES, ())


def vit_nd_pope_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_nd_pope.py::ViTND``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_vit_nd_pope``)."""
    return _state_dict(params, _VIT_ND_FLAT_MODULES, (("learned_bias", "polar_emb.learned_bias"),))


def deepvit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/deepvit.py::DeepViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_deepvit``)."""
    return _state_dict(params, _DEEPVIT_MODULES, _DEEPVIT_TOP_LEVEL)


def cait_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/cait.py::CaiT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_cait``)."""
    return _state_dict(params, _CAIT_MODULES, _CAIT_TOP_LEVEL)


def parallel_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/parallel_vit.py::ViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_parallel_vit``)."""
    return _state_dict(params, _PARALLEL_VIT_MODULES, _TOP_LEVEL)


def t2t_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/t2t.py::T2TViT``'s ``params`` tree (the built-in
    transformer) -> the port's ``state_dict`` (the inverse of
    ``convert_t2t``): stem transformer g at ``to_patch_embedding.{4g + 3}``,
    the projection after the last of the stages' four modules."""
    stems = sorted(int(k.rsplit("_", 1)[1]) for k in params if k.startswith("t2t_transformer_"))
    modules = tuple(
        (p.replace("transformer", f"t2t_transformer_{g}", 1), v.replace("transformer", f"to_patch_embedding.{4 * g + 3}", 1))
        for g in stems for p, v in _VIT_MODULES[3:10]
    )
    modules += ((r"t2t_proj", f"to_patch_embedding.{4 * (len(stems) + 1)}"),) + _VIT_MODULES[3:]
    return _state_dict(params, modules, _TOP_LEVEL)


def cct_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/cct.py::CCT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_cct``; NHWC conv kernels
    (kh, kw, in, out) become NCHW weights (out, in, kh, kw))."""
    return _state_dict(params, _CCT_MODULES, _CCT_TOP_LEVEL)


# the 3-D model's names are the 2-D one's; its conv kernels (kd, kh, kw, in,
# out) become (out, in, kd, kh, kw)
cct_3d_state_dict_from_jax = cct_state_dict_from_jax

# the port Transformer's map as the efficient shell's transformer
TRANSFORMER_MODULES = _VIT_MODULES[3:10]


def efficient_vit_state_dict_from_jax(params: Mapping, transformer_modules=TRANSFORMER_MODULES,
                                      transformer_top_level=()) -> dict[str, torch.Tensor]:
    """The JAX ``models/efficient.py::ViT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_efficient_vit``), the caller's
    transformer through ``transformer_modules`` / ``transformer_top_level``
    (JAX paths under ``transformer/``; by default the shared
    ``Transformer``'s)."""
    return _state_dict(params, _EFFICIENT_MODULES + tuple(transformer_modules),
                       _TOP_LEVEL + tuple(transformer_top_level))


# ssl/distill.py: the distillable models keep their plain model's params
distillable_vit_state_dict_from_jax = vit_state_dict_from_jax
distillable_t2t_state_dict_from_jax = t2t_state_dict_from_jax
distillable_efficient_vit_state_dict_from_jax = efficient_vit_state_dict_from_jax


def distill_wrapper_state_dict_from_jax(params: Mapping, student_from_jax=vit_state_dict_from_jax):
    """The JAX ``ssl/distill.py::DistillWrapper``'s ``params`` tree -> the
    port's ``state_dict`` without the teacher (whose params the JAX wrapper
    does not hold: load with ``strict=False``, the teacher through its own
    map): ``distillation_token``, ``distill_mlp.0|1`` and the student's
    tree through ``student_from_jax``."""
    out = {f"student.{k}": v for k, v in student_from_jax(params["student"]).items()}
    rest = {k: v for k, v in params.items() if k != "student"}
    out.update(_state_dict(rest, ((r"distill_norm", "distill_mlp.0"), (r"distill_mlp", "distill_mlp.1")),
                           ("distillation_token",)))
    return out


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


# the variants whose params are SimpleViT's, as utils/convert.py aliases their
# converters (convert_simple_vit_1d, _3d, _with_patch_dropout; the 3-D
# flash-attn variant's rules are SimpleViT's without the final norm)
simple_vit_1d_state_dict_from_jax = simple_vit_state_dict_from_jax
simple_vit_3d_state_dict_from_jax = simple_vit_state_dict_from_jax
simple_vit_patch_dropout_state_dict_from_jax = simple_vit_state_dict_from_jax
simple_flash_attn_vit_3d_state_dict_from_jax = simple_vit_state_dict_from_jax


def simple_vit_qk_norm_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_with_qk_norm.py::SimpleViT``'s ``params``
    tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_VIT_QK_NORM_MODULES, ())


def simple_vit_register_tokens_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_with_register_tokens.py::SimpleViT``'s
    ``params`` tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_VIT_MODULES, ("register_tokens",))


def simple_flash_attn_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_flash_attn_vit.py::SimpleViT``'s ``params``
    tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_FLASH_MODULES, ())


def simple_vit_fft_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_with_fft.py::SimpleViT``'s ``params``
    tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_FFT_MODULES, ())


def simple_vit_orthog_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_orthog_residual_update.py::SimpleViT``'s
    ``params`` tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_ORTHOG_MODULES, ())


def simple_vit_hyper_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_with_hyper_connections.py::SimpleViT``'s
    ``params`` tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_HYPER_MODULES, _SIMPLE_HYPER_TOP_LEVEL)


def simple_vit_value_residual_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_with_value_residual.py::SimpleViT``'s
    ``params`` tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_VALUE_RESIDUAL_MODULES, ())


def simple_vit_specialized_cls_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_with_specialized_cls.py::SimpleViT``'s
    ``params`` tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_SPECIALIZED_MODULES, ("cls_token",))


def simple_vit_attn_residual_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_vit_attn_residual.py::SimpleViTAttnResidual``'s
    ``params`` tree -> the port's ``state_dict``."""
    return _state_dict(params, _SIMPLE_ATTN_RESIDUAL_MODULES, _SIMPLE_ATTN_RESIDUAL_TOP_LEVEL)


def vivit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vivit.py::ViViT``'s ``params`` tree (either variant)
    -> the port ``ViViT``'s ``state_dict``."""
    return _state_dict(params, _VIVIT_MODULES, ("pos_embedding", "spatial_cls_token", "temporal_cls_token"))


def mae_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ssl/mae.py::MAE``'s ``params`` tree -> the port ``MAE``'s
    ``state_dict``.  The JAX encoder has no ``mlp_head`` (MAE never calls
    it): load with ``strict=False`` where the port's encoder has one."""
    return _state_dict(params, _MAE_MODULES, (("encoder/(cls_token|pos_embedding)", r"encoder.\1"), "mask_token"))


def _vit_under(jax_scope: str, torch_prefix: str):
    """The port ``ViT``'s modules and top-level parameters with the JAX tree
    under ``jax_scope/`` and the torch keys under ``torch_prefix.``."""
    modules = tuple((f"{jax_scope}/{p}", f"{torch_prefix}.{t}") for p, t in _VIT_MODULES)
    return modules, ((f"{jax_scope}/(cls_token|pos_embedding)", rf"{torch_prefix}.\1"),)


def _net_wrapper(params: Mapping, jax_scope: str, torch_prefix: str, projectors) -> dict[str, torch.Tensor]:
    """A Dino ``NetWrapper`` (or EsViT's): the JAX net at the top-level
    ``net/`` (flax shares it with the wrapper), each projector's ``fc{i}``
    and ``out`` under ``jax_scope/`` at ``{torch_prefix}.{projector}.net.{2i}``
    and ``.net.{2L - 1}``."""
    modules, top = _vit_under("net", f"{torch_prefix}.net")
    for name in projectors:
        fcs = sorted(int(k[2:]) for k in params[jax_scope][name] if k.startswith("fc"))
        modules += tuple((f"{jax_scope}/{name}/fc{i}", f"{torch_prefix}.{name}.net.{2 * i}") for i in fcs)
        modules += ((f"{jax_scope}/{name}/out", f"{torch_prefix}.{name}.net.{2 * len(fcs) + 1}"),)
    return _state_dict(params, modules, top)


def _student_teacher(params: Mapping, teacher_params, projectors) -> dict[str, torch.Tensor]:
    teacher = params if teacher_params is None else teacher_params
    if "params" in teacher:  # the variables dict DinoState holds
        teacher = teacher["params"]
    return {**_net_wrapper(params, "student_encoder", "student_encoder", projectors),
            **_net_wrapper(teacher, "student_encoder", "teacher_encoder", projectors)}


def dino_state_dict_from_jax(params: Mapping, teacher_params: Mapping = None) -> dict[str, torch.Tensor]:
    """The JAX ``ssl/dino.py::Dino``'s ``params`` tree -> the port
    ``Dino``'s ``state_dict``: the student from ``params``, the teacher from
    ``teacher_params`` (``DinoState.teacher_params``, or its ``params``
    tree), else from ``params``, as ``create_state`` copies them.  The
    centres are not in the tree: load with ``strict=False``."""
    return _student_teacher(params, teacher_params, ("projector",))


def esvit_state_dict_from_jax(params: Mapping, teacher_params: Mapping = None) -> dict[str, torch.Tensor]:
    """The JAX ``ssl/es_vit.py::EsViTTrainer``'s ``params`` tree -> the port
    ``EsViTTrainer``'s ``state_dict``, the teacher as in
    :func:`dino_state_dict_from_jax`."""
    return _student_teacher(params, teacher_params, ("view_projector", "region_projector"))


def lejepa_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ssl/lejepa.py::LeJEPA``'s ``params`` tree -> the port
    ``LeJEPA``'s ``state_dict``."""
    return _net_wrapper(params, "encoder", "encoder", ("projector",))


def simmim_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ssl/simmim.py::SimMIM``'s ``params`` tree -> the port
    ``SimMIM``'s ``state_dict``.  The JAX encoder has no ``mlp_head``
    (SimMIM never calls it): load with ``strict=False`` where the port's
    encoder has one."""
    modules, top = _vit_under("encoder", "encoder")
    return _state_dict(params, modules + (("to_pixels", "to_pixels"),), top + ("mask_token",))


def mpp_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ssl/mpp.py::MPP``'s ``params`` tree -> the port ``MPP``'s
    ``state_dict`` (the encoder's head absent, as for SimMIM)."""
    modules, top = _vit_under("transformer", "transformer")
    return _state_dict(params, modules + (("to_bits", "to_bits"),), top + ("mask_token",))


def mp3_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``ssl/mp3.py::MP3``'s ``params`` tree -> the port ``MP3``'s
    ``state_dict``.  The JAX tree has no ``vit/head_norm`` and
    ``vit/linear_head`` (MP3 never calls the ViT's head): load with
    ``strict=False``."""
    return _state_dict(params, _MP3_MODULES, ())


def _with_stats(params: Mapping, batch_stats, modules, top_level) -> dict[str, torch.Tensor]:
    out = _state_dict(params, modules, top_level)
    if batch_stats is not None:
        out.update(_state_dict(batch_stats, modules, ()))
    return out


def max_vit_state_dict_from_jax(params: Mapping, batch_stats: Mapping = None) -> dict[str, torch.Tensor]:
    """The JAX ``models/max_vit.py::MaxViT``'s ``params`` and
    ``batch_stats`` trees -> the port ``MaxViT``'s ``state_dict`` (its
    running averages included)."""
    return _with_stats(params, batch_stats, _MAX_VIT_MODULES, ())


def max_vit_with_registers_state_dict_from_jax(params: Mapping, batch_stats: Mapping = None) -> dict[str, torch.Tensor]:
    """The JAX ``models/max_vit_with_registers.py::MaxViT``'s ``params`` and
    ``batch_stats`` trees -> the port's ``state_dict``."""
    return _with_stats(params, batch_stats, _MAX_VIT_REGISTERS_MODULES,
                       ((r"block_(\d+)_register_tokens", r"register_tokens.\1"),))


def local_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/local_vit.py::LocalViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_local_vit``)."""
    return _state_dict(params, _LOCAL_VIT_MODULES, _TOP_LEVEL)


def small_dataset_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_for_small_dataset.py::ViT``'s ``params`` tree ->
    the port's ``state_dict`` (the inverse of ``convert_small_dataset_vit``)."""
    return _state_dict(params, _SMALL_DATASET_MODULES, _SMALL_DATASET_TOP_LEVEL)


def pit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/pit.py::PiT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_pit``): stage s's transformer
    at ``layers.{2s}``, its pool at ``layers.{2s + 1}``."""
    stages = sorted(int(k.split("_")[1]) for k in params if k.startswith("stage_") and k.endswith("_transformer"))
    modules = ((r"patch_proj", "to_patch_embedding.2"),) + _LN_LINEAR_HEAD
    for s_ in stages:
        modules += tuple((p.replace("transformer", f"stage_{s_}_transformer", 1),
                          v.replace("transformer", f"layers.{2 * s_}", 1)) for p, v in _VIT_MODULES[3:9])
        modules += ((rf"stage_{s_}_pool/downsample/depthwise", f"layers.{2 * s_ + 1}.downsample.net.0"),
                    (rf"stage_{s_}_pool/downsample/pointwise", f"layers.{2 * s_ + 1}.downsample.net.1"),
                    (rf"stage_{s_}_pool/cls_ff", f"layers.{2 * s_ + 1}.cls_ff"))
    return _state_dict(params, modules, _TOP_LEVEL)


def cross_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/cross_vit.py::CrossViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_cross_vit``, the
    branches' fused ``to_qkv`` kept)."""
    return _state_dict(params, _CROSS_VIT_MODULES, _CROSS_VIT_TOP_LEVEL)


def xcit_state_dict_from_jax(params: Mapping, batch_stats: Mapping = None) -> dict[str, torch.Tensor]:
    """The JAX ``models/xcit.py::XCiT``'s ``params`` and ``batch_stats``
    trees -> the port's ``state_dict`` (the inverse of ``convert_xcit``, the
    local patch interactions' running averages included)."""
    return _with_stats(params, batch_stats, _XCIT_MODULES, _XCIT_TOP_LEVEL)


def rvt_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/rvt.py::RvT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_rvt``)."""
    return _state_dict(params, _RVT_MODULES, ("cls_token",))


def nest_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/nest.py::NesT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_nest``; its LayerNorms the
    channel norms' ``g`` and ``b``)."""
    return _state_dict(params, _NEST_MODULES, _NEST_TOP_LEVEL, chan_norms=r".*norm(_pre|_post)?")


def mobile_vit_state_dict_from_jax(params: Mapping, batch_stats: Mapping = None) -> dict[str, torch.Tensor]:
    """The JAX ``models/mobile_vit.py::MobileViT``'s ``params`` and
    ``batch_stats`` trees -> the port's ``state_dict`` (the inverse of
    ``convert_mobile_vit``, which reads blocks with an expansion; without
    one the depthwise pair sits at ``conv.0|1``)."""
    modules = _mobile_vit_modules(expansion="pw" in params["stem_0"])
    return _with_stats(params, batch_stats, modules, ())


def cvt_state_dict_from_jax(params: Mapping, batch_stats: Mapping = None) -> dict[str, torch.Tensor]:
    """The JAX ``models/cvt.py::CvT``'s ``params`` and ``batch_stats`` trees
    -> the port's ``state_dict`` (the inverse of ``convert_cvt``; the
    LayerNorms the channel norms' ``g`` and ``b``, the projections'
    BatchNorms' running averages included)."""
    out = _state_dict(params, _CVT_MODULES, (), chan_norms=r".*/ln")
    if batch_stats is not None:
        out.update(_state_dict(batch_stats, _CVT_MODULES, ()))
    return out


def twins_svt_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/twins_svt.py::TwinsSVT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_twins_svt``; the
    LayerNorms the channel norms' ``g`` and ``b``)."""
    return _state_dict(params, _TWINS_MODULES, (), chan_norms=r".*norm(_pre|_post)?")


# models/sep_vit.py: stage s at layers.s: embedding 0, position generator 1, transformer 2
_SEP_VIT_MODULES = (
    (r"stage_(\d+)_ope", r"layers.\1.0.conv"),
    (r"stage_(\d+)_peg", r"layers.\1.1.proj"),
    (r"stage_(\d+)_layers_(\d+)_attn/(norm|to_qkv)", r"layers.\1.2.layers.\2.0.\3"),
    (r"stage_(\d+)_layers_(\d+)_attn/window_norm", r"layers.\1.2.layers.\2.0.window_tokens_to_qk.0"),
    (r"stage_(\d+)_layers_(\d+)_attn/window_to_qk", r"layers.\1.2.layers.\2.0.window_tokens_to_qk.3"),
    (r"stage_(\d+)_layers_(\d+)_attn/to_out", r"layers.\1.2.layers.\2.0.to_out.0"),
    (r"stage_(\d+)_layers_(\d+)_ff/norm", r"layers.\1.2.layers.\2.1.net.0"),
    (r"stage_(\d+)_layers_(\d+)_ff/conv1", r"layers.\1.2.layers.\2.1.net.1"),
    (r"stage_(\d+)_layers_(\d+)_ff/conv2", r"layers.\1.2.layers.\2.1.net.4"),
    (r"stage_(\d+)_norm", r"layers.\1.2.norm"),
    (r"head_norm", "mlp_head.1"),
    (r"mlp_head", "mlp_head.2"),
)
_SEP_VIT_TOP_LEVEL = ((r"stage_(\d+)_layers_(\d+)_attn/window_tokens", r"layers.\1.2.layers.\2.0.window_tokens"),)


def _conv1d(state: dict, pattern: str) -> dict:
    """The Linear weights (out, in) of the keys matching ``pattern`` as 1x1
    ``nn.Conv1d`` weights (out, in, 1)."""
    return {k: v[..., None] if re.fullmatch(pattern, k) else v for k, v in state.items()}


def sep_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/sep_vit.py::SepViT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_sep_vit``; the channel norms'
    ``g`` and ``b``, the qkv and window q, k projections 1x1 Conv1d
    weights)."""
    out = _state_dict(params, _SEP_VIT_MODULES, _SEP_VIT_TOP_LEVEL,
                      chan_norms=r"stage_\d+_(layers_\d+_(attn|ff)/norm|norm)")
    return _conv1d(out, r".*\.(to_qkv|window_tokens_to_qk\.3)\.weight")


# models/levit.py: one stage's transformer (``S`` its JAX name, ``T`` its backbone index)
_LEVIT_STAGE = (
    (r"S/layers_(\d+)_attn/to_(q|k|v)", r"backbone.T.layers.\1.0.to_\2.0"),
    (r"S/layers_(\d+)_attn/(q|k|v)_bn", r"backbone.T.layers.\1.0.to_\2.1"),
    (r"S/layers_(\d+)_attn/out_conv", r"backbone.T.layers.\1.0.to_out.1"),
    (r"S/layers_(\d+)_attn/out_bn", r"backbone.T.layers.\1.0.to_out.2"),
    (r"S/layers_(\d+)_ff/conv1", r"backbone.T.layers.\1.1.net.0"),
    (r"S/layers_(\d+)_ff/conv2", r"backbone.T.layers.\1.1.net.3"),
)


def levit_state_dict_from_jax(params: Mapping, batch_stats: Mapping = None) -> dict[str, torch.Tensor]:
    """The JAX ``models/levit.py::LeViT``'s ``params`` and ``batch_stats``
    trees -> the port's ``state_dict`` (the inverse of ``convert_levit``):
    ``stage_s`` at ``backbone.{2s}``, ``stage_s_downsample`` at
    ``backbone.{2s + 1}``; the distillation head, which the converter does not
    map, at ``distill_head``."""
    modules = ((r"conv_embedding_(\d+)", r"conv_embedding.\1"), (r"mlp_head", "mlp_head"),
               (r"distill_head", "distill_head"))
    top = ()
    for name in params:
        m = re.fullmatch(r"stage_(\d+)(_downsample)?", name)
        if m:
            i = str(2 * int(m.group(1)) + bool(m.group(2)))
            modules += tuple((p.replace("S", name, 1), t.replace("T", i, 1)) for p, t in _LEVIT_STAGE)
            top += ((rf"{name}/layers_(\d+)_attn/pos_bias", rf"backbone.{i}.layers.\1.0.pos_bias.weight"),)
    return _with_stats(params, batch_stats, modules, top)


# models/crossformer.py: stage s's embedding at layers.s.0, its transformer at layers.s.1
_CROSSFORMER_DPB = (("fc0", 0), ("norm0", 1), ("fc1", 3), ("norm1", 4), ("fc2", 6), ("norm2", 7), ("out", 9))
_CROSSFORMER_MODULES = ((r"stage_(\d+)_cel/conv_(\d+)", r"layers.\1.0.convs.\2"),) + tuple(
    m for kind, i in (("short", 0), ("long", 2)) for m in (
        (rf"stage_(\d+)_layers_(\d+)_{kind}_attn/(norm|to_qkv|to_out)", rf"layers.\1.1.layers.\2.{i}.\3"),
        *((rf"stage_(\d+)_layers_(\d+)_{kind}_attn/dpb/{name}", rf"layers.\1.1.layers.\2.{i}.dpb.{j}")
          for name, j in _CROSSFORMER_DPB),
        (rf"stage_(\d+)_layers_(\d+)_{kind}_ff/norm", rf"layers.\1.1.layers.\2.{i + 1}.0"),
        (rf"stage_(\d+)_layers_(\d+)_{kind}_ff/conv1", rf"layers.\1.1.layers.\2.{i + 1}.1"),
        (rf"stage_(\d+)_layers_(\d+)_{kind}_ff/conv2", rf"layers.\1.1.layers.\2.{i + 1}.4"),
    )) + ((r"to_logits", "to_logits.1"),)


def crossformer_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/crossformer.py::CrossFormer``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_crossformer``; the
    attentions' and feed-forwards' LayerNorms the channel norms' ``g`` and
    ``b``)."""
    return _state_dict(params, _CROSSFORMER_MODULES, (), chan_norms=r".*_(attn|ff)/norm")


# models/regionvit.py: stage s's downsampling at layers.s.0, position generator .1, transformer .2
_REGIONVIT_MODULES = (
    (r"local_encoder", "local_encoder"),
    (r"local_conv1", "local_encoder.0"),
    (r"local_norm1", "local_encoder.1"),
    (r"local_conv2", "local_encoder.3"),
    (r"local_norm2", "local_encoder.4"),
    (r"local_conv3", "local_encoder.6"),
    (r"region_encoder", "region_encoder.1"),
    (r"stage_(\d+)_downsample", r"layers.\1.0.conv"),
    (r"stage_(\d+)_peg", r"layers.\1.1.proj"),
    (r"stage_(\d+)_transformer/layers_(\d+)_attn/(norm|to_qkv)", r"layers.\1.2.layers.\2.0.\3"),
    (r"stage_(\d+)_transformer/layers_(\d+)_attn/to_out", r"layers.\1.2.layers.\2.0.to_out.0"),
    (r"stage_(\d+)_transformer/layers_(\d+)_ff/norm", r"layers.\1.2.layers.\2.1.0"),
    (r"stage_(\d+)_transformer/layers_(\d+)_ff/fc1", r"layers.\1.2.layers.\2.1.1"),
    (r"stage_(\d+)_transformer/layers_(\d+)_ff/fc2", r"layers.\1.2.layers.\2.1.4"),
    (r"head_norm", "to_logits.1"),
    (r"to_logits", "to_logits.2"),
)


def regionvit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/regionvit.py::RegionViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_regionvit``, which maps
    neither the position generators nor the three-convolution local
    tokenizer; its LayerNorms the channel norms' ``g`` and ``b``)."""
    top = ((r"stage_(\d+)_transformer/local_rel_pos_bias", r"layers.\1.2.local_rel_pos_bias.weight"),)
    return _state_dict(params, _REGIONVIT_MODULES, top, chan_norms=r"local_norm\d")


# models/scalable_vit.py: stage s's transformer at layers.s.0 (a block [ssa, ff1, peg, ff2, iwsa]),
# its downsampling at layers.s.1
_SCALABLE_BLOCK = r"stage_(\d+)_block_(\d+)"
_SCALABLE_MODULES = (
    (r"to_patches", "to_patches"),
    (rf"{_SCALABLE_BLOCK}_ssa/(norm|to_q|to_k|to_v)", r"layers.\1.0.layers.\2.0.\3"),
    (rf"{_SCALABLE_BLOCK}_ssa/to_out", r"layers.\1.0.layers.\2.0.to_out.0"),
    *((rf"{_SCALABLE_BLOCK}_{ff}/{name}", rf"layers.\1.0.layers.\2.{i}.net.{j}")
      for ff, i in (("ff1", 1), ("ff2", 3)) for name, j in (("norm", 0), ("conv1", 1), ("conv2", 4))),
    (rf"{_SCALABLE_BLOCK}_peg", r"layers.\1.0.layers.\2.2.proj"),
    (rf"{_SCALABLE_BLOCK}_iwsa/(norm|to_q|to_k|to_v|local_interactive_module)", r"layers.\1.0.layers.\2.4.\3"),
    (rf"{_SCALABLE_BLOCK}_iwsa/to_out", r"layers.\1.0.layers.\2.4.to_out.0"),
    (r"stage_(\d+)_norm", r"layers.\1.0.norm"),
    (r"stage_(\d+)_downsample", r"layers.\1.1.conv"),
    (r"head_norm", "mlp_head.1"),
    (r"mlp_head", "mlp_head.2"),
)


def scalable_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/scalable_vit.py::ScalableViT``'s ``params`` tree ->
    the port's ``state_dict`` (the inverse of ``convert_scalable_vit``; the
    channel norms' ``g`` and ``b``)."""
    return _state_dict(params, _SCALABLE_MODULES, (),
                       chan_norms=rf"({_SCALABLE_BLOCK}_(ssa|ff1|ff2|iwsa)/norm|stage_\d+_norm)")


# models/vit_with_patch_merger.py: the JAX model's flat layers under transformer
_PATCH_MERGER_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn/(norm|to_qkv)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
) + _FF_LAYERS + (
    (r"patch_merger/norm", "transformer.patch_merger.norm"),
    (r"norm", "transformer.norm"),
    (r"mlp_head", "mlp_head.1"),
)


def vit_with_patch_merger_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_with_patch_merger.py::ViT``'s ``params`` tree ->
    the port's ``state_dict`` (the inverse of
    ``convert_vit_with_patch_merger``)."""
    top = ("pos_embedding", (r"patch_merger/queries", "transformer.patch_merger.queries"))
    return _state_dict(params, _PATCH_MERGER_MODULES, top)


# models/learnable_memory_vit.py: the split q and kv projections
_MEMORY_VIT_MODULES = _PATCH_EMBEDDING + (
    (r"transformer/layers_(\d+)_attn/(norm|to_q|to_kv)", r"transformer.layers.\1.0.\2"),
    (r"transformer/layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
    (r"transformer/layers_(\d+)_ff/norm", r"transformer.layers.\1.1.net.0"),
    (r"transformer/layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.1"),
    (r"transformer/layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.4"),
    (r"head_norm", "mlp_head.0"),
    (r"mlp_head", "mlp_head.1"),
)


def learnable_memory_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/learnable_memory_vit.py::ViT``'s ``params`` tree ->
    the port's ``state_dict`` (the inverse of
    ``convert_learnable_memory_vit``)."""
    return _state_dict(params, _MEMORY_VIT_MODULES, _TOP_LEVEL)


def adapter_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/learnable_memory_vit.py::Adapter``'s ``params`` tree
    -> the port's ``state_dict`` (the inverse of ``convert_adapter``): the
    wrapped ViT's under ``vit.``, whose head the JAX tree does not hold (the
    Adapter never calls it): load with ``strict=False``."""
    out = {f"vit.{k}": v for k, v in learnable_memory_vit_state_dict_from_jax(params["vit"]).items()}
    rest = {k: v for k, v in params.items() if k != "vit"}
    out.update(_state_dict(rest, _MEMORY_VIT_MODULES[-2:], ("memory_cls_token", "memories_per_layer")))
    return out


# models/ats_vit.py: the JAX model's flat layers under transformer
_ATS_VIT_MODULES = _PATCH_EMBEDDING + (
    (r"layers_(\d+)_attn/(norm|to_qkv)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
) + _FF_LAYERS + _MEMORY_VIT_MODULES[-2:]


def ats_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/ats_vit.py::ViT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_ats_vit``)."""
    return _state_dict(params, _ATS_VIT_MODULES, _TOP_LEVEL)


# models/look_vit.py: layer N's [attn, mlp, lookup_cross_attn, highres_attn, highres_norm, highres_mlp]
_LOOK_VIT_MODULES = (
    (r"patch_conv", "to_patches.1"),
    (r"patch_norm", "to_patches.3"),
    *(m for name, i in (("attn", 0), ("lookup_cross_attn", 2), ("highres_attn", 3)) for m in (
        (rf"layers_(\d+)_{name}/(norm|norm_context|to_q|to_k|to_v)", rf"layers.\1.{i}.\2"),
        (rf"layers_(\d+)_{name}/to_out", rf"layers.\1.{i}.to_out.1"))),
    *((rf"layers_(\d+)_{name}/{sub}", rf"layers.\1.{i}.{j}") for name, i in (("mlp", 1), ("highres_mlp", 5))
      for sub, j in (("norm", 0), ("fc1", 1), ("fc2", 4))),
    (r"layers_(\d+)_highres_norm", r"layers.\1.4"),
    (r"(norm|highres_norm|to_logits)", r"\1"),
)


def look_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/look_vit.py::LookViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_look_vit``)."""
    return _state_dict(params, _LOOK_VIT_MODULES, ())


# ssl/vat.py, ssl/vaat.py, ssl/vat_siglip.py: the port keeps the JAX module
# tree, so a JAX path becomes a torch key by these renames and "/" -> "."
_VAT_FAMILY_RENAMES = (
    (r"\blayers_(\d+)_attn\b", r"layers/\1/0"),
    (r"\blayers_(\d+)_ff\b", r"layers/\1/1"),
    (r"\b(films|self_attns|cross_attns|crosses|img_crosses|audio_crosses|ffs)_(\d+)\b", r"\1/\2"),
    (r"\bpatch_embedding/norm_pre\b", "patch_embedding/1"),
    (r"\bpatch_embedding/proj\b", "patch_embedding/2"),
    (r"\bpatch_embedding/norm_post\b", "patch_embedding/3"),
    (r"/(kernel|scale|embedding)$", "/weight"),
)


def vat_family_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The ``params`` tree of a JAX ``ssl/vat.py`` ``ViT`` or ``VAT``, an
    ``ssl/vaat.py`` ``AST`` or ``VAAT``, or an ``ssl/vat_siglip.py``
    ``SigLIP`` or ``SigLIPVAT`` -> the port module's ``state_dict``.  The
    JAX ``ViT`` inside a VAT has no ``mlp_head`` (VAT never calls it): load
    with ``strict=False`` where the port's has one."""
    out = {}
    for path, value in _flatten(params):
        array = np.array(value)
        if path.endswith("/kernel"):
            array = np.ascontiguousarray(array.T)
        for pattern, template in _VAT_FAMILY_RENAMES:
            path = re.sub(pattern, template, path)
        out[path.replace("/", ".")] = torch.from_numpy(array)
    return out



# models/vivit_with_moss.py::MOSS, under "moss" in ViViT and in AcceptVideoWrapper;
# its channel LayerNorms' gains become (1, c, 1, 1) gammas (_moss_gammas)
_MOSS_MODULES = (
    (r"moss/encoders_(\d+)/(spatial_to_hidden|time_to_out)", r"moss.encoders.\1.\2"),
    *((rf"moss/encoders_(\d+)/{jax}", rf"moss.encoders.\1.conv.{i}")
      for jax, i in (("conv0", 0), ("conv_norm0", 1), ("conv1", 3), ("conv_norm1", 4))),
    (r"moss/to_order_out_(\d+)", r"moss.to_order_out.\1"),
    (r"moss/to_out", "moss.to_out"),
)


def _moss_gammas(state: dict) -> dict:
    return {re.sub(r"(conv\.[14])\.weight$", r"\1.gamma", k): v.reshape(1, -1, 1, 1) if re.search(
        r"conv\.[14]\.weight$", k) else v for k, v in state.items()}


def moss_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vivit_with_moss.py::MOSS``'s own ``params`` tree ->
    the port ``MOSS``'s ``state_dict``."""
    return {k.removeprefix("moss."): v for k, v in _moss_gammas(_state_dict({"moss": params}, _MOSS_MODULES,
                                                                            ())).items()}


def accept_video_wrapper_state_dict_from_jax(params: Mapping, image_net_from_jax=vit_state_dict_from_jax):
    """The JAX ``wrappers/accept_video_wrapper.py::AcceptVideoWrapper``'s
    ``params`` tree -> the port's ``state_dict``: ``embed_proj``,
    ``pos_emb`` and the MOSS module's ``moss`` subtree, and the wrapped net's
    ``image_net`` subtree through ``image_net_from_jax`` (the map of its
    model)."""
    out = {f"image_net.{k}": v for k, v in image_net_from_jax(params.get("image_net", {})).items()}
    out.update(_moss_gammas(_state_dict({k: v for k, v in params.items() if k != "image_net"},
                                        (("embed_proj", "embed_proj"), *_MOSS_MODULES), ("pos_emb",))))
    return out


def vit_with_patch_dropout_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_with_patch_dropout.py::ViT``'s ``params`` tree ->
    the port's ``state_dict`` (the inverse of
    ``convert_vit_with_patch_dropout``): the bare patch Linear at
    ``to_patch_embedding.1``, no transformer norm, the LN -> Linear head."""
    modules = ((r"patch_embedding/proj", "to_patch_embedding.1"), *_VIT_MODULES[3:9], *_LN_LINEAR_HEAD)
    return _state_dict(params, modules, _TOP_LEVEL)


def vit_with_keel_post_ln_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_with_keel_post_ln.py::ViT``'s ``params`` tree ->
    the port's ``state_dict`` (the inverse of
    ``convert_vit_with_keel_post_ln``): layer i's attention at
    ``transformer.layers.{2i}``, its FF at ``{2i + 1}``."""
    depth = sum(1 for k in params if re.fullmatch(r"layers_\d+_attn", k))
    modules = _PATCH_EMBEDDING + tuple(
        m for i in range(depth) for m in (
            (rf"layers_{i}_attn/(norm|to_qkv)", rf"transformer.layers.{2 * i}.\1"),
            (rf"layers_{i}_attn/to_out", f"transformer.layers.{2 * i}.to_out.0"),
            (rf"layers_{i}_ff/norm", f"transformer.layers.{2 * i + 1}.net.0"),
            (rf"layers_{i}_ff/fc1", f"transformer.layers.{2 * i + 1}.net.1"),
            (rf"layers_{i}_ff/fc2", f"transformer.layers.{2 * i + 1}.net.4"),
        )
    ) + ((r"post_norms_(\d+)", r"transformer.post_norms.\1"), (r"mlp_head", "mlp_head"))
    return _state_dict(params, modules, _TOP_LEVEL)


def simple_uvit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/simple_uvit.py::SimpleUViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_simple_uvit``)."""
    modules = _PATCH_EMBEDDING + (
        (r"layers_(\d+)_combine_skip", r"transformer.layers.\1.0"),
        (r"layers_(\d+)_attn/(norm|to_qkv|to_out)", r"transformer.layers.\1.1.\2"),
        (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.2.0"),
        (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.2.1"),
        (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.2.3"),
        (r"norm", "transformer.norm"),
        (r"linear_head", "linear_head"),
    )
    return _state_dict(params, modules, ("register_tokens",))


def jumbo_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/jumbo_vit.py::JumboViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_jumbo_vit``)."""
    modules = _PATCH_EMBEDDING + (
        (r"layers_(\d+)_attn/(norm|to_qkv|to_out)", r"layers.\1.0.\2"),
        (r"layers_(\d+)_ff/norm", r"layers.\1.1.0"),
        (r"layers_(\d+)_ff/fc1", r"layers.\1.1.1"),
        (r"layers_(\d+)_ff/fc2", r"layers.\1.1.3"),
        (r"jumbo_ff/norm", "jumbo_ff.1.0"),
        (r"jumbo_ff/fc1", "jumbo_ff.1.1"),
        (r"jumbo_ff/fc2", "jumbo_ff.1.3"),
        (r"(norm|linear_head)", r"\1"),
    )
    return _state_dict(params, modules, ("jumbo_cls_token",))


# the ViT's layers flat at the top of the JAX tree, under transformer in the port
_FLAT_VIT_LAYERS = (
    (r"layers_(\d+)_attn/(norm|to_qkv)", r"transformer.layers.\1.0.\2"),
    (r"layers_(\d+)_attn/to_out", r"transformer.layers.\1.0.to_out.0"),
) + _FF_LAYERS + ((r"norm", "transformer.norm"), (r"mlp_head", "mlp_head"))


def vit_detpool_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_detpool.py::ViTDetPool``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_vit_detpool``)."""
    return _state_dict(params, _PATCH_EMBEDDING + _FLAT_VIT_LAYERS, _TOP_LEVEL)


def vit_with_decorr_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vit_with_decorr.py::ViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_vit_with_decorr``): the
    FF's LayerNorm beside its ``net``, fc2 at ``net.3``.  The subspace
    projections (the JAX ``buffers`` collection) are no parameters: copy
    them into ``decorr_loss.proj``."""
    modules = _PATCH_EMBEDDING + (
        (r"layers_(\d+)_ff/norm", r"transformer.layers.\1.1.norm"),
        (r"layers_(\d+)_ff/fc1", r"transformer.layers.\1.1.net.0"),
        (r"layers_(\d+)_ff/fc2", r"transformer.layers.\1.1.net.3"),
    ) + _FLAT_VIT_LAYERS
    return _state_dict(params, modules, _TOP_LEVEL)


def normalized_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/normalized_vit.py::nViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_normalized_vit``): each
    NormLinear kernel (in, out) the raw (out, in) weight at
    ``<module>.linear.parametrizations.weight.original``, the position
    embedding's (dim, num_patches) too."""
    weight = ".linear.parametrizations.weight.original"
    modules = (
        (r"patch_embedding", "to_patch_embedding.1"),
        (r"layers_(\d+)_attn/(to_q|to_k|to_v|to_out)", r"layers.\1.0.\2"),
        (r"layers_(\d+)_ff/(to_hidden|to_gate|to_out)", r"layers.\1.1.\2"),
        (r"to_pred", "to_pred"),
    )
    top = (
        "logit_scale",
        (r"residual_lerp_scales_(\d+)_attn", r"residual_lerp_scales.\1.0"),
        (r"residual_lerp_scales_(\d+)_ff", r"residual_lerp_scales.\1.1"),
        (r"layers_(\d+)_attn/(q_scale|k_scale)", r"layers.\1.0.\2"),
        (r"layers_(\d+)_ff/(hidden_scale|gate_scale)", r"layers.\1.1.\2"),
    )
    rest = {k: v for k, v in params.items() if k != "abs_pos_emb"}
    out = {re.sub(r"\.weight$", weight, k) if k.endswith(".weight") else k: v
           for k, v in _state_dict(rest, modules, top).items()}
    out[f"abs_pos_emb{weight}"] = torch.from_numpy(np.ascontiguousarray(np.array(params["abs_pos_emb"]).T))
    return out


_JET_KINDS = (("fa", "FA"), ("wa", "WA"), ("la", "LA"))


def jet_vit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/jet_vit.py::JetViT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_jet_vit`` with the same
    ``attn_layers``): each built kind under
    ``transformer.layers.N.0.options.FA|WA|LA``."""
    modules = _PATCH_EMBEDDING + tuple(
        m for jax, kind in _JET_KINDS for m in (
            (rf"layers_(\d+)_{jax}/(norm|to_qkv)", rf"transformer.layers.\1.0.options.{kind}.\2"),
            (rf"layers_(\d+)_{jax}/to_out", rf"transformer.layers.\1.0.options.{kind}.to_out.0"),
            (rf"layers_(\d+)_{jax}", rf"transformer.layers.\1.0.options.{kind}"),  # WA's rel_pos_bias
            (rf"layers_(\d+)_{jax}/dynamic_conv/mlp_fc1", rf"transformer.layers.\1.0.options.{kind}.dynamic_conv.mlp.0"),
            (rf"layers_(\d+)_{jax}/dynamic_conv/mlp_fc2", rf"transformer.layers.\1.0.options.{kind}.dynamic_conv.mlp.2"),
        )
    ) + _FF_LAYERS + ((r"norm", "transformer.norm"), (r"mlp_head", "mlp_head"))
    return _state_dict(params, modules, ("pos_embedding",))


def wwt_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/wwt.py::WWT``'s ``params`` tree -> the port's
    ``state_dict`` (the inverse of ``convert_wwt``; ``mask_project`` and the
    token head, which it does not map, in the port's names)."""
    modules = _PATCH_EMBEDDING + (
        (r"layers_(\d+)_norm_(\d+)", r"layers.\1.norms.\2"),
        (r"layers_(\d+)_attn_(\d+)/(to_q_v_tokens|to_k_v_slots|mask_project)", r"layers.\1.attns.\2.\3"),
        (r"layers_(\d+)_attn_(\d+)/(to_out_tokens|to_out_slots)", r"layers.\1.attns.\2.\3.0"),
        *((rf"layers_(\d+)_attn_(\d+)/mlp_mask/{jax}", rf"layers.\1.attns.\2.mlp_mask.{i}")
          for jax, i in (("norm", 0), ("fc1", 1), ("fc2", 4))),
        *((rf"layers_(\d+)_mlp_(\d+)/{jax}", rf"layers.\1.mlps.\2.{i}") for jax, i in (("norm", 0), ("fc1", 1),
                                                                                        ("fc2", 4))),
        (r"head_norm", "mlp_head.0"),
        (r"mlp_head", "mlp_head.1"),
        (r"token_head_norm", "mlp_head_tokens.0"),
        (r"mlp_head_tokens", "mlp_head_tokens.1"),
    )
    top = ("pos_embedding", "register_tokens", (r"slots_(\d+)", r"slots.\1"),
           (r"register_slots_(\d+)", r"register_slots.\1"))
    return _state_dict(params, modules, top)


def vivit_moss_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``models/vivit_with_moss.py::ViViT``'s ``params`` tree -> the
    port's ``state_dict`` (the inverse of ``convert_vivit_moss``)."""
    modules = _LN_LINEAR_HEAD + _VIVIT_MODULES + _MOSS_MODULES
    top = ("pos_embedding", "spatial_cls_token", "temporal_cls_token")
    return _moss_gammas(_state_dict(params, modules, top))


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
