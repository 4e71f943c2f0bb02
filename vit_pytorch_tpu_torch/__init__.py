"""vit-pytorch-tpu-torch — the PyTorch / CUDA port of ``vit_pytorch_tpu``,
for NVIDIA Hopper (H100).

The JAX package beside it stays the reference.  The port keeps its layout
(``nn/``, ``ops/``, ``models/``, ``utils/``, ``serving.py``) and its names;
``ops/`` holds the hand-written CUDA kernels (sources in ``csrc/``, built at
first use into ``build/``).  No JAX import anywhere in the package.

Ported so far: the ViT serving path (``models.vit.ViT``,
``serving.Predictor``) and its training step (``parallel.train``), with the
whole-layer kernels forward and backward; SimpleViT (``models.simple_vit``,
with qk-norm and register tokens beside it) on the attention-block kernels;
NaViT (``models.na_vit``, the nested-tensor variants in 2-D and 3-D beside
it) on the flash kernels, with the in-tile qk-norm behind the JAX switch
``VIT_TPU_FUSE_QKNORM``; the JAX package's layer prototypes of ``tools/``
as the port's bench tools (``tools/``); ViViT (``models.vivit``, both
variants, with a frame mask), MAE pretraining (``ssl.mae``) on the
whole-layer kernels; MaxViT (``models.max_vit``, with register tokens
beside it), whose 49-token windows take the attention composite; the SSL
trainers Dino (``ssl.dino``, with the augmentations of ``ssl.augment``),
EsViT (``ssl.es_vit``), LeJEPA (``ssl.lejepa``), SimMIM (``ssl.simmim``)
and MPP (``ssl.mpp``) on the whole-layer kernels, and MP3 (``ssl.mp3``),
whose cross-attention takes the composite; the vision-action transformers
VAT (``ssl.vat``), VAAT (``ssl.vaat``, its audio on ``ops.spectrogram``) and
SigLIPVAT (``ssl.vat_siglip``), whose cross-attention takes the flash and
short kernels; the introspection wrappers of ``wrappers`` (Recorder,
Extractor, AcceptVideoWrapper); the simple-ViT family; ViT-1D, -3D and -ND
(``models.vit_1d``, ``vit_3d``, ``vit_nd``, with Golden-Gate rotary and
PoPE beside it), DeepViT, CaiT, ParallelViT, T2T-ViT, CCT (2-D and 3-D) and
the efficient-ViT shell, on the layer, flash and short kernels where their
attention is the shared one, and the DeiT-style distillation
(``ssl.distill``); CrossViT and PiT (their transformers on the layer
kernels), XCiT, LocalViT, the small-dataset ViT, RvT, NesT, MobileViT, CvT
and Twins-SVT (``models.cross_vit``, ``pit``, ``xcit``, ``local_vit``,
``vit_for_small_dataset``, ``rvt``, ``nest``, ``mobile_vit``, ``cvt``,
``twins_svt``); LeViT, RegionViT, CrossFormer, ScalableViT and SepViT
(``models.levit``, ``regionvit``, ``crossformer``, ``scalable_vit``,
``sep_vit``), ATS-ViT, the patch-merger ViT (its layers after the merge on
the attention-block kernels), the learnable-memory ViT with its Adapter and
LookViT (``models.ats_vit``, ``vit_with_patch_merger``,
``learnable_memory_vit``, ``look_vit``); nViT, JumboViT, SimpleUViT,
ViTDetPool, JetViT and WWT (``models.normalized_vit``, ``jumbo_vit``,
``simple_uvit``, ``vit_detpool``, ``jet_vit``, ``wwt``), ViViT with MOSS
(``models.vivit_with_moss``, which the AcceptVideoWrapper's ``moss`` runs),
the decorrelation, KEEL post-LN and patch-dropout ViTs
(``models.vit_with_decorr``, ``vit_with_keel_post_ln``,
``vit_with_patch_dropout``), the attention of JumboViT, SimpleUViT, the
mask-free ViTDetPool and the KEEL ViT on the attention-block kernels, the
patch-dropout ViT's layers on the whole-layer kernels.  Models are imported
by submodule path, as in the JAX package.

The single-card infrastructure of the JAX package's ``utils/`` and
``serving.py`` is ported too: checkpoints with resume
(``utils.checkpoint``), the input pipeline (``utils.data``), the whole
``serving.Predictor`` and the program artifacts of ``serving.export_model``
/ ``load_model``; ``entry.entry()`` is the flagship forward of the JAX
``__graft_entry__.py``.
"""

import importlib

__all__ = ["SimpleViT", "ViT", "MAE", "Dino"]

# the top-level names are imported on first use, so that importing a
# submodule (``vit_pytorch_tpu_torch.ops`` to run an exported program) does
# not import the models
_LAZY = {
    "SimpleViT": "vit_pytorch_tpu_torch.models.simple_vit",
    "ViT": "vit_pytorch_tpu_torch.models.vit",
    "Dino": "vit_pytorch_tpu_torch.ssl.dino",
    "MAE": "vit_pytorch_tpu_torch.ssl.mae",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__version__ = "0.1.0"
