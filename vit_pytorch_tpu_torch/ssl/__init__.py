"""Self-supervised and action-prediction trainers, port of
``vit_pytorch_tpu/ssl/``: ``mae.MAE``, ``dino.Dino`` with the augmentations
of ``augment``, ``es_vit.EsViTTrainer``, ``lejepa.LeJEPA``,
``simmim.SimMIM``, ``mpp.MPP`` and ``mp3.MP3``; the vision-action
transformers ``vat.VAT``, ``vaat.VAAT`` (with ``vaat.AST`` on
``ops/spectrogram.py``) and ``vat_siglip.SigLIPVAT`` (with
``vat_siglip.load_siglip``); the DeiT-style distillation of ``distill``
(``DistillWrapper``, ``distill_forward`` and the distillable ViT, T2T-ViT
and efficient ViT), re-exported here."""

from vit_pytorch_tpu_torch.ssl.distill import (
    DistillableEfficientViT,
    DistillableT2TViT,
    DistillableViT,
    DistillWrapper,
    distill_forward,
)

__all__ = ["DistillWrapper", "DistillableViT", "DistillableT2TViT", "DistillableEfficientViT", "distill_forward"]
