"""Self-supervised and action-prediction trainers, port of
``vit_pytorch_tpu/ssl/``: ``mae.MAE``, ``dino.Dino`` with the augmentations
of ``augment``, ``es_vit.EsViTTrainer``, ``lejepa.LeJEPA``,
``simmim.SimMIM``, ``mpp.MPP`` and ``mp3.MP3``; the vision-action
transformers ``vat.VAT``, ``vaat.VAAT`` (with ``vaat.AST`` on
``ops/spectrogram.py``) and ``vat_siglip.SigLIPVAT`` (with
``vat_siglip.load_siglip``).  ``distill`` is not ported yet (ROADMAP:
modules to port, item 8)."""
