"""Self-supervised pretraining wrappers, port of ``vit_pytorch_tpu/ssl/``:
``mae.MAE``, ``dino.Dino`` with the augmentations of ``augment``,
``es_vit.EsViTTrainer``, ``lejepa.LeJEPA``, ``simmim.SimMIM``, ``mpp.MPP``
and ``mp3.MP3``."""
