"""Self-supervised pretraining wrappers, port of ``vit_pytorch_tpu/ssl/``
(so far: ``mae.MAE``)."""
