"""The JAX package's example scripts (``examples/``) on the port, each a
module with ``main(argv=None)`` and its model's widths in a module-level
``CONFIG`` (``--set key=value`` overrides an entry):

    python -m vit_pytorch_tpu_torch.examples.serve_vit            # Predictor, ViT-B/16 buckets
    python -m vit_pytorch_tpu_torch.examples.train_digits         # real data, resumable checkpoints
    python -m vit_pytorch_tpu_torch.examples.train_navit_packed   # packed NaViT on the flash kernels
    python -m vit_pytorch_tpu_torch.examples.pretrain_mae         # MAE, bf16, whole-layer kernels
    python -m vit_pytorch_tpu_torch.examples.pretrain_dino        # Dino with the teacher's EMA
    python -m vit_pytorch_tpu_torch.examples.train_vit_decorr     # the mesh-sharded recipe

Each runs on the CUDA card unless ``--device`` names another.
"""
