"""The reference's one in-repo training recipe (reference
train_vit_decorr.py:1-112), the port of ``examples/train_vit_decorr.py``: a
ViT with the decorrelation auxiliary loss on CIFAR-100-shaped data, Adam
3e-4, batch 32.

The reference hands the model to HuggingFace ``accelerate`` for placement;
the JAX script runs the mesh-sharded train step of its ``parallel`` package.
So does the port: ``parallel/mesh.py::make_mesh`` (one process a device; run
alone it starts a world of one itself, NCCL on the card, gloo with
``--device cpu``, and ends it on return), ``shard_train_state`` and
``make_sharded_train_step``, the batches placed over the mesh's 'data' axis
(``batch_sharding``).  Under ``torchrun`` each process takes its rows of
every batch and the gradients are averaged over 'data'.

No kernel of the port runs here: the decorrelation ViT's layers are the
plain composite (its attention returns each call's normed input for the
loss), in float32 as the JAX script trains.

No dataset download in this environment: it runs on synthetic batches, the
JAX script's default, until CIFAR-100 is in the repository.

    python -m vit_pytorch_tpu_torch.examples.train_vit_decorr [--steps 20] [--checkpoint PATH] [--device cuda]
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.vit_with_decorr import ViT
from ..parallel.mesh import batch_sharding, global_array_from_process_local, make_mesh, mesh_device
from ..parallel.train import create_train_state, make_sharded_train_step, shard_train_state
from ..utils.checkpoint import save_checkpoint
from ..utils.data import process_local_slice
from ._common import derived_seed, ms_since, parse, parser

# the reference model config (reference train_vit_decorr.py:47-60; JAX examples/train_vit_decorr.py:60-71)
CONFIG = dict(image_size=32, patch_size=4, num_classes=100, dim=256, depth=6, heads=8, mlp_dim=512, dropout=0.1,
              emb_dropout=0.1, decorr_sample_frac=0.25)


def synthetic_batches(batch_size, num_batches, image_size=32, num_classes=100, seed=0):
    """The JAX script's synthetic batches (:39-47): float32 normal images and
    integer labels from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        yield (
            rng.standard_normal((batch_size, 3, image_size, image_size)).astype(np.float32),
            rng.integers(0, num_classes, (batch_size,)).astype(np.int32),
        )


def arguments():
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--decorr-weight", type=float, default=0.1)
    ap.add_argument("--checkpoint", type=str, default=None)
    return ap


def main(argv=None):
    """Returns ``{"model", "losses", "accuracies", "ms", "mesh"}`` (the mesh
    shape)."""
    args, cfg, device = parse(arguments(), argv, CONFIG)
    started = not (dist.is_available() and dist.is_initialized())
    mesh = make_mesh(device_type=device.type)
    try:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"mesh: {shape}")
        device = mesh_device(mesh)
        model = ViT(**cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
        state = create_train_state(model, tx=functools.partial(torch.optim.Adam, lr=args.lr))
        state = shard_train_state(state, mesh)
        step_fn = make_sharded_train_step(model, mesh, aux_loss_weight=args.decorr_weight, donate=True)
        spec = batch_sharding(mesh).spec
        place = lambda a: global_array_from_process_local(process_local_slice(a, mesh=mesh), mesh, spec)  # noqa: E731

        losses, accuracies, times = [], [], []
        batches = synthetic_batches(args.batch_size, args.steps, cfg["image_size"], cfg["num_classes"])
        for step, (images, labels) in enumerate(batches):
            # the dropout masks and the sampled tokens of each step from a
            # generator seeded for the step, the same on every rank (the JAX
            # script hands every step the same PRNGKey(1))
            x, y = place(torch.from_numpy(images)), place(torch.from_numpy(labels).long())
            gen = torch.Generator().manual_seed(derived_seed(1, step))
            t0 = time.perf_counter()
            metrics = step_fn(state, x, y, gen)
            losses.append(metrics["loss"].item())
            accuracies.append(metrics["accuracy"].item())
            times.append(ms_since(t0, device))
            print(f"step {step}: loss {losses[-1]:.4f} acc {accuracies[-1]:.3f} ({times[-1]:.0f} ms)")

        if args.checkpoint:
            save_checkpoint(args.checkpoint, {"params": model.state_dict()})
            print(f"saved params to {args.checkpoint}")
        return {"model": model, "losses": losses, "accuracies": accuracies, "ms": times, "mesh": shape}
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
