"""NaViT packed variable-resolution training, the port of
``examples/train_navit_packed.py``.

Images of several resolutions are packed greedily on the host into
fixed-shape token buffers (``ops/packing.py::pack_images``), and every
attention call masks across images by segment ids.  On the card each of the
6 layers' attention and the attention pooling run the flash kernels of
``ops/flash_attention.py`` (``flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``: 7 of each a step), which skip the tiles that no image
shares.

The JAX script trains in float32, which its Pallas flash kernels take on
the TPU.  The port's Hopper kernels take bf16, so the port trains in bf16
(``build`` and ``make_batch`` in float32 give the JAX arithmetic, on the
materialized composite).  Its ``jit_init`` (an init traced on one pack) has no
counterpart: a torch module is built directly on the card (``device=``).

Synthetic data; swap ``sample_images`` for a real loader.

    python -m vit_pytorch_tpu_torch.examples.train_navit_packed [--steps 20] [--device cuda]
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models.na_vit import NaViT
from ..ops.packing import pack_images
from ._common import ms_since, parse, parser

# the JAX script's model (examples/train_navit_packed.py:45-54)
CONFIG = dict(image_size=256, patch_size=16, num_classes=100, dim=384, depth=6, heads=6, mlp_dim=1536,
              token_dropout_prob=0.1)
MAX_SEQ = 1024  # :29
RESOLUTIONS = [(256, 256), (224, 224), (160, 256), (256, 160), (128, 128), (96, 192)]  # :31
IMAGES_PER_STEP, PACKS, MAX_IMAGES = 32, 8, 8  # :59, :69-70
LR, WEIGHT_DECAY = 3e-4, 1e-4  # optax.adamw(3e-4): its weight decay defaults to 1e-4 (torch's AdamW: 1e-2)


def sample_images(rng: np.random.Generator, n: int, num_classes: int):
    """n random-resolution images and labels (a stand-in for a real
    dataset), the JAX ``sample_images`` (:34-41)."""
    images, labels = [], []
    for _ in range(n):
        h, w = RESOLUTIONS[rng.integers(len(RESOLUTIONS))]
        images.append(rng.normal(size=(3, h, w)).astype(np.float32))
        labels.append(int(rng.integers(num_classes)))
    return images, np.asarray(labels, np.int32)


def slot_labels(packed, labels: np.ndarray) -> np.ndarray:
    """The labels scattered into the ``(packs, max_images)`` slots in the
    order the packing grouped the images, -1 where a slot is empty (the JAX
    script's loop, :72-79)."""
    num_images = packed.num_images.cpu().numpy()
    lab = np.full((packed.patches.shape[0], packed.max_images), -1, np.int32)
    idx = 0
    for g in range(packed.patches.shape[0]):
        for s in range(packed.max_images):
            if num_images[g] > s:
                lab[g, s] = labels[idx]
                idx += 1
    return lab


def make_batch(host_rng: np.random.Generator, cfg: dict, device, dtype=torch.bfloat16, *, train: bool = True) -> dict:
    """One step's inputs: ``IMAGES_PER_STEP`` images packed into at least
    ``PACKS`` packs of ``MAX_SEQ`` tokens (static shapes: the pack count and
    the slots a pack padded), token dropout from ``host_rng`` in training;
    ``{"packed", "labels"}``."""
    images, labels = sample_images(host_rng, IMAGES_PER_STEP, cfg["num_classes"])
    packed = pack_images(images, patch_size=cfg["patch_size"], max_seq_len=MAX_SEQ,
                         token_dropout_prob=cfg["token_dropout_prob"] if train else None, train=train, rng=host_rng,
                         pad_groups_to=PACKS, max_images=MAX_IMAGES, dtype=dtype, device=device)
    return {"packed": packed, "labels": torch.from_numpy(slot_labels(packed, labels)).long().to(device)}


def masked_cross_entropy(logits, labels):
    """The mean cross-entropy of the slots that hold an image (label >= 0),
    in float32."""
    valid = labels >= 0
    losses = F.cross_entropy(logits.float().flatten(0, 1), labels.clamp_min(0).flatten(), reduction="none")
    return (losses.view(labels.shape) * valid).sum() / valid.sum().clamp_min(1)


def build(cfg: dict, device, dtype=torch.bfloat16):
    """The model (seeded initialisation, cast to ``dtype``) and its AdamW."""
    model = NaViT(**cfg, device=device, generator=torch.Generator(device=device).manual_seed(0)).to(dtype)
    return model, torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY)


def loss_of(model, inputs):
    """The step's loss, the model in training mode."""
    model.train()
    return masked_cross_entropy(model(inputs["packed"]), inputs["labels"])


def train_step(model, opt, inputs):
    opt.zero_grad(set_to_none=True)
    loss = loss_of(model, inputs)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    """Returns ``{"model", "losses", "ms"}``."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args, cfg, device = parse(ap, argv, CONFIG)
    model, opt = build(cfg, device)
    host_rng = np.random.default_rng(0)
    losses, times = [], []
    for step in range(args.steps):
        inputs = make_batch(host_rng, cfg, device)
        t0 = time.perf_counter()
        loss = train_step(model, opt, inputs)
        times.append(ms_since(t0, device))
        losses.append(loss.item())
        print(f"step {step}: loss {losses[-1]:.4f}  ({times[-1]:.0f} ms)")
    return {"model": model, "losses": losses, "ms": times}


if __name__ == "__main__":
    main()
