"""DINO self-distillation pretraining, the port of
``examples/pretrain_dino.py``.

The JAX script carries the teacher and the centres as a functional
``DinoState``; here they are the trainer's own state (``ssl/dino.py``: the
teacher a frozen copy of the student, the centres float32 buffers), and
``update_moving_average()`` moves them after each optimizer step.  The views
are augmented on the card from a CPU generator seeded a step.

The JAX script trains in float32; the port's kernels take bf16, so the port
trains in bf16 (``build`` in float32 gives the JAX arithmetic, on the
composite; the centres and the loss are float32 either way, as JAX's are).
On the card the student's two calls and the teacher's two run the
whole-layer kernels of ``ops/fused_block.py`` at 37 tokens (36 patches and
the cls token): 6 x (2 x 13 + 2 x 7) launches a step.

Synthetic data; swap ``make_batch`` for a real loader.

    python -m vit_pytorch_tpu_torch.examples.pretrain_dino [--steps 20] [--device cuda]
"""

from __future__ import annotations

import time

import torch

from ..models.vit import ViT
from ..ssl.dino import Dino
from ._common import derived_seed, ms_since, parse, parser

# the JAX script's net and Dino (examples/pretrain_dino.py:28-36)
DINO_KEYS = ("num_classes_K", "projection_hidden_size", "projection_layers")
CONFIG = dict(image_size=96, patch_size=16, num_classes=1000, dim=384, depth=6, heads=6, mlp_dim=1536,
              num_classes_K=4096, projection_hidden_size=512, projection_layers=3)
BATCH = 32  # :58
LR, WEIGHT_DECAY = 3e-4, 1e-4  # optax.adamw(3e-4), whose weight decay defaults to 1e-4 (:41)


def build(cfg: dict, device, dtype=torch.bfloat16):
    """The Dino trainer around its ViT, initialised from one seeded
    generator and cast to ``dtype``, and the student's AdamW."""
    gen = torch.Generator(device=device).manual_seed(0)
    net = ViT(**{k: v for k, v in cfg.items() if k not in DINO_KEYS}, device=device, generator=gen)
    dino = Dino(net, image_size=cfg["image_size"], **{k: cfg[k] for k in DINO_KEYS}, device=device,
                generator=gen).to(dtype)
    student = [p for p in dino.parameters() if p.requires_grad]
    return dino, torch.optim.AdamW(student, lr=LR, weight_decay=WEIGHT_DECAY)


def make_batch(step: int, cfg: dict, device, batch: int = BATCH) -> dict:
    """One step's inputs: ``batch`` float32 images uniform in [0, 1) from a
    generator seeded ``100 + step`` (the JAX ``PRNGKey(100 + i)``), and the
    seed of the step's augmentation draws (the JAX script splits
    ``PRNGKey(42)`` a step)."""
    gen = torch.Generator(device=device).manual_seed(100 + step)
    size = cfg["image_size"]
    return {"images": torch.rand((batch, 3, size, size), generator=gen, device=device),
            "views_seed": derived_seed(42, step)}


def loss_of(dino, inputs):
    """The step's Dino loss (``last_teacher_centers`` takes the teacher's
    mean); the views drawn from a CPU generator seeded with the step's seed,
    or ``inputs["views"]`` where given."""
    gen = torch.Generator().manual_seed(inputs["views_seed"])
    return dino(inputs["images"], generator=gen, views=inputs.get("views"))


def train_step(dino, opt, inputs):
    """One AdamW step of the student, then the teacher's and the centres'
    moving averages (the JAX ``update_moving_average`` after the update)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of(dino, inputs)
    loss.backward()
    opt.step()
    dino.update_moving_average()
    return loss.detach()


def main(argv=None):
    """Returns ``{"model", "losses", "ms"}``."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args, cfg, device = parse(ap, argv, CONFIG)
    dino, opt = build(cfg, device)
    losses, times = [], []
    for step in range(args.steps):
        inputs = make_batch(step, cfg, device)
        t0 = time.perf_counter()
        loss = train_step(dino, opt, inputs)
        times.append(ms_since(t0, device))
        losses.append(loss.item())
        print(f"step {step}: dino loss {losses[-1]:.4f}  ({times[-1]:.0f} ms)")
    return {"model": dino, "losses": losses, "ms": times}


if __name__ == "__main__":
    main()
