"""MAE masked-autoencoder pretraining, the port of
``examples/pretrain_mae.py`` (the reference README's ``mae.py`` usage: wrap
a ViT encoder, train on the reconstruction loss, then reuse the encoder).

Every floating parameter is bf16 (the JAX script casts its whole tree), and
AdamW's moments take the parameters' dtype, as optax's do.  On the card the
encoder's 12 layers (on the 49 unmasked tokens) and the decoder's 4 (on all
196) run the whole-layer kernels of ``ops/fused_block.py``, forward and
backward: 16 x 13 launches a step.  The pretrained encoder is
``mae.encoder``: a ``models.vit.ViT`` to fine-tune.

Synthetic data; swap ``make_batch`` for a real loader.

    python -m vit_pytorch_tpu_torch.examples.pretrain_mae [--steps 20] [--device cuda]
"""

from __future__ import annotations

import time

import torch

from ..models.vit import ViT
from ..ssl.mae import MAE
from ._common import derived_seed, ms_since, parse, parser

# the JAX script's encoder and MAE (examples/pretrain_mae.py:25-30)
ENCODER_KEYS = ("image_size", "patch_size", "num_classes", "dim", "depth", "heads", "mlp_dim", "pool")
CONFIG = dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=12, mlp_dim=3072, pool="mean",
              decoder_dim=512, masking_ratio=0.75, decoder_depth=4, decoder_heads=8)
BATCH = 64  # :52
LR, WEIGHT_DECAY = 1.5e-4, 1e-4  # optax.adamw(1.5e-4), whose weight decay defaults to 1e-4 (:38)


def build(cfg: dict, device, dtype=torch.bfloat16):
    """The MAE around its encoder, initialised from one seeded generator in
    float32 and cast to ``dtype`` (the script's bf16), and its AdamW."""
    gen = torch.Generator(device=device).manual_seed(0)
    encoder_kw = {k: v for k, v in cfg.items() if k in ENCODER_KEYS}
    encoder = ViT(**encoder_kw, device=device, generator=gen)
    mae = MAE(encoder=encoder, **{k: v for k, v in cfg.items() if k not in ENCODER_KEYS}, device=device,
              generator=gen).to(dtype)
    return mae, torch.optim.AdamW(mae.parameters(), lr=LR, weight_decay=WEIGHT_DECAY)


def make_batch(step: int, cfg: dict, device, batch: int = BATCH, dtype=torch.bfloat16) -> dict:
    """One step's inputs: ``batch`` normal images in ``dtype`` from a generator
    seeded ``100 + step`` (the JAX ``PRNGKey(100 + i)``), and the seed of the
    step's mask draw (the JAX script splits ``PRNGKey(42)`` a step)."""
    gen = torch.Generator(device=device).manual_seed(100 + step)
    size = cfg["image_size"]
    images = torch.randn((batch, 3, size, size), generator=gen, device=device).to(dtype)
    return {"images": images, "mask_seed": derived_seed(42, step)}


def loss_of(mae, inputs):
    """The step's reconstruction loss; the masked patches drawn from a
    generator seeded with the step's mask seed, or ``inputs["rand_indices"]``
    where given."""
    gen = torch.Generator(device=inputs["images"].device).manual_seed(inputs["mask_seed"])
    return mae(inputs["images"], rand_indices=inputs.get("rand_indices"), generator=gen)


def train_step(mae, opt, inputs):
    opt.zero_grad(set_to_none=True)
    loss = loss_of(mae, inputs)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    """Returns ``{"model", "losses", "ms"}``."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args, cfg, device = parse(ap, argv, CONFIG)
    mae, opt = build(cfg, device)
    mae.train()
    losses, times = [], []
    for step in range(args.steps):
        inputs = make_batch(step, cfg, device)
        t0 = time.perf_counter()
        loss = train_step(mae, opt, inputs)
        times.append(ms_since(t0, device))
        losses.append(loss.item())
        print(f"step {step}: recon loss {losses[-1]:.4f}  ({times[-1]:.0f} ms)")
    return {"model": mae, "losses": losses, "ms": times}


if __name__ == "__main__":
    main()
