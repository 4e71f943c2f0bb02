"""End-to-end training on real data: the UCI handwritten digits (1,797 8x8
grayscale images, 10 classes), the port of ``examples/train_digits.py``.

A ViT learns the digits with Adam and reports the test accuracy each epoch:
from ~10% (chance) to well above 50%.  The batches go through the input
pipeline (``utils/data.py``: ``minibatches`` -> ``prefetch_to_device``, the
next batch's copy to the card in flight while a step runs) into
``parallel/train.py::make_train_step``.  With ``--checkpoint-dir`` each epoch
is saved (``utils/checkpoint.py::CheckpointManager``, the last 3 kept), and
``--resume`` continues from the latest: the batch order and the dropout
masks of an epoch come from generators derived from the epoch's number and
never carried across epochs, so a resumed run is bit for bit an
uninterrupted one.

The data is the copy of scikit-learn's bundled ``digits.csv.gz`` in
``examples/data/`` (see its README), read with numpy as scikit-learn reads
it.  No kernel of the port runs here: the heads are 16 wide, outside every
kernel's gate (the kernels take 64), so the layers run the composite, in
float32 as the JAX script trains.

    python -m vit_pytorch_tpu_torch.examples.train_digits [--epochs 20] [--checkpoint-dir DIR [--resume]]
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from ..models.vit import ViT
from ..parallel.train import create_train_state, make_train_step
from ..utils.checkpoint import CheckpointManager
from ..utils.data import minibatches, prefetch_to_device
from ._common import derived_seed, parse, parser

# the JAX script's model (examples/train_digits.py:62-74)
CONFIG = dict(image_size=8, patch_size=2, num_classes=10, dim=64, depth=4, heads=4, dim_head=16, mlp_dim=128,
              channels=1, dropout=0.1, emb_dropout=0.1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "digits.csv.gz")


def load_data(seed=0):
    """``(x_train, y_train, x_test, y_test)``: the JAX ``load_data`` (:26-41)
    on the repo's copy of the data, 64 pixels then the label a row, pixels
    0..16 scaled by 1/16 to (n, 1, 8, 8) float32, the rows permuted by
    ``np.random.default_rng(seed)``, the first fifth held out."""
    data = np.loadtxt(DATA, delimiter=",")
    images = data[:, :-1].reshape(-1, 8, 8).astype(np.float32) / 16.0
    images = images[:, None, :, :]
    labels = data[:, -1].astype(int).astype(np.int32)
    order = np.random.default_rng(seed).permutation(len(images))
    images, labels = images[order], labels[order]
    n_test = len(images) // 5
    return images[n_test:], labels[n_test:], images[:n_test], labels[:n_test]


def build_model(cfg: dict, device) -> ViT:
    return ViT(**cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))


@torch.no_grad()
def accuracy(model, images, labels) -> float:
    model.eval()
    logits = model(images)
    return float((logits.argmax(-1) == labels).float().mean())


def run(args, data, device, *, cfg: dict = CONFIG, model=None) -> dict:
    """The training loop of ``main()`` on ``data`` (``load_data()``'s
    tuple), from ``model`` (by default a new one of ``cfg``).  Returns
    ``{"state", "accuracy", "losses"}``: the ``TrainState``, the final test
    accuracy and each epoch's mean loss."""
    x_train, y_train, x_test, y_test = data
    model = build_model(cfg, device) if model is None else model
    state = create_train_state(model, tx=functools.partial(torch.optim.Adam, lr=args.lr))
    step = make_train_step(model)
    x_eval = torch.as_tensor(x_test).to(device)
    y_eval = torch.as_tensor(y_test).to(device)

    mgr, start_epoch = None, 0
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir, max_to_keep=3)
        if args.resume and mgr.latest_step() is not None:
            start_epoch = mgr.latest_step()
            mgr.restore(state)
            print(f"resumed from epoch {start_epoch}")

    t0 = time.time()
    epoch_losses = []
    for epoch in range(start_epoch, args.epochs):
        # per-epoch derived generators (not carried across epochs) so that a
        # resume from any epoch boundary replays the same batch order and
        # dropout masks: the JAX fold_in(PRNGKey(1), epoch) and
        # default_rng((1, epoch))
        dropout_gen = torch.Generator().manual_seed(derived_seed(1, epoch))
        batches = prefetch_to_device(
            minibatches({"x": x_train, "y": y_train}, args.batch_size, rng=np.random.default_rng((1, epoch))),
            depth=2, device=device,
        )
        losses = [step(state, batch["x"], batch["y"].long(), dropout_gen)["loss"] for batch in batches]
        epoch_losses.append(float(torch.stack(losses).mean()))
        acc = accuracy(model, x_eval, y_eval)
        print(f"epoch {epoch + 1:2d}  loss {epoch_losses[-1]:.4f}  test acc {acc * 100:5.1f}%  "
              f"({time.time() - t0:.1f}s)")
        if mgr is not None:
            mgr.save(epoch + 1, state)
    if mgr is not None:
        mgr.close()
    acc = accuracy(model, x_eval, y_eval)
    return {"state": state, "accuracy": acc, "losses": epoch_losses}


def arguments():
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None, help="save a checkpoint per epoch (keep the last 3)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --checkpoint-dir; bit-exact with an "
                         "uninterrupted run (per-epoch derived generators)")
    return ap


def main(argv=None):
    """Trains, asserts that the model learned (test accuracy over 50%) and
    returns :func:`run`'s dict."""
    args, cfg, device = parse(arguments(), argv, CONFIG)
    data = load_data()
    print(f"train {len(data[0])} / test {len(data[2])} images (8x8 digits)")
    out = run(args, data, device, cfg=cfg)
    if not out["accuracy"] > 0.5:
        raise AssertionError("model failed to learn")
    print(f"final test accuracy: {out['accuracy'] * 100:.1f}% (chance = 10%)")
    return out


if __name__ == "__main__":
    main()
