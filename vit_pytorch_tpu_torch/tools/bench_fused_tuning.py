"""The tuning experiments of ``tools/bench_fused_tuning.py`` on the port:
(a) the attention block at several images a TPU grid step, (b) the remat
policies of the ViT-B/16 bs=1024 training step.

``make_fused`` (:40, call :66): LN -> qkv (no bias, one cast of the f32
dot) -> per-head softmax (``exp`` and a division) -> ``f32 x + f32 dot``,
one cast; no out bias.  On a CUDA tensor four launches of the port's
kernels (``_common.py``), on a CPU tensor the plain twin of the kernel's
lines.  ``imgs_per_step`` changes nothing here.

``tune_train`` (:106-160) times three training steps of ViT-B/16 @224 at
bs=1024 (bf16 parameters, Adam 3e-4, the cross-entropy of f32 logits):
``remat=True`` with ``torch.utils.checkpoint``'s default (every op
recomputed), ``remat=True`` saving every matmul's output (the JAX
``dots_saveable`` policy) and no remat.  As the JAX tool patches
``nn.remat`` for the experiment (:118-126, restored at :158-159), the port's
tool patches ``nn/blocks.py``'s ``checkpoint`` while a mode runs
(:func:`remat_policy`); the package gains no knob.  On the card at dropout
0 every layer is the whole-layer Function, which saves only x and y, and
remat leaves it alone (as the JAX ``Transformer`` does), so the policy acts
on the composite path only.

    python -m vit_pytorch_tpu_torch.tools.bench_fused_tuning         # on a CUDA card
    python -m vit_pytorch_tpu_torch.tools.bench_fused_tuning train   # the training step's remat modes
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..nn import blocks
from . import _common as c

# tune_kernel()'s sizes (the JAX tool's)
B, H, N, D = 128, 12, 197, 64
DIM = H * D
LAYERS = 12
INNER = 10


def make_fused(imgs_per_step):
    """``fn(x, w_qkv, w_out, lns, lnb)``: ``x + OutProj(Attention(LN(x) @
    Wqkv))``, one cast."""

    def fn(x, w_qkv, w_out, lns, lnb):
        if c.on_card(x):
            return c.attention_chain(x, w_qkv, w_out, lns, lnb)
        return c.attention_twin(x, w_qkv, w_out, lns, lnb)

    return fn


def tune_kernel(device=None):
    """The JAX tool's kernel sweep on the card: 12 blocks a call at 1, 2 and
    4 images a step.  Returns {imgs_per_step: ms a call}."""
    dev = c.card(device)
    c.print_card(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen, device=dev) * s).to(torch.bfloat16)
    x = rnd(B, N, DIM)
    w_qkv, w_out = rnd(3 * DIM, DIM, s=0.02), rnd(DIM, DIM, s=0.02)
    lns = torch.ones(DIM, dtype=torch.bfloat16, device=dev)
    lnb = torch.zeros(DIM, dtype=torch.bfloat16, device=dev)

    def stack(fn):
        def run(x, *rest):
            for _ in range(LAYERS):
                x = fn(x, *rest)
            return x

        return run

    results = {}
    with torch.inference_mode():
        for ips in (1, 2, 4):
            results[ips] = c.timeit(f"fused block {ips} img/step", stack(make_fused(ips)), x, w_qkv, w_out, lns, lnb,
                                    iters=INNER, layers=LAYERS, label="ms/layer-equiv")
    return results


# tune_train()'s step (the JAX tool's, :110-117)
VIT_B = dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=12, mlp_dim=3072)
TRAIN_BATCH = 1024
# the matmuls whose outputs dots_saveable keeps (jax.checkpoint_policies.dots_saveable)
MATMULS = frozenset(getattr(torch.ops.aten, name) for name in ("mm", "addmm", "bmm", "baddbmm", "_scaled_mm"))


def dots_saveable(ctx, op, *args, **kwargs):
    """Save every matmul's output for the backward, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op.overloadpacket in MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


# name: (remat, selective-checkpoint policy or None for checkpoint's default), :111-115
TRAIN_MODES = {
    "remat full (current)": (True, None),
    "remat dots_saveable": (True, dots_saveable),
    "no remat": (False, None),
}


@contextlib.contextmanager
def remat_policy(policy):
    """``nn/blocks.py``'s ``checkpoint`` under the selective-checkpoint
    ``policy`` (None: unchanged) while the block runs, restored after it,
    also when it raises."""
    if policy is None:
        yield
        return
    saved = blocks.checkpoint
    blocks.checkpoint = functools.partial(
        checkpoint, context_fn=functools.partial(create_selective_checkpoint_contexts, policy))
    try:
        yield
    finally:
        blocks.checkpoint = saved


def train_setup(remat: bool, *, batch: int = TRAIN_BATCH, device=None, cfg: dict = VIT_B, seed: int = 0):
    """``(model, optimizer, images, labels)`` of the JAX tool's step: a ViT
    initialised in float32 from a generator seeded ``seed`` and cast to bf16,
    Adam 3e-4 (bf16 moments, as optax's over bf16 parameters), a bf16
    normal batch and zero labels."""
    from ..models.vit import ViT

    dev = torch.device(device) if device is not None else torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = ViT(**cfg, remat=remat, device=dev, generator=gen).to(torch.bfloat16)
    size = cfg["image_size"]
    images = torch.randn((batch, 3, size, size), generator=gen, device=dev).to(torch.bfloat16)
    labels = torch.zeros(batch, dtype=torch.long, device=dev)
    return model, torch.optim.Adam(model.parameters(), lr=3e-4), images, labels


def train_step(model, opt, images, labels):
    """One Adam step on the cross-entropy of the f32 logits; the loss."""
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(images).float(), labels)
    loss.backward()
    opt.step()
    return loss.detach()


def train_mode(name: str, *, batch: int = TRAIN_BATCH, device=None, cfg: dict = VIT_B) -> dict:
    """One mode of :data:`TRAIN_MODES`: a step, then the best of 3 more
    (host clock around the step and a synchronize, as the JAX tool times
    it).  Returns ``{"ms", "img_s", "loss", "model"}``; the step's
    errors propagate."""
    remat, policy = TRAIN_MODES[name]
    model, opt, images, labels = train_setup(remat, batch=batch, device=device, cfg=cfg)
    sync = torch.cuda.synchronize if images.is_cuda else (lambda: None)
    with remat_policy(policy):
        loss = train_step(model, opt, images, labels)
        sync()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            loss = train_step(model, opt, images, labels)
            sync()
            best = min(best, time.perf_counter() - t0)
    return {"ms": best * 1e3, "img_s": batch / best, "loss": loss, "model": model}


def tune_train(device=None, batch: int = TRAIN_BATCH):
    """The JAX tool's remat sweep on the card: ms/step and img/s of each
    mode, ``FAILED`` for a mode that raises (:155-156).  Returns {mode: ms
    or None}."""
    dev = c.card(device)
    c.print_card(dev)
    results = {}
    for name in TRAIN_MODES:
        try:
            out = train_mode(name, batch=batch, device=dev)
            results[name] = out["ms"]
            print(f"train {name:28s} {out['ms']:8.1f} ms/step ({out['img_s']:.0f} img/s)", flush=True)
        except Exception as e:  # noqa: BLE001 -- the JAX tool reports a mode that fails and goes on
            results[name] = None
            print(f"train {name:28s} FAILED: {type(e).__name__}: {str(e)[:120]}", flush=True)
        torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    if "train" in sys.argv:
        tune_train()
    else:
        tune_kernel()
