"""Entry point of the port, counterpart of the JAX package's
``__graft_entry__.py::entry`` (:13-38).

``entry()`` returns ``(forward, (img,))``: the forward of the flagship model,
ViT-B/16 @224 in bf16 with zero weights, and a batch of 8 ones, on the CUDA
card unless the caller names another device.  On the card the forward runs
the whole-layer kernels.  ``dryrun_multichip`` waits for the port's mesh
(ROADMAP item 11b).

    python -m vit_pytorch_tpu_torch.entry
"""

from __future__ import annotations

import torch

from .models.vit import ViT
from .utils.helpers import default_device


def entry(device=None):
    """``(forward, (img,))`` for ViT-B/16 @224 in bf16 with zero weights: the
    model is built on ``meta`` (no initialisation), then its storage is
    allocated on the device and zeroed, as the JAX ``entry`` zeroes the
    abstract params."""
    device = default_device(device)
    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=12, mlp_dim=3072,
                device="meta", dtype=torch.bfloat16).to_empty(device=device).eval()
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.zero_()
    img = torch.ones((8, 3, 224, 224), dtype=torch.bfloat16, device=device)

    def forward(img):
        with torch.inference_mode():
            return model(img)

    return forward, (img,)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype, out.device)
