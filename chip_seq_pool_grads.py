"""CCT-3D's first training step at chip_smoke.py phase 51's shape: each
parameter's gradient on the kernel path (twice), the plain bf16 path, the
plain bf16 path on a 1e-3-noisy batch and fp32 (the flash twins admitted in
f32, so the same dropout and stochastic-depth masks on every path), each
against fp32: the four worst parameters of each path, and the sequence
pool's and the head's gradients by path.  Run on the card from the repo
root: ``python3 chip_seq_pool_grads.py`` (~1 min)."""
import copy
import sys

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from vit_pytorch_tpu_torch.ops._build import load_library
from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

load_library()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(1)
shape, bs = cs.ZOO2["cct_3d"][3], cs.ZOO2["cct_3d"][5]
x = torch.randn(bs, *shape, generator=gen, device=dev)
y = torch.randint(0, 1000, (bs,), generator=gen, device=dev)
noisy = x * (1 + 1e-3 * torch.randn(x.shape, generator=gen, device=dev))
fp32 = cs.zoo2_model("cct_3d", dev, torch.float32)


def grads(model, images, ctx=None):
    import contextlib

    with ctx or contextlib.nullcontext():
        loss = make_train_step(model)(create_train_state(model), images, y, torch.Generator(device=dev).manual_seed(0))
    return loss["loss"].item(), {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}


def rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


runs = {
    "kernel": grads(copy.deepcopy(fp32).to(torch.bfloat16), x.to(torch.bfloat16)),
    "kernel again": grads(copy.deepcopy(fp32).to(torch.bfloat16), x.to(torch.bfloat16)),
    "plain": grads(copy.deepcopy(fp32).to(torch.bfloat16), x.to(torch.bfloat16), cs.plain_flash()),
    "plain noisy": grads(copy.deepcopy(fp32).to(torch.bfloat16), noisy.to(torch.bfloat16), cs.plain_flash()),
    "fp32": grads(copy.deepcopy(fp32), x, cs.plain_flash(admit_fp32=True)),
    "fp32 noisy": grads(copy.deepcopy(fp32), noisy, cs.plain_flash(admit_fp32=True)),
}
ref = runs["fp32"][1]
for name, (loss, g) in runs.items():
    worst = sorted(((rel(g[k], ref[k]), k) for k in g), reverse=True)[:4]
    print(f"{name}: loss {loss:.6f}; vs fp32 worst {[(f'{v:.3e}', k) for v, k in worst]}")
for k in ("classifier.attention_pool.weight", "classifier.attention_pool.bias", "classifier.fc.weight"):
    print(k, "norm", ref[k].norm().item(), {n: f"{rel(g[k], ref[k]):.3e}" for n, (_, g) in runs.items()},
          "kernel vs plain", f"{rel(runs['kernel'][1][k], runs['plain'][1][k]):.3e}",
          "plain vs plain noisy", f"{rel(runs['plain noisy'][1][k], runs['plain'][1][k]):.3e}")
