"""Entry point of the port, counterpart of the JAX package's
``__graft_entry__.py::entry`` (:13-38).

``entry()`` returns ``(forward, (img,))``: the forward of the flagship model,
ViT-B/16 @224 in bf16 with zero weights, and a batch of 8 ones, on the CUDA
card unless the caller names another device.  On the card the forward runs
the whole-layer kernels.

``dryrun_multichip(n)`` (``__graft_entry__.py:41-144``) runs the full
data + tensor + fully sharded training step over an ``n``-device mesh for
one step on tiny shapes.  A port runs one process a device, so the mesh is
``n`` gloo processes on the CPU, joined through a file store in a temporary
directory: CPU by definition, as the JAX function pins its virtual CPU
devices, even on a machine with a card, which neither it nor its workers
initialise.

    python -m vit_pytorch_tpu_torch.entry
    python -m vit_pytorch_tpu_torch.entry dryrun 8
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import tempfile

import torch

from .models.vit import ViT
from .utils.helpers import default_device

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DRYRUN_TIMEOUT = 600  # seconds a worker may take, its torch import included


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


def _dryrun_worker(rank: int, n_devices: int, store: str) -> None:
    """One rank of :func:`dryrun_multichip`: the step of
    ``__graft_entry__.py:93-136`` on this rank's CPU, then the loss printed
    as ``LOSS <value>``."""
    torch.set_num_threads(1)
    from .parallel.mesh import initialize_distributed, make_mesh
    from .parallel.train import create_train_state, make_sharded_train_step, shard_train_state

    initialize_distributed(num_processes=n_devices, process_id=rank, backend="gloo", init_method=f"file://{store}")
    try:
        # data x model mesh: tensor parallelism when the device count allows
        model_par = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
        mesh = make_mesh(data=n_devices // model_par, model=model_par, device_type="cpu")
        # tiny flagship-shaped model (heads/mlp divisible by the 'model' axis)
        torch.manual_seed(0)
        tiny = ViT(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128,
                   dropout=0.1, device="cpu")
        batch = max(n_devices, 8)
        images = torch.ones((batch, 3, 32, 32))
        labels = torch.zeros((batch,), dtype=torch.long)
        # full layout: batch on 'data', Megatron TP on 'model', FSDP/ZeRO-3
        # parameter + moment sharding over 'data'
        state = shard_train_state(create_train_state(tiny), mesh, fsdp=True, fsdp_min_size=512)
        step = make_sharded_train_step(tiny, mesh)
        metrics = step(state, images, labels, torch.Generator().manual_seed(1))
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise RuntimeError(f"dryrun_multichip: the loss is not finite: {metrics}")
        # every tensor this function made lives on the CPU
        made = [*tiny.parameters(), *tiny.buffers(), *metrics.values(),
                *(t for moments in state.optimizer.state.values() for t in moments.values()
                  if isinstance(t, torch.Tensor))]
        bad = [tuple(t.shape) for t in made if t.device.type != "cpu"]
        if bad:
            raise RuntimeError(f"dryrun_multichip: tensors off the CPU: {bad}")
        print(f"LOSS {loss!r} MESH {mesh.shape[0]} {mesh.shape[1]}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """Run the full DP + TP + FSDP training step of a tiny ViT (dropout 0.1)
    over an ``n_devices`` mesh, ``(n/2, 2)`` when ``n`` is even and at
    least 4, else ``(n, 1)``, one step: ``n`` gloo CPU processes, each with
    no visible card (``CUDA_VISIBLE_DEVICES`` empty), joined through a file
    store.  Raises unless the loss is finite, the same on every rank, and every
    tensor made lies on the CPU; this process initialises neither CUDA nor
    a process group.  Prints ``dryrun_multichip ok: mesh={...} loss=...``."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, (_PACKAGE_ROOT, os.environ.get("PYTHONPATH"))))}
    code = "import sys; from vit_pytorch_tpu_torch.entry import _dryrun_worker; " \
           "_dryrun_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])"
    with tempfile.TemporaryDirectory(prefix="vit-torch-dryrun-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), str(n_devices), store], env=env, cwd=tmp,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=_DRYRUN_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip: rank {rank} failed (exit {p.returncode}):\n{out}")
    lines = [next((line for line in out.splitlines() if line.startswith("LOSS ")), None) for out in outs]
    if None in lines:
        raise RuntimeError(f"dryrun_multichip: a rank printed no loss:\n{outs[lines.index(None)]}")
    fields = [line.split() for line in lines]
    losses = {float(f[1]) for f in fields}
    if len(losses) != 1:
        raise RuntimeError(f"dryrun_multichip: the ranks' losses differ: {sorted(losses)}")
    loss = losses.pop()
    mesh_shape = {"data": int(fields[0][3]), "model": int(fields[0][4])}
    print(f"dryrun_multichip ok: mesh={mesh_shape} loss={loss:.4f}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["dryrun"]:
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry ok:", tuple(out.shape), out.dtype, out.device)
