"""Device mesh and parameter layouts, port of ``vit_pytorch_tpu/parallel/mesh.py``.

JAX partitions one program over every device of one process.  PyTorch runs
one process a device: :func:`initialize_distributed` joins the process
group, :func:`make_mesh` lays its ranks out as a ``('data', 'model')``
``DeviceMesh``, and a tensor's layout is a :class:`Sharding`, a mesh and a
spec that names a mesh axis (or None) for each tensor dimension, as a
``PartitionSpec`` does.  Its ``placements`` are the DTensor placements it
means, one for each mesh axis.

Data parallel  : batch sharded on 'data'; gradients averaged over 'data'.
Tensor parallel: attention qkv / mlp hidden sharded on 'model'
                 (Megatron-style column -> row parallel pairs), optional:
                 ViTs are small, so 'model' usually stays size 1.

The rules are written on the port's parameter names and torch's
``(out, in)`` weights, the transpose of the JAX ``(in, out)`` kernels: a
column-parallel kernel (JAX ``P(None, 'model')``) is a weight sharded on
dim 0, a row-parallel one (``P('model', None)``) a weight sharded on dim 1.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "model")

# (regex on the parameter's state_dict name, spec on torch's layout) -- first
# match wins.  Column-parallel (output sharded): qkv, q, kv, fc1 (``net.1``).
# Row-parallel (input sharded, output all-reduced): the projection out
# (``to_out.0``, a bare ``to_out`` in the simple layout) and fc2 (``net.4``,
# ``net.3`` in the simple FF), nn/blocks.py's FeedForward and Attention.
_TP_RULES = [
    (r"(.*\.)?(to_qkv|to_q|to_kv)\.weight", ("model", None)),
    (r"(.*\.)?net\.1\.weight", ("model", None)),
    (r"(.*\.)?net\.1\.bias", ("model",)),
    (r"(.*\.)?(to_out(\.0)?|net\.[34])\.weight", (None, "model")),
]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout, the counterpart of ``jax.sharding.NamedSharding``:
    ``spec`` names, for each leading tensor dimension, the mesh axis it is
    split over (or None); dimensions past its end are whole."""

    mesh: object
    spec: tuple = ()

    @property
    def placements(self) -> tuple:
        """The DTensor placements, one for each mesh axis: ``Shard(d)`` where
        the spec names the axis at dimension d, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        return tuple(
            Shard(self.spec.index(axis)) if axis in self.spec else Replicate() for axis in self.mesh.mesh_dim_names
        )


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _available_devices(min_count: int = 1, allow_cpu_fallback: bool = False, device_type: Optional[str] = None):
    """``(device_type, ranks)`` for mesh building: the CUDA cards of the
    process group, one a rank.  The CPU is used only when the caller asks
    for it (``device_type="cpu"``, or ``allow_cpu_fallback=True`` where no
    card is visible): a mis-sized request on a real multi-card job must
    error, not silently run on host CPUs."""
    world = dist.get_world_size() if _initialized() else 1
    if device_type is None:
        if torch.cuda.is_available():
            device_type = "cuda"
        elif allow_cpu_fallback:
            device_type = "cpu"
        else:
            raise ValueError(
                f"make_mesh needs {min_count} CUDA devices but none is visible. Pass device_type='cpu' (with a "
                f"gloo process group of {min_count} processes) to validate layouts on the CPU, or "
                f"allow_cpu_fallback=True to opt into the fallback explicitly."
            )
    if world < min_count:
        raise ValueError(
            f"make_mesh needs {min_count} devices but the process group has {world} ({device_type}): start one "
            f"process a device and call initialize_distributed in each"
        )
    return device_type, list(range(world))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    *,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    **kwargs,
):
    """Join the process group: ``torch.distributed.init_process_group``,
    one call a process, before :func:`make_mesh`.

    ``coordinator_address`` is ``'host:port'`` of process 0 (a
    ``tcp://`` rendezvous); ``init_method`` may name another (``file://``
    a path every process sees); with neither, the ``env://`` variables of
    ``torchrun`` are read.  ``num_processes`` and ``process_id`` are the
    world size and this process's rank.  ``backend``: NCCL where a CUDA
    card is visible, gloo on the CPU.  ``local_device_ids``: the card this
    process drives (its first entry), by default the ``LOCAL_RANK``
    variable or the rank, modulo the visible cards.  Idempotent: a call in
    an initialised process changes nothing.

    Feed each process its local slice of the batch
    (``utils.data.process_local_slice`` -> ``prefetch_to_device(...,
    mesh=mesh)``), which assembles batches of the global shape.

    Returns ``(rank, world_size)``.
    """
    import os

    if not _initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if init_method is None:
            init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
        if backend == "nccl":
            if local_device_ids is not None:
                index = list(local_device_ids)[0]
            else:
                index = int(os.environ.get("LOCAL_RANK", process_id or 0))
            torch.cuda.set_device(index % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id, **kwargs,
        )
    return dist.get_rank(), dist.get_world_size()


def _world_of_one(device_type: str) -> None:
    """A process group of this process alone, as JAX's single-process mesh
    needs no setup: an in-memory store, NCCL on the card, gloo on the
    CPU."""
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def global_array_from_process_local(local, mesh, spec: Optional[Sequence] = None):
    """Tensors of the global shape from this process's shard of each leaf
    (leading axis split over 'data' by default): ``DTensor.from_local`` on
    ``mesh``'s device.  Ranks that differ only in 'model' hold the same
    rows.  Works in a world of one too (then each local leaf is the whole
    tensor)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_map

    placements = Sharding(mesh, tuple(("data",) if spec is None else spec)).placements
    device = mesh_device(mesh)
    return tree_map(lambda a: DTensor.from_local(torch.as_tensor(a).to(device), mesh, placements), local)


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(data: Optional[int] = None, model: int = 1, devices=None, allow_cpu_fallback: bool = False, *,
              device_type: Optional[str] = None):
    """Build a ``('data', 'model')`` ``DeviceMesh`` over the process group's
    ranks, one device a rank.  ``data`` defaults to filling all ranks after
    'model' is taken.  ``devices``: the ranks to lay out (default: every
    rank of the group).  ``device_type``: ``"cuda"`` (the default; no
    visible card raises) or ``"cpu"``.

    A 1 x 1 mesh in a process without a group starts a world of one itself;
    a larger one needs :func:`initialize_distributed` first."""
    if not _initialized():
        if (1 if data is None else data) * model != 1:
            raise ValueError(f"make_mesh: a {data}x{model} mesh needs a process group: call initialize_distributed "
                             f"in each of its processes first")
        _world_of_one(_available_devices(1, allow_cpu_fallback, device_type)[0])
    if devices is None:
        device_type, devices = _available_devices(model if data is None else data * model, allow_cpu_fallback,
                                                  device_type)
    else:
        device_type = _available_devices(1, allow_cpu_fallback, device_type)[0]
        devices = list(devices)
    n = len(devices)
    if data is None:
        data = n // model  # floor: the mesh below uses the first data*model
        if data < 1:  # JAX's assertions, kept under -O
            raise AssertionError(f"need at least {model} devices for model={model}, got {n}")
        if data * model < n:
            warnings.warn(
                f"make_mesh: {n} devices do not divide by model={model}; using a {data}x{model} mesh and leaving "
                f"{n - data * model} device(s) idle",
                stacklevel=2,
            )
    if data * model > n:
        raise AssertionError(f"mesh {data}x{model} needs {data * model} devices, got {n}")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if devices[: data * model] == list(range(dist.get_world_size())):
        return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)
    ranks = torch.tensor(devices[: data * model]).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def param_partition_spec(name: str) -> tuple:
    """The tensor-parallel spec of the parameter ``name`` (a ``state_dict``
    name) on torch's layout; ``()`` replicates."""
    for pattern, spec in _TP_RULES:
        if re.fullmatch(pattern, name):
            return spec
    return ()


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _trim(axes) -> tuple:
    """A spec without its trailing Nones (``P(None, 'model')`` and
    ``P(None, 'model', None)`` are one layout)."""
    axes = list(axes)
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def _tp_spec(name: str, shape, sizes: dict) -> tuple:
    spec = param_partition_spec(name)
    # guard: the axis must divide the dim, else replicate
    if len(spec) > len(shape) or any(axis is not None and n % sizes[axis] for n, axis in zip(shape, spec)):
        return ()
    return _trim(spec)


def _kernels(model: nn.Module) -> set:
    """The names of the weights that the JAX package holds transposed
    (``kernel``s of Dense and Conv: torch ``(out, in, *k)``, JAX
    ``(*k, in, out)``)."""
    return {f"{prefix}.weight" if prefix else "weight" for prefix, m in model.named_modules()
            if isinstance(m, (nn.Linear, nn.modules.conv._ConvNd))}


def infer_param_shardings(model: nn.Module, mesh) -> dict:
    """``{name: Sharding}`` of ``model``'s parameters (tensor-parallel
    layout): the TP specs where the 'model' axis divides, replicated
    elsewhere."""
    sizes = _axis_sizes(mesh)
    return {name: Sharding(mesh, _tp_spec(name, p.shape, sizes)) for name, p in model.named_parameters()}


def infer_param_shardings_fsdp(model: nn.Module, mesh, *, min_size: int = 2**14) -> dict:
    """FSDP / ZeRO-3 layout: on top of the TP specs, shard each parameter's
    first still-unsharded divisible dimension over the 'data' axis, "first"
    in the JAX layout (a kernel's input dim, then its output dim: torch
    dims ``2.., 1, 0`` of a weight), so that the layout is the JAX
    package's through the transpose.  Parameters smaller than ``min_size``
    elements stay replicated (gather latency would dominate)."""
    sizes = _axis_sizes(mesh)
    kernels = _kernels(model)
    out = {}
    for name, p in model.named_parameters():
        axes = [*_tp_spec(name, p.shape, sizes), *[None] * p.ndim][: p.ndim]
        if p.numel() >= min_size:
            order = [*range(2, p.ndim), 1, 0] if name in kernels and p.ndim >= 2 else range(p.ndim)
            for d in order:
                if axes[d] is None and p.shape[d] % sizes["data"] == 0:
                    axes[d] = "data"
                    break
        out[name] = Sharding(mesh, _trim(axes))
    return out


def batch_sharding(mesh) -> Sharding:
    return Sharding(mesh, ("data",))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())
