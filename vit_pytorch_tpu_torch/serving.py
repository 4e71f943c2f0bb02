"""Serving layer: bucket-batched inference and portable program artifacts,
port of ``vit_pytorch_tpu/serving.py``.

``Predictor`` (:60-240) casts the model's floating parameters and persistent
buffers (BatchNorm statistics: the JAX ``batch_stats``) to the serving dtype
once, pads every request up to the smallest batch-size bucket that fits and
chunks requests larger than the biggest bucket.  Fixed buckets bound the set
of shapes the kernels see.  Where the JAX ``Predictor`` compiles one
executable a bucket, the port runs each bucket once (at construction with
``aot=True``, else at its first use), which builds the CUDA kernels on first
use.  ``from_checkpoint`` builds one from a checkpoint of
``utils/checkpoint.py``; ``cost_analysis`` counts a bucket's FLOPs from a
FakeTensor trace.

``export_model`` / ``load_model`` (:257-379) are the counterpart of the JAX
``jax.export`` artifacts through ``torch.export``: the program ``(variables,
images) -> outputs`` with a dynamic batch dimension, without the weights,
loadable in a process that does not import the model code.

Over a mesh (``parallel/mesh.py``, one process a device) the layout is the
JAX package's (serving.py:49-57): parameters replicated, the batch on the
'data' axis.  Every rank is handed the whole request, runs the rows of its
'data' coordinate on its own device and returns the whole result, gathered
over 'data'.

Example::

    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=768,
                depth=12, heads=12, mlp_dim=3072)
    p = Predictor(model, example_shape=(3, 224, 224))
    logits = p(images)          # images: (k, 3, 224, 224), any k
"""

from __future__ import annotations

import copy
import io
import json
import os
import zipfile
from itertools import chain
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import FlopCounterMode

from .utils.helpers import default_device

_ARTIFACT_META = "vit_torch.json"  # the artifact's own metadata, beside the program
_OPS_NAMESPACE = "vit_torch"  # ops/_library.py's NAMESPACE; serving does not import ops/


def _call(model: nn.Module, x):
    return model(x)


class _DataAxis:
    """THE serving layout over a mesh, defined once for ``Predictor``,
    ``export_model`` and ``load_model``: parameters replicated (a whole copy
    on every rank), the batch split over the mesh's 'data' axis.  ``rows``
    takes this rank's share of a batch, ``gather`` joins the ranks' outputs
    in 'data' order, tensor by tensor of the output."""

    def __init__(self, mesh):
        if "data" not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh must have a 'data' axis, got {mesh.mesh_dim_names}")
        self.mesh, self.size, self.group = mesh, mesh["data"].size(), mesh.get_group("data")

    def rows(self, x):
        from .utils.data import process_local_slice

        return process_local_slice(x, mesh=self.mesh)

    def gather(self, out):
        def join(o):
            if o is None or self.size == 1:
                return o
            parts = [torch.empty_like(o) for _ in range(self.size)]
            torch.distributed.all_gather(parts, o.contiguous(), group=self.group)
            return torch.cat(parts, dim=0)

        return tree_map(join, out)


class _Applied(nn.Module):
    """``apply_fn(model, x)`` as a module, for ``torch.func.functional_call``:
    the model's tensors are named ``model.<name>``."""

    def __init__(self, model: nn.Module, apply_fn: Callable):
        super().__init__()
        self.model, self.apply_fn = model, apply_fn

    def forward(self, x):
        return self.apply_fn(self.model, x)


def _non_persistent(model: nn.Module) -> dict:
    """The buffers outside ``state_dict`` (SimpleViT's sincos table)."""
    persistent = model.state_dict(keep_vars=True)
    return {name: buf for name, buf in model.named_buffers() if name not in persistent}


def forward_flops(model: nn.Module, example_shape: Sequence[int], dtype: torch.dtype, *, device=None,
                  apply_fn: Optional[Callable] = None) -> int:
    """FLOPs of one forward of ``apply_fn(model, x)`` (default ``model(x)``)
    on ``x`` of ``example_shape`` and ``dtype``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over a trace with
    FakeTensors on ``device`` (default: the model's), which launches nothing.
    It counts 2 FLOP a multiply-add of every product (``bench.py:11-13``'s
    convention); the kernel ops register their formulas
    (``ops/_library.py``), so a trace on the card counts what the plain
    composite counts on the CPU.  XLA's ``cost_analysis`` also counts
    elementwise work; this count does not."""
    device = torch.device(device) if device is not None else next(chain(model.parameters(), model.buffers())).device
    applied = _Applied(model, apply_fn or _call)
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {f"model.{name}": torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=device)
                 for name, t in chain(model.named_parameters(), model.named_buffers())}
        x = torch.empty(tuple(example_shape), dtype=dtype, device=device)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            torch.func.functional_call(applied, state, (x,))
    return counter.get_total_flops()


class Predictor:
    """Bucket-batched inference wrapper for a model of the port.

    Args:
        model: an ``nn.Module``; it is copied, so the caller's module keeps
            its device and dtype.
        example_shape: per-example input shape, e.g. ``(3, 224, 224)``.
        batch_sizes: bucket sizes.  Requests are padded up to the smallest
            bucket that fits and chunked by the largest when bigger.
        param_dtype: serving dtype of the floating parameters and of the
            floating persistent buffers (bf16 by default, the dtype the
            kernels take).  The JAX ``Predictor`` casts every floating leaf
            of the variables, ``batch_stats`` included (serving.py:40-46); a
            non-persistent buffer is outside them (SimpleViT's sincos table)
            and keeps its dtype.
        input_dtype: dtype the batch is cast to (defaults to
            ``param_dtype``).
        apply_fn: optional ``(model, batch) -> out`` called on the served
            copy in place of ``model(batch)`` (extra arguments, wrapper
            methods, ...).  The JAX ``apply_fn`` takes ``(variables,
            batch)``; in the port the module holds its variables.
        mesh: a ``parallel.mesh.make_mesh`` mesh with a 'data' axis.  The
            parameters are replicated, the batch is split over 'data': each
            bucket size must be a multiple of the data-axis size.  Every rank
            calls the Predictor with the whole request, runs its rows on its
            device (``device`` defaults to the mesh's) and returns the whole
            output, gathered over 'data'.
        aot: run every bucket once at construction (default), as the JAX
            ``Predictor`` compiles them then.  With ``aot=False`` each bucket
            runs first at its first use (``warmup()`` runs the rest).
        device: where the model runs: the CUDA card unless the caller names
            another (``utils/helpers.py::default_device``).
    """

    def __init__(
        self,
        model: nn.Module,
        *,
        example_shape: Sequence[int],
        batch_sizes: Sequence[int] = (1, 8, 32, 128),
        param_dtype: torch.dtype = torch.bfloat16,
        input_dtype: Optional[torch.dtype] = None,
        apply_fn: Optional[Callable] = None,
        mesh=None,
        aot: bool = True,
        device=None,
    ):
        if not batch_sizes:
            raise ValueError("need at least one batch-size bucket")
        self.batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
        self.mesh = mesh
        self._layout = None
        if mesh is not None:
            from .parallel.mesh import mesh_device

            self._layout = _DataAxis(mesh)
            bad = [b for b in self.batch_sizes if b % self._layout.size]
            if bad:
                raise ValueError(f"bucket sizes {bad} are not multiples of the data-axis size {self._layout.size} — "
                                 f"each bucket shards evenly over 'data'")
            device = mesh_device(mesh) if device is None else device
        self.example_shape = tuple(example_shape)
        self.param_dtype = param_dtype
        self.input_dtype = input_dtype or param_dtype
        self.device = default_device(device)
        self._apply = apply_fn or _call
        model = copy.deepcopy(model).to(device=self.device)
        for p in model.parameters():
            p.requires_grad_(False)
            if p.is_floating_point():
                p.data = p.data.to(param_dtype)
        persistent = model.state_dict(keep_vars=True)
        for name, buf in model.named_buffers():
            if name in persistent and buf.is_floating_point():
                buf.data = buf.data.to(param_dtype)
        self.model = model.eval()
        self._run: set = set()
        if aot:
            self.warmup()

    @classmethod
    def from_checkpoint(cls, model: nn.Module, path: str, sample_input, **kwargs) -> "Predictor":
        """Load the parameters from a checkpoint of ``utils/checkpoint.py``
        written by ``save_checkpoint({"params": model.state_dict()})``, or
        the model of a ``TrainState`` checkpoint, and build a Predictor.

        ``model`` is best built on ``device="meta"``: it is then only the
        structure, and ``load_state_dict(assign=True)`` takes the
        checkpoint's tensors (memory-mapped from the file) into it, so that
        loading does not hold the weights twice, as the JAX function
        restores into an abstract target.  A non-persistent buffer is
        outside the checkpoint; the models build theirs on the CPU when
        asked for ``meta`` (``utils/helpers.py::table_device``).

        ``sample_input``: one example WITH batch dim; its shape is the
        default ``example_shape``."""
        from .utils.checkpoint import load_checkpoint

        tree = load_checkpoint(path)
        if isinstance(tree, dict) and "params" in tree:
            state = tree["params"]
        elif isinstance(tree, dict) and {"model", "optimizer", "step"} <= set(tree):
            state = tree["model"]
        else:
            raise ValueError(f"{path}: neither a {{'params': state_dict}} nor a TrainState checkpoint")
        model.load_state_dict(state, assign=True)
        left = [name for name, t in chain(model.named_parameters(), model.named_buffers()) if t.is_meta]
        if left:
            raise ValueError(f"from_checkpoint: {left} are still on the meta device after the load")
        kwargs.setdefault("example_shape", tuple(sample_input.shape[1:]))
        return cls(model, **kwargs)

    # -- buckets ----------------------------------------------------------

    def warmup(self):
        """Run every bucket that has not run yet (blocking)."""
        for b in self.batch_sizes:
            if b not in self._run:
                self._run_padded(torch.zeros((b, *self.example_shape), dtype=self.input_dtype, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @property
    def compiled_buckets(self):
        """The buckets run so far."""
        return tuple(sorted(self._run))

    def cost_analysis(self, bucket: Optional[int] = None) -> dict:
        """``{"flops": ...}`` of one forward at ``bucket`` (default the
        largest), see :func:`forward_flops`."""
        b = bucket or self.batch_sizes[-1]
        return {"flops": forward_flops(self.model, (b, *self.example_shape), self.input_dtype,
                                       apply_fn=self._apply)}

    # -- dispatch ---------------------------------------------------------

    def _bucket_for(self, k: int) -> int:
        for b in self.batch_sizes:
            if b >= k:
                return b
        return self.batch_sizes[-1]

    def _run_padded(self, x):
        """x.shape[0] <= largest bucket: pad up, run, slice back each tensor
        of the output (a tensor, or a tuple, list or dict of them; ``None``
        passes through), as the JAX ``jax.tree.map`` does."""
        k = x.shape[0]
        b = self._bucket_for(k)
        if k != b:
            pad = x.new_zeros((b - k, *self.example_shape))
            x = torch.cat([x, pad], dim=0)
        if self._layout is not None:
            x = self._layout.rows(x)
        with torch.inference_mode():
            out = self._apply(self.model, x)
            if self._layout is not None:
                out = self._layout.gather(out)
        self._run.add(b)
        return tree_map(lambda o: None if o is None else o[:k], out)

    def __call__(self, x):
        """Run inference on ``x`` of shape ``(k, *example_shape)``, any k;
        the chunks of a request above the largest bucket are joined tensor by
        tensor of the output."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.input_dtype)
        if tuple(x.shape[1:]) != self.example_shape:
            raise ValueError(f"expected (k, {self.example_shape}), got {tuple(x.shape)}")
        big = self.batch_sizes[-1]
        if x.shape[0] <= big:
            return self._run_padded(x)
        outs = [self._run_padded(x[i : i + big]) for i in range(0, x.shape[0], big)]
        return tree_map(lambda *os: None if os[0] is None else torch.cat(os, dim=0), *outs)


# ---------------------------------------------------------------------------
# Portable model artifacts (torch.export)
#
# The JAX package serialises a StableHLO program with a symbolic batch
# dimension.  The port exports ``(variables, images) -> outputs`` through
# ``torch.export``: one artifact serves every batch size the program's guards
# admit (on the card, the kernels' gates), can be loaded in a process that
# does not import the model code, and holds the PROGRAM only; parameters ship
# separately (checkpoints), so weight updates do not re-export.
# ---------------------------------------------------------------------------


class _Program(nn.Module):
    """``(variables, images) -> apply_fn(model, images)`` with the model's
    parameters and persistent buffers taken from ``variables`` by
    ``torch.func.functional_call``.  The model is held outside the module
    tree, so its own tensors are not lifted into the program; its
    non-persistent buffers enter as constants."""

    def __init__(self, model: nn.Module, apply_fn: Callable, constants: dict):
        super().__init__()
        self._held = (_Applied(model, apply_fn), constants)

    def forward(self, variables, images):
        applied, constants = self._held
        state = {f"model.{name}": t for name, t in chain(variables.items(), constants.items())}
        return torch.func.functional_call(applied, state, (images,))


def _platform_device(variables: dict, platforms: Optional[Sequence[str]]) -> torch.device:
    if platforms is None:
        first = next(iter(variables.values()), None)
        return first.device if first is not None else torch.device("cpu")
    platforms = tuple(platforms)
    if len(platforms) != 1 or platforms[0] not in ("cpu", "cuda"):
        raise ValueError(f"platforms must be ('cpu',) or ('cuda',), got {platforms}")
    return torch.device("cuda", 0) if platforms[0] == "cuda" else torch.device("cpu")


def export_model(
    model: nn.Module,
    variables,
    example_shape: Sequence[int],
    *,
    input_dtype: torch.dtype = torch.float32,
    batch_symbol: str = "b",
    platforms: Optional[Sequence[str]] = None,
    path: Optional[str] = None,
    apply_fn: Optional[Callable] = None,
    mesh=None,
    **apply_kwargs,
) -> bytes:
    """Serialise ``model(images)`` as a portable artifact: the program
    ``(variables, images) -> outputs`` through ``torch.export``.

    ``variables`` is the model's ``state_dict`` (or any dict of its
    parameters and persistent buffers), used only for its keys, shapes and
    dtypes: the artifact takes the parameters as a call argument, pairing
    with checkpoints.  Non-persistent buffers become constants of the
    program.

    The batch dimension is dynamic (``torch.export.Dim.DYNAMIC``), so the
    loaded program accepts every batch size its guards admit without
    re-export; on the card those are the kernels' gates (at most 65,535
    images, at most ``GEMM_MAX_ROWS`` token rows), which the loaded program
    checks at each call.  ``batch_symbol`` is the JAX function's name for
    that dimension; ``torch.export`` names its symbols itself, and the
    artifact records ``batch_symbol`` beside the program.

    ``platforms``: ``("cpu",)`` traces the plain composite, a run-anywhere
    artifact; ``("cuda",)`` traces the kernels, through the ops of
    ``vit_pytorch_tpu_torch.ops``.  Default: the device of ``variables``.
    The trace uses FakeTensors and launches nothing.

    ``apply_fn(model, images)`` replaces ``model(images, **apply_kwargs)``;
    ``apply_kwargs`` beside a custom ``apply_fn`` raise, as in JAX.

    ``mesh`` exports a MULTI-DEVICE serving artifact with the Predictor's
    layout baked in (parameters replicated, the batch split over the
    'data' axis): the program is the one each rank runs on its rows, and
    the artifact records the mesh beside it.  The batch is constrained to
    multiples of the data-axis size (``batch_symbol`` becomes
    ``"{ndata}*{batch_symbol}"``, as the JAX symbol does), and the artifact
    must be loaded with a mesh of as many devices (``load_model(...,
    mesh=...)``), which checks both at each call.

    Returns the serialised bytes; also writes ``path`` when given.
    """
    layout = {}
    if mesh is not None:
        ndata = _DataAxis(mesh).size
        batch_symbol = f"{ndata}*{batch_symbol}" if ndata > 1 else batch_symbol
        layout = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "devices": mesh.size()}
        if platforms is None and mesh.device_type in ("cpu", "cuda"):
            platforms = (mesh.device_type,)
    if apply_fn is None:
        def apply_fn(m, images):
            return m(images, **apply_kwargs)
    elif apply_kwargs:
        raise ValueError(
            f"apply_kwargs {sorted(apply_kwargs)} are folded into the DEFAULT "
            "apply_fn — with a custom apply_fn, bake them into it instead"
        )
    variables = dict(variables)
    device = _platform_device(variables, platforms)
    constants = {name: buf.to(device) for name, buf in _non_persistent(model).items()}
    with FakeTensorMode() as mode:
        fake_vars = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in variables.items()}
        fake_images = torch.empty((2, *tuple(example_shape)), dtype=input_dtype, device=device)
    del mode
    program = _Program(model, apply_fn, constants)
    with torch.no_grad():
        exported = torch.export.export(
            program, (fake_vars, fake_images), strict=False,
            dynamic_shapes=({k: None for k in fake_vars}, {0: torch.export.Dim.DYNAMIC}),
        )
    exported.example_inputs = None  # FakeTensors; the artifact carries no data
    ops = sorted({node.target.name() for node in exported.graph.nodes
                  if isinstance(node.target, torch._ops.OpOverload) and node.target.namespace == _OPS_NAMESPACE})
    meta = {"variables": list(fake_vars), "batch_symbol": batch_symbol, "ops": ops, **layout}
    buf = io.BytesIO()
    torch.export.save(exported, buf, extra_files={_ARTIFACT_META: json.dumps(meta)})
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def _artifact_meta(blob: bytes) -> dict:
    """The metadata ``export_model`` stores beside the program (an extra
    file of the ``.pt2`` zip archive), read before the program is."""
    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        name = next((n for n in archive.namelist() if n.endswith(f"/extra/{_ARTIFACT_META}")), None)
        if name is None:
            raise ValueError("not an export_model artifact: no metadata in the archive")
        return json.loads(archive.read(name))


def _registered(qualified: str) -> bool:
    namespace, name = qualified.split("::")
    try:
        getattr(getattr(torch.ops, namespace), name.split(".")[0])
    except AttributeError:
        return False
    return True


def load_model(blob_or_path, *, mesh=None) -> Callable:
    """Load an :func:`export_model` artifact; returns ``fn(variables,
    images) -> outputs`` (any batch size the program admits).

    Accepts the raw bytes or a filesystem path (``str`` or ``PathLike``).
    No model code is imported.  An artifact traced on the card calls the
    port's kernel ops: the process must have imported
    ``vit_pytorch_tpu_torch.ops``, which registers them, else loading
    raises naming that module.

    An artifact exported with a mesh must be loaded with a mesh of the same
    device count, and one exported without with none (or one of a single
    device); ``fn`` is then called on every rank with the whole batch, a
    multiple of the data-axis size, runs this rank's rows and returns the
    whole output, gathered over 'data', matching the layout baked in at
    export.
    """
    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(blob_or_path)
    meta = _artifact_meta(blob)
    devices = meta.get("devices", 1)
    if mesh is not None and mesh.size() != devices:
        raise ValueError(f"artifact was exported for {devices} devices; the given mesh has {mesh.size()}")
    if mesh is None and devices > 1:
        raise ValueError(f"artifact was exported for {devices} devices — pass load_model(..., mesh=...) with an "
                         f"equal-size mesh")
    missing = [name for name in meta["ops"] if not _registered(name)]
    if missing:
        raise RuntimeError(f"the artifact calls the port's kernel ops {missing}, which are not registered: import "
                           f"vit_pytorch_tpu_torch.ops before load_model")
    keys = meta["variables"]
    program = torch.export.load(io.BytesIO(blob)).module()

    layout = None if mesh is None else _DataAxis(mesh)

    def fn(variables, images):
        missing = set(keys) - set(variables)
        if missing:
            raise KeyError(f"load_model: variables lack {sorted(missing)}")
        if layout is None:
            return program({k: variables[k] for k in keys}, images)
        return layout.gather(program({k: variables[k] for k in keys}, layout.rows(images)))

    return fn
