"""Start a gloo CPU world of the port's mesh tests and read its results
(imported by path by the test_torch_* modules that need one).

Each test module starts one world, whose ranks run every check of the
module (tests/torch_mesh_worker.py) and write their results; the tests then
assert on those, one test a check.  The ranks join through a file store in
a temporary directory (no ports, no collisions between pytest-xdist
workers), see no card, run one thread each, and the world has a time limit
of its own."""

import os
import subprocess
import sys

import torch

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
TIMEOUT = 300  # seconds, for the whole world


def run_world(directory, scenario: str, world: int, inputs: dict) -> list:
    """Run ``scenario`` on ``world`` ranks; the list of the ranks' result
    dicts (read them with :func:`check`).  Raises with every rank's output
    when a rank crashes or the world outlives its limit."""
    directory = str(directory)
    torch.save(inputs, os.path.join(directory, "inputs.pt"))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, scenario, str(rank), str(world), directory], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = "\n".join(f"--- rank {rank} (exit {p.returncode}) ---\n{out}" for rank, (p, out) in
                     enumerate(zip(procs, outs)))
    if any(p.returncode for p in procs):
        raise RuntimeError(f"the {scenario} world failed:\n{logs}")
    return [torch.load(os.path.join(directory, f"result_{rank}.pt"), weights_only=False) for rank in range(world)]


def check(result, name: str):
    """The result of check ``name``, raising its error if it raised or if
    the scenario stopped before it."""
    if name not in result:
        raise AssertionError(f"{name} did not run: the scenario stopped before it:\n{result.get('error')}")
    value = result[name]
    if isinstance(value, dict) and "error" in value:
        raise AssertionError(f"{name} raised in the world:\n{value['error']}")
    return value


def trim(spec) -> tuple:
    """A spec without its trailing Nones."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def port_spec(jax_spec, ndim: int, kernel: bool) -> tuple:
    """A JAX PartitionSpec over the JAX layout, on torch's: a Dense or Conv
    kernel (in, out) / (*k, in, out) is the weight (out, in) / (out, in,
    *k), as ``utils/from_jax.py`` transposes it."""
    axes = [*jax_spec, *[None] * (ndim - len(tuple(jax_spec)))]
    if kernel and ndim >= 2:
        axes = [axes[j] for j in (ndim - 1, ndim - 2, *range(ndim - 2))]
    return trim(axes)


def jax_specs_by_port_name(shardings, params, modules, top_level) -> dict:
    """``{port parameter name: spec on torch's layout}`` of a JAX
    ``infer_param_shardings*`` tree, named through the converter's
    tables."""
    from flax.traverse_util import flatten_dict

    from vit_pytorch_tpu_torch.utils.from_jax import _torch_key

    flat = flatten_dict(params)
    out = {}
    for key, sharding in flatten_dict(shardings).items():
        path = "/".join(key)
        out[_torch_key(path, modules, top_level)] = port_spec(tuple(sharding.spec), len(flat[key].shape),
                                                              key[-1] == "kernel")
    return out


def drop_unit_axes(spec, sizes: dict) -> tuple:
    """``spec`` without the mesh axes of size 1, which hold the whole dim
    either way."""
    return trim(a if a is not None and sizes[a] > 1 else None for a in spec)
