"""One rank of a gloo CPU world for the port's mesh tests
(tests/torch_mesh_world.py starts them):

    python tests/torch_mesh_worker.py <scenario> <rank> <world> <directory>

Each scenario runs every check of one test module on this rank and writes
``<directory>/result_<rank>.pt``, a dict of check name -> result, where a
check that raised holds ``{"error": traceback}``; the tests assert on the
results, one test a check.  Inputs (weights, batches) come from
``<directory>/inputs.pt``, written by the test process from a numpy seed
and the JAX package's init.  The ranks join through a file store in the
directory: no ports.  Nothing here imports JAX."""

import functools
import os
import sys
import traceback
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

from vit_pytorch_tpu_torch import SimpleViT, ViT  # noqa: E402
from vit_pytorch_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from vit_pytorch_tpu_torch.parallel import train as port_train  # noqa: E402

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def spec_of(t) -> tuple:
    """The spec (mesh axis or None per tensor dim, trailing Nones dropped)
    that a tensor's realized layout means: a DTensor's placements on its
    mesh's named axes; a plain tensor is whole."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return ()
    spec = [None] * t.ndim
    for axis, placement in zip(t.device_mesh.mesh_dim_names, t.placements):
        if placement.is_shard():
            spec[placement.dim] = axis
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def full(t) -> torch.Tensor:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def join(rank, world, directory):
    return port_mesh.initialize_distributed(num_processes=world, process_id=rank, backend="gloo",
                                            init_method=f"file://{os.path.join(directory, 'store')}")


def optimizer(kind):
    if kind == "sgd":
        return functools.partial(torch.optim.SGD, lr=1e-2)
    return functools.partial(torch.optim.Adam, lr=1e-3)


def vit(inputs, key="state_dict", kw="kw"):
    model = ViT(**inputs[kw], device="cpu")
    model.load_state_dict(inputs[key])
    return model


# -- test_torch_mesh.py ------------------------------------------------------


@scenario
def mesh(rank, world, directory, inputs, out):
    def raises(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the type and message are the result
            return type(e).__name__, str(e)
        return None

    out["larger_mesh_without_a_group"] = raises(lambda: port_mesh.make_mesh(2, 1, device_type="cpu"))
    one = port_mesh.make_mesh(1, 1, device_type="cpu")
    out["world_of_one"] = (torch.distributed.get_world_size(), torch.distributed.get_backend(), tuple(one.shape),
                           one.mesh_dim_names, one.device_type)
    torch.distributed.destroy_process_group()
    out["initialize"] = join(rank, world, directory)
    out["initialize_again"] = port_mesh.initialize_distributed()
    out["default"] = tuple(port_mesh.make_mesh(device_type="cpu").shape)
    out["model_2"] = tuple(port_mesh.make_mesh(model=2, device_type="cpu").shape)
    out["fallback"] = (lambda m: (tuple(m.shape), m.device_type))(port_mesh.make_mesh(allow_cpu_fallback=True))
    out["no_card"] = raises(lambda: port_mesh.make_mesh())
    out["no_card_sized"] = raises(lambda: port_mesh.make_mesh(2, 1))
    out["too_many"] = raises(lambda: port_mesh.make_mesh(data=4, device_type="cpu"))
    out["too_wide"] = raises(lambda: port_mesh.make_mesh(model=3, device_type="cpu"))
    out["over_the_devices"] = raises(lambda: port_mesh.make_mesh(data=2, model=2, devices=[0, 1],
                                                                 device_type="cpu"))
    sub = port_mesh.make_mesh(data=1, devices=[1], device_type="cpu")
    out["subset"] = (tuple(sub.shape), sub.mesh.tolist())
    m = port_mesh.make_mesh(2, 1, device_type="cpu")
    local = torch.arange(6.0).reshape(3, 2) + 10 * rank
    g = port_mesh.global_array_from_process_local({"x": local}, m)["x"]
    out["global_array"] = (tuple(g.shape), str(g.placements), full(g))


# -- test_torch_parallel.py --------------------------------------------------

PARALLEL_CASES = {
    # name: (mesh shape, fsdp, optimizer, grad_accum)
    "dp": ((4, 1), False, "sgd", 1),
    "tp": ((2, 2), False, "sgd", 1),
    "fsdp": ((2, 2), True, "adam", 1),
    "accum": ((4, 1), False, "sgd", 2),
    "tp_adam": ((2, 2), False, "adam", 1),
    "fsdp_dp": ((4, 1), True, "adam", 1),
}


@scenario
def parallel(rank, world, directory, inputs, out):
    join(rank, world, directory)
    images, labels = inputs["images"], inputs["labels"]
    for name, (shape, fsdp, opt, accum) in PARALLEL_CASES.items():
        try:
            mesh = port_mesh.make_mesh(*shape, device_type="cpu")
            model = vit(inputs)
            state = port_train.shard_train_state(port_train.create_train_state(model, optimizer(opt)), mesh,
                                                 fsdp=fsdp, fsdp_min_size=512)
            step = port_train.make_sharded_train_step(model, mesh, grad_accum=accum)
            metrics = step(state, images, labels)
            params = dict(model.named_parameters())
            moments = {}
            for n, p in params.items():
                st = state.optimizer.state.get(p, {})
                moments[n] = {k: (spec_of(v), isinstance(v, torch.Tensor) and getattr(v, "placements", None)
                                  == getattr(p, "placements", None)
                                  and getattr(v, "device_mesh", None) == getattr(p, "device_mesh", None))
                              for k, v in st.items() if isinstance(v, torch.Tensor) and v.ndim}
            out[name] = {
                "loss": float(metrics["loss"]), "accuracy": float(metrics["accuracy"]),
                "params": {n: full(p) for n, p in params.items()},
                "specs": {n: spec_of(p) for n, p in params.items()},
                "moments": moments,
                "step_counts": sorted({str(type(v).__name__) for st in state.optimizer.state.values()
                                       for k, v in st.items() if k == "step"}),
            }
            if name == "tp":
                out["gates"] = gates(model)
        except Exception:  # noqa: BLE001
            out[name] = {"error": traceback.format_exc()}


def gates(model):
    """The kernel gates of a TP-sharded ViT with the device test taken as
    true: the whole-layer and attention-block predicates must refuse its
    DTensor weights (plain x, DTensor x)."""
    from torch.distributed.tensor import DTensor, Replicate

    from vit_pytorch_tpu_torch.nn import blocks
    from vit_pytorch_tpu_torch.ops import fused_block

    saved = blocks.on_cuda, blocks.whole_layer_supported, blocks.fused_block_supported
    blocks.on_cuda = lambda x: True
    blocks.whole_layer_supported = lambda *a, **k: True
    blocks.fused_block_supported = lambda *a, **k: True
    try:
        x = torch.zeros(2, 17, model.dim)
        xd = DTensor.from_local(x, model.transformer.layers[0][0].to_qkv.weight.device_mesh, [Replicate()])
        attn = model.transformer.layers[0][0]
        plain = ViT(**{"image_size": 32, "patch_size": 8, "num_classes": 5, "dim": 32, "depth": 1, "heads": 2,
                       "dim_head": 16, "mlp_dim": 64}, device="cpu")
        return {
            "whole_layer": [model.transformer.whole_layer_eligible(x), model.transformer.whole_layer_eligible(xd)],
            "block": [attn.fuses(x), attn.fuses(xd)],
            "plain_model": [plain.transformer.whole_layer_eligible(x), plain.transformer.layers[0][0].fuses(x)],
            "fused_block_module": fused_block.__name__,
        }
    finally:
        blocks.on_cuda, blocks.whole_layer_supported, blocks.fused_block_supported = saved


# -- test_torch_multihost.py -------------------------------------------------


@scenario
def multihost(rank, world, directory, inputs, out):
    from vit_pytorch_tpu_torch.utils.data import prefetch_to_device, process_local_slice

    out["initialize"] = join(rank, world, directory)
    out["initialize_again"] = port_mesh.initialize_distributed()  # idempotent: a no-op, not a crash
    mesh = port_mesh.make_mesh(data=4, model=1, device_type="cpu")
    model = vit(inputs)
    state = port_train.shard_train_state(port_train.create_train_state(model, optimizer("adam")), mesh)
    step = port_train.make_sharded_train_step(model, mesh)
    X, Y = inputs["images"], inputs["labels"]
    local = process_local_slice({"x": X, "y": Y})
    out["local_rows"] = local["x"].shape[0]
    b = next(prefetch_to_device(iter([local]), mesh=mesh))
    out["global_shape"] = (tuple(b["x"].shape), str(b["x"].placements), full(b["x"]), full(b["y"]))
    metrics = step(state, b["x"], b["y"])
    out["loss"] = float(metrics["loss"])
    out["params"] = {n: full(p) for n, p in model.named_parameters()}

    grid = port_mesh.make_mesh(data=2, model=2, device_type="cpu")
    rows = process_local_slice({"y": torch.arange(8)}, mesh=grid)["y"]
    out["grid_rows"] = (grid.get_local_rank("data"), grid.get_local_rank("model"), rows.tolist())
    placed = next(prefetch_to_device(iter([{"y": rows}]), mesh=grid))["y"]
    out["grid_global"] = (tuple(placed.shape), str(placed.placements), full(placed).tolist())
    # the global batch handed to the sharded step on a (2, 2) mesh: model-axis
    # peers take the same rows
    model2 = vit(inputs)
    state2 = port_train.shard_train_state(port_train.create_train_state(model2, optimizer("adam")), grid)
    out["grid_loss"] = float(port_train.make_sharded_train_step(model2, grid)(state2, X, Y)["loss"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        idle = port_mesh.make_mesh(model=3, device_type="cpu")
    out["idle"] = (tuple(idle.shape), idle.mesh.tolist(), [str(w.message) for w in caught])


# -- serving, export, data ---------------------------------------------------


@scenario
def serving(rank, world, directory, inputs, out):
    from vit_pytorch_tpu_torch.serving import Predictor

    join(rank, world, directory)
    mesh = port_mesh.make_mesh(2, 1, device_type="cpu")
    model = vit(inputs)
    x = inputs["images"]
    single = Predictor(model, example_shape=tuple(x.shape[1:]), batch_sizes=(2, 4), param_dtype=torch.float32,
                       device="cpu")
    sharded = Predictor(model, example_shape=tuple(x.shape[1:]), batch_sizes=(2, 4), param_dtype=torch.float32,
                        mesh=mesh)
    out["buckets"] = sharded.compiled_buckets
    out["logits"] = {k: (single(x[:k]), sharded(x[:k])) for k in (1, 3, 4, 7)}
    try:
        Predictor(model, example_shape=tuple(x.shape[1:]), batch_sizes=(3,), mesh=mesh, aot=False)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    simple = SimpleViT(**inputs["simple_kw"], device="cpu")
    simple.load_state_dict(inputs["simple_state_dict"])
    p = Predictor(simple, example_shape=tuple(x.shape[1:]), batch_sizes=(4,), param_dtype=torch.float32, mesh=mesh)
    with torch.no_grad():
        out["simple"] = (p(x[:4]), simple(x[:4]))


@scenario
def export(rank, world, directory, inputs, out):
    from vit_pytorch_tpu_torch.serving import export_model, load_model

    join(rank, world, directory)
    mesh = port_mesh.make_mesh(2, 1, device_type="cpu")
    model = vit(inputs).eval()
    variables = model.state_dict()
    blob = export_model(model, variables, (3, 32, 32), mesh=mesh, path=os.path.join(directory, f"mesh{rank}.pt2"))
    fn = load_model(os.path.join(directory, f"mesh{rank}.pt2"), mesh=mesh)
    x = inputs["images"]
    with torch.no_grad():
        out["served"] = {k: (fn(variables, x[:k]), model(x[:k])) for k in (2, 4, 6)}

    def error(call):
        try:
            call()
        except ValueError as e:
            return str(e)
        return None

    out["odd_batch"] = error(lambda: fn(variables, x[:3]))
    out["single_device_load"] = error(lambda: load_model(blob))
    one = port_mesh.make_mesh(data=1, devices=[rank], device_type="cpu")
    out["smaller_mesh_load"] = error(lambda: load_model(blob, mesh=one))
    plain = export_model(model, variables, (3, 32, 32))
    out["plain_on_a_mesh"] = error(lambda: load_model(plain, mesh=mesh))
    out["plain_on_one"] = load_model(plain, mesh=one) is not None
    from vit_pytorch_tpu_torch.serving import _artifact_meta

    out["meta"] = _artifact_meta(blob)


@scenario
def data(rank, world, directory, inputs, out):
    from vit_pytorch_tpu_torch.utils.data import minibatches, prefetch_to_device, process_local_slice

    join(rank, world, directory)
    mesh = port_mesh.make_mesh(2, 1, device_type="cpu")
    host = inputs["data"]
    batches = list(prefetch_to_device((process_local_slice(b, mesh=mesh) for b in minibatches(host, 8)),
                                      mesh=mesh))
    out["mesh"] = [{k: (tuple(v.shape), str(v.placements), full(v)) for k, v in b.items()} for b in batches]
    sharding = {"images": port_mesh.batch_sharding(mesh), "labels": port_mesh.replicated(mesh)}
    got = list(prefetch_to_device(
        ({"images": process_local_slice(b, mesh=mesh)["images"], "labels": b["labels"]}
         for b in minibatches(host, 8)), sharding=sharding, host_workers=True))
    out["sharding"] = [{k: (tuple(v.shape), str(v.placements), full(v)) for k, v in b.items()} for b in got]


# -- test_torch_checkpoint.py ------------------------------------------------


def _full_state(state):
    """Every tensor of a TrainState gathered whole, by name."""
    from vit_pytorch_tpu_torch.utils.checkpoint import _tree

    tree = _tree(state)
    return {
        "model": {k: full(v) for k, v in tree["model"].items()},
        "optimizer": {n: {k: full(v) for k, v in m.items()} for n, m in tree["optimizer"]["state"].items()},
        "step": tree["step"],
    }


@scenario
def checkpoint(rank, world, directory, inputs, out):
    from vit_pytorch_tpu_torch.utils.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint

    join(rank, world, directory)
    images, labels = inputs["images"], inputs["labels"]
    fsdp = port_mesh.make_mesh(2, 1, device_type="cpu")
    model = vit(inputs)
    state = port_train.shard_train_state(port_train.create_train_state(model), fsdp, fsdp=True, fsdp_min_size=512)
    port_train.make_sharded_train_step(model, fsdp)(state, images, labels)
    out["fsdp_specs"] = {n: spec_of(p) for n, p in model.named_parameters()}
    out["saved"] = _full_state(state)
    save_checkpoint(os.path.join(directory, "fsdp"), state)
    out["committed"] = sorted(os.listdir(os.path.join(directory, "fsdp")))

    # into a (1, 2) tensor-parallel layout
    tp = port_mesh.make_mesh(1, 2, device_type="cpu")
    model_tp = vit(inputs)
    state_tp = port_train.shard_train_state(port_train.create_train_state(model_tp), tp)
    restore_checkpoint(os.path.join(directory, "fsdp"), state_tp)
    out["tp_specs"] = {n: spec_of(p) for n, p in model_tp.named_parameters()}
    out["into_tp"] = _full_state(state_tp)
    # it trains on from there as the FSDP state does
    m1 = port_train.make_sharded_train_step(model, fsdp)(state, images, labels)
    m2 = port_train.make_sharded_train_step(model_tp, tp)(state_tp, images, labels)
    out["next_losses"] = (float(m1["loss"]), float(m2["loss"]))

    # one device (written by the test process) into the FSDP layout
    model_in = vit(inputs)
    state_in = port_train.shard_train_state(port_train.create_train_state(model_in), fsdp, fsdp=True,
                                            fsdp_min_size=512)
    restore_checkpoint(os.path.join(directory, "single"), state_in)
    out["into_fsdp"] = _full_state(state_in)

    # a dict of DTensors restores into placed targets
    tree = {"w": state.model.pos_embedding, "n": 3}
    save_checkpoint(os.path.join(directory, "tree"), tree)
    like = model_tp.pos_embedding
    target = {"w": torch.distributed.tensor.zeros(tuple(like.shape), device_mesh=like.device_mesh,
                                                  placements=like.placements), "n": 0}
    back = restore_checkpoint(os.path.join(directory, "tree"), target)
    out["tree"] = (str(back["w"].placements), torch.equal(full(back["w"]), full(state.model.pos_embedding)),
                   back["n"])

    # the manager: async saves of DTensors, committed by rank 0, seen by all
    with CheckpointManager(os.path.join(directory, "managed"), max_to_keep=1) as mgr:
        mgr.save(1, state)
        mgr.save(2, state)
        mgr.wait_until_finished()
        out["manager"] = (mgr.latest_step(), list(mgr.all_steps()))


def main():
    name, rank, world, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    out: dict = {}
    try:
        SCENARIOS[name](rank, world, directory, inputs, out)
    except Exception:  # noqa: BLE001 — recorded; the checks that ran before it still count
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(directory, f"result_{rank}.pt"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
