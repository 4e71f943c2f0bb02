"""The port's input pipeline (vit_pytorch_tpu_torch/utils/data.py) on the
CPU: ``minibatches`` and ``process_local_slice`` give exactly the JAX
functions' rows for the same seeds and indices; ``prefetch_to_device``
keeps the stream's order at each depth with and without the host thread,
forwards producer errors, stops its thread when the stream is abandoned
and validates eagerly.  The pinned-memory copy path runs on the card only
(``cuda``).

Placement over a mesh (tests/test_data_pipeline.py:80-95) runs in a gloo
world of 2 CPU processes (tests/torch_mesh_world.py) on a (2, 1) mesh:
each rank's ``process_local_slice(mesh=)`` of every global batch becomes a
DTensor of the global shape sharded on 'data', through ``mesh=`` and
through a ``sharding=`` pytree, and the batches hold the stream's rows in
order."""

import gc
import os
import sys
import threading

import numpy as np
import pytest
import torch

from vit_pytorch_tpu.utils.data import minibatches as jax_minibatches
from vit_pytorch_tpu.utils.data import process_local_slice as jax_process_local_slice
from vit_pytorch_tpu_torch.utils.data import minibatches, prefetch_to_device, process_local_slice

THREAD = "vit-torch-host-prefetch"


def _data(n=20):
    return {
        "images": np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3),
        "labels": np.arange(n, dtype=np.int32),
    }


def _rows(batches):
    return [np.asarray(b["labels"]).tolist() for b in batches]


@pytest.mark.parametrize("seed", [None, 0, (1, 3)])
@pytest.mark.parametrize("batch_size,drop_last", [(8, True), (8, False), (5, True), (1, True)])
def test_minibatches_match_jax(seed, batch_size, drop_last):
    data = _data()
    rng = lambda: None if seed is None else np.random.default_rng(seed)  # noqa: E731
    want = list(jax_minibatches(data, batch_size, rng=rng(), drop_last=drop_last))
    got = list(minibatches(data, batch_size, rng=rng(), drop_last=drop_last))
    assert _rows(got) == _rows(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])


def test_minibatches_of_tensors_match_numpy():
    data = _data()
    tensors = {k: torch.from_numpy(v) for k, v in data.items()}
    got = list(minibatches(tensors, 6, rng=np.random.default_rng(4)))
    want = list(minibatches(data, 6, rng=np.random.default_rng(4)))
    assert _rows(got) == _rows(want)
    assert all(isinstance(b["images"], torch.Tensor) for b in got)


def test_minibatches_rejects_misaligned_leaves_and_bad_size():
    with pytest.raises(ValueError, match="leading dims"):
        next(minibatches({"a": np.zeros((4, 2)), "b": np.zeros((5,))}, 2))
    with pytest.raises(ValueError, match="batch_size"):
        next(minibatches(_data(), 0))


def test_minibatches_unshuffled_yields_views():
    data = {"x": np.arange(32, dtype=np.float32).reshape(8, 4)}
    batch = next(minibatches(data, 4))
    assert np.shares_memory(batch["x"], data["x"])
    t = {"x": torch.arange(32.0).reshape(8, 4)}
    view = next(minibatches(t, 4))["x"]
    assert view._is_view() and view.untyped_storage().data_ptr() == t["x"].untyped_storage().data_ptr()


@pytest.mark.parametrize("index,count", [(0, 1), (0, 4), (3, 4), (1, 2)])
def test_process_local_slice_matches_jax(index, count):
    data = _data(16)
    want = jax_process_local_slice(data, process_index=index, process_count=count)
    got = process_local_slice(data, process_index=index, process_count=count)
    assert got["labels"].tolist() == want["labels"].tolist()
    np.testing.assert_array_equal(got["images"], want["images"])


def test_process_local_slice_defaults_and_errors():
    data = _data(10)
    assert process_local_slice(data) is data  # no process group: one process
    with pytest.raises(ValueError, match="divide"):
        process_local_slice(data, process_index=0, process_count=3)


@pytest.mark.parametrize("host_workers", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_preserves_stream(depth, host_workers):
    data = _data(40)
    host = list(minibatches(data, 8, rng=np.random.default_rng(2)))
    out = list(prefetch_to_device(iter(host), depth=depth, host_workers=host_workers, device="cpu"))
    assert len(out) == len(host)
    for got, want in zip(out, host):
        assert isinstance(got["images"], torch.Tensor) and got["images"].device.type == "cpu"
        np.testing.assert_array_equal(got["images"].numpy(), want["images"])
        assert got["labels"].tolist() == want["labels"].tolist()


def test_prefetch_empty_iterator():
    assert list(prefetch_to_device(iter([]), device="cpu")) == []
    assert list(prefetch_to_device(iter([]), device="cpu", host_workers=True)) == []


@pytest.mark.parametrize("host_workers", [False, True])
def test_prefetch_propagates_producer_errors(host_workers):
    def broken():
        yield {"x": np.zeros((2,))}
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(prefetch_to_device(broken(), depth=2, host_workers=host_workers, device="cpu"))


def test_prefetch_host_thread_stops_when_abandoned():
    """A consumer that stops early must not leave the producer thread
    blocked on a full queue pinning batches for the process lifetime."""
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield {"x": np.full((4,), i, dtype=np.float32)}

    stream = prefetch_to_device(gen(), depth=2, host_workers=True, device="cpu")
    assert next(stream)["x"][0] == 0
    assert next(stream)["x"][0] == 1
    threads = [t for t in threading.enumerate() if t.name == THREAD]
    stream.close()
    del stream
    gc.collect()
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive(), "producer thread still running after the consumer left"
    assert len(produced) < 1000, "producer drained the whole stream anyway"


def test_prefetch_validates_eagerly():
    """Bad arguments raise at call time, not at the first next()."""
    with pytest.raises(ValueError, match="depth"):
        prefetch_to_device(iter([]), depth=0, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        prefetch_to_device(iter([]), mesh=object(), sharding=object(), device="cpu")


def test_prefetch_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch_to_device(iter([]))


def test_prefetch_feeds_a_step():
    """End to end on the CPU: a step consumes the prefetched stream and sees
    every row exactly once."""
    data = _data(32)
    total = 0
    for batch in prefetch_to_device(minibatches(data, 8, rng=np.random.default_rng(0)), depth=2, device="cpu",
                                    host_workers=True):
        total += int(batch["labels"].sum())
    assert total == sum(range(32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned copies and the copy stream run on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("host_workers", [False, True])
def test_prefetch_to_card_checksums(card, host_workers):
    """50 distinct batches at depth 3, each read on the card by a reduction
    as soon as it is yielded and then dropped: every checksum equals its host
    batch's."""
    rng = np.random.default_rng(0)
    host = [{"x": rng.integers(0, 1000, (64, 257)).astype(np.int64)} for _ in range(50)]
    sums = [int(t["x"].sum()) for t in prefetch_to_device(iter(host), depth=3, device=card,
                                                          host_workers=host_workers)]
    assert sums == [int(b["x"].sum()) for b in host]


def test_minibatches_gather_keeps_every_kind_of_leaf():
    """The shuffled batches hold the selected rows of every kind of leaf:
    numeric, Fortran-ordered, read-only and strings (file names)."""
    a = np.arange(60, dtype=np.float32).reshape(20, 3)
    read_only = np.arange(20, dtype=np.int64)
    read_only.flags.writeable = False
    data = {"a": a, "strided": np.asfortranarray(a), "read_only": read_only,
            "names": np.array([f"img{i}.png" for i in range(20)])}
    got = list(minibatches(data, 6, rng=np.random.default_rng(7)))
    order = np.arange(20)
    np.random.default_rng(7).shuffle(order)
    for i, batch in enumerate(got):
        sel = order[6 * i : 6 * (i + 1)]
        for key, leaf in data.items():
            assert isinstance(batch[key], np.ndarray) and batch[key].dtype == leaf.dtype
            np.testing.assert_array_equal(batch[key], leaf[sel])


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_world as world

    return world, world.run_world(tmp_path_factory.mktemp("data"), "data", 2, {"data": _data(16)})


def test_prefetch_mesh_places_batch_on_data_axis(mesh_ranks):
    world, ranks = mesh_ranks
    data = _data(16)
    for r in ranks:
        batches = world.check(r, "mesh")
        assert len(batches) == 2
        for b in batches:
            for shape, placements, _ in b.values():
                assert shape[0] == 8 and placements == "(Shard(dim=0), Replicate())"
        got = np.concatenate([b["labels"][2].numpy() for b in batches])
        np.testing.assert_array_equal(got, np.arange(16))
        np.testing.assert_array_equal(np.concatenate([b["images"][2].numpy() for b in batches]), data["images"])


def test_prefetch_sharding_pytree(mesh_ranks):
    """A pytree of shardings: the images sharded on 'data' (each rank's
    rows), the labels replicated (every rank holds the whole batch's)."""
    world, ranks = mesh_ranks
    for r in ranks:
        batches = world.check(r, "sharding")
        assert [b["images"][:2] for b in batches] == [((8, 2, 3), "(Shard(dim=0), Replicate())")] * 2
        assert [b["labels"][:2] for b in batches] == [((8,), "(Replicate(), Replicate())")] * 2
        np.testing.assert_array_equal(np.concatenate([b["labels"][2].numpy() for b in batches]), np.arange(16))
