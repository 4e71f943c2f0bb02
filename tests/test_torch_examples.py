"""The port's example scripts (vit_pytorch_tpu_torch/examples/) and the
training half of its tuning tool (tools/bench_fused_tuning.py::tune_train)
against the JAX package on the CPU, fp32, at narrow widths.

Each training example's step is held against the JAX package's own
functions (not the JAX scripts, which fix their widths): the same weights
(the JAX init, carried over by ``utils/from_jax.py``), the same numpy
batches, the same masks, views and sampled tokens.  Tolerances: the loss
within 5e-5 absolute and 1e-4 relative (the port's fp32 parity bar);
after an optimizer step, the parameters whose gradient is well above
Adam's eps within 1e-6 of JAX's and every parameter within 2 lr of it
(Adam's first step is ~lr * sign(g), as tests/test_torch_na_vit.py holds
it); after a digits epoch every parameter within 5e-5 + 1e-4 relative.

The digits data is read from the port's copy and held bit for bit to the
JAX script's ``load_data`` (through scikit-learn).  The digits resume is
bitwise; ``tune_train``'s three modes are bitwise one another on the
composite, and the ``dots_saveable`` policy is counted by a
``TorchDispatchMode`` on the backward's matmuls."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from vit_pytorch_tpu import ViT as JaxViT
from vit_pytorch_tpu.models import vit_with_decorr as j_decorr
from vit_pytorch_tpu.models.na_vit import NaViT as JaxNaViT
from vit_pytorch_tpu.ops.packing import pack_images as jax_pack_images
from vit_pytorch_tpu.parallel import mesh as jax_mesh
from vit_pytorch_tpu.parallel import train as jax_train
from vit_pytorch_tpu.ssl.dino import Dino as JaxDino
from vit_pytorch_tpu.ssl.dino import dino_forward
from vit_pytorch_tpu.ssl.mae import MAE as JaxMAE
from vit_pytorch_tpu_torch.examples import (
    pretrain_dino,
    pretrain_mae,
    serve_vit,
    train_digits,
    train_navit_packed,
    train_vit_decorr,
)
from vit_pytorch_tpu_torch.models import vit_with_decorr
from vit_pytorch_tpu_torch.models.vit import ViT
from vit_pytorch_tpu_torch.nn import blocks
from vit_pytorch_tpu_torch.tools import bench_fused_tuning as tuning
from vit_pytorch_tpu_torch.utils import from_jax

ATOL, RTOL = 5e-5, 1e-4
CPU = torch.device("cpu")
EXAMPLES = [serve_vit, train_digits, train_navit_packed, pretrain_mae, pretrain_dino, train_vit_decorr]

# the JAX scripts' widths, as they write them
JAX_CONFIGS = {
    # examples/serve_vit.py:33-41
    serve_vit: dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=12, mlp_dim=3072),
    # examples/train_digits.py:62-74
    train_digits: dict(image_size=8, patch_size=2, num_classes=10, dim=64, depth=4, heads=4, dim_head=16,
                       mlp_dim=128, channels=1, dropout=0.1, emb_dropout=0.1),
    # examples/train_navit_packed.py:45-54
    train_navit_packed: dict(image_size=256, patch_size=16, num_classes=100, dim=384, depth=6, heads=6,
                             mlp_dim=1536, token_dropout_prob=0.1),
    # examples/pretrain_mae.py:25-30 (the encoder, then the MAE)
    pretrain_mae: dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=12, mlp_dim=3072,
                       pool="mean", decoder_dim=512, masking_ratio=0.75, decoder_depth=4, decoder_heads=8),
    # examples/pretrain_dino.py:28-36 (the net, then the Dino; image_size 96 in both)
    pretrain_dino: dict(image_size=96, patch_size=16, num_classes=1000, dim=384, depth=6, heads=6, mlp_dim=1536,
                        num_classes_K=4096, projection_hidden_size=512, projection_layers=3),
    # examples/train_vit_decorr.py:60-71
    train_vit_decorr: dict(image_size=32, patch_size=4, num_classes=100, dim=256, depth=6, heads=8, mlp_dim=512,
                           dropout=0.1, emb_dropout=0.1, decorr_sample_frac=0.25),
}


@pytest.mark.parametrize("module", EXAMPLES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_config_is_the_jax_scripts(module):
    assert module.CONFIG == JAX_CONFIGS[module]


def test_script_constants_are_the_jax_scripts():
    """Batches, buckets, requests, learning rates (optax's adamw weight decay
    1e-4), packing: examples/serve_vit.py:29, :56, :72;
    train_navit_packed.py:29, :31, :59, :69-70, :98; pretrain_mae.py:38, :52;
    pretrain_dino.py:41, :58."""
    assert serve_vit.BUCKETS == (1, 8, 32, 128) and serve_vit.REQUESTS == (1, 5, 8, 32, 100, 128)
    assert serve_vit.OVERSIZE == 300
    assert train_navit_packed.MAX_SEQ == 1024
    assert train_navit_packed.RESOLUTIONS == [(256, 256), (224, 224), (160, 256), (256, 160), (128, 128), (96, 192)]
    assert (train_navit_packed.IMAGES_PER_STEP, train_navit_packed.PACKS, train_navit_packed.MAX_IMAGES) == (32, 8, 8)
    assert (train_navit_packed.LR, train_navit_packed.WEIGHT_DECAY) == (3e-4, 1e-4)
    assert (pretrain_mae.BATCH, pretrain_mae.LR, pretrain_mae.WEIGHT_DECAY) == (64, 1.5e-4, 1e-4)
    assert (pretrain_dino.BATCH, pretrain_dino.LR, pretrain_dino.WEIGHT_DECAY) == (32, 3e-4, 1e-4)
    # optax's adamw weight decay, which the constants above copy (torch's AdamW defaults to 1e-2)
    import inspect

    assert inspect.signature(optax.adamw).parameters["weight_decay"].default == 1e-4


@pytest.mark.parametrize("module", EXAMPLES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_needs_a_card_unless_asked_for_the_cpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a machine without a card, wherever it runs
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_set_overrides_only_config_keys():
    with pytest.raises(SystemExit):
        serve_vit.main(["--device", "cpu", "--set", "no_such_width=3"])


def test_examples_import_without_jax():
    """Every example module imports in a fresh interpreter without JAX,
    flax, optax, the JAX package or its examples."""
    root = Path(__file__).resolve().parents[1]
    names = [m.__name__ for m in EXAMPLES] + ["vit_pytorch_tpu_torch.tools.bench_fused_tuning"]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}: importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'vit_pytorch_tpu', 'examples', 'tools'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# -- train_digits ---------------------------------------------------------------------------------------------


def test_digits_data_is_the_jax_scripts():
    """The port's copy read with numpy: the JAX ``load_data`` (scikit-learn's
    ``load_digits``) bit for bit, dtypes and shapes too."""
    from examples.train_digits import load_data as jax_load_data

    want = jax_load_data()
    got = train_digits.load_data()
    assert [a.shape for a in got] == [(1438, 1, 8, 8), (1438,), (359, 1, 8, 8), (359,)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    other = train_digits.load_data(seed=3)
    everything = lambda d: np.sort(np.concatenate([d[1], d[3]]))  # noqa: E731
    assert not np.array_equal(other[1], got[1]) and np.array_equal(everything(other), everything(got))


def test_digits_data_file_is_packaged():
    root = Path(__file__).resolve().parents[1]
    text = (root / "pyproject.toml").read_text()
    assert '"examples/data/digits.csv.gz"' in text
    assert (root / "vit_pytorch_tpu_torch" / "examples" / "data" / "README").is_file()
    assert os.path.getsize(train_digits.DATA) == 57523


MINI = dict(train_digits.CONFIG, dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32)


def _digits_run(tmp, epochs, resume, n=256):
    data = train_digits.load_data()
    data = (data[0][:n], data[1][:n], data[2], data[3])
    argv = ["--epochs", str(epochs), "--checkpoint-dir", str(tmp)] + (["--resume"] if resume else [])
    args = train_digits.arguments().parse_args(argv)
    return train_digits.run(args, data, CPU, cfg=MINI)["state"]


def test_digits_resume_is_bit_exact(tmp_path):
    """A miniature of the digits loop (dim 16, depth 1, 256 images, dropout
    0.1): 2 epochs, then a resume into a new model and optimizer to 4,
    against 4 uninterrupted: every parameter and Adam moment bitwise."""
    full = _digits_run(tmp_path / "full", 4, False)
    _digits_run(tmp_path / "split", 2, False)
    resumed = _digits_run(tmp_path / "split", 4, True)
    assert full.step == resumed.step == 4 * 2
    for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    # a different epoch's generator draws other masks: the run is not trivially bitwise
    other = _digits_run(tmp_path / "other", 1, False)
    assert not all(torch.equal(a, b) for a, b in zip(other.model.parameters(), full.model.parameters()))


def test_digits_epoch_matches_jax():
    """One epoch at dropout 0 at the script's widths: the port's loop
    (``minibatches`` -> ``prefetch_to_device`` -> ``make_train_step``)
    against the JAX ``ViT`` with ``optax.adam`` on the same batch order,
    from the same weights."""
    cfg = dict(train_digits.CONFIG, dropout=0.0, emb_dropout=0.0)
    data = train_digits.load_data()
    jmodel = JaxViT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 8, 8)))["params"]
    tx = optax.adam(3e-4)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, imgs, labels):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(jmodel.apply({"params": p}, imgs), labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    model = ViT(**cfg, device="cpu")
    model.load_state_dict(from_jax.vit_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    from vit_pytorch_tpu.utils.data import minibatches as jax_minibatches

    losses = []
    for batch in jax_minibatches({"x": data[0], "y": data[1]}, 128, rng=np.random.default_rng((1, 0))):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(batch["x"]), jnp.asarray(batch["y"]))
        losses.append(float(loss))
    out = train_digits.run(train_digits.arguments().parse_args(["--epochs", "1"]), data, CPU, cfg=cfg, model=model)
    np.testing.assert_allclose(out["losses"][0], np.mean(losses), atol=ATOL, rtol=RTOL)
    want = from_jax.vit_state_dict_from_jax(jax.tree.map(np.asarray, params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL, err_msg=name)
    acc = float(jnp.mean(jnp.argmax(jmodel.apply({"params": params}, jnp.asarray(data[2])), -1) == data[3]))
    assert out["accuracy"] == pytest.approx(acc, abs=1.5 / len(data[3]))


# -- one step of each training example --------------------------------------------------------------------------


def _assert_step(model, grads, want, lr, err=""):
    """Parameters after one Adam(W) step against JAX's: within 1e-6 where
    the gradient is well above Adam's eps, within 2 lr everywhere."""
    for name, p in model.named_parameters():
        if name not in want:
            continue
        got, w = p.detach().numpy(), want[name].numpy()
        big = np.abs(grads[name].numpy()) > 1e-5
        np.testing.assert_allclose(got[big], w[big], atol=1e-6, rtol=0, err_msg=f"{err}{name}")
        assert np.all(np.abs(got - w) <= 2 * lr), f"{err}{name}"


NAVIT = dict(train_navit_packed.CONFIG, dim=64, depth=2, heads=2, mlp_dim=128)


def _jax_slot_labels(packed, labels):
    """The JAX script's label scatter (examples/train_navit_packed.py:72-79)."""
    lab = np.full((packed.patches.shape[0], packed.max_images), -1, np.int32)
    idx = 0
    for g in range(packed.patches.shape[0]):
        for s in range(packed.max_images):
            if np.asarray(packed.num_images)[g] > s:
                lab[g, s] = labels[idx]
                idx += 1
    return lab


def test_navit_step_matches_jax():
    """One AdamW step of the packed NaViT at dim 64, depth 2, on the same
    packs (32 images of the six resolutions, token dropout 0.1, 8 packs of
    1,024) and labels (scattered in the JAX order), from the same weights."""
    from examples.train_navit_packed import sample_images as jax_sample_images

    rng = np.random.default_rng(0)
    images, labels = jax_sample_images(rng, 32)
    jpacked = jax_pack_images(images, patch_size=16, max_seq_len=1024, token_dropout_prob=0.1, train=True, rng=rng,
                              pad_groups_to=8, max_images=8)
    jlabels = _jax_slot_labels(jpacked, labels)
    inputs = train_navit_packed.make_batch(np.random.default_rng(0), NAVIT, CPU, torch.float32)
    for field in ("patches", "pos_hw", "image_ids", "num_images"):
        assert np.array_equal(getattr(inputs["packed"], field).numpy(), np.asarray(getattr(jpacked, field))), field
    assert np.array_equal(inputs["labels"].numpy(), jlabels) and (jlabels >= 0).sum() > 8

    jmodel = JaxNaViT(**NAVIT)
    params = jmodel.init(jax.random.PRNGKey(0), jpacked)["params"]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jpacked, train=True)
        valid = jnp.asarray(jlabels) >= 0
        ls = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.maximum(jnp.asarray(jlabels), 0))
        return jnp.sum(ls * valid) / jnp.maximum(jnp.sum(valid), 1)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adamw(3e-4)
    new = optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])

    model, opt = train_navit_packed.build(NAVIT, CPU, torch.float32)
    model.load_state_dict(from_jax.na_vit_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    got = train_navit_packed.train_step(model, opt, inputs)
    np.testing.assert_allclose(got.item(), float(loss), atol=ATOL, rtol=RTOL)
    to_torch = lambda tree: from_jax.na_vit_state_dict_from_jax(jax.tree.map(np.asarray, tree))  # noqa: E731
    _assert_step(model, to_torch(grads), to_torch(new), train_navit_packed.LR)


MAE_CFG = dict(pretrain_mae.CONFIG, image_size=32, patch_size=8, dim=64, depth=1, heads=2, mlp_dim=128,
               decoder_dim=32, decoder_depth=1, decoder_heads=2)


def test_mae_step_matches_jax():
    """One AdamW(1.5e-4, wd 1e-4) step of the MAE example's step at narrow
    widths, fp32, with the same ``rand_indices`` on both sides; without
    them the port draws the same permutation from the step's mask seed."""
    mae, opt = pretrain_mae.build(MAE_CFG, CPU, torch.float32)
    inputs = pretrain_mae.make_batch(0, MAE_CFG, CPU, batch=2, dtype=torch.float32)
    n = (32 // 8) ** 2
    idx = torch.rand((2, n), generator=torch.Generator().manual_seed(inputs["mask_seed"])).argsort(dim=-1)
    with torch.no_grad():
        drawn = pretrain_mae.loss_of(mae, inputs)
        assert torch.equal(drawn, pretrain_mae.loss_of(mae, {**inputs, "rand_indices": idx}))

    enc_kw = {k: v for k, v in MAE_CFG.items() if k in pretrain_mae.ENCODER_KEYS}
    jmae = JaxMAE(encoder=JaxViT(**enc_kw), **{k: v for k, v in MAE_CFG.items() if k not in pretrain_mae.ENCODER_KEYS})
    img = inputs["images"].numpy()
    params = jmae.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, jnp.asarray(img))["params"]
    loss_fn = lambda p: jmae.apply({"params": p}, jnp.asarray(img), rand_indices=jnp.asarray(idx.numpy()))  # noqa: E731
    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adamw(1.5e-4)
    new = optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])

    missing, unexpected = mae.load_state_dict(from_jax.mae_state_dict_from_jax(jax.tree.map(np.asarray, params)),
                                              strict=False)
    assert sorted(missing) == ["encoder.mlp_head.bias", "encoder.mlp_head.weight"] and not unexpected
    got = pretrain_mae.train_step(mae, opt, {**inputs, "rand_indices": idx})
    np.testing.assert_allclose(got.item(), float(loss), atol=ATOL, rtol=RTOL)
    to_torch = lambda tree: from_jax.mae_state_dict_from_jax(jax.tree.map(np.asarray, tree))  # noqa: E731
    _assert_step(mae, to_torch(grads), to_torch(new), pretrain_mae.LR)


def test_mae_example_casts_every_parameter_to_bf16():
    mae, opt = pretrain_mae.build(MAE_CFG, CPU)
    assert {p.dtype for p in mae.parameters()} == {torch.bfloat16}
    loss = pretrain_mae.train_step(mae, opt, pretrain_mae.make_batch(0, MAE_CFG, CPU, batch=2))
    assert torch.isfinite(loss)
    moments = [t for s in opt.state.values() for k, t in s.items() if k in ("exp_avg", "exp_avg_sq")]
    assert moments and {t.dtype for t in moments} == {torch.bfloat16}  # optax's moments take the params' dtype
    assert opt.defaults["weight_decay"] == 1e-4


DINO_CFG = dict(pretrain_dino.CONFIG, image_size=32, patch_size=8, dim=32, depth=2, heads=2, mlp_dim=64,
                num_classes_K=64, projection_hidden_size=32)


def test_dino_step_matches_jax():
    """One step of the Dino example (AdamW(3e-4, wd 1e-4), then
    ``update_moving_average``) with injected views against the JAX
    ``dino_forward``, ``optax.adamw`` and ``Dino.update_moving_average``:
    the loss, the student, the teacher's EMA and both centres."""
    rng = np.random.default_rng(0)
    views = tuple(rng.random((2, 3, 32, 32), dtype=np.float32) for _ in range(4))
    net_kw = {k: v for k, v in DINO_CFG.items() if k not in pretrain_dino.DINO_KEYS}
    jdino = JaxDino(net=JaxViT(**net_kw), image_size=32, **{k: DINO_CFG[k] for k in pretrain_dino.DINO_KEYS})
    variables = jdino.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(views[0]))
    state = jdino.create_state(variables)
    fn = lambda p: dino_forward(jdino, p, state, None, views=tuple(map(jnp.asarray, views)))  # noqa: E731
    (loss, new_last), grads = jax.value_and_grad(fn, has_aux=True)(variables)
    tx = optax.adamw(3e-4)
    new = optax.apply_updates(variables, tx.update(grads, tx.init(variables), variables)[0])
    state = jdino.update_moving_average(new, state.replace(last_teacher_centers=new_last))

    dino, opt = pretrain_dino.build(DINO_CFG, CPU, torch.float32)
    params = jax.tree.map(np.asarray, variables["params"])
    missing, unexpected = dino.load_state_dict(from_jax.dino_state_dict_from_jax(params, {"params": params}),
                                               strict=False)
    assert sorted(missing) == ["last_teacher_centers", "teacher_centers"] and not unexpected
    inputs = {**pretrain_dino.make_batch(0, DINO_CFG, CPU, batch=2), "views": tuple(map(torch.from_numpy, views))}
    got = pretrain_dino.train_step(dino, opt, inputs)
    np.testing.assert_allclose(got.item(), float(loss), atol=ATOL, rtol=RTOL)

    to_torch = lambda tree: from_jax.dino_state_dict_from_jax(jax.tree.map(np.asarray, tree["params"]))  # noqa: E731
    want_grads = to_torch(grads)
    student = {k: v for k, v in to_torch(new).items() if k.startswith("student_encoder.")}
    grads_or_zero = {k: v if dino.get_parameter(k).grad is not None else torch.zeros_like(v)
                     for k, v in want_grads.items() if k in student}
    _assert_step(dino, grads_or_zero, student, pretrain_dino.LR)
    teacher = from_jax.dino_state_dict_from_jax(jax.tree.map(np.asarray, new["params"]),
                                                jax.tree.map(np.asarray, state.teacher_params))
    got_teacher = dict(dino.teacher_encoder.named_parameters(prefix="teacher_encoder"))
    assert got_teacher
    for name, p in got_teacher.items():
        # 0.9 teacher + 0.1 student: the student's bounds, a tenth of them
        got_t, want_t = p.detach().numpy(), teacher[name].numpy()
        big = np.abs(grads_or_zero[name.replace("teacher_encoder.", "student_encoder.", 1)].numpy()) > 1e-5
        np.testing.assert_allclose(got_t[big], want_t[big], atol=1e-6, rtol=0, err_msg=name)
        assert np.all(np.abs(got_t - want_t) <= 0.2 * pretrain_dino.LR + 1e-6), name
    np.testing.assert_allclose(dino.last_teacher_centers.numpy(), np.asarray(state.last_teacher_centers),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dino.teacher_centers.numpy(), np.asarray(state.teacher_centers), atol=ATOL, rtol=RTOL)
    assert np.abs(np.asarray(state.teacher_centers)).max() > 0


DECORR = dict(train_vit_decorr.CONFIG, dim=64, depth=2, heads=2, mlp_dim=128, dropout=0.0, emb_dropout=0.0)
DECORR_BATCH = 4


def test_decorr_step_matches_jax(monkeypatch):
    """The decorrelation example's ``main()`` for one step at dim 64, depth 2,
    dropout 0, on the CPU (``make_mesh(device_type="cpu")``: a gloo world
    of one, ended on return), against the JAX ``shard_train_state`` +
    ``make_train_step(aux_loss_weight=0.1)`` on a 1 x 1 mesh: the same
    weights (loaded into ``main()``'s model before its first step), the
    same synthetic batch and the same sampled tokens (the token scores fixed
    on both sides)."""
    from examples.train_vit_decorr import synthetic_batches as jax_batches

    images, labels = next(jax_batches(DECORR_BATCH, 1))
    np.testing.assert_array_equal(next(train_vit_decorr.synthetic_batches(DECORR_BATCH, 1))[0], images)
    jmodel = j_decorr.ViT(**DECORR)
    sample = jnp.zeros((DECORR_BATCH, 3, 32, 32))
    state = jax_train.create_train_state(jmodel, jax.random.PRNGKey(0), sample, tx=optax.adam(3e-4))
    mesh = jax_mesh.make_mesh(1, 1, devices=jax.devices("cpu")[:1])
    state = jax_train.shard_train_state(state, mesh)
    params = jax.tree.map(np.asarray, state.params)
    rows = 2 * DECORR["depth"] * DECORR_BATCH  # one row of token scores a Gram matrix
    scores = np.random.default_rng(13).standard_normal((rows, 65)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(scores[: shape[0]]))
    monkeypatch.setattr(vit_with_decorr, "sample_scores",
                        lambda shape, gen, device: torch.from_numpy(scores[: shape[0]]))
    step = jax_train.make_train_step(jmodel, aux_loss_weight=0.1, donate=False)
    jstate, metrics = step(state, jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(1))

    loaded, seen = from_jax.vit_with_decorr_state_dict_from_jax(params), []
    make_step = train_vit_decorr.make_sharded_train_step

    def loading_step(model, mesh, **kw):
        step = make_step(model, mesh, **kw)

        def first_load(state, images, labels, gen):
            seen.append((images.to_local().shape, type(images).__name__))
            model.load_state_dict(loaded)
            return step(state, images, labels, gen)

        return first_load

    monkeypatch.setattr(train_vit_decorr, "make_sharded_train_step", loading_step)
    argv = ["--device", "cpu", "--steps", "1", "--batch-size", str(DECORR_BATCH)]
    widths = ("dim", "depth", "heads", "mlp_dim", "dropout", "emb_dropout")
    argv += [a for k in widths for a in ("--set", f"{k}={DECORR[k]}")]
    out = train_vit_decorr.main(argv)
    assert not torch.distributed.is_initialized()
    assert seen == [((DECORR_BATCH, 3, 32, 32), "DTensor")] and out["mesh"] == {"data": 1, "model": 1}
    np.testing.assert_allclose(out["losses"][0], float(metrics["loss"]), atol=ATOL, rtol=RTOL)
    assert out["accuracies"][0] == pytest.approx(float(metrics["accuracy"]), abs=1e-6)
    grads = jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jmodel.apply({"params": p}, jnp.asarray(images), train=True, rngs={"decorr": jax.random.PRNGKey(1)})[0],
        jnp.asarray(labels)).mean() + 0.1 * jmodel.apply(
        {"params": p}, jnp.asarray(images), train=True, rngs={"decorr": jax.random.PRNGKey(1)})[1])(state.params)
    to_torch = lambda tree: from_jax.vit_with_decorr_state_dict_from_jax(jax.tree.map(np.asarray, tree))  # noqa: E731
    _assert_step(out["model"], to_torch(grads), to_torch(jstate.params), 3e-4)


def test_decorr_checkpoint_holds_the_params(tmp_path):
    from vit_pytorch_tpu_torch.utils.checkpoint import load_checkpoint

    path = str(tmp_path / "decorr")
    argv = ["--device", "cpu", "--steps", "2", "--batch-size", "2", "--checkpoint", path,
            "--set", "dim=32", "--set", "depth=1", "--set", "heads=1", "--set", "mlp_dim=32"]
    out = train_vit_decorr.main(argv)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    saved = load_checkpoint(path)["params"]
    for name, t in out["model"].state_dict().items():
        assert torch.equal(saved[name], t), name


# -- serve_vit ---------------------------------------------------------------------------------------------------

SERVE = ["--set", "image_size=16", "--set", "patch_size=8", "--set", "dim=32", "--set", "depth=1", "--set", "heads=2",
         "--set", "mlp_dim=64"]


def test_serve_vit_outputs_are_the_models():
    """A narrow ViT through the example: every bucket ran ahead of traffic;
    the k = 5 request is the served model's bucket-8 run sliced, the
    300-image request its chunks 128 + 128 + 44, bitwise; the served bf16
    logits near the f32 model's that ``main()`` built."""
    out = serve_vit.main(["--device", "cpu", *SERVE])
    p = out["predictor"]
    assert p.compiled_buckets == serve_vit.BUCKETS and list(out["latency_ms"]) == list(serve_vit.REQUESTS)
    assert all(len(t) == serve_vit.RUNS == 10 for t in out["latency_ms"].values()) and out["gflop"] > 0
    x5, y5 = out["outputs"][5]
    assert x5.shape == (5, 3, 16, 16) and x5.dtype == torch.bfloat16
    with torch.inference_mode():
        padded = p.model(torch.cat([x5, x5.new_zeros(3, 3, 16, 16)]))[:5]
    assert torch.equal(y5, padded)
    x300, y300 = out["outputs"][300]
    assert y300.shape == (300, 1000)
    assert torch.equal(y300, torch.cat([p(x300[:128]), p(x300[128:256]), p(x300[256:])]))
    cfg = dict(serve_vit.CONFIG, image_size=16, patch_size=8, dim=32, depth=1, heads=2, mlp_dim=64)
    model = ViT(**cfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        want = model(x300.float())
    assert ((y300.float() - want).norm() / want.norm()).item() < 3e-2


# -- tune_train ------------------------------------------------------------------------------------------------

TINY = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2, mlp_dim=128)


class MatmulCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in tuning.MATMULS:
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_tune_train_modes_agree_bitwise():
    """The three modes at a tiny ViT on the CPU (the composite path, where
    the policy acts): the same loss and parameters after their steps, bit
    for bit; ``checkpoint`` restored after each."""
    outs = {name: tuning.train_mode(name, batch=4, device="cpu", cfg=TINY) for name in tuning.TRAIN_MODES}
    assert blocks.checkpoint is torch.utils.checkpoint.checkpoint
    first, *rest = outs.values()
    assert first["model"].transformer.remat and not outs["no remat"]["model"].transformer.remat
    for out in rest:
        assert torch.equal(out["loss"], first["loss"])
        for (name, a), b in zip(first["model"].state_dict().items(), out["model"].state_dict().values()):
            assert torch.equal(a, b), name
    assert all(o["ms"] > 0 and o["img_s"] > 0 for o in outs.values())


def test_dots_saveable_recomputes_no_matmul():
    """Counted on the backward: under ``dots_saveable`` as many matmuls as
    without remat (none recomputed), under ``checkpoint``'s default more."""
    counts = {}
    for name, (remat, policy) in tuning.TRAIN_MODES.items():
        model, _, images, labels = tuning.train_setup(remat, batch=4, device="cpu", cfg=TINY)
        with tuning.remat_policy(policy):
            loss = F.cross_entropy(model(images).float(), labels)
            with MatmulCount() as mode:
                loss.backward()
        counts[name] = mode.count
    assert counts["remat dots_saveable"] == counts["no remat"] > 0
    assert counts["remat full (current)"] > counts["no remat"]


def test_remat_policy_is_restored_when_the_step_raises(monkeypatch):
    original = blocks.checkpoint

    def broken(*args):
        assert blocks.checkpoint is not original  # the policy is in place inside the mode
        raise RuntimeError("step failed")

    monkeypatch.setattr(tuning, "train_step", broken)
    with pytest.raises(RuntimeError, match="step failed"):
        tuning.train_mode("remat dots_saveable", batch=2, device="cpu", cfg=TINY)
    assert blocks.checkpoint is original


def test_tune_train_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tuning.tune_train()
    with pytest.raises(RuntimeError, match="CUDA"):
        tuning.tune_train("cpu", batch=2)
