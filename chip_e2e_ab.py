"""Times the model paths of the port's attention and layer-chain kernels,
for one checkout, on one CUDA card (H100, sm_90a), for comparing two commits
in one call.

    python3 chip_e2e_ab.py <checkout> <label>

Builds ``<checkout>``'s kernels into its own ``build/`` and imports its
``chip_smoke.py`` and package (not this file's), then times the kernel
paths of its phases, each after a warm-up, on the same seeded inputs:

  - ViT-B/16 @224 served behind the Predictor's buckets (1, 8, 32, 128)
    (phases 4-5, VIT_TPU_STACK_LAYERS unset: the chain of 7 launches a
    layer), ms a request of each bucket's size over 20 requests (10 at 128);
  - ViT-B/16 trained at bs=1024 (phase 8) at dropout 0 and (phase 11) at
    dropout 0.1 and emb_dropout 0.1, ms a step over 2 steps;
  - SimpleViT config 2 served at bs=256 and SimpleViT-qk-norm at bs=128,
    each trained at bs=256 (phase 19), ms a batch over 10 and ms a step
    over 2;
  - SimpleViT-B/16 @512 served at bs=32 (phase 30: 12 ``short_attention``
    launches a batch), ms a batch over 10 batches;
  - NaViT-B served on phase 15's 120-image mix in 16 packs of 2048 tokens
    (13 ``flash_fwd`` a forward), ms a batch over 10;
  - NaViT-B trained on phase 14's packs (token dropout 0.25) at dropout 0
    (phase 15) and at dropout 0.1 (phase 24), ms a step over 4 steps.

Prints one JSON line {"tree": label, metric: ms, ...}.  Run two checkouts
in turns (A, B, B, A) in one call; to time a parent commit, unpack it with
``git archive`` into a git-ignored directory.
"""

import json
import os
import sys

if __name__ == "__main__":
    tree, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs
    from vit_pytorch_tpu_torch.ops._build import load_library
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the timing needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    lib = load_library()
    if not str(lib.path).startswith(os.path.abspath(tree)):
        print(f"FAIL: the kernels came from {lib.path}, not from {tree}", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    out = {"tree": label}
    for key in cs.STACK_KEYS:
        os.environ.pop(key, None)

    from vit_pytorch_tpu_torch import ViT
    from vit_pytorch_tpu_torch.serving import Predictor

    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=cs.DIM, depth=cs.DEPTH, heads=cs.HEADS,
                mlp_dim=cs.MLP, device=dev, generator=torch.Generator(device=dev).manual_seed(cs.SEED)).eval()
    pred = Predictor(model, example_shape=(3, 224, 224), batch_sizes=cs.BUCKETS, device=dev).warmup()
    for k in cs.BUCKETS:
        img = torch.randn(k, 3, 224, 224, generator=gen, device=dev)
        with torch.inference_mode():
            out[f"vit-b/16 serving ms/request bs={k}"] = cs.host_ms(lambda: pred(img), 10 if k == 128 else 20)
    del model, pred

    for rate in (0.0, cs.RATE):
        drop = dict(dropout=rate, emb_dropout=rate) if rate else {}
        model = cs.vit_b(dev, bf16, **drop)
        images = torch.randn(cs.B_TRAIN_TIME, 3, 224, 224, generator=gen, device=dev).to(bf16)
        labels = torch.randint(0, 1000, (cs.B_TRAIN_TIME,), generator=gen, device=dev)
        state, step = create_train_state(model), make_train_step(model)
        drop_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
        run = (lambda: step(state, images, labels, drop_gen)) if rate else (lambda: step(state, images, labels))
        out[f"vit-b/16 training ms/step bs={cs.B_TRAIN_TIME} dropout {rate}"] = cs.train_step_ms(dev, run)[0]
        del model, state, step, images

    for kind, bs in (("simple", cs.SIMPLE_BS), ("qknorm", cs.QKNORM_BS)):
        cfg = cs.QKNORM if kind == "qknorm" else cs.SIMPLE
        model = cs.simple_model(kind, dev, bf16).eval()
        img = torch.randn(bs, 3, cfg["image_size"], cfg["image_size"], generator=gen, device=dev).to(bf16)
        with torch.inference_mode():
            out[f"simplevit {kind} serving ms/batch bs={bs}"] = cs.host_ms(lambda: model(img), 10)
        del model, img
    for kind, bs in (("simple", cs.SIMPLE_BS), ("qknorm", cs.QKNORM_TRAIN_BS)):
        cfg = cs.QKNORM if kind == "qknorm" else cs.SIMPLE
        width = cfg["dim"] if kind == "qknorm" else cfg["num_classes"]
        model = cs.simple_model(kind, dev, bf16)
        images = torch.randn(bs, 3, cfg["image_size"], cfg["image_size"], generator=gen, device=dev).to(bf16)
        labels = torch.randint(0, width, (bs,), generator=gen, device=dev)
        state, step = create_train_state(model), make_train_step(model)
        out[f"simplevit {kind} training ms/step bs={bs}"] = cs.train_step_ms(dev, lambda: step(state, images, labels))[0]
        del model, state, step, images

    model = cs.simple_512_model("simple", dev, bf16).eval()
    size = cs.SIMPLE_512["image_size"]
    img = torch.randn(cs.SIMPLE_512_BUCKETS[-1], 3, size, size, generator=gen, device=dev).to(bf16)
    with torch.inference_mode():
        out["simplevit512 serving ms/batch bs=32"] = cs.host_ms(lambda: model(img), 10)
    del model, img

    images, _, rng = cs.navit_images(cs.SEED, labels=False)
    packed = cs.pack_navit(images, rng, dev, train=False)
    model = cs.navit_model(dev, bf16).eval()
    with torch.inference_mode():
        out["navit serving ms/batch"] = cs.host_ms(lambda: model(packed), 10)
    del model

    packed, labels = cs.navit_train_batch(dev)
    for rate in (0.0, cs.RATE):
        drop = dict(dropout=rate, emb_dropout=rate) if rate else {}
        model = cs.navit_model(dev, bf16, token_dropout_prob=cs.NAVIT_TOKEN_DROPOUT, **drop)
        state, step = create_train_state(model), make_train_step(model, cs.masked_ce)
        drop_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
        run = (lambda: step(state, packed, labels, drop_gen)) if rate else (lambda: step(state, packed, labels))
        out[f"navit training ms/step dropout {rate}"] = cs.train_step_ms(dev, run, 4)[0]
        del model, state, step
    print(json.dumps(out), flush=True)
