"""Holds this tree's flash_fwd bitwise to another checkout's, every
instantiation, on one CUDA card (H100, sm_90a).

    python3 chip_flash_fwd_bits.py <other checkout>

Builds this tree's kernels and those of ``<other checkout>``'s
``vit_pytorch_tpu_torch/csrc`` (each into ``build/`` under its own source
hash), and calls each through this tree's wrapper (the C entry point
``vit_flash_fwd`` takes the same arguments in both) on the same seeded
operands: rate 0, [dropout] at 0.1, [qknorm], [dropout,qknorm], [causal]
and [bias] / [bias,causal] (a (1, h, n, m) f32 table), on two of NaViT's
2048-token packs with their ids (q and k through rms_norm, scale 1), on
(2, 12, 1100, 1100) without ids, and at the ring's edges n = 129, m = 130
and n = 1, m = 1000.  Prints one line a call (o and lse), with max|a - b|
where the two differ, and exits 1 unless every output is bitwise equal.
"""

import sys
from pathlib import Path

import torch

import chip_smoke as cs


def outputs(fa, packed, rnd_state):
    """Every instantiation's (o, lse) on the operands of the generator state
    ``rnd_state``, as {label: tensor}."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.set_state(rnd_state)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    gq, gk = ((1 + 0.2 * rn(cs.HEADS, 1, cs.DH)).to(torch.bfloat16) for _ in range(2))
    ids = packed.image_ids[:2].contiguous()
    out = {}
    for label, b, n, m, seg, scale in (("packs", 2, cs.NAVIT_SEQ, cs.NAVIT_SEQ, ids, 1.0),
                                       ("no ids 1100", 2, 1100, 1100, None, cs.DH**-0.5),
                                       ("n=129 m=130", 2, 129, 130, None, cs.DH**-0.5),
                                       ("n=1 m=1000", 2, 1, 1000, None, cs.DH**-0.5)):
        q, k, v = (rn(b, cs.HEADS, r, cs.DH) for r in (n, m, m))
        q, k, v = fa.rms_norm(q, 1.0).to(torch.bfloat16), fa.rms_norm(k, 1.0).to(torch.bfloat16), v.to(torch.bfloat16)
        bias = rn(1, cs.HEADS, n, m)
        kw = dict(scale=scale, q_segment_ids=seg, kv_segment_ids=seg)
        calls = {
            "": {}, "[dropout]": dict(dropout_rate=cs.RATE, seed=cs.DROP_SEED),
            "[qknorm]": dict(gamma_q=gq, gamma_k=gk),
            "[dropout,qknorm]": dict(dropout_rate=cs.RATE, seed=cs.DROP_SEED, gamma_q=gq, gamma_k=gk),
            "[causal]": dict(causal=True), "[bias]": dict(bias=bias), "[bias,causal]": dict(bias=bias, causal=True),
        }
        with torch.inference_mode():
            for name, extra in calls.items():
                o, lse = fa.flash_fwd(q, k, v, **kw, **extra)
                out[f"{label} flash_fwd{name} o"] = o.clone()
                if "bias" not in name:  # the [bias] instantiations write no lse the backward keeps
                    out[f"{label} flash_fwd{name} lse"] = lse.clone()
    torch.cuda.synchronize()
    return out


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the check needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    other = Path(sys.argv[1]).resolve() / "vit_pytorch_tpu_torch" / "csrc"
    from vit_pytorch_tpu_torch.ops import _build
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    images, _, rng = cs.navit_images(cs.SEED, labels=False)
    packed = cs.pack_navit(images, rng, dev, train=False)
    state = torch.Generator(device=dev).manual_seed(cs.SEED).get_state()
    results = []
    for csrc in (_build.CSRC_DIR, other):
        _build.CSRC_DIR, _build._library = csrc, None
        lib = _build.load_library()
        print(f"{csrc}: {lib.path.name}", flush=True)
        results.append(outputs(fa, packed, state))
    mine, theirs = results
    same = True
    for key, t in mine.items():
        u = theirs[key]
        bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        equal = t.dtype == u.dtype and t.shape == u.shape and torch.equal(t.view(bits), u.view(bits))
        same &= equal
        note = "bitwise equal" if equal else f"DIFFER: max|a - b| = {(t.float() - u.float()).abs().max().item():.4e}"
        print(f"  {key}: {tuple(t.shape)} {t.dtype}: {note}", flush=True)
    print(f"flash_fwd bitwise against {sys.argv[1]}: {'every output equal' if same else 'FAILED'}", flush=True)
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
