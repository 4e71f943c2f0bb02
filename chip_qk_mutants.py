"""Mutation check of the qk-norm kernels on one CUDA card (H100, sm_90a).

    python3 chip_qk_mutants.py

Runs chip_smoke.py's phase 16 (``check_qknorm``: attention_rows[qknorm] and
attention_bwd_rows[qknorm] against their twins) first on the kernels as they
are, which must pass every check, then on deliberately wrong copies of
``vit_pytorch_tpu_torch/csrc``, each built under ``build/mutants/`` (git-ignored)
with one edit, which must each fail at least one check.  Prints one line a
kernel and exits 1 if the right kernels fail or a mutant passes.
"""

import shutil
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs

# name: (file in csrc/, text replaced, replacement); each text occurs once
MUTANTS = {
    "the norm's closing without the projection term (d g - xhat <d g, xhat> -> d g)": (
        "common.cuh", "  s0 = quad_sum(s0);\n  s1 = quad_sum(s1);", "  s0 = 0.f;\n  s1 = 0.f;"),
    "dgamma without the sqrt(dh) factor": ("fused_layer_bwd.cu", "width, kRmsRoot);", "width, 1.f);"),
    "the norm with a mean of squares (RMSNorm) instead of the sum": (
        "common.cuh", "const float rr = rsqrtf(ss + kRmsEps);", "const float rr = rsqrtf(ss * (1.f / 64) + kRmsEps);"),
    "the key pass's dgamma partial written into the q half": (
        "fused_layer_bwd.cu", "* 2 * inner + inner + h * kAttnDh,", "* 2 * inner + h * kAttnDh,"),
}


def run_checks(check, fb, dev, csrc_dir):
    """``check(fb, rnd, dev)`` (a phase of chip_smoke.py) on the kernels built
    from ``csrc_dir``; returns the messages of the checks that failed."""
    from vit_pytorch_tpu_torch.ops import _build

    _build.CSRC_DIR, _build._library = csrc_dir, None
    fails = []
    cs.fail = lambda msg: fails.append(msg)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    try:
        check(fb, rnd, dev)
    except Exception as e:  # a mutant may also break a launch; that refuses it too
        fails.append(repr(e))
    return fails


def main(mutants=MUTANTS, check=lambda fb, rnd, dev: cs.check_qknorm(fb, rnd, dev), tag="qk"):
    """The right kernels through ``check``, then each of ``mutants`` (name:
    (file in csrc/, text, replacement)) built under build/mutants/<tag>-<i>;
    exits 1 unless the right kernels pass and every mutant fails."""
    sys.exit(0 if run(mutants, check, tag) else 1)


def run(mutants, check, tag):
    """main's work: True when the right kernels pass ``check`` and every one
    of ``mutants`` fails it."""
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the mutation check needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from vit_pytorch_tpu_torch.ops import _build
    from vit_pytorch_tpu_torch.ops import fused_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    src = _build.CSRC_DIR
    ok = True
    t = time.perf_counter()
    fails = run_checks(check, fb, dev, src)
    ok &= not fails
    print(f"right kernels: {len(fails)} failed checks ({time.perf_counter() - t:.1f} s) "
          f"{'ok' if not fails else 'FAILED: ' + '; '.join(fails[:3])}", flush=True)
    for i, (name, (fname, old, new)) in enumerate(mutants.items()):
        d = _build.build_dir() / "mutants" / f"{tag}-{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        text = (d / fname).read_text()
        if text.count(old) != 1:
            print(f"FAIL: mutant {name!r}: its text occurs {text.count(old)} times in {fname}", file=sys.stderr)
            sys.exit(1)
        (d / fname).write_text(text.replace(old, new))
        t = time.perf_counter()
        fails = run_checks(check, fb, dev, Path(d))
        ok &= bool(fails)
        print(f"{'refused' if fails else 'NOT REFUSED'}: {name}: {len(fails)} failed checks "
              f"({time.perf_counter() - t:.1f} s); first: {fails[:2]}", flush=True)
    _build.CSRC_DIR, _build._library = src, None
    return ok


if __name__ == "__main__":
    main()
