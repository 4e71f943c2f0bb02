"""Holds this tree's gemm_bf16 bitwise to another checkout's, every epilogue,
on one CUDA card (H100, sm_90a).

    python3 chip_gemm_bits.py <other checkout>

Builds this tree's kernels and those of ``<other checkout>``'s
``vit_pytorch_tpu_torch/csrc`` (each into ``build/`` under its own source
hash), and calls each through this tree's wrappers (the C entry points
``vit_gemm_bf16`` and ``vit_gemm_ff`` take the same arguments in both) on
the same seeded operands: every epilogue (qkv with and without a bias,
cast, out, fc1, fc2, block_out bare, with a bias and a residual, and with
dropout 0.1, fc1_f32, gemm_f32out, fc1_save's act and h1, gelu_bwd's dh1
and db1) at ViT-B's layer widths (dim 768, 3 x 768, mlp 3072) and rows b x
197 with b = 8 and at 183 rows (3 x 61: a partial last 128-row tile), and
at 100 rows with K = 64 (one k-tile), mlp 192 and N = 200 (partial last
128-column tiles).
Prints one line a call, with max|a - b| where the two differ, and exits 1
unless every output is bitwise equal.
"""

import sys
from pathlib import Path

import torch

SEED = 0
RATE, DROP_SEED, HEADS = 0.1, 1234, 12


def outputs(fb, rnd_state):
    """Every epilogue's outputs on the operands of the generator state
    ``rnd_state``, as {label: tensor}."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.set_state(rnd_state)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    out = {}
    for b, n, dim, inner, mlp in ((8, 197, 768, 768, 3072), (3, 61, 768, 768, 3072), (2, 50, 64, 64, 192)):
        tag = f"b={b} n={n} dim={dim} mlp={mlp}"
        x, m, a = rnd(b, n, dim), rnd(b, n, inner), rnd(b, n, mlp)
        h = rnd(b, n, dim)
        w_qkv, w_out = rnd(3 * inner, dim, scale=dim**-0.5), rnd(dim, inner, scale=inner**-0.5)
        w1, w2 = rnd(mlp, dim, scale=dim**-0.5), rnd(dim, mlp, scale=mlp**-0.5)
        b_qkv, b_out, b1, b2 = rnd(3 * inner, scale=0.1), rnd(dim, scale=0.1), rnd(mlp, scale=0.1), rnd(dim, scale=0.1)
        h1 = rnd(b, n, mlp)
        g = rnd(b, n, dim)
        w_qkv_t = w_qkv.t().contiguous()
        calls = {
            "qkv": lambda: fb.gemm_bf16(h, w_qkv, "qkv"),
            "qkv+bias": lambda: fb.gemm_bf16(h, w_qkv, "qkv", bias=b_qkv),
            "cast": lambda: fb.gemm_bf16(g, w_out.t().contiguous(), "cast"),
            "out": lambda: fb.gemm_bf16(m, w_out, "out", bias=b_out, residual=x),
            "fc1": lambda: fb.gemm_bf16(h, w1, "fc1", bias=b1),
            "fc2": lambda: fb.gemm_bf16(a, w2, "fc2", bias=b2, residual=x),
            "block_out bare": lambda: fb.gemm_bf16(m, w_out, "block_out"),
            "block_out+b+x": lambda: fb.gemm_bf16(m, w_out, "block_out", bias=b_out, residual=x),
            "block_out dropout": lambda: fb.gemm_bf16(m, w_out, "block_out", bias=b_out, residual=x,
                                                      dropout_rate=RATE, seed=DROP_SEED, heads=HEADS),
            "fc1_f32": lambda: fb.gemm_bf16(h, w1, "fc1_f32", bias=b1),
            "gemm_f32out": lambda: fb.gemm_f32out(rnd(b, n, 3 * inner), w_qkv_t),
            "fc1_save": lambda: fb.gemm_bf16(h, w1, "fc1_save", bias=b1),
            "gelu_bwd": lambda: fb.gemm_bf16(g, w2.t().contiguous(), "gelu_bwd", aux=h1),
        }
        if dim == 64:  # N = 200: a last 128-column tile of 72 columns, its second 64-column box of 8
            w_200, b_200, h1_200 = rnd(200, dim, scale=dim**-0.5), rnd(200, scale=0.1), rnd(b, n, 200)
            calls.update({
                "qkv+bias N=200": lambda: fb.gemm_bf16(h, w_200, "qkv", bias=b_200),
                "fc1 N=200": lambda: fb.gemm_bf16(h, w_200, "fc1", bias=b_200),
                "gemm_f32out N=200": lambda: fb.gemm_f32out(h, w_200),
                "fc1_save N=200": lambda: fb.gemm_bf16(h, w_200, "fc1_save", bias=b_200),
                "gelu_bwd N=200": lambda: fb.gemm_bf16(h, w_200, "gelu_bwd", aux=h1_200),
            })
        with torch.inference_mode():
            for name, call in calls.items():
                r = call()
                for i, t in enumerate(r if isinstance(r, tuple) else (r,)):
                    out[f"{tag} {name}[{i}]"] = t.clone()
    torch.cuda.synchronize()
    return out


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the check needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    other = Path(sys.argv[1]).resolve() / "vit_pytorch_tpu_torch" / "csrc"
    from vit_pytorch_tpu_torch.ops import _build
    from vit_pytorch_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda", 0)
    state = torch.Generator(device=dev).manual_seed(SEED).get_state()
    results = []
    for csrc in (_build.CSRC_DIR, other):
        _build.CSRC_DIR, _build._library = csrc, None
        lib = _build.load_library()
        print(f"{csrc}: {lib.path.name}", flush=True)
        results.append(outputs(fb, state))
    mine, theirs = results
    same = True
    for key, t in mine.items():
        u = theirs[key]
        bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        equal = t.dtype == u.dtype and t.shape == u.shape and torch.equal(t.view(bits), u.view(bits))
        same &= equal
        note = "bitwise equal" if equal else f"DIFFER: max|a - b| = {(t.float() - u.float()).abs().max().item():.4e}"
        print(f"  {key}: {tuple(t.shape)} {t.dtype}: {note}", flush=True)
    print(f"gemm_bf16 bitwise against {sys.argv[1]}: {'every output equal' if same else 'FAILED'}", flush=True)
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
