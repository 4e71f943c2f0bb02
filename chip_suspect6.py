"""Suspect 6: why the o of the flash kernels' in-tile qk-norm instantiations
strays from its twin's on fresh draws, on one CUDA card (H100, sm_90a).

    python3 chip_suspect6.py [csrc_dir]

Builds the kernels of ``csrc_dir`` (default: this checkout's
``vit_pytorch_tpu_torch/csrc``; pass a ``git archive`` of another commit's
to read its kernels through this checkout's wrappers) and replays the fresh
draws of ``chip_smoke.qk_vs_f32_draws`` (its generator, its cases, 20 draws
at rate 0 and at 0.1).  For each case it forms q^ and k^ two ways, the
twin's (``rms_tile_reference``, the sum of squares in torch's order) and the
kernels' (``chip_smoke.kernel_order_hats``, the sum in the kernels' f32
order), counts the bf16 elements in which they differ, and runs each pair
without gammas through ``flash_fwd``, its twin and an f64 composite (the
same mask and keep bits, no rounding).  Each o distance is given as the
worst |d| / (8e-3 + 8e-3 |want|), the bound of phase 25's o check (above 1
that check fails):

  - ``[qknorm] vs twin``: the kernel with gammas against the twin with
    gammas (phase 25's check before it was settled);
  - ``on twin's hats``: the kernel against the twin, both fed the twin's
    q^ and k^;
  - ``[qknorm] vs twin on kernel's hats``: the kernel with gammas against
    the twin fed the kernels' q^ and k^ (the check phases 25 and 28 now
    make); beside it the share of o bitwise equal to the kernel without
    gammas fed those hats;
  - ``hats apart``: the twin on the twin's hats against the twin on the
    kernels' hats: what one rounding of q^ and k^ moves;
  - rel L2 of the kernel and of the twin, each against the f64 composite
    of the same hats.

Prints a line a draw, a summary a rate and one JSON line; exits 1 without a
card.
"""

import json
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs


def excess(got, want):
    """The worst |got - want| / (ATTN_ATOL + ATTN_RTOL |want|)."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (cs.ATTN_ATOL + cs.ATTN_RTOL * w.abs())).max().item()


def f64_composite(fa, q, k, v, *, scale, q_segment_ids, kv_segment_ids, dropout_rate, seed):
    """o of softmax attention in f64 on the given bf16 q, k, v: the
    segment mask, fully masked rows at 0, the kernels' keep bits."""
    valid = fa._valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2], False, q.device)
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    if valid is not None:
        s = s.masked_fill(~valid, -torch.inf)
    mx = s.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    p = torch.exp(s - mx)
    l = p.sum(-1, keepdim=True)
    if dropout_rate:
        p = p.masked_fill(~fa._keep(q, k, dropout_rate, seed), 0.0) / (1.0 - dropout_rate)
    return torch.matmul(p, v.double()) / torch.where(l == 0, 1.0, l)


def main(csrc=None):
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the diagnosis needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from vit_pytorch_tpu_torch.ops import _build
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if csrc is not None:
        _build.CSRC_DIR, _build._library = Path(csrc).resolve(), None
    lib = _build.load_library()
    print(f"kernels: {_build.CSRC_DIR} -> {lib.path.name}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 25)  # qk_vs_f32_draws' draws
    keys = ("[qknorm] vs twin", "on twin's hats", "[qknorm] vs twin on kernel's hats", "hats apart")
    summary = {}
    t0 = time.perf_counter()
    for rate in (0.0, cs.RATE):
        worst = dict.fromkeys(keys, (0.0, ""))
        above = dict.fromkeys(keys, 0)
        l2 = {"kernel": 0.0, "twin": 0.0}
        flips = [0, 0, 0]  # differing q^ elements, k^ elements, all elements
        bitwise = 1.0
        for draw in range(cs.QK_F32_DRAWS):
            cases, (gq, gk) = cs.flash_qk_cases(fa, dev, gen)
            draw_worst = dict.fromkeys(keys, (0.0, ""))
            for name, q, k, v, qs, ks, scale in cases:
                torch.randn(q.shape, generator=gen, device=dev)  # the dO of qk_vs_f32_draws, drawn to keep step
                kw = dict(scale=scale, q_segment_ids=qs, kv_segment_ids=ks, dropout_rate=rate,
                          seed=cs.DROP_SEED if rate else None)
                with torch.inference_mode():
                    qt, kt = fa.rms_tile_reference(q, gq), fa.rms_tile_reference(k, gk)
                    qe, ke = cs.kernel_order_hats(q, k, gq, gk)
                    flips[0] += int((qt != qe).sum())
                    flips[1] += int((kt != ke).sum())
                    flips[2] += qt.numel() + kt.numel()
                    o_qk = fa.flash_fwd(q, k, v, **kw, gamma_q=gq, gamma_k=gk)[0]
                    o_qk_twin = fa.flash_fwd_reference(q, k, v, **kw, gamma_q=gq, gamma_k=gk)[0]
                    o_kt, o_tt = fa.flash_fwd(qt, kt, v, **kw)[0], fa.flash_fwd_reference(qt, kt, v, **kw)[0]
                    o_ke, o_te = fa.flash_fwd(qe, ke, v, **kw)[0], fa.flash_fwd_reference(qe, ke, v, **kw)[0]
                    bitwise = min(bitwise, (o_qk == o_ke).float().mean().item())
                    reads = {keys[0]: excess(o_qk, o_qk_twin), keys[1]: excess(o_kt, o_tt),
                             keys[2]: excess(o_qk, o_te), keys[3]: excess(o_te, o_tt)}
                    for key, val in reads.items():
                        draw_worst[key] = max(draw_worst[key], (val, name))
                    o64 = f64_composite(fa, qt, kt, v, **kw)
                    if o64.norm() > 0:
                        l2["kernel"] = max(l2["kernel"], cs.rel_l2(o_kt, o64))
                        l2["twin"] = max(l2["twin"], cs.rel_l2(o_tt, o64))
                    del qt, kt, qe, ke, o_qk, o_qk_twin, o_kt, o_tt, o_ke, o_te, o64
            torch.cuda.synchronize()
            for key in keys:
                worst[key] = max(worst[key], draw_worst[key])
                above[key] += draw_worst[key][0] > 1
            print(f"rate {rate}, draw {draw}: " + "; ".join(f"{key} {v:.3f} ({c})" for key, (v, c) in
                                                            draw_worst.items()), flush=True)
        summary[str(rate)] = {
            "worst": {key: round(v, 4) for key, (v, _) in worst.items()},
            "draws_above_bound": above,
            "hat_elements_differing": {"q": flips[0], "k": flips[1], "of": flips[2]},
            "o_vs_f64_rel_l2_on_twin_hats": {key: round(v, 6) for key, v in l2.items()},
            "min_share_bitwise_qknorm_vs_kernel_on_kernel_hats": bitwise,
        }
        print(f"rate {rate} over {cs.QK_F32_DRAWS} draws: {json.dumps(summary[str(rate)])}", flush=True)
    print(f"({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"suspect6": summary, "csrc": str(_build.CSRC_DIR)}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
