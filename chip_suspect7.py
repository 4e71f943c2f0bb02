"""Suspect 7: whether the lse of the flash forward's in-tile qk-norm
instantiations holds to its twin on fresh draws, on one CUDA card (H100,
sm_90a).

    python3 chip_suspect7.py [draws]

Replays fresh draws of phase 25's cases (``chip_smoke.flash_qk_cases``, from
the generator of ``chip_smoke.qk_vs_f32_draws``) and of phase 28's causal
flash cases (two images of 2048 / 1100 queries and keys and the two
2048-token packs with their ids, raw q and k, from a generator of their
own), each at rate 0 and at ``chip_smoke.RATE``, with and without the
causal mask, always with a fresh gamma pair.  On each draw it reads the lse
of ``flash_fwd[qknorm]`` (or ``[dropout,qknorm]``, ``[qknorm,causal]``, ...)
four ways, each as the worst |d| / (FLASH_LSE_ATOL + FLASH_LSE_RTOL |want|)
over the rows with a key (above 1 a check at FLASH_LSE_ATOL fails):

  - ``old pairing``: the kernel against the twin fed the twin's own q^ and
    k^ (``rms_tile_reference``), the check phases 25 and 28 made at
    QK_LSE_ATOL;
  - ``kernel hats``: the kernel against the twin fed the kernels' own q^
    and k^ (``chip_smoke.kernel_order_hats``);
  - ``kernel vs f64`` and ``twin vs f64``: the kernel, and the twin on the
    kernels' hats, against the lse of an f64 composite on that same pair
    (the mask, no rounding).

The twin's lse does not depend on the dropout (l sums the undropped p), so
the twins run at rate 0; the kernel runs at the rate.  Prints a line a draw,
a summary and one JSON line; exits 1 without a card.
"""

import json
import sys
import time

import torch

import chip_smoke as cs

KEYS = ("old pairing", "kernel hats", "kernel vs f64", "twin vs f64")
CAUSAL_DRAW_SEED = cs.SEED + 28 * 1000  # phase 28's causal cases, a generator of their own


def excess(got, want):
    """The worst |got - want| / (FLASH_LSE_ATOL + FLASH_LSE_RTOL |want|)."""
    return ((got.double() - want.double()).abs() / (cs.FLASH_LSE_ATOL + cs.FLASH_LSE_RTOL * want.double().abs())
            ).max().item()


def f64_lse(fa, q, k, *, scale, q_segment_ids, kv_segment_ids, causal):
    """The lse of softmax attention in f64 on the given bf16 q^, k^."""
    valid = fa._valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2], causal, q.device)
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    if valid is not None:
        s = s.masked_fill(~valid, -torch.inf)
    return torch.logsumexp(s, -1)


def causal_cases(fa, dev, gen):
    """Phase 28's causal flash cases: raw bf16 q, k, v."""
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
    ops3 = lambda b, n, m: (rn(b, cs.HEADS, n, cs.DH), rn(b, cs.HEADS, m, cs.DH), rn(b, cs.HEADS, m, cs.DH))
    packs, _ = cs.flash_cases(fa, dev, gen)
    _, qp, kp, vp, ids, _, _ = packs[0]
    scale = cs.DH**-0.5
    return (
        (f"n=m={cs.N_LONG}", *ops3(2, cs.N_LONG, cs.N_LONG), None, None, scale),
        (f"n={cs.N_MID} m={cs.N_LONG}", *ops3(2, cs.N_MID, cs.N_LONG), None, None, scale),
        (f"n={cs.N_LONG} m={cs.N_MID}", *ops3(2, cs.N_LONG, cs.N_MID), None, None, scale),
        ("packed ids", qp, kp, vp, ids, ids, 1.0),
    )


def main(draws=cs.QK_F32_DRAWS):
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the diagnosis needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen25 = torch.Generator(device=dev).manual_seed(cs.SEED + 25)  # qk_vs_f32_draws' draws
    gen28 = torch.Generator(device=dev).manual_seed(CAUSAL_DRAW_SEED)
    worst = {(c, r): dict.fromkeys(KEYS, (0.0, "")) for c in (False, True) for r in (0.0, cs.RATE)}
    above = {key: dict.fromkeys(KEYS, 0) for key in worst}
    max_abs = dict.fromkeys(KEYS, 0.0)
    t0 = time.perf_counter()
    for draw in range(draws):
        cases25, (gq, gk) = cs.flash_qk_cases(fa, dev, gen25)
        cases = [(f"25 {c[0]}", *c[1:]) for c in cases25] + [(f"28 {c[0]}", *c[1:]) for c in
                                                              causal_cases(fa, dev, gen28)]
        draw_worst = {key: dict.fromkeys(KEYS, (0.0, "")) for key in worst}
        for name, q, k, v, qs, ks, scale in cases:
            with torch.inference_mode():
                qe, ke = cs.kernel_order_hats(q, k, gq, gk)
                for causal in (False, True):
                    kw = dict(scale=scale, q_segment_ids=qs, kv_segment_ids=ks, causal=causal)
                    _, lse_old = fa.flash_fwd_reference(q, k, v, **kw, gamma_q=gq, gamma_k=gk)
                    _, lse_twin = fa.flash_fwd_reference(qe, ke, v, **kw)
                    lse64 = f64_lse(fa, qe, ke, scale=scale, q_segment_ids=qs, kv_segment_ids=ks, causal=causal)
                    live = lse_twin > 0.5 * fa.NEG_INF
                    if not live.any():
                        continue
                    for rate in (0.0, cs.RATE):
                        lse = fa.flash_fwd(q, k, v, **kw, dropout_rate=rate, seed=cs.DROP_SEED if rate else None,
                                           gamma_q=gq, gamma_k=gk)[1]
                        got, old, twin, ref = lse[live], lse_old[live], lse_twin[live], lse64[live]
                        reads = {"old pairing": (got, old), "kernel hats": (got, twin), "kernel vs f64": (got, ref),
                                 "twin vs f64": (twin, ref)}
                        for key, (a, b) in reads.items():
                            draw_worst[(causal, rate)][key] = max(draw_worst[(causal, rate)][key],
                                                                  (excess(a, b), name))
                            max_abs[key] = max(max_abs[key], (a.double() - b.double()).abs().max().item())
                        del lse, got
                    del lse_old, lse_twin, lse64, live
                del qe, ke
        torch.cuda.synchronize()
        for key in worst:
            for k2 in KEYS:
                worst[key][k2] = max(worst[key][k2], draw_worst[key][k2])
                above[key][k2] += draw_worst[key][k2][0] > 1
        print(f"draw {draw}: " + " | ".join(
            f"{'causal' if c else 'full'} rate {r}: " + "; ".join(f"{k2} {v:.3f} ({n})" for k2, (v, n) in
                                                                  draw_worst[(c, r)].items())
            for c, r in draw_worst), flush=True)
    summary = {f"{'causal' if c else 'full'}, rate {r}": {
        "worst": {k2: round(v, 4) for k2, (v, _) in worst[(c, r)].items()},
        "worst_case": {k2: n for k2, (_, n) in worst[(c, r)].items()},
        "draws_above_1e-3_bound": above[(c, r)]} for c, r in worst}
    for key, val in summary.items():
        print(f"{key} over {draws} draws: {json.dumps(val)}", flush=True)
    print(f"max |d| over every draw: {json.dumps({k2: float(f'{v:.4e}') for k2, v in max_abs.items()})}")
    print(f"({time.perf_counter() - t0:.1f} s)")
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"suspect7": summary, "max_abs": max_abs, "draws": draws, "card": smi}))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else cs.QK_F32_DRAWS)
