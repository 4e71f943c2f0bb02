"""Where the device time of SigLIPVAT goes, served and trained, and of a
VAT_B and a VAAT_B training step, on one CUDA card (H100, sm_90a).

    python3 chip_vla_profile.py

Builds the port's kernels and ``chip_smoke.py``'s SigLIPVAT (phase 46: the
reference's defaults, (3, 2) views x frames, bs=8), VAT_B and VAAT_B (phase
47, bs=4) in bf16 from the seed, with chip_smoke's matmul settings (no
TF32, no reduced-precision bf16 reductions).  For SigLIPVAT's forward and
each model's AdamW(1e-4) step: 3 warm-up calls, 3 on the host clock, 3
under ``torch.profiler``, printed as ``chip_zoo_profile.py`` prints them
(the device time of each kernel group and of the top kernels, the device's
busy share of the window, one JSON line a model), softmax kernels a group
of their own, CUTLASS's GEMMs with cuBLAS's.  Then SigLIPVAT's step on the
host clock once more with cuBLAS allowed reduced-precision bf16 reductions
(torch's default), the two settings in turns (off, on, on, off), to show
what chip_smoke's setting costs.
"""

import sys
import time

import chip_zoo_profile as zp

_group = zp.group


def group(name):
    """chip_zoo_profile's groups, softmax kernels apart, and CUTLASS's GEMMs
    (whose names hold ``gemm_bf16`` too) with cuBLAS's."""
    if "softmax" in name.lower():
        return "softmax"
    if "cutlass" in name or "nvjet" in name:
        return "cuBLAS / CUTLASS GEMM"
    return _group(name)


zp.group = group


def step_ms(step, iters=3):
    import torch

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def main():
    import torch

    import chip_smoke as cs
    from vit_pytorch_tpu_torch.ops._build import load_library

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; the profile needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    load_library()
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    views = cs.SIGLIP_VIEWS["flash"]
    model = cs.siglip_vat(dev, bf16, views)
    x = cs.siglip_images(dev, cs.SIGLIP_BS, views, cs.SEED + 46).to(bf16)
    actions = torch.randn(cs.SIGLIP_BS, 50, 32, generator=torch.Generator(device=dev).manual_seed(cs.SEED + 346),
                          device=dev).to(bf16)
    model.eval()
    with torch.inference_mode():
        zp.profile_steps(f"SigLIPVAT serving bs={cs.SIGLIP_BS} {views}", lambda: model(x))
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=cs.SIGLIP_LR, weight_decay=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        model(x, actions=actions).backward()
        opt.step()

    zp.profile_steps(f"SigLIPVAT training bs={cs.SIGLIP_BS} {views}", step)
    times = []
    for reduced in (False, True, True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        times.append(step_ms(step))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[SigLIPVAT training] ms/step with reduced-precision bf16 reductions off / on / on / off: "
          f"{' / '.join(f'{t:.3f}' for t in times)}", flush=True)
    del model, opt, x

    inputs = cs.vat_b_inputs(dev)
    for label, audio in (("VAT_B", False), ("VAAT_B", True)):
        vmodel = cs.vat_b_model(dev, bf16, audio)
        run = cs.vat_b_run(inputs, audio)
        vopt = torch.optim.AdamW(vmodel.parameters(), lr=cs.SIGLIP_LR, weight_decay=1e-4)

        def vstep(vmodel=vmodel, vopt=vopt, run=run):
            vopt.zero_grad(set_to_none=True)
            run(vmodel, bf16).backward()
            vopt.step()

        zp.profile_steps(f"{label} training bs={cs.VAT_BS}", vstep)
        del vmodel, vopt


if __name__ == "__main__":
    main()
