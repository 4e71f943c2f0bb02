"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. device: name, power limit, torch and CUDA versions (no card: exit 1);
  2. build: nvcc of vit_pytorch_tpu_torch/csrc into build/, with its seconds;
  3. kernels against their plain PyTorch twins, bf16, at ViT-B shapes
     (b=8, n=197, dim=768, heads=12, dh=64, mlp=3072; attention also at
     n=50, mostly padded keys), and the whole layer;
  4. serving: ViT-B/16 @224 from a seeded generator behind a Predictor with
     buckets (1, 8, 32, 128); requests of 1, 5, 32 and 130 images; launch
     counters; logits against the plain bf16 path and against fp32;
  5. timing at bs=128: model img/s, one layer, each kernel (gemm_bf16 at
     each of its four sites), kernel vs plain; beside each GEMM site that no
     one torch call computes, its bare product through F.linear (a
     product-only yardstick; also for gemm_f32out in phase 8, fc1_save and
     gelu_bwd in 21, fc1_f32 in 35);
  6. backward kernels against their plain twins at the shapes of phase 3
     (attention_bwd_rows also at n = 50, 1, 16, 17, 64 and 208, the edges
     of its key-chunk instantiations, and at n=197 with dp near one value
     along each row; bitwise from run to run), and the whole layer's
     backward:
     every operand gradient of the kernel Function against the same
     Function run on the twins;
  7. training: ViT-B/16 @224 (depth 12, remat=True, dropout 0) in bf16 from
     a seeded generator, trained through parallel/train.py::make_train_step
     on one seeded batch: loss finite and falling, exact launch counters,
     the first step's loss and gradients against the plain bf16 path and
     against an fp32 copy, and one step with grad_accum=2;
  8. training timing at bs=1024: ms/step kernel vs plain, peak device
     memory, and each backward launch of one layer at bs=128;
  9. dropout kernels against their twins at rate 0.1 and the shapes of
     phase 3: the dropout_masks replay bitwise (n = 197 and 50, keep
     fraction 0.9 +- 0.005), attention_rows[dropout] (n = 197 and 50),
     gemm_bf16[block_out], dropout_apply bitwise, attention_bwd_rows[dropout]
     (n = 197, 50, 1, 16, 17, 64 and 208; bitwise from run to run), and the
     attention-block Function's output and every
     operand gradient against the same Function on the twins, at rate 0 and
     rate 0.1;
 10. training with dropout: ViT-B/16 @224 (depth 12, dropout 0.1,
     emb_dropout 0.1, remat=True) in bf16, 4 steps through make_train_step
     with a generator: loss finite and falling, exact launch counters, the
     first step's loss and gradients against the plain-twin path with the
     same generator (the same masks);
 11. dropout training timing at bs=1024: ms/step kernel vs plain, peak
     device memory, and each launch of one attention block's forward and
     backward at bs=128;
 12. flash kernels (flash_fwd, flash_bwd_dq, flash_bwd_dkv) against their
     plain twins, bf16, h=12, dh=64: two 2048-token packs of the NaViT
     resolution mix, the attn_pool shape (16 queries, empty slots at -2),
     an all-pad pack and no ids at n=m=1100, and flash_fwd's ring edges (n =
     1, m = 1000; n = 129, m = 130; ids at n = m = 1000), and the backward
     kernels' 128-row work items and admission (unsorted ids 0, 1, 0, 2, ...
     over two packs; n = m = 193 without and with ids; causal with the
     diagonal mid-item, n = m = 193 and unsorted ids at n = m = 1000); o,
     lse, dq, dk, dv (the backward kernels run twice: bitwise the same), and
     the Function against autograd through the materialized twin in f32;
     the fraction of tiles the skip test admits;
 13. NaViT-B serving: forward_packed on the 120-image mix of the JAX bench
     (13 flash_fwd launches, exact), logits against the plain bf16 path
     (flash_attention_twins swapped in: the flash Function on its twins)
     and fp32 (the gate sends fp32 to the materialized composite): at depth
     12 within the bf16 noise floor measured in the run, at depth 2 (full
     width) within fixed bounds; a depth-2 nested-tensor NaViT against its
     plain path;
 14. NaViT-B training: make_train_step with the masked cross-entropy on the
     bench's 16 packs with token dropout 0.25: at depth 12, 4 Adam steps
     (loss falls, 13 launches of each flash kernel a step, exact, the first
     step's loss against the plain bf16 path and fp32); at depth 2, the first
     step's loss and gradients against both;
 15. NaViT timing: serving img/s and tokens/s and the training ms/step
     (peak memory) at 16 packs, kernel against plain in turns, and each
     flash launch at the packed shape, the backward kernels beside SDPA's
     backward under the block-diagonal mask (forward + backward less the
     forward);
 16. the qk-norm kernels against their twins at the shapes of phase 3 (n =
     197 and 50) and SimpleViT-qk-norm's served one (b=128, n=196), scale 1,
     gammas at SimpleViT-qk-norm's init and random: attention_rows[qknorm],
     attention_bwd_rows[qknorm] (m, dq, dk, dv, dgamma_q, dgamma_k, the
     dgammas; also at n = 1, 16, 17, 64 and 208; every output bitwise from
     run to run), both again with dropout 0.1, and the
     qk-norm attention-block Function's output and its 7 gradients against
     the same Function on the twins; attention_rows and attention_bwd_rows at
     SimpleViT config 2's shapes (b=256, n=64 and 68, 16 heads);
 17. SimpleViT serving: BASELINE config 2 (tools/bench_zoo.py:132-141, 64
     tokens) behind buckets (1, 8, 32, 256), its register-token variant (n =
     68), and SimpleViT-qk-norm (tools/bench_qknorm_model.py:28-29, 196
     tokens) behind the ViT buckets: exact launch counters (4 attention-block
     launches a layer), outputs against the plain bf16 path and fp32;
 18. SimpleViT training: both models through make_train_step, 4 steps each
     (loss falls, exact counters: 10 launches a layer a step), the first
     step's loss and gradients (the gammas' included) against the plain bf16
     path and fp32;
 19. SimpleViT timing: serving img/s (config 2 at bs=256, qk-norm at
     bs=128), training ms/step and peak memory at bs=256, kernel against
     plain in turns; each qk-norm launch alone; attention_rows at config 2's
     64 tokens (4 key chunks) against its twin, its bound and SDPA, and
     attention_bwd_rows there against its twin, its bound and SDPA's
     forward + backward, each an entry of its own in the kernels line
     (beside every attention_bwd_rows time, in phases 8, 11 and 19, SDPA's
     forward + backward on the same q, k, v and dm is the yardstick);
     each model's gemm_bf16[block_out] site
     against its twin, its bound and the one torch call computing it;
 20. the kernels of the JAX package's opt-in backwards of the whole layer
     (the ports of _ff_bwd_kernel and _layer_bwd_kernel) against their plain
     twins at 1,576 rows (phase 6's b=8, n=197) and at 183 rows:
     gemm_bf16[fc1_save] (act, h1), gemm_bf16[gelu_bwd] (dh1, db1),
     layernorm_bwd_rows[res_f32] (bf16 and f32 residual and dx; dgamma,
     dbeta, the residual's column sum), gemm_wgrad at its four sites; the
     column sums and gemm_wgrad bitwise deterministic; both LayerNorm
     backward variants at each of their paths (dims 200, 768, 1024, 1032,
     2416, 3584 at 1,576 rows, and bs=128's 25,216 rows of 768) against
     their twins, each run twice, every output bitwise; the whole layer's 13
     gradients under each switch against the same Function on the twins;
 21. ViT-B/16 training under VIT_TPU_FF_BWD=full, =hybrid and
     VIT_TPU_ENABLE_WHOLE_LAYER_BWD=1, each set in-process: 4 steps (loss
     falls, exact launch counters), the first step's loss and gradients
     against the plain twins under the same switch; ms/step and peak memory
     at bs=1024 of each beside the default backward, in turns; each new
     launch at bs=128 against its twin, bound and library call, and one
     gemm_wgrad launch at bs=1024;
 22. the flash kernels' dropout instantiations against their plain twins
     at rate 0.1 on phase 12's cases and a packed case with q = 0 (every p
     exactly 1, a tight bound on o): flash_fwd[dropout] (o, lse; it differs
     from the rate-0 kernel), flash_bwd_dq[dropout], flash_bwd_dkv[dropout]
     (each run twice: bitwise the same); the flash_dropout_masks replay
     bitwise against its twin and, at n = m, against dropout_masks'
     attention mask, keep fraction 0.9 +- 0.005; the Function's o, dq, dk,
     dv against autograd through the f32 materialized composite fed the
     same masks;
 23. NaViT-B training with dropout 0.1, emb_dropout 0.1 (phase 14's batch,
     a generator a step): depth 12, 4 steps (loss finite, exact counters:
     12 of each [dropout] flash kernel and 1 of each rate-0 one a step, the
     first step's loss against the plain bf16 path with an equal
     generator); depth 2, the first step's loss and gradients against it; a
     depth-2 nested-tensor NaViT, 2 steps with exact counters;
 24. its timing: ms/step and peak memory, kernel against plain in turns
     (plain one step a turn) and against dropout 0 in turns; each [dropout]
     launch at the packed shape against its twin and its rate-0 kernel,
     SDPA with dropout_p beside flash_fwd[dropout] and its backward beside
     the backward kernels; the mask replay;
 25. the flash kernels' in-tile qk-norm instantiations ([qknorm] and
     [dropout,qknorm] of flash_fwd, flash_bwd_dq, flash_bwd_dkv) against
     their plain twins on phase 12's cases and phase 22's q = 0 case, q and
     k raw with row norms spread over ~e^+-4.5, gammas 1 + 0.2 N(0, 1) (o
     and lse against the twin fed the kernels' own q^ and k^, suspects 6
     and 7; lse against the twin on its own, logged; the backward kernels
     run twice: bitwise the same); o also differs from the kernel without
     gammas; the Function's o, dq, dk, dv, dgamma_q and dgamma_k against
     autograd through the f32 composite with the eager rms_norm; that
     check again over 20 fresh draws at rate
     0 and 20 at rate 0.1, for the kernels and for the Function on its plain
     twins, logged (each output's worst rel L2 a draw, and o against the
     twin fed either rounding of q^ and k^);
 26. NaViT-B under VIT_TPU_FUSE_QKNORM=1 (set in-process): serving at depth
     12 and 2 (exact counters: depth + 1 flash_fwd[qknorm] a forward; the
     switch unset, depth + 1 rate-0 flash_fwd as in phase 13), logits
     against the plain twins under the switch, the eager default and fp32;
     training at dropout 0 (depth + 1 of each [qknorm] kernel a step) and
     0.1 (depth of each [dropout,qknorm] and one of each [qknorm]), the
     first step's loss at depth 12 and gradients at depth 2 against the
     plain twins; a depth-2 3-D NaViT (pack_volumes, register tokens)
     served and trained 2 steps, on the rate-0 kernels;
 27. its timing, the switch on and off in turns: serving img/s and real
     tokens/s, training ms/step and peak memory at dropout 0 and 0.1; each
     new launch against its twin and its kernel without qk-norm; the eager
     rms_norm pair and the plain VJP epilogue alone;
 28. the short kernel (short_attention, [bias] with an f32 and a bf16
     per-head bias) against its twin at b x h = 32 x 12, (n, m) from 49 to
     1024 and n != m, and at q = 0 (every p exactly 1); the flash kernels'
     causal variants ([causal], [dropout,causal], [qknorm,causal],
     [dropout,qknorm,causal] of flash_fwd, flash_bwd_dq, flash_bwd_dkv) at
     n = m = 2048, n = 1100 < m = 2048, n = 2048 > m = 1100 and two packs
     with segment ids; flash_fwd[bias] and [bias,causal] with (1, h), (b, 1),
     (b, h) biases, f32 and bf16, causal, with segment ids; the edges of
     the ring and the head-ordered grid (SHORT_EDGES, FLASH_EDGES); the
     Functions against autograd through the f32 composite, dbias included;
 29. SimpleViT-B/16 @512 and SimpleViT-qk-norm @512 (1024 tokens: the
     dispatcher's short route) served behind buckets (1, 8, 32) (exact
     counters: 12 short_attention a forward, no other launch; outputs
     against the plain bf16 path and fp32) and trained 4 steps at bs=32
     (short forward, composite backward; exact counters, first-step loss and
     gradients against the plain bf16 path and fp32); dot_product_attention
     on the card at the m = 1024 / 1025 edge, fp32 and dim_head 32 on the
     composite, then its causal and bias calls at m = 2048 (and a per-head
     bias at m = 1024), forward and backward, one launch of each variant;
 30. their timing: serving img/s and training ms/step with peak memory of
     both models, kernel against plain in turns; each new launch against its
     twin, its bound and SDPA (is_causal, dropout_p, a float attn_mask), the
     backward ones beside PyTorch's flash-attention backward (one aten call
     for dq, dk, dv; SDPA's backward where this torch lacks it), and
     flash_fwd, flash_bwd_dq and flash_bwd_dkv without options at the same
     8 x 12 x 2048 beside SDPA and that backward.
 31. stack_layers (VIT_TPU_STACK_LAYERS: g whole layers in one launch)
     against the chain of 7g launches, bitwise, its last layer against the
     twin's step within the whole layer's bounds and the whole stack against
     the twins' chain within g times them, at ViT-B widths, (b, n) =
     (8, 197) and (3, 50), g in (1, 2, 3, 6), each optional bias on and
     off, and at (37, 197), whose every step ends on a ragged wave of the
     grid; 20 launches of g = 6 at bs=128 of both instantiations, each
     bitwise the first and the chain; the grad route (the per-layer
     Functions) bitwise, output and 12g + 1 gradients; a mixed-bias stack
     and n = 209 refused;
 32. ViT-B/16 @224 behind the buckets (1, 8, 32, 128) with the switch set
     in-process: exact counters (g = 6: 2 stack_layers a bucket run and no
     other launch; g = 5: 3; unset, or VIT_TPU_DISABLE_STACK beside g = 6:
     the 12 x 7 chain), logits bitwise the switch unset's at every bucket
     and within phase 4's bounds of plain bf16 and fp32; two training steps
     at g = 6: the default's counters (no stack_layers), loss and gradients
     bitwise;
 33. its timing: serving img/s at each bucket, unset against g = 2, 3, 6 in
     3 turn pairs (the median and the range of each); one stack_layers
     launch at bs=128 for g = 1 .. 6 against its
     chain of 7g launches in turns, in ms a layer, beside its bound; the
     g = 6 launch against its twin;
 34. the port's bench tools (vit_pytorch_tpu_torch/tools/, the JAX
     package's layer prototypes in tools/ with their f32 epilogues): each of
     the ten counterparts against its plain twin at b = 8, ViT-B widths, n =
     197 and n_pad = 200 (n_real = 197), with exact launch counters (7 a
     layer, 4 an attention block, 3 an FF block, 1 stack_layers[tools] a
     stack); the padded calls' real rows bitwise unchanged when the padded
     rows' inputs change; make_stack bitwise the chain of 7L launches at
     L = 1, 2, 3, 4, 6 and within L times the layer bounds of its twin;
     gemm_bf16[block_out] at the tools' three sites bitwise bf16(gemm_f32out
     + bias + residual); gemm_bf16[fc1_f32] against bf16(gelu(bf16(
     gemm_f32out + b1))) by the share of elements that differ;
     attention_rows[n_keys] against its twin, n_keys of 0 and n + 1
     refused;
 35. each tool's main() at bs=128 (the main path of this slice, its
     counters zeroed before each and read after); each new kernel entry
     against its twin in turns, its bound and its library call; each of the
     ten counterparts against its twin; the tools' layer against
     fused_transformer_layer and make_stack(6) against its chain, in ms a
     layer.
Each phase prints its seconds.  Then one JSON line with the kernels (their
times, bounds and library-call times), and the last line {"ok": true,
"device": {...}}.  Any failed check exits non-zero before it.

Imports nothing of JAX.
"""

import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B_CHECK, N, DIM, HEADS, DH, MLP, DEPTH = 8, 197, 768, 12, 64, 3072, 12
B_TIME = 128
BUCKETS = (1, 8, 32, 128)
REQUESTS = (1, 5, 32, 130)
LAUNCHES_PER_LAYER = {"layernorm_rows": 2, "gemm_bf16": 4, "attention_rows": 1}
# gemm_bf16's four sites of a layer, one launch each: each its own entry of
# the kernels line, since only some of them are one torch call
GEMM_SITES = ("qkv", "out", "fc1", "fc2")
ATTN_CHECK_N = (N, 50)  # 13 and 4 key chunks of 16: 11 and 14 padded keys
# attention_bwd_rows also at the edges of its instantiations (1 and 2 key
# chunks, 13 with none padded) and at SimpleViT config 2's 64 tokens (4)
ATTN_BWD_EDGE_N = (1, 16, 17, 64, 208)
# Each kernel is held to its plain twin twice.  The twins round at the same
# points, so what differs is f32 summation order and exp2/rsqrt ulps, which
# can flip one bf16 rounding of an output element:
# - elementwise, |got - want| <= atol + rtol*|want|, a few ulps of the output.
#   LayerNorm and GEMM outputs reach |x| ~ 5 (ulp 2^-5); attention's stay
#   under ~1.3 (ulp 2^-7), so its bound is 2 ulps there and well under the
#   ~3% uniform shrink that letting the padded keys into the row sum makes;
# - relative L2 over the whole output: a flipped rounding moves one element
#   by one ulp, ~2^-8 of it, in a fraction of the elements, so a right kernel
#   reads ~1e-3; a systematic error of 0.5% or more fails it.
KERNEL_ATOL = KERNEL_RTOL = 2e-2
ATTN_ATOL = ATTN_RTOL = 8e-3
KERNEL_REL_L2 = 5e-3
# the whole layer chains 7 roundings; a flip in y (|y| up to ~8, ulp 2^-5)
# passes into the output unchanged when fc2's term cancels against it: 2 ulps
LAYER_ATOL, LAYER_RTOL = 6.25e-2, 2e-2
# relative L2 of ViT-B logits (12 layers, random weights)
LOGITS_VS_PLAIN_BF16 = 3e-2
LOGITS_VS_FP32 = 5e-2
# Backward outputs (dq, dk, dv, the whole layer's gradients) have no fixed
# scale, so their elementwise bound is relative to the largest element:
# |d| <= frac*max|want| + rtol*|want|.  dq/dk/dv: 2 bf16 ulps of the largest
# (2^-6); a right kernel reads max_abs/max|want| <= 1.9e-3 and rel L2
# <= 6.8e-5 (H100 80GB HBM3, 700 W).
BWD_ATOL_FRAC = 2.0**-6
# f32 outputs (gemm_f32out's dh, dgamma, dbeta) against an f32 twin: only the
# f32 summation order differs, ~sqrt(K) f32 ulps; a right kernel reads rel
# L2 <= 2.4e-6, and a bf16 rounding anywhere on the way reads ~2e-3
F32_ATOL_FRAC = F32_RTOL = 1e-4
F32_REL_L2 = 1e-4
# the whole layer's gradients chain ~20 roundings through the forward's y and
# the FF vjp; a right chain reads max_abs/max|want| <= 5.8e-3 and rel L2
# <= 4.4e-3 against the twins (H100 80GB HBM3, 700 W): 4 ulps of
# the largest element, and 3x the rel L2 reading
LAYER_GRAD_ATOL_FRAC = 2.0**-5
LAYER_GRAD_REL_L2 = 1.5e-2
B_TRAIN, TRAIN_STEPS = 32, 4
B_TRAIN_TIME = 1024  # the JAX package's training metric, bench.py:38
TRAIN_LAUNCHES_PER_LAYER = {  # forward 7 + backward 6
    "layernorm_rows": 3, "gemm_bf16": 6, "attention_rows": 1,
    "attention_bwd_rows": 1, "gemm_f32out": 1, "layernorm_bwd_rows": 1,
}
# First training step: the loss's relative difference, the relative L2 over
# all gradients together and that of the worst single parameter.  A right
# chain reads, against the plain bf16 path, loss 4.8e-4, grads 9.4e-3, worst
# 1.5e-2 (the patch embedding's last LayerNorm, which every layer's dx
# reaches); against fp32, 2.0e-4, 1.05e-2, 1.5e-2; grad_accum=2 against the
# full batch, 0, 2.9e-3, 3.4e-3; with dropout 0.1 against the plain path
# with the same masks, 8.0e-5 to 6.0e-4, 1.11e-2, 1.57e-2 (H100 80GB HBM3,
# 700 W).  Bounds: about 3x the readings.
TRAIN_VS_PLAIN = dict(loss=2e-3, grads=3e-2, worst=5e-2)
TRAIN_VS_FP32 = dict(loss=2e-3, grads=3e-2, worst=5e-2)
ACCUM_VS_FULL = dict(loss=1e-3, grads=1e-2, worst=1.5e-2)
RATE, DROP_SEED = 0.1, 1234  # dropout of phases 9-11 (the reference README's ViT)
KEEP_FRACTION_TOL = 0.005
# Attention-block Function (phase 9), kernels vs twins at rate 0 and 0.1: a
# right chain reads, for the output, max_abs 1.6e-2 (one ulp at |x| in
# [2, 4)) and rel L2 5.1e-4; for the 7 operand gradients max_abs/max|want|
# <= 5.5e-3 and rel L2 <= 1.57e-3 (H100 80GB HBM3, 700 W).  Bounds: the
# forward kernels' for the output; 2^-6 of the largest element (~3x) and
# rel L2 5e-3 (~3x) for the gradients
BLOCK_GRAD_ATOL_FRAC = 2.0**-6
BLOCK_GRAD_REL_L2 = 5e-3
DROPOUT_LAUNCHES_PER_LAYER = {  # forward 4 + backward 7 (the FF is plain PyTorch)
    "layernorm_rows": 2, "gemm_bf16": 3, "attention_rows[dropout]": 1, "gemm_bf16[block_out]": 1,
    "dropout_apply": 1, "attention_bwd_rows[dropout]": 1, "gemm_f32out": 1, "layernorm_bwd_rows": 1,
}
# gemm_bf16[block_out] rounds once: against its twin only f32 summation order
# differs, which flips the final rounding of a few elements in 10^4, and a
# right kernel reads rel L2 4.5e-5 to 6.0e-5 (H100 80GB HBM3, 700 W); an
# extra rounding of the f32 dot + bias moves every element by up to half an
# ulp.  Bound: ~10x the reading
BLOCK_OUT_REL_L2 = 5e-4
# -- the NaViT slice (phases 12-15): NaViT-B at the configuration of the JAX
# package's own NaViT benches, tools/bench_zoo.py:144-213 (serving) and
# tools/bench_navit_train.py:48-77 (training): 120 images from a seeded
# resolution mix, packed into 16 packs of 2048 tokens with at most 16 images
NAVIT = dict(image_size=256, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP)
NAVIT_RESOLUTIONS = ((256, 256), (224, 224), (160, 256), (256, 160), (128, 128), (96, 192))
NAVIT_IMAGES, NAVIT_PACKS, NAVIT_MAX_IMAGES, NAVIT_SEQ = 120, 16, 16, 2048
NAVIT_TOKEN_DROPOUT = 0.25  # training only
# Phase 12, each flash kernel against its plain twin at the kernel's rounding
# points on the same inputs (the backward twins fed the kernel's own lse):
# - o: the attention bounds of phase 3 (2 bf16 ulps at |o| ~ 2);
# - lse (f32, rows with a key only; a row with none must read -1e30 in
#   both): f32 summation order and exp2 vs exp, well under 1e-3;
# - dq, dk, dv: the backward bounds of phase 6, 2^-6 of the largest element.
# And the Function's o, dq, dk, dv against autograd through
# flash_attention_reference (the materialized composite) on f32 copies of
# the inputs: the kernels' bf16 p and ds against f32 throughout.  A right
# kernel reads rel L2 <= 6.3e-4 (o), 8.4e-8 (lse), 1.5e-4 (dq, dk, dv) and
# <= 5.3e-3 against f32; mutants refused: p not zeroed where masked (o rel
# L2 1.1e-2), the mask before exp only in the backward (dq 8.8), the skip
# test on the tiles' first ids (o 0.65), dk without the scale (7.0), no
# -1e30 sentinel (H100 80GB HBM3, 700 W).
FLASH_LSE_ATOL, FLASH_LSE_RTOL = 1e-3, 1e-5
FLASH_VS_F32_ATOL_FRAC, FLASH_VS_F32_REL_L2 = 2.0**-5, 2e-2
# Phases 13-14: relative L2 of NaViT-B's logits, and of the first training
# step's loss and gradients, against the plain bf16 path (the flash Function
# on its twins) and fp32.  NaViT-B at random init is chaotic in bf16: its
# qk-norm attention runs at scale 1 on rows of norm 8, so a logit moves by
# ~64x the relative error of q or k, one bf16 rounding shifts the near-top
# softmax weights by percents, and the error doubles every 3-4 layers.  With
# no kernel at all, plain bf16 at depth 12 sits at rel L2 ~0.36 from fp32,
# and 1e-3 relative noise on the input pixels moves its logits by as much;
# two bf16 paths' depth-12 gradients are uncorrelated.  So:
# - depth 12 (the model as served and trained): the logits are held to the
#   noise floor measured in the same run (kernel vs fp32 within
#   NAVIT_NOISE_RATIO of plain bf16 vs fp32; kernel vs plain within it of
#   plain vs plain on the perturbed input), the first step's loss to
#   NAVIT_DEEP_LOSS; its gradients are printed, not bounded.  A right kernel
#   reads 0.98x and 0.66x of those floors, 6.7e-5 and 1.2e-3 on the loss;
# - depth 2 at full width: logits and the first step's loss and gradients
#   against bounds ~2-3x a right kernel's reading: logits 1.48e-2 vs plain,
#   3.08e-2 vs fp32 (plain bf16 itself 3.10e-2); gradients 4.6e-2 (worst
#   parameter 5.1e-2) vs plain, 0.111 (0.125) vs fp32 (plain bf16 itself
#   0.110); the nested-tensor NaViT's logits 4.66e-3 (H100 80GB HBM3, 700 W).
# These checks catch wiring (ids, layouts, heads) and the loss; phase 12's
# bounds are the ones that refuse a wrong kernel.
NAVIT_NOISE_RATIO, NAVIT_INPUT_NOISE = 1.5, 1e-3
NAVIT_DEEP_LOSS = 5e-3
NAVIT_SHALLOW = 2
NAVIT_SHALLOW_VS_PLAIN, NAVIT_SHALLOW_VS_FP32 = 4.5e-2, 1e-1
NESTED_DEPTH, NESTED_VS_PLAIN = 2, 2e-2
NAVIT_TRAIN_VS_PLAIN = dict(loss=5e-3, grads=1e-1, worst=1.5e-1)
NAVIT_TRAIN_VS_FP32 = dict(loss=5e-3, grads=2.5e-1, worst=3e-1)
TPU_FLASH = {
    "flash_fwd": "vit_pytorch_tpu/ops/flash_attention.py:202",
    "flash_bwd_dq": "vit_pytorch_tpu/ops/flash_attention.py:298",
    "flash_bwd_dkv": "vit_pytorch_tpu/ops/flash_attention.py:376",
}
FLASH_SOURCE = "vit_pytorch_tpu_torch/csrc/flash_attention.cu"
TPU_KERNEL = "vit_pytorch_tpu/ops/fused_block.py:1053"
TPU_BWD_KERNEL = "vit_pytorch_tpu/ops/fused_block.py:524"
TPU_BLOCK_KERNEL = "vit_pytorch_tpu/ops/fused_block.py:260"
TPU_MASKS_KERNEL = "vit_pytorch_tpu/ops/fused_block.py:190"
SOURCE = "vit_pytorch_tpu_torch/csrc/fused_layer.cu"
GEMM_SOURCE = "vit_pytorch_tpu_torch/csrc/gemm_bf16.cu"  # gemm_bf16 (every epilogue) and gemm_f32out
ATTN_SOURCE = "vit_pytorch_tpu_torch/csrc/attention_rows.cu"  # attention_rows and its variants
BWD_SOURCE = "vit_pytorch_tpu_torch/csrc/fused_layer_bwd.cu"
ATTN_BWD_SOURCE = "vit_pytorch_tpu_torch/csrc/attention_bwd_rows.cuh"  # attention_bwd_rows and its variants
DROPOUT_SOURCE = "vit_pytorch_tpu_torch/csrc/dropout.cu"
# The least time the card could take for a kernel's work (its bound): the
# larger of the bytes it must move (each input read once, each output written
# once) over the memory rate, and its operations over the peak rate of their
# type.  Published peaks of one H100 SXM, dense: bf16 tensor-core products,
# f32 and 32-bit integer work on the CUDA cores, HBM3.
HBM_BYTES_PER_S, BF16_TENSOR_OPS_PER_S, F32_OPS_PER_S = 3.35e12, 989e12, 67e12
# Philox4x32-10 gives 4 keep bits for ~100 32-bit operations (10 rounds of two
# multiplies-hi/lo, xors and key adds): ~25 a dropout element
PHILOX_OPS_PER_ELEMENT = 25


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters):
    """Mean device time of fn over iters chained calls (CUDA events)."""
    for _ in range(3):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, iters):
    """plain, kernel, kernel, plain on one card; the mean of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def work(bytes_=0, tensor=0, f32=0):
    """A kernel's work: bytes moved, bf16 tensor-core operations, and f32 or
    32-bit integer operations on the CUDA cores."""
    return {"bytes": bytes_, "tensor": tensor, "f32": f32}


def bound_ms(w):
    """(ms, "bytes" or "operations"): the least time of the work ``w``."""
    t_bytes = w["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = (w["tensor"] / BF16_TENSOR_OPS_PER_S + w["f32"] / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ln_work(rows, dim):
    """LayerNorm: read x, write the bf16 output; ~8 f32 operations an element."""
    return work(2 * 2 * rows * dim + 2 * 2 * dim, f32=8 * rows * dim)


def ln_bwd_work(rows, dim, residual):
    """LayerNorm backward: read x (bf16), dh (f32), the residual; write dx;
    ~12 f32 operations an element; dgamma and dbeta written once."""
    return work(rows * dim * (2 + 4 + 2 + (2 if residual else 0)) + 2 * dim + 2 * 4 * dim, f32=12 * rows * dim)


def gemm_work(m, n, k, *, bias=False, residual=False, out_bytes=2, dropout=False):
    """C[m, n] = A[m, k] . W[n, k]^T in bf16, with its epilogue's reads."""
    b = 2 * (m * k + n * k) + out_bytes * m * n + (2 * n if bias else 0) + (2 * m * n if residual else 0)
    return work(b, tensor=2 * m * n * k, f32=PHILOX_OPS_PER_ELEMENT * m * n if dropout else 0)


def attention_work(b, n, heads, *, backward=False, dropout=False, qknorm=False):
    """attention_rows (qkv in, merged heads out; q.k and p.v) or
    attention_bwd_rows (qkv and dm in, m and dqkv out; q.k, p.v, dv, dp, dq,
    dk): 4 or 12 n^2 dh bf16 products a head, ~5 f32 operations a logit, a
    Philox draw a logit with dropout; qk-norm adds the gammas (and the
    dgammas) and ~6 f32 operations an element of q and k (twice backward)."""
    inner = heads * DH
    bytes_ = b * n * inner * 2 * (8 if backward else 4)
    logits = b * heads * n * n
    f32 = 5 * logits + (PHILOX_OPS_PER_ELEMENT * logits if dropout else 0)
    if qknorm:
        bytes_ += 2 * inner * 2 + (2 * inner * 4 if backward else 0)
        f32 += 6 * 2 * b * n * inner * (2 if backward else 1)
    return work(bytes_, tensor=(12 if backward else 4) * logits * DH, f32=f32)


def flash_work(name, ids, heads, dropout=False, qknorm=False):
    """The flash kernels on packs with segment ids: the work the same-image
    (query, key) pairs of this data need (4, 6, 8 dh bf16 products a pair
    for flash_fwd, flash_bwd_dq, flash_bwd_dkv, and a Philox draw a pair with
    dropout), and their operands: q, k, v (and dO) in, o (dq; dk and dv)
    out, the f32 lse (and delta); the in-tile qk-norm adds the gammas and
    ~6 f32 operations an element of q and of k, each normalised once."""
    pairs = 0
    for row in ids.tolist():
        counts = np.bincount([i for i in row if i >= 0])
        pairs += int((counts.astype(np.int64) ** 2).sum())
    pairs *= heads
    b, n = ids.shape
    t = b * heads * n * DH * 2  # one (b, h, n, dh) bf16 tensor
    vec = b * heads * n * 4  # one (b, h, n) f32 vector
    ops = {"flash_fwd": (4, 4 * t + vec), "flash_bwd_dq": (6, 5 * t + 2 * vec), "flash_bwd_dkv": (8, 6 * t + 2 * vec)}
    per_pair, bytes_ = ops[name]
    f32 = (5 + (PHILOX_OPS_PER_ELEMENT if dropout else 0)) * pairs
    if qknorm:
        bytes_ += 2 * heads * DH * 4
        f32 += 6 * 2 * b * heads * n * DH
    return work(bytes_ + 2 * b * n * 4, tensor=per_pair * DH * pairs, f32=f32)


def record(per_kernel, name, km, pm, w, library_ms=None, product_ms=None, product_of=None):
    """Add one call site's kernel and plain times, work and library time to
    a kernel's entry (a kernel timed at several sites sums them);
    ``product_ms``: a site without a library call, the time of a yardstick
    that computes part or more of it, named by ``product_of`` (default: its
    bare product alone through F.linear at the same (M, N, K), for a GEMM
    site; the function differs: no epilogue)."""
    e = per_kernel.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "work": work(), "library_ms": None,
                                     "product_only_ms": None, "product_only_of": None})
    if product_of is not None:
        e["product_only_of"] = product_of
    e["ms"] += km
    e["plain_ms"] += pm
    e["work"] = {k: e["work"][k] + w[k] for k in w}
    if library_ms is not None:
        e["library_ms"] = (e["library_ms"] or 0.0) + library_ms
    if product_ms is not None:
        e["product_only_ms"] = (e["product_only_ms"] or 0.0) + product_ms


def ln_bwd_library_ms(x, dh, weight, eps, iters=10):
    """Device ms of torch.ops.aten.native_layer_norm_backward on x's rows and
    the f32 gradient dh of its normalised rows, given the forward's mean and
    rstd (from native_layer_norm): dx, dgamma and dbeta in one call, the
    library call beside layernorm_bwd_rows (which adds a residual too).
    Where it refuses dh in f32 beside x in bf16, dh is cast to x's dtype
    first, outside the timing, and the log says so."""
    aten = torch.ops.aten
    dim = x.shape[-1]
    bias = torch.zeros_like(weight)
    _, mean, rstd = aten.native_layer_norm(x, [dim], weight, bias, eps)
    g = dh.reshape(x.shape)
    call = lambda: aten.native_layer_norm_backward(g, x, [dim], mean, rstd, weight, bias, [True, True, True])
    cast = "none"
    try:
        call()
        sync()
    except RuntimeError:
        g, cast = g.to(x.dtype), f"dh cast from f32 to {x.dtype}"
    ms = cuda_ms(call, iters)
    log(f"  native_layer_norm_backward at {x.numel() // dim} rows of {dim} (x {x.dtype}, the cast: {cast}): "
        f"{ms:.4f} ms")
    return ms


def linear_ms(a, w, iters=20):
    """Device ms of the bare product a . w^T through F.linear: the
    product-only yardstick of a GEMM site that no one torch call computes."""
    return cuda_ms(lambda: torch.nn.functional.linear(a, w), iters)


def sdpa_ms(qkv, heads, iters, **kw):
    """Device ms of torch's scaled_dot_product_attention on the heads of a
    packed (b, n, 3*inner) qkv: the library call beside attention_rows."""
    b, n, _ = qkv.shape
    q, k, v = qkv.view(b, n, 3, heads, DH).permute(2, 0, 3, 1, 4)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw), iters)


SDPA_FWD_BWD = "scaled_dot_product_attention forward + backward (torch.autograd.grad to q, k, v)"


def sdpa_fwd_bwd_ms(qkv, dm, heads, iters, **kw):
    """Device ms of torch's scaled_dot_product_attention forward and its
    backward to q, k and v, with the merged-heads gradient dm as the
    output's cotangent, on the heads of a packed (b, n, 3*inner) qkv: a
    yardstick beside attention_bwd_rows (which computes m and dqkv; no one
    torch call does)."""
    b, n, _ = qkv.shape
    with torch.inference_mode(False), torch.enable_grad():
        q, k, v = (t.clone().requires_grad_() for t in qkv.view(b, n, 3, heads, DH).permute(2, 0, 3, 1, 4))
        go = dm.view(b, n, heads, DH).transpose(1, 2).clone()

        def run():
            o = torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)
            torch.autograd.grad(o, (q, k, v), go)

        return cuda_ms(run, iters)


SDPA_BWD_ONLY = ("scaled_dot_product_attention forward + backward (torch.autograd.grad to q, k, v) less its forward: "
                 "dq, dk and dv at once")
FLASH_BACKEND_BWD = "aten._scaled_dot_product_flash_attention_backward: dq, dk and dv in one call"


def sdpa_bwd_only_ms(q, k, v, do, iters, **kw):
    """Device ms of torch's scaled_dot_product_attention forward and its
    backward to q, k and v (cotangent ``do``), less the forward alone, on
    (b, h, rows, 64) operands: the yardstick beside the flash backward
    kernels where no one torch call computes dq, dk and dv (a segment mask:
    SDPA takes the block-diagonal mask as ``attn_mask``)."""
    with torch.inference_mode(False), torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        go = do.detach().clone()
        kw = {name: val.clone() if torch.is_tensor(val) else val for name, val in kw.items()}  # a mask made in
        # inference mode could not be saved for the backward

        def both():
            torch.autograd.grad(torch.nn.functional.scaled_dot_product_attention(*leaves, **kw), leaves, go)

        fwd_bwd = cuda_ms(both, iters)
        with torch.no_grad():
            fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*leaves, **kw), iters)
    return fwd_bwd - fwd


def flash_backend_bwd_ms(q, k, v, do, iters, causal=False, dropout_p=0.0):
    """(ms, what) of the library's backward beside the flash backward kernels
    without ids: PyTorch's flash-attention backward, one aten call for dq,
    dk and dv fed its own forward's output and logsumexp, where this torch
    exposes it; else :func:`sdpa_bwd_only_ms`."""
    aten = torch.ops.aten
    scale = q.shape[-1] ** -0.5
    try:
        o, lse, cq, ck, mq, mk, seed, offset = aten._scaled_dot_product_flash_attention(
            q, k, v, dropout_p, causal, False, scale=scale)[:8]
        ms = cuda_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, o, lse, cq, ck, mq, mk, dropout_p, causal, seed, offset, scale=scale), iters)
        return ms, FLASH_BACKEND_BWD
    except (AttributeError, RuntimeError, TypeError) as e:
        log(f"  (no flash-attention backward op in this torch: {type(e).__name__}; SDPA's backward instead)")
        return sdpa_bwd_only_ms(q, k, v, do, iters, is_causal=causal, dropout_p=dropout_p, scale=scale), SDPA_BWD_ONLY


def rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def compare(name, got, want, atol, rtol, max_rel_l2=KERNEL_REL_L2, atol_frac=None):
    """Elementwise and relative-L2 check; with ``atol_frac`` the absolute
    bound is that fraction of max|want|."""
    if atol_frac is not None:
        atol = atol_frac * want.float().abs().max().item()
    d = (got.float() - want.float()).abs()
    max_abs = d.max().item()
    rel = max_abs / want.float().abs().max().item()
    l2 = rel_l2(got, want)
    ok = (bool(torch.isfinite(got).all()) and bool((d <= atol + rtol * want.float().abs()).all())
          and l2 <= max_rel_l2)
    log(f"  {name:30s} max_abs={max_abs:.4e} max_abs/max|want|={rel:.3e} bound |d|<={atol:.3g}+{rtol}|want|; "
        f"rel L2={l2:.3e} bound {max_rel_l2} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name} disagrees with its plain twin")
    return max_abs


def edge_rnd(seed):
    """A seeded bf16 N(0, 1) draw of its own for the attention_bwd_rows
    cases of phases 6, 9, 16 and 19 at ATTN_BWD_EDGE_N and config 2, so that
    they leave the data every other phase draws from the run's generator as
    it was without them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def check_attention_bwd(fb, name, qkv, dm, kw, label, m_atol=ATTN_ATOL, m_atol_frac=None):
    """attention_bwd_rows (``kw``: scale, dropout, gammas) against its twin
    on (qkv, dm): m, then dq, dk and dv (2 bf16 ulps of the largest) and the
    dgammas; a part the twin gives as zeros (n = 1: one key, so ds = 0) must
    be zeros.  Run twice: the outputs, dgammas included, bitwise equal.
    Returns the largest max_abs."""
    inner = dm.shape[-1]
    got = fb.attention_bwd_rows(qkv, dm, **kw)
    want = fb.attention_bwd_rows_reference(qkv, dm, **kw)
    errs = [compare(f"{name} m [{label}]", got[0], want[0], m_atol, ATTN_RTOL, atol_frac=m_atol_frac)]
    for i, part in enumerate("qkv"):
        cols = slice(i * inner, (i + 1) * inner)
        errs.append(compare_or_zero(f"{name} d{part} [{label}]", got[1][..., cols], want[1][..., cols], None,
                                    ATTN_RTOL, atol_frac=BWD_ATOL_FRAC))
    for part, a, b in zip(("dgamma_q", "dgamma_k"), got[2:], want[2:]):
        errs.append(compare_or_zero(f"{name} {part} [{label}]", a, b, None, QK_DGAMMA_RTOL, QK_DGAMMA_REL_L2,
                                    atol_frac=QK_DGAMMA_ATOL_FRAC))
    again = fb.attention_bwd_rows(qkv, dm, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{name} [{label}] is not bitwise the same from run to run")
    return max(errs)


def check_kernels(fb, rnd):
    """Phase 3: each kernel and the whole layer against its plain twin on the
    card; returns the largest max_abs of each kernel."""
    log(f"[3 kernels] b={B_CHECK} n={N} dim={DIM} heads={HEADS} dh={DH} mlp={MLP}, bf16")
    inner = HEADS * DH
    w = dict(
        w_qkv=rnd(3 * inner, DIM, scale=DIM**-0.5), w_out=rnd(DIM, inner, scale=inner**-0.5),
        ln1_scale=1 + rnd(DIM, scale=0.1), ln1_bias=rnd(DIM, scale=0.1),
        ln2_scale=1 + rnd(DIM, scale=0.1), ln2_bias=rnd(DIM, scale=0.1),
        w1=rnd(MLP, DIM, scale=DIM**-0.5), b1=rnd(MLP, scale=0.1),
        w2=rnd(DIM, MLP, scale=MLP**-0.5), b2=rnd(DIM, scale=0.1),
    )
    b_qkv, b_out = rnd(3 * inner, scale=0.1), rnd(DIM, scale=0.1)
    x = rnd(B_CHECK, N, DIM)
    errs = {}
    with torch.inference_mode():
        h = fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])
        errs["layernorm_rows"] = compare(
            "layernorm_rows", fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]), h, KERNEL_ATOL, KERNEL_RTOL)
        sync()
        m, a = rnd(B_CHECK, N, inner), rnd(B_CHECK, N, MLP)
        sites = (
            ("qkv", h, w["w_qkv"], None, None), ("qkv+bias", h, w["w_qkv"], b_qkv, None),
            ("out", m, w["w_out"], b_out, x), ("fc1", h, w["w1"], w["b1"], None),
            ("fc2", a, w["w2"], w["b2"], x),
        )
        for site, inp, weight, bias, res in sites:
            epi = site.split("+")[0]
            e = compare(f"gemm_bf16[{site}]", fb.gemm_bf16(inp, weight, epi, bias=bias, residual=res),
                        fb.gemm_bf16_reference(inp, weight, epi, bias=bias, residual=res), KERNEL_ATOL, KERNEL_RTOL)
            errs[f"gemm_bf16[{epi}]"] = max(errs.get(f"gemm_bf16[{epi}]", 0.0), e)
        sync()
        attn_errs = []
        for n in ATTN_CHECK_N:
            qkv = (fb.gemm_bf16_reference(h, w["w_qkv"], "qkv", bias=b_qkv) if n == N
                   else rnd(B_CHECK, n, 3 * inner))
            akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
            attn_errs.append(compare(f"attention_rows[n={n}]", fb.attention_rows(qkv, **akw),
                                     fb.attention_rows_reference(qkv, **akw), ATTN_ATOL, ATTN_RTOL))
        errs["attention_rows"] = max(attn_errs)
        sync()
        lkw = dict(heads=HEADS, dim_head=DH, b_qkv=b_qkv, b_out=b_out)
        compare("fused_transformer_layer", fb.fused_transformer_layer(x, **w, **lkw),
                fb.layer_reference(x, **w, **lkw), LAYER_ATOL, LAYER_RTOL)
        sync()
    return errs


def layer_weights(rnd):
    """Random bf16 operands of one ViT-B layer, the scales of phase 3."""
    inner = HEADS * DH
    w = dict(
        w_qkv=rnd(3 * inner, DIM, scale=DIM**-0.5), w_out=rnd(DIM, inner, scale=inner**-0.5),
        ln1_scale=1 + rnd(DIM, scale=0.1), ln1_bias=rnd(DIM, scale=0.1),
        ln2_scale=1 + rnd(DIM, scale=0.1), ln2_bias=rnd(DIM, scale=0.1),
        w1=rnd(MLP, DIM, scale=DIM**-0.5), b1=rnd(MLP, scale=0.1),
        w2=rnd(DIM, MLP, scale=MLP**-0.5), b2=rnd(DIM, scale=0.1),
    )
    return w, dict(b_qkv=rnd(3 * inner, scale=0.1), b_out=rnd(DIM, scale=0.1))


def layer_grads(layer, x, w, kw, g):
    """Output and every operand gradient of one layer (``layer`` is the
    kernel Function or its twin), for the cotangent ``g``."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, *w.values(), *kw.values())]
    out = layer(leaves[0], *leaves[1:11], heads=HEADS, dim_head=DH, b_qkv=leaves[11], b_out=leaves[12])
    return out, torch.autograd.grad(out, leaves, g)


def check_backward(fb, rnd):
    """Phase 6: each backward kernel and the whole layer's backward against
    its plain twin on the card; returns the largest max_abs of each kernel."""
    log(f"[6 backward kernels] b={B_CHECK} n={N} dim={DIM} heads={HEADS} dh={DH} mlp={MLP}, bf16")
    inner = HEADS * DH
    akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
    w, kw = layer_weights(rnd)
    x = rnd(B_CHECK, N, DIM)
    errs = {}
    with torch.inference_mode():
        h = fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])
        attn_errs = []
        for n in ATTN_CHECK_N:
            qkv = (fb.gemm_bf16_reference(h, w["w_qkv"], "qkv", bias=kw["b_qkv"]) if n == N
                   else rnd(B_CHECK, n, 3 * inner))
            dm = rnd(B_CHECK, n, inner)
            attn_errs.append(check_attention_bwd(fb, "attention_bwd_rows", qkv, dm, akw, f"n={n}"))
            if n == N:
                dqkv_full = fb.attention_bwd_rows_reference(qkv, dm, **akw)[1]
        erd = edge_rnd(SEED + 6)
        for n in ATTN_BWD_EDGE_N:
            qkv, dm = erd(B_CHECK, n, 3 * inner), erd(B_CHECK, n, inner)
            attn_errs.append(check_attention_bwd(fb, "attention_bwd_rows", qkv, dm, akw, f"n={n}"))
        # v rows near one vector and dm off zero: dp = dm.v^T is near one value
        # along a row, so ds = p (dp - D) is a small difference of large terms,
        # and D = rowsum(dp * p) has to come from the f32 p (from the bf16 p
        # it moves ds by a few percent)
        qkv = torch.cat((erd(B_CHECK, N, 2 * inner), (1 + 0.02 * erd(B_CHECK, N, inner).float()).to(qkv.dtype)), -1)
        dm = (erd(B_CHECK, N, inner).float() + 4).to(qkv.dtype)
        attn_errs.append(check_attention_bwd(fb, "attention_bwd_rows", qkv, dm, akw, f"n={N}, dp near one value"))
        errs["attention_bwd_rows"] = max(attn_errs)
        sync()
        w_qkv_t = w["w_qkv"].t().contiguous()
        dh = fb.gemm_f32out_reference(dqkv_full, w_qkv_t)
        errs["gemm_f32out"] = compare("gemm_f32out [dh]", fb.gemm_f32out(dqkv_full, w_qkv_t), dh, None, F32_RTOL,
                                      F32_REL_L2, atol_frac=F32_ATOL_FRAC)
        sync()
        dy = rnd(B_CHECK, N, DIM)
        got = fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=dy)
        want = fb.layernorm_bwd_rows_reference(x, dh, w["ln1_scale"], residual=dy)
        errs["layernorm_bwd_rows"] = max(
            compare("layernorm_bwd_rows dx", got[0], want[0], KERNEL_ATOL, KERNEL_RTOL),
            compare("layernorm_bwd_rows dgamma", got[1], want[1], None, F32_RTOL, F32_REL_L2, atol_frac=F32_ATOL_FRAC),
            compare("layernorm_bwd_rows dbeta", got[2], want[2], None, F32_RTOL, F32_REL_L2, atol_frac=F32_ATOL_FRAC),
        )
        again = fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=dy)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail("layernorm_bwd_rows is not deterministic")
        sync()
    g = rnd(B_CHECK, N, DIM)
    out, grads = layer_grads(fb.fused_transformer_layer, x, w, kw, g)
    out_want, grads_want = layer_grads(fb.layer_reference, x, w, kw, g)
    compare("fused_transformer_layer (out)", out, out_want, LAYER_ATOL, LAYER_RTOL)
    for name, a, b in zip(("x", *w, *kw), grads, grads_want):
        compare(f"layer grad d{name}", a, b, None, KERNEL_RTOL, LAYER_GRAD_REL_L2, atol_frac=LAYER_GRAD_ATOL_FRAC)
    sync()
    return errs


@contextlib.contextmanager
def plain_layers():
    """The model's layers through the plain twins: the same Functions with
    every kernel swapped for its twin (ops/fused_block.py::layer_reference
    for the whole layer, attention_block_reference for the attention block
    of the dropout path)."""
    from vit_pytorch_tpu_torch.nn import blocks
    from vit_pytorch_tpu_torch.ops import fused_block as fb

    saved = blocks.fused_transformer_layer, blocks.fused_attention_block
    blocks.fused_transformer_layer, blocks.fused_attention_block = fb.layer_reference, fb.attention_block_reference
    try:
        yield
    finally:
        blocks.fused_transformer_layer, blocks.fused_attention_block = saved


def vit_b(dev, dtype, **kw):
    """ViT-B/16 @224 as bench.py:48-57 trains it (remat=True; dropout 0
    unless ``kw`` says otherwise), random weights from SEED, initialised in
    f32 and cast as the JAX bench casts its params."""
    from vit_pytorch_tpu_torch import ViT

    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP,
                remat=True, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED), **kw)
    return model.to(dtype)


def grad_vector(model):
    return [p.grad.detach().float().clone() for p in model.parameters()]


def grads_rel_l2(got, want):
    """Relative L2 of all gradients together."""
    num = sum(((a - b).norm() ** 2 for a, b in zip(got, want)), torch.zeros((), device=got[0].device))
    den = sum((b.norm() ** 2 for b in want), torch.zeros((), device=got[0].device))
    return (num / den).sqrt().item()


def compare_grads(name, got, want, loss, loss_want, bounds, names):
    """Relative L2 of the loss, of all gradients together and of the worst
    single parameter."""
    d_loss = abs(loss - loss_want) / abs(loss_want)
    total = grads_rel_l2(got, want)
    per = [((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(got, want)]
    worst = max(range(len(per)), key=per.__getitem__)
    ok = (d_loss <= bounds["loss"] and total <= bounds["grads"] and per[worst] <= bounds["worst"]
          and all(bool(torch.isfinite(a).all()) for a in got))
    log(f"  {name}: loss {loss:.6f} vs {loss_want:.6f} (rel {d_loss:.3e}, bound {bounds['loss']}); grads rel L2 "
        f"{total:.4e} (bound {bounds['grads']}), worst {names[worst]} {per[worst]:.4e} (bound {bounds['worst']}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"training: {name} out of bounds")


def check_training(fb, dev, gen):
    """Phase 7: ViT-B/16 training steps through make_train_step; returns the
    launch counts of the kernel path's steps."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[7 training] ViT-B/16 @224, depth {DEPTH}, remat=True, dropout 0, bf16 params and inputs, seed {SEED}; "
        f"bs={B_TRAIN}, {TRAIN_STEPS} Adam steps on one batch")
    fp32_model = vit_b(dev, torch.float32)
    model = copy.deepcopy(fp32_model).to(bf16)
    initial = copy.deepcopy(model)
    names = [n for n, _ in model.named_parameters()]
    images = torch.randn(B_TRAIN, 3, 224, 224, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (B_TRAIN,), generator=gen, device=dev)

    state, step = create_train_state(model), make_train_step(model)
    fb.reset_launch_counts()
    losses = []
    for i in range(TRAIN_STEPS):
        metrics = step(state, images.to(bf16), labels)
        losses.append(metrics["loss"].item())
        if i == 0:
            grads = grad_vector(model)
    sync()
    counts = dict(fb.LAUNCHES)
    want = {k: DEPTH * TRAIN_LAUNCHES_PER_LAYER.get(k, 0) * TRAIN_STEPS for k in fb.LAUNCHES}
    log(f"  losses {[f'{v:.6f}' for v in losses]}; launches {counts} (expected {want}: {DEPTH} layers x "
        f"{sum(TRAIN_LAUNCHES_PER_LAYER.values())} launches x {TRAIN_STEPS} steps)")
    if not all(v == v and abs(v) != float("inf") for v in losses) or not losses[-1] < losses[0]:
        fail("the training loss is not finite or does not fall on the repeated batch")
    if counts != want:
        fail("the training path did not launch every kernel of every layer")

    plain = copy.deepcopy(initial)
    fb.reset_launch_counts()
    with plain_layers():
        loss_plain = make_train_step(plain)(create_train_state(plain), images.to(bf16), labels)["loss"].item()
    sync()
    if any(fb.LAUNCHES.values()):
        fail(f"the plain path launched kernels: {fb.LAUNCHES}")
    compare_grads("first step vs plain bf16", grads, grad_vector(plain), losses[0], loss_plain, TRAIN_VS_PLAIN, names)
    loss_fp32 = make_train_step(fp32_model)(create_train_state(fp32_model), images, labels)["loss"].item()
    compare_grads("first step vs fp32", grads, grad_vector(fp32_model), losses[0], loss_fp32, TRAIN_VS_FP32, names)

    accum = copy.deepcopy(initial)
    fb.reset_launch_counts()
    loss_accum = make_train_step(accum, grad_accum=2)(create_train_state(accum), images.to(bf16), labels)["loss"].item()
    sync()
    want_accum = {k: DEPTH * TRAIN_LAUNCHES_PER_LAYER.get(k, 0) * 2 for k in fb.LAUNCHES}
    log(f"  grad_accum=2: launches {fb.LAUNCHES} (expected {want_accum})")
    if dict(fb.LAUNCHES) != want_accum:
        fail("the grad_accum=2 step did not launch every kernel of every layer in each microbatch")
    compare_grads("grad_accum=2 vs first step", grad_vector(accum), grads, loss_accum, losses[0], ACCUM_VS_FULL, names)
    return counts


def time_training(fb, dev, gen, smi):
    """Phase 8: ms/step at bs=1024, kernel and plain paths in turns, peak
    memory, and each backward launch of one layer at bs=128; returns the
    backward kernels' (kernel ms, plain ms)."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[8 training timing] ViT-B/16 bs={B_TRAIN_TIME}, {smi}")
    model = vit_b(dev, bf16)
    images = torch.randn(B_TRAIN_TIME, 3, 224, 224, generator=gen, device=dev).to(bf16)
    labels = torch.randint(0, 1000, (B_TRAIN_TIME,), generator=gen, device=dev)
    state, step = create_train_state(model), make_train_step(model)

    def kernel_step():
        step(state, images, labels)

    def plain_step():
        with plain_layers():
            step(state, images, labels)

    (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (train_step_ms(dev, f)
                                                  for f in (plain_step, kernel_step, kernel_step, plain_step))
    log(f"  train step: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path {(p1 + p2) / 2:.3f} ms/step; "
        f"turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; peak device memory "
        f"kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
    del model, state, step, images

    b = B_TIME
    w, kw = layer_weights(lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16))
    x = torch.randn(b, N, DIM, generator=gen, device=dev).to(bf16)
    dy = torch.randn(b, N, DIM, generator=gen, device=dev).to(bf16)
    akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
    with torch.inference_mode():
        h = fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"])
        qkv = fb.gemm_bf16(h, w["w_qkv"], "qkv", bias=kw["b_qkv"])
        w_out_t, w_qkv_t = w["w_out"].t().contiguous(), w["w_qkv"].t().contiguous()
        dm = fb.gemm_bf16(dy, w_out_t, "cast")
        _, dqkv = fb.attention_bwd_rows(qkv, dm, **akw)
        dh = fb.gemm_f32out(dqkv, w_qkv_t)
        launches = (  # (kernel, site, kernel call, plain call) in the backward's order
            ("layernorm_rows", "ln1 (recompute)", lambda: fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]),
             lambda: fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])),
            ("gemm_bf16", "qkv (recompute)", lambda: fb.gemm_bf16(h, w["w_qkv"], "qkv", bias=kw["b_qkv"]),
             lambda: fb.gemm_bf16_reference(h, w["w_qkv"], "qkv", bias=kw["b_qkv"])),
            ("gemm_bf16", "dm = dy.W_out", lambda: fb.gemm_bf16(dy, w_out_t, "cast"),
             lambda: fb.gemm_bf16_reference(dy, w_out_t, "cast")),
            ("attention_bwd_rows", "attention backward", lambda: fb.attention_bwd_rows(qkv, dm, **akw),
             lambda: fb.attention_bwd_rows_reference(qkv, dm, **akw)),
            ("gemm_f32out", "dh = dqkv.W_qkv", lambda: fb.gemm_f32out(dqkv, w_qkv_t),
             lambda: fb.gemm_f32out_reference(dqkv, w_qkv_t)),
            ("layernorm_bwd_rows", "LN1 backward (+dy)",
             lambda: fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=dy),
             lambda: fb.layernorm_bwd_rows_reference(x, dh, w["ln1_scale"], residual=dy)),
        )
        per_kernel = {}
        inner = HEADS * DH
        works = {"attention_bwd_rows": attention_work(b, N, HEADS, backward=True),
                 "gemm_f32out": gemm_work(b * N, DIM, 3 * inner, out_bytes=4),
                 "layernorm_bwd_rows": ln_bwd_work(b * N, DIM, residual=True)}
        log(f"  one layer's backward launches at bs={b}:")
        for name, site, kern, plain in launches:
            km, pm = in_turns(kern, plain, 10)
            prod, prod_of = None, None
            lib_ms = None
            if name == "gemm_f32out":
                prod = linear_ms(dqkv, w_qkv_t)
            elif name == "attention_bwd_rows":
                prod, prod_of = sdpa_fwd_bwd_ms(qkv, dm, HEADS, 10), SDPA_FWD_BWD
            elif name == "layernorm_bwd_rows":
                lib_ms = ln_bwd_library_ms(x, dh, w["ln1_scale"], fb.LN_EPS)
            if name in works:
                record(per_kernel, name, km, pm, works[name], library_ms=lib_ms, product_ms=prod, product_of=prod_of)
            prod_note = "" if prod is None else (f", yardstick ({prod_of or 'product only: F.linear, bf16 out'}) "
                                                 f"{prod:.4f} ms")
            log(f"  {name}[{site}]: kernel {km:.4f} ms, plain {pm:.4f} ms{prod_note}")
    g = dy
    lk, lp = in_turns(lambda: layer_grads(fb.fused_transformer_layer, x, w, kw, g),
                      lambda: layer_grads(fb.layer_reference, x, w, kw, g), 5)
    log(f"  one layer forward+backward at bs={b}: kernels {lk:.4f} ms, plain {lp:.4f} ms")
    sync()
    return per_kernel


BLOCK_OPERANDS = ("x", "w_qkv", "w_out", "ln_scale", "ln_bias", "b_qkv", "b_out")


def block_grads(block, x, w, kw, g, rate):
    """Output and every operand gradient of one attention block (``block``
    is the kernel Function or its twin), called as the Transformer calls it
    (residual = x), for the cotangent ``g``."""
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, w["w_qkv"], w["w_out"], w["ln1_scale"], w["ln1_bias"], kw["b_qkv"], kw["b_out"])]
    xl, w_qkv, w_out, ln_s, ln_b, b_qkv, b_out = leaves
    out = block(xl, xl, w_qkv, w_out, ln_s, ln_b, heads=HEADS, dim_head=DH, b_qkv=b_qkv, b_out=b_out,
                dropout_rate=rate, dropout_seed=DROP_SEED if rate else None)
    return out, torch.autograd.grad(out, leaves, g)


def check_dropout(fb, rnd, dev):
    """Phase 9: the dropout kernels and the attention-block Function against
    their plain twins on the card; returns the largest max_abs of each
    kernel and the launches of the mask replay kernel in its checks."""
    log(f"[9 dropout kernels] rate {RATE}, seed {DROP_SEED}; b={B_CHECK} n={N} dim={DIM} heads={HEADS} dh={DH}, bf16")
    inner = HEADS * DH
    akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
    dkw = dict(dropout_rate=RATE, seed=DROP_SEED)
    w, kw = layer_weights(rnd)
    x = rnd(B_CHECK, N, DIM)
    errs = {"dropout_masks": 0.0, "dropout_apply": 0.0}
    fb.reset_launch_counts()
    with torch.inference_mode():
        for n in ATTN_CHECK_N:
            got = fb.dropout_masks(DROP_SEED, B_CHECK, n, DIM, HEADS, RATE, device=dev)
            want = fb.dropout_masks_reference(DROP_SEED, B_CHECK, n, DIM, HEADS, RATE, device=dev)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            fracs = [t.float().mean().item() for t in got]
            apart = not (torch.equal(got[0][0, 0], got[0][0, 1]) or torch.equal(got[0][0, 0], got[0][1, 0]))
            ok = same and apart and all(abs(f - (1 - RATE)) <= KEEP_FRACTION_TOL for f in fracs)
            log(f"  dropout_masks [n={n}] bitwise equal to the twin: {same}; streams of (img, head) apart: {apart}; "
                f"keep fraction attention {fracs[0]:.5f}, output {fracs[1]:.5f} (want {1 - RATE} +- "
                f"{KEEP_FRACTION_TOL}) {'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"dropout_masks [n={n}] disagrees with its twin or keeps the wrong fraction")
        sync()
        mask_launches = fb.LAUNCHES["dropout_masks"]
        h = fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])
        qkv_full = fb.gemm_bf16_reference(h, w["w_qkv"], "qkv", bias=kw["b_qkv"])
        attn_errs = []
        for n in ATTN_CHECK_N:
            qkv = qkv_full if n == N else rnd(B_CHECK, n, 3 * inner)
            attn_errs.append(compare(f"attention_rows[dropout] [n={n}]", fb.attention_rows(qkv, **akw, **dkw),
                                     fb.attention_rows_reference(qkv, **akw, **dkw), ATTN_ATOL, ATTN_RTOL))
        errs["attention_rows[dropout]"] = max(attn_errs)
        sync()
        m = rnd(B_CHECK, N, inner)
        bo_errs = []
        for site, rate, res in (("block_out", RATE, x), ("block_out, rate 0", 0.0, x),
                                ("block_out, no residual", RATE, None)):
            okw = dict(bias=kw["b_out"], residual=res, dropout_rate=rate, seed=DROP_SEED, heads=HEADS)
            bo_errs.append(compare(f"gemm_bf16[{site}]", fb.gemm_bf16(m, w["w_out"], "block_out", **okw),
                                   fb.gemm_bf16_reference(m, w["w_out"], "block_out", **okw), KERNEL_ATOL,
                                   KERNEL_RTOL, BLOCK_OUT_REL_L2))
        errs["gemm_bf16[block_out]"] = max(bo_errs)
        sync()
        g = rnd(B_CHECK, N, DIM)
        same = torch.equal(fb.dropout_apply(g, DROP_SEED, heads=HEADS, rate=RATE),
                           fb.out_dropout_bwd_reference(g, DROP_SEED, heads=HEADS, rate=RATE))
        log(f"  dropout_apply bitwise equal to the twin: {same} {'ok' if same else 'FAILED'}")
        if not same:
            fail("dropout_apply disagrees with its twin")
        sync()
        bwd_errs = []
        erd = edge_rnd(SEED + 9)
        for n in (*ATTN_CHECK_N, *ATTN_BWD_EDGE_N):
            draw = rnd if n in ATTN_CHECK_N else erd
            qkv = qkv_full if n == N else draw(B_CHECK, n, 3 * inner)
            dm = draw(B_CHECK, n, inner)
            bwd_errs.append(check_attention_bwd(fb, "attention_bwd_rows[dropout]", qkv, dm, {**akw, **dkw},
                                                f"n={n}"))
        errs["attention_bwd_rows[dropout]"] = max(bwd_errs)
        sync()
    g = rnd(B_CHECK, N, DIM)
    for rate in (0.0, RATE):
        fb.reset_launch_counts()
        out, grads = block_grads(fb.fused_attention_block, x, w, kw, g, rate)
        sync()
        counts = {k: v for k, v in fb.LAUNCHES.items() if v}
        out_want, grads_want = block_grads(fb.attention_block_reference, x, w, kw, g, rate)
        log(f"  attention block [rate {rate}]: launches {counts}")
        compare(f"attention block [rate {rate}] (out)", out, out_want, KERNEL_ATOL, KERNEL_RTOL)
        for name, a, b in zip(BLOCK_OPERANDS, grads, grads_want):
            compare(f"block grad d{name} [rate {rate}]", a, b, None, KERNEL_RTOL, BLOCK_GRAD_REL_L2,
                    atol_frac=BLOCK_GRAD_ATOL_FRAC)
    sync()
    return errs, mask_launches


def check_dropout_training(fb, dev, gen):
    """Phase 10: ViT-B/16 training steps with dropout 0.1 through
    make_train_step with a generator; returns the launch counts of the
    kernel path's steps."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[10 dropout training] ViT-B/16 @224, depth {DEPTH}, dropout {RATE}, emb_dropout {RATE}, remat=True, bf16, "
        f"seed {SEED}; bs={B_TRAIN}, {TRAIN_STEPS} Adam steps on one batch, dropout generator seed {SEED + 1}")
    model = vit_b(dev, bf16, dropout=RATE, emb_dropout=RATE)
    initial = copy.deepcopy(model)
    names = [n for n, _ in model.named_parameters()]
    images = torch.randn(B_TRAIN, 3, 224, 224, generator=gen, device=dev).to(bf16)
    labels = torch.randint(0, 1000, (B_TRAIN,), generator=gen, device=dev)
    state, step = create_train_state(model), make_train_step(model)
    drop_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    fb.reset_launch_counts()
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append(step(state, images, labels, drop_gen)["loss"].item())
        if i == 0:
            grads = grad_vector(model)
    sync()
    counts = dict(fb.LAUNCHES)
    want = {k: DEPTH * DROPOUT_LAUNCHES_PER_LAYER.get(k, 0) * TRAIN_STEPS for k in fb.LAUNCHES}
    log(f"  losses {[f'{v:.6f}' for v in losses]}; launches {counts} (expected {want}: {DEPTH} layers x "
        f"{sum(DROPOUT_LAUNCHES_PER_LAYER.values())} launches x {TRAIN_STEPS} steps)")
    if not all(v == v and abs(v) != float("inf") for v in losses) or not losses[-1] < losses[0]:
        fail("the dropout training loss is not finite or does not fall on the repeated batch")
    if counts != want:
        fail("the dropout training path did not launch every kernel of every layer")

    plain = copy.deepcopy(initial)
    fb.reset_launch_counts()
    with plain_layers():
        metrics = make_train_step(plain)(create_train_state(plain), images, labels,
                                         torch.Generator(device=dev).manual_seed(SEED + 1))
    loss_plain = metrics["loss"].item()
    sync()
    if any(fb.LAUNCHES.values()):
        fail(f"the plain path launched kernels: {fb.LAUNCHES}")
    compare_grads("first step vs plain bf16, same masks", grads, grad_vector(plain), losses[0], loss_plain,
                  TRAIN_VS_PLAIN, names)
    return counts


def train_step_ms(dev, fn, iters=2):
    """Host ms of one training step (after one warm-up step) and the peak
    device memory of those steps, GiB."""
    fn()
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t) * 1e3 / iters, torch.cuda.max_memory_allocated(dev) / 2**30


def time_dropout_training(fb, dev, gen, smi):
    """Phase 11: ms/step with dropout at bs=1024, kernel and plain paths in
    turns, peak memory, and each launch of one attention block at bs=128;
    returns the new kernels' (kernel ms, plain ms)."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[11 dropout training timing] ViT-B/16 bs={B_TRAIN_TIME}, dropout {RATE}, emb_dropout {RATE}, {smi}")
    model = vit_b(dev, bf16, dropout=RATE, emb_dropout=RATE)
    images = torch.randn(B_TRAIN_TIME, 3, 224, 224, generator=gen, device=dev).to(bf16)
    labels = torch.randint(0, 1000, (B_TRAIN_TIME,), generator=gen, device=dev)
    state, step = create_train_state(model), make_train_step(model)
    drop_gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def kernel_step():
        step(state, images, labels, drop_gen)

    def plain_step():
        with plain_layers():
            step(state, images, labels, drop_gen)

    (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (train_step_ms(dev, f)
                                                  for f in (plain_step, kernel_step, kernel_step, plain_step))
    log(f"  train step with dropout: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path {(p1 + p2) / 2:.3f} "
        f"ms/step; turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; peak device memory "
        f"kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
    del model, state, step, images

    b = B_TIME
    w, kw = layer_weights(lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16))
    x = torch.randn(b, N, DIM, generator=gen, device=dev).to(bf16)
    g = torch.randn(b, N, DIM, generator=gen, device=dev).to(bf16)
    akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5, dropout_rate=RATE, seed=DROP_SEED)
    okw = dict(bias=kw["b_out"], residual=x, dropout_rate=RATE, seed=DROP_SEED, heads=HEADS)
    with torch.inference_mode():
        h = fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"])
        qkv = fb.gemm_bf16(h, w["w_qkv"], "qkv", bias=kw["b_qkv"])
        m = fb.attention_rows(qkv, **akw)
        w_out_t, w_qkv_t = w["w_out"].t().contiguous(), w["w_qkv"].t().contiguous()
        gm = fb.dropout_apply(g, DROP_SEED, heads=HEADS, rate=RATE)
        dm = fb.gemm_bf16(gm, w_out_t, "cast")
        _, dqkv = fb.attention_bwd_rows(qkv, dm, **akw)
        dh = fb.gemm_f32out(dqkv, w_qkv_t)
        launches = (  # (kernel, site, kernel call, plain call): the forward's 4, then the backward's 7
            ("layernorm_rows", "ln1", lambda: fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]),
             lambda: fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])),
            ("gemm_bf16", "qkv", lambda: fb.gemm_bf16(h, w["w_qkv"], "qkv", bias=kw["b_qkv"]),
             lambda: fb.gemm_bf16_reference(h, w["w_qkv"], "qkv", bias=kw["b_qkv"])),
            ("attention_rows[dropout]", "attention", lambda: fb.attention_rows(qkv, **akw),
             lambda: fb.attention_rows_reference(qkv, **akw)),
            ("gemm_bf16[block_out]", "out (+b, dropout, +x)", lambda: fb.gemm_bf16(m, w["w_out"], "block_out", **okw),
             lambda: fb.gemm_bf16_reference(m, w["w_out"], "block_out", **okw)),
            ("dropout_apply", "gm", lambda: fb.dropout_apply(g, DROP_SEED, heads=HEADS, rate=RATE),
             lambda: fb.out_dropout_bwd_reference(g, DROP_SEED, heads=HEADS, rate=RATE)),
            ("layernorm_rows", "ln1 (recompute)", lambda: fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]),
             lambda: fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])),
            ("gemm_bf16", "qkv (recompute)", lambda: fb.gemm_bf16(h, w["w_qkv"], "qkv", bias=kw["b_qkv"]),
             lambda: fb.gemm_bf16_reference(h, w["w_qkv"], "qkv", bias=kw["b_qkv"])),
            ("gemm_bf16", "dm = gm.W_out", lambda: fb.gemm_bf16(gm, w_out_t, "cast"),
             lambda: fb.gemm_bf16_reference(gm, w_out_t, "cast")),
            ("attention_bwd_rows[dropout]", "attention backward", lambda: fb.attention_bwd_rows(qkv, dm, **akw),
             lambda: fb.attention_bwd_rows_reference(qkv, dm, **akw)),
            ("gemm_f32out", "dh = dqkv.W_qkv", lambda: fb.gemm_f32out(dqkv, w_qkv_t),
             lambda: fb.gemm_f32out_reference(dqkv, w_qkv_t)),
            ("layernorm_bwd_rows", "LN1 backward (+g)",
             lambda: fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=g),
             lambda: fb.layernorm_bwd_rows_reference(x, dh, w["ln1_scale"], residual=g)),
            ("dropout_masks", "mask replay", lambda: fb.dropout_masks(DROP_SEED, b, N, DIM, HEADS, RATE, device=dev),
             lambda: fb.dropout_masks_reference(DROP_SEED, b, N, DIM, HEADS, RATE, device=dev)),
        )
        per_kernel = {}
        inner = HEADS * DH
        works = {
            "attention_rows[dropout]": attention_work(b, N, HEADS, dropout=True),
            "gemm_bf16[block_out]": gemm_work(b * N, DIM, inner, bias=True, residual=True, dropout=True),
            "dropout_apply": work(2 * 2 * b * N * DIM, f32=PHILOX_OPS_PER_ELEMENT * b * N * DIM),
            "attention_bwd_rows[dropout]": attention_work(b, N, HEADS, backward=True, dropout=True),
            "dropout_masks": work(4 * (b * HEADS * N * N + b * N * DIM),
                                  f32=PHILOX_OPS_PER_ELEMENT * (b * HEADS * N * N + b * N * DIM)),
        }
        library = {"attention_rows[dropout]": sdpa_ms(qkv, HEADS, 10, dropout_p=RATE)}
        yardstick = {"attention_bwd_rows[dropout]": sdpa_fwd_bwd_ms(qkv, dm, HEADS, 10, dropout_p=RATE)}
        log(f"  one attention block's launches at bs={b} (forward, backward, then the mask replay):")
        for name, site, kern, plain in launches:
            km, pm = in_turns(kern, plain, 10)
            if name in works:
                record(per_kernel, name, km, pm, works[name], library.get(name), yardstick.get(name),
                       f"{SDPA_FWD_BWD}, dropout_p={RATE}" if name in yardstick else None)
            log(f"  {name}[{site}]: kernel {km:.4f} ms, plain {pm:.4f} ms")
        log(f"  {SDPA_FWD_BWD} with dropout_p={RATE} on the same qkv and dm: "
            f"{yardstick['attention_bwd_rows[dropout]']:.4f} ms")
        log(f"  scaled_dot_product_attention(dropout_p={RATE}) on the same qkv: "
            f"{library['attention_rows[dropout]']:.4f} ms")
    bk, bp = in_turns(lambda: block_grads(fb.fused_attention_block, x, w, kw, g, RATE),
                      lambda: block_grads(fb.attention_block_reference, x, w, kw, g, RATE), 5)
    log(f"  one attention block forward+backward at bs={b}, rate {RATE}: kernels {bk:.4f} ms, plain {bp:.4f} ms")
    sync()
    return per_kernel


def navit_images(seed, labels: bool):
    """The JAX benches' 120 images, drawn as they draw them from
    ``np.random.default_rng(seed)``: a resolution from the mix, the pixels,
    and (tools/bench_navit_train.py:53-58) a label after each image.
    Returns the images, the labels and the generator, which goes on to the
    token dropout."""
    rng = np.random.default_rng(seed)
    images, label_list = [], []
    for _ in range(NAVIT_IMAGES):
        h, w = NAVIT_RESOLUTIONS[rng.integers(len(NAVIT_RESOLUTIONS))]
        images.append(rng.normal(size=(3, h, w)).astype(np.float32))
        if labels:
            label_list.append(int(rng.integers(1000)))
    return images, label_list, rng


def pack_navit(images, rng, dev, *, train: bool):
    """The benches' packing: 16 packs of 2048 tokens, 16 query slots, bf16
    patches; token dropout 0.25 in training."""
    from vit_pytorch_tpu_torch.ops.packing import pack_images

    return pack_images(images, 16, max_seq_len=NAVIT_SEQ, token_dropout_prob=NAVIT_TOKEN_DROPOUT if train else None,
                       train=train, rng=rng, pad_groups_to=NAVIT_PACKS, max_images=NAVIT_MAX_IMAGES,
                       dtype=torch.bfloat16, device=dev)


def compare_or_zero(name, got, want, atol, rtol, max_rel_l2=KERNEL_REL_L2, atol_frac=None):
    """:func:`compare`, except that a ``want`` of zeros (a fully masked
    operand) must be matched exactly."""
    if want.numel() and want.abs().max().item() > 0:
        return compare(name, got, want, atol, rtol, max_rel_l2, atol_frac)
    ok = bool((got == 0).all())
    log(f"  {name:30s} want is all zeros; got all zeros: {ok} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name}: a fully masked operand is not zero")
    return got.float().abs().max().item() if got.numel() else 0.0


def flash_cases(fa, dev, gen):
    """Phase 12's cases: (name, q, k, v, q ids, kv ids, scale), bf16, h=12,
    dh=64.  q and k go through rms_norm as NaViT's do (rows of norm
    sqrt(64), logits up to ~+-64 at scale 1)."""
    from vit_pytorch_tpu_torch.models.na_vit import pooling_query_ids

    images, _, rng = navit_images(SEED, labels=False)
    packed = pack_navit(images, rng, dev, train=False)
    ids = packed.image_ids[:2].contiguous()

    def operands(b, n, m, norm):
        q, k, v = (torch.randn(b, HEADS, r, DH, generator=gen, device=dev) for r in (n, m, m))
        if norm:
            q, k = fa.rms_norm(q, 1.0), fa.rms_norm(k, 1.0)
        return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)

    pad = torch.full((1, NAVIT_SEQ), -1, dtype=torch.int32, device=dev)
    cases = (
        ("packed", *operands(2, NAVIT_SEQ, NAVIT_SEQ, True), ids, ids, 1.0),
        ("attn_pool", *operands(2, NAVIT_MAX_IMAGES, NAVIT_SEQ, True), pooling_query_ids(packed)[:2].contiguous(),
         ids, 1.0),
        ("all-pad", *operands(1, NAVIT_SEQ, NAVIT_SEQ, True), pad, pad, 1.0),
        ("no ids, n=m=1100", *operands(2, 1100, 1100, False), None, None, DH**-0.5),
    )
    return cases, packed


def flash_edge_cases(packed, dev, gen):
    """Phase 12's edge cases of flash_fwd's 64-key ring and head-ordered grid,
    drawn from ``gen``: keys that fill no whole tile (m = 1000, 130), one
    query and 129 queries, the packs' ids cut to 1000 tokens; rows of norm
    sqrt(64) as flash_cases'."""
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    def operands(b, n, m):
        q, k, v = (torch.randn(b, HEADS, r, DH, generator=gen, device=dev) for r in (n, m, m))
        return fa.rms_norm(q, 1.0).to(torch.bfloat16), fa.rms_norm(k, 1.0).to(torch.bfloat16), v.to(torch.bfloat16)

    ids = packed.image_ids[:2, :1000].contiguous()
    return (
        ("no ids, n=1 m=1000", *operands(2, 1, 1000), None, None, DH**-0.5),
        ("no ids, n=129 m=130", *operands(2, 129, 130), None, None, DH**-0.5),
        ("ids, n=m=1000", *operands(2, 1000, 1000), ids, ids, 1.0),
    )


def flash_bwd_twice(fa, label, q, k, v, do, lse, delta, **kw):
    """dq (flash_bwd_dq) and dk, dv (flash_bwd_dkv) of one case, each kernel
    run twice on the same inputs: every sum is made in one warpgroup in a
    fixed order (no atomics), so the two runs must be the same bits."""
    got = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw), *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw), *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  flash_bwd_dq, flash_bwd_dkv [{label}]: dq, dk, dv bitwise the same from run to run: {same}")
    if not same:
        fail(f"flash_bwd_dq / flash_bwd_dkv [{label}] are not bitwise the same from run to run")
    return got


def unsorted_ids(gen, dev, b, length):
    """(b, length) int32 ids of alternating runs, 0, 1, 0, 2, 0, 3, ..., each
    run 20-259 tokens long, so runs cross the 64-row tiles and a block's
    admitted tiles have gaps (no id order is assumed)."""
    runs = torch.randint(20, 260, (b, length), generator=gen, device=dev).tolist()
    rows = []
    for r in runs:
        row, k = [], 0
        while len(row) < length:
            row += [0 if k % 2 == 0 else k // 2 + 1] * r[k]
            k += 1
        rows.append(row[:length])
    return torch.tensor(rows, dtype=torch.int32, device=dev)


def flash_walk_cases(packed, dev, gen):
    """Phase 12's cases of the backward kernels' work items (128 rows) and
    their admission, drawn from ``gen``: unsorted ids over two 2048-token
    packs, n = m = 193 (a second item of 65 rows) without and with ids, and
    the causal mask with the diagonal in the middle of an item (n = m = 193,
    and unsorted ids at n = m = 1000); (name, q, k, v, q ids, kv ids, scale,
    causal)."""
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    def operands(b, n, m):
        q, k, v = (torch.randn(b, HEADS, r, DH, generator=gen, device=dev) for r in (n, m, m))
        return fa.rms_norm(q, 1.0).to(torch.bfloat16), fa.rms_norm(k, 1.0).to(torch.bfloat16), v.to(torch.bfloat16)

    unsorted = unsorted_ids(gen, dev, 2, NAVIT_SEQ)
    ids193 = packed.image_ids[:2, :193].contiguous()
    unsorted1000 = unsorted[:, :1000].contiguous()
    return (
        ("unsorted ids, n=m=2048", *operands(2, NAVIT_SEQ, NAVIT_SEQ), unsorted, unsorted, 1.0, False),
        ("no ids, n=m=193", *operands(2, 193, 193), None, None, DH**-0.5, False),
        ("ids, n=m=193", *operands(2, 193, 193), ids193, ids193, 1.0, False),
        ("causal, no ids, n=m=193", *operands(2, 193, 193), None, None, DH**-0.5, True),
        ("causal, unsorted ids, n=m=1000", *operands(2, 1000, 1000), unsorted1000, unsorted1000, 1.0, True),
    )


def check_flash(fa, dev, gen):
    """Phase 12: each flash kernel against its plain twin, and the Function
    against autograd through the materialized twin in f32, on the packed,
    attn_pool, all-pad and uneven cases; returns the largest max_abs of each
    kernel against its twin."""
    log(f"[12 flash kernels] bf16, heads={HEADS}, dh={DH}: two 2048-token packs of the seeded resolution mix, the "
        f"attn_pool shape (n={NAVIT_MAX_IMAGES}, empty slots at -2), an all-pad pack, no ids at n=m=1100")
    cases, packed = flash_cases(fa, dev, gen)
    admitted = fa.tile_admitted(packed.image_ids, packed.image_ids)
    log(f"  tiles admitted by the skip test at the packed shape ({NAVIT_PACKS} packs x {NAVIT_SEQ} tokens, "
        f"{fa.BLOCK_Q}x{fa.BLOCK_K} tiles): {admitted.float().mean().item():.4f} of {admitted.numel()}")
    errs = {name: 0.0 for name in TPU_FLASH}
    egen = torch.Generator(device=dev).manual_seed(SEED + 12)  # the edges' own: later phases keep their inputs
    edges = flash_edge_cases(packed, dev, egen)
    log(f"  and the edges of flash_fwd's ring: {', '.join(case[0] for case in edges)}")
    wgen = torch.Generator(device=dev).manual_seed(SEED + 112)  # the work items' cases, their own too
    walks = flash_walk_cases(packed, dev, wgen)
    log(f"  and the backward kernels' items and admission: {', '.join(case[0] for case in walks)}")
    for (name, q, k, v, qs, ks, scale, *causal), g in ([((*case, False), gen) for case in cases]
                                                      + [((*case, False), egen) for case in edges]
                                                      + [(case, wgen) for case in walks]):
        kw = dict(scale=scale, q_segment_ids=qs, kv_segment_ids=ks, causal=causal[0])
        do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
        fwd, dq_name, dkv_name = (fa._counter(kernel, causal=kw["causal"]) for kernel in TPU_FLASH)
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, **kw)
            o_want, lse_want = fa.flash_fwd_reference(q, k, v, **kw)
            errs[fwd] = max(errs.get(fwd, 0.0),
                            compare_or_zero(f"{fwd} o [{name}]", o, o_want, ATTN_ATOL, ATTN_RTOL))
            live = lse_want > 0.5 * fa.NEG_INF
            dead_ok = bool((lse[~live] == fa.NEG_INF).all())
            log(f"  {fwd} lse [{name}]: {int(live.sum())} rows with a key, {int((~live).sum())} without, which "
                f"read -1e30: {dead_ok}")
            if not dead_ok:
                fail(f"{fwd} lse [{name}]: a fully masked row does not read the sentinel")
            if live.any():
                errs[fwd] = max(errs[fwd], compare(
                    f"{fwd} lse [{name}]", lse[live], lse_want[live], FLASH_LSE_ATOL, FLASH_LSE_RTOL, F32_REL_L2))
            delta = (do.float() * o.float()).sum(-1)
            dq, dk, dv = flash_bwd_twice(fa, name, q, k, v, do, lse, delta, **kw)
            want = fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw)
            for kernel, part, got, w in ((dq_name, "dq", dq, want[0]), (dkv_name, "dk", dk, want[1]),
                                         (dkv_name, "dv", dv, want[2])):
                errs[kernel] = max(errs.get(kernel, 0.0), compare_or_zero(f"{kernel} {part} [{name}]", got, w, None,
                                                                          ATTN_RTOL, atol_frac=BWD_ATOL_FRAC))
        sync()
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, **kw)
        got = (out, *torch.autograd.grad(out, leaves, do))
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        out_ref = fa.flash_attention_reference(*ref, **kw)
        want = (out_ref, *torch.autograd.grad(out_ref, ref, do.float()))
        for part, a, b in zip(("o", "dq", "dk", "dv"), got, want):
            compare_or_zero(f"flash_attention {part} vs f32 twin [{name}]", a, b, None, ATTN_RTOL,
                            FLASH_VS_F32_REL_L2, atol_frac=FLASH_VS_F32_ATOL_FRAC)
        del leaves, ref, out, out_ref, got, want
        sync()
    return errs


@contextlib.contextmanager
def plain_flash(admit_fp32=False):
    """Every flash call of the dispatcher through the plain twins:
    ``flash_attention_twins``, the same Function with each kernel swapped
    for its twin (as ``plain_layers`` swaps the layer's).  With
    ``admit_fp32`` the kernels' gate admits fp32 too, so that an fp32 model
    runs the twins in f32 instead of the materialized composite, whose saved
    (n, m) matrices would not fit at NaViT-B's 16 training packs."""
    from vit_pytorch_tpu_torch.ops import attention
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    saved = attention.flash_attention, attention.flash_supported
    attention.flash_attention = fa.flash_attention_twins
    if admit_fp32:
        attention.flash_supported = lambda *args: True
    try:
        yield
    finally:
        attention.flash_attention, attention.flash_supported = saved


def navit_model(dev, dtype, nested=False, **kw):
    """NaViT-B (or the nested-tensor NaViT), random weights from SEED,
    initialised in f32 and cast as the JAX benches cast their params."""
    from vit_pytorch_tpu_torch.models import na_vit, na_vit_nested_tensor

    cls = na_vit_nested_tensor.NaViT if nested else na_vit.NaViT
    args = {**NAVIT, **kw}
    return cls(**args, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).to(dtype)


def all_launches(fb, fa):
    """Every launch counter: the attention-block and layer kernels', the
    flash kernels', the short kernel's."""
    from vit_pytorch_tpu_torch.ops import short_attention as sa

    return {**fb.LAUNCHES, **fa.LAUNCHES, **sa.LAUNCHES}


def reset_all(fb, fa):
    from vit_pytorch_tpu_torch.ops import short_attention as sa

    fb.reset_launch_counts()
    fa.reset_launch_counts()
    sa.reset_launch_counts()


def expect_launches(fb, fa, want, what):
    """Fail unless the launch counters read ``want`` exactly (every other
    kernel zero)."""
    counts = all_launches(fb, fa)
    full = {k: want.get(k, 0) for k in counts}
    log(f"  launches {({k: v for k, v in counts.items() if v})} (expected {({k: v for k, v in full.items() if v})})")
    if counts != full:
        fail(f"{what}: the launch counters are not the expected ones")
    return counts


def navit_paths(fb, fa, model, fp32, images, depth):
    """NaViT logits of ``images`` through the kernel path (its launch
    counters exact), the plain bf16 path and fp32 (which the gate sends to
    the materialized composite); returns (counts, kernel, plain, fp32)."""
    from vit_pytorch_tpu_torch.models.na_vit import forward_packed

    reset_all(fb, fa)
    logits = forward_packed(model, images)
    sync()
    counts = expect_launches(fb, fa, {"flash_fwd": depth + 1}, f"NaViT serving at depth {depth}")
    if logits.shape != (NAVIT_IMAGES, NAVIT["num_classes"]) or not bool(torch.isfinite(logits).all()):
        fail(f"NaViT serving: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    reset_all(fb, fa)
    with plain_flash():
        plain = forward_packed(model, images)
    want = forward_packed(fp32, images)
    sync()
    if any(all_launches(fb, fa).values()):
        fail(f"the plain and fp32 paths launched kernels: {all_launches(fb, fa)}")
    return counts, logits, plain, want


def check_navit_serving(fb, fa, dev):
    """Phase 13: NaViT-B serving through ``forward_packed`` on the 120-image
    mix, at depth 12 and 2: exact launch counters, logits against the plain
    bf16 path and fp32 (at depth 12 against the bf16 noise floor, see
    NAVIT_NOISE_RATIO); then a depth-2 nested-tensor NaViT against its plain
    path.  Returns the launch counts of the depth-12 forward."""
    from vit_pytorch_tpu_torch.models.na_vit import forward_packed
    from vit_pytorch_tpu_torch.models.na_vit_nested_tensor import forward_images

    log(f"[13 NaViT serving] NaViT-B ({NAVIT}), bf16, random weights (seed {SEED}); forward_packed on the "
        f"{NAVIT_IMAGES}-image resolution mix (tools/bench_zoo.py:148-162), packs of {NAVIT_SEQ} tokens")
    images, _, _ = navit_images(SEED, labels=False)
    noise = np.random.default_rng(SEED + 1)
    noisy = [img * (1 + NAVIT_INPUT_NOISE * noise.standard_normal(img.shape, dtype=np.float32)) for img in images]
    with torch.inference_mode():
        for depth in (DEPTH, NAVIT_SHALLOW):
            fp32 = navit_model(dev, torch.float32, depth=depth).eval()
            model = copy.deepcopy(fp32).to(torch.bfloat16)
            launches, logits, plain, want = navit_paths(fb, fa, model, fp32, images, depth)
            e_kp, e_kf, e_pf = rel_l2(logits, plain), rel_l2(logits, want), rel_l2(plain, want)
            if depth == DEPTH:
                counts = launches
                with plain_flash():
                    floor = rel_l2(forward_packed(model, noisy), plain)
                ok = e_kf <= NAVIT_NOISE_RATIO * e_pf and e_kp <= NAVIT_NOISE_RATIO * floor
                log(f"  depth {depth}, logits of {NAVIT_IMAGES} images, rel L2: kernel vs fp32 {e_kf:.4e} (bound "
                    f"{NAVIT_NOISE_RATIO} x plain bf16 vs fp32, {e_pf:.4e}); kernel vs plain bf16 {e_kp:.4e} (bound "
                    f"{NAVIT_NOISE_RATIO} x plain bf16 vs plain bf16 with {NAVIT_INPUT_NOISE} relative noise on the "
                    f"pixels, {floor:.4e}) {'ok' if ok else 'FAILED'}")
            else:
                ok = e_kp <= NAVIT_SHALLOW_VS_PLAIN and e_kf <= NAVIT_SHALLOW_VS_FP32
                log(f"  depth {depth}, logits of {NAVIT_IMAGES} images, rel L2: kernel vs plain bf16 {e_kp:.4e} "
                    f"(bound {NAVIT_SHALLOW_VS_PLAIN}); kernel vs fp32 {e_kf:.4e} (bound {NAVIT_SHALLOW_VS_FP32}; "
                    f"plain bf16 vs fp32 {e_pf:.4e}) {'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"NaViT serving logits at depth {depth} disagree with the plain path or fp32")
            del model, fp32

        nested = navit_model(dev, torch.bfloat16, nested=True, depth=NESTED_DEPTH).eval()
        reset_all(fb, fa)
        got = forward_images(nested, images)
        sync()
        expect_launches(fb, fa, {"flash_fwd": NESTED_DEPTH + 1}, "nested-tensor NaViT serving")
        with plain_flash():
            want = forward_images(nested, images)
        e = rel_l2(got, want)
        log(f"  nested-tensor NaViT (depth {NESTED_DEPTH}) logits: rel L2 vs plain bf16 {e:.4e} (bound "
            f"{NESTED_VS_PLAIN})")
        if not e <= NESTED_VS_PLAIN or not bool(torch.isfinite(got).all()):
            fail("nested-tensor NaViT logits disagree with the plain path")
    sync()
    return counts


def navit_labels(packed, labels):
    """tools/bench_navit_train.py:69-77: the labels in slot order, -1 on
    empty slots, (b, max_images) on the device."""
    b, num = packed.image_ids.shape[0], packed.num_images.tolist()
    lab = np.full((b, packed.max_images), -1, np.int64)
    idx = 0
    for g in range(b):
        for s in range(packed.max_images):
            if num[g] > s and idx < len(labels):
                lab[g, s] = labels[idx]
                idx += 1
    return torch.from_numpy(lab).to(packed.device)


def masked_ce(logits, labels):
    """The bench's loss (tools/bench_navit_train.py:97-103): softmax
    cross-entropy over the (b, max_images) slots, in f32, masked where the
    label is -1, averaged over the real images."""
    valid = labels >= 0
    ls = torch.nn.functional.cross_entropy(logits.float().flatten(0, 1), labels.clamp_min(0).flatten(),
                                           reduction="none")
    return (ls.view(labels.shape) * valid).sum() / valid.sum().clamp_min(1)


def navit_train_batch(dev):
    images, labels, rng = navit_images(SEED, labels=True)
    packed = pack_navit(images, rng, dev, train=True)
    return packed, navit_labels(packed, labels)


def check_navit_training(fb, fa, dev):
    """Phase 14: NaViT-B training through make_train_step with the masked
    loss on the bench's packed batch (token dropout 0.25).  Depth 12: 4
    steps, loss finite and falling, exact launch counters, the first step's
    loss against the plain bf16 path and fp32 (its gradients printed);
    depth 2: the first step's loss and gradients against both.  Returns the
    launch counts of the depth-12 steps."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    packed, labels = navit_train_batch(dev)
    tokens = int((packed.image_ids >= 0).sum())
    log(f"[14 NaViT training] NaViT-B, bf16 params and inputs, seed {SEED}; {NAVIT_IMAGES} images, token dropout "
        f"{NAVIT_TOKEN_DROPOUT}, {packed.image_ids.shape[0]} packs x {NAVIT_SEQ} ({tokens} real tokens), masked "
        f"cross-entropy, Adam 3e-4; depth {DEPTH}: {TRAIN_STEPS} steps on the batch; depth {NAVIT_SHALLOW}: one")
    for depth in (DEPTH, NAVIT_SHALLOW):
        fp32 = navit_model(dev, torch.float32, depth=depth, token_dropout_prob=NAVIT_TOKEN_DROPOUT)
        model = copy.deepcopy(fp32).to(bf16)
        initial = copy.deepcopy(model)
        names = [n for n, _ in model.named_parameters()]
        steps = TRAIN_STEPS if depth == DEPTH else 1
        state, step = create_train_state(model), make_train_step(model, masked_ce)
        reset_all(fb, fa)
        losses = []
        for i in range(steps):
            losses.append(step(state, packed, labels)["loss"].item())
            if i == 0:
                grads = grad_vector(model)
        sync()
        launches = expect_launches(fb, fa, {k: (depth + 1) * steps for k in TPU_FLASH},
                                   f"NaViT training at depth {depth}")
        plain = copy.deepcopy(initial)
        reset_all(fb, fa)
        with plain_flash():
            loss_plain = make_train_step(plain, masked_ce)(create_train_state(plain), packed, labels)["loss"].item()
        sync()
        if any(all_launches(fb, fa).values()):
            fail(f"the plain path launched kernels: {all_launches(fb, fa)}")
        # fp32 through the twins in f32: the composite's saved (n, m) matrices
        # would not fit at 16 packs
        with plain_flash(admit_fp32=True):
            metrics = make_train_step(fp32, masked_ce)(create_train_state(fp32), packed.to(dtype=torch.float32),
                                                       labels)
        loss_fp32, plain_grads, fp32_grads = metrics["loss"].item(), grad_vector(plain), grad_vector(fp32)
        if depth == DEPTH:
            counts = launches
            log(f"  depth {depth}: losses {[f'{v:.6f}' for v in losses]}")
            if not all(v == v and abs(v) != float("inf") for v in losses) or not losses[-1] < losses[0]:
                fail("the NaViT training loss is not finite or does not fall on the repeated batch")
            d_plain, d_fp32 = (abs(losses[0] - v) / abs(v) for v in (loss_plain, loss_fp32))
            ok = d_plain <= NAVIT_DEEP_LOSS and d_fp32 <= NAVIT_DEEP_LOSS and all(
                bool(torch.isfinite(g).all()) for g in grads)
            log(f"  depth {depth}, first step: loss {losses[0]:.6f}, rel to plain bf16 {d_plain:.3e}, to fp32 "
                f"{d_fp32:.3e} (bound {NAVIT_DEEP_LOSS}) {'ok' if ok else 'FAILED'}; gradients (finite; not bounded at "
                f"this depth) rel L2 kernel vs plain bf16 {grads_rel_l2(grads, plain_grads):.4e}, kernel vs fp32 "
                f"{grads_rel_l2(grads, fp32_grads):.4e}, plain bf16 vs fp32 {grads_rel_l2(plain_grads, fp32_grads):.4e}")
            if not ok:
                fail(f"NaViT training at depth {depth}: the first step's loss is out of bounds")
        else:
            log(f"  depth {depth}, first step: plain bf16 vs fp32 gradients rel L2 "
                f"{grads_rel_l2(plain_grads, fp32_grads):.4e}")
            compare_grads(f"depth {depth}, first step vs plain bf16", grads, plain_grads, losses[0], loss_plain,
                          NAVIT_TRAIN_VS_PLAIN, names)
            compare_grads(f"depth {depth}, first step vs fp32", grads, fp32_grads, losses[0], loss_fp32,
                          NAVIT_TRAIN_VS_FP32, names)
        del model, plain, fp32, initial, state, step
        sync()
    return counts


def time_navit(fb, fa, dev, gen, smi):
    """Phase 15: NaViT-B serving img/s and tokens/s and the training ms/step
    (peak memory), kernel against plain paths in turns, and each flash launch
    at the packed shape; returns each flash kernel's (kernel ms, plain ms)."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[15 NaViT timing] {smi}")
    images, _, rng = navit_images(SEED, labels=False)
    packed = pack_navit(images, rng, dev, train=False)
    tokens = int((packed.image_ids >= 0).sum())
    model = navit_model(dev, bf16).eval()
    with torch.inference_mode():
        def serve():
            model(packed)

        def serve_plain():
            with plain_flash():
                model(packed)

        p1, k1, k2, p2 = (host_ms(f, 5) for f in (serve_plain, serve, serve, serve_plain))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    log(f"  serving {NAVIT_IMAGES} images ({tokens} tokens in {NAVIT_PACKS} packs of {NAVIT_SEQ}): kernel path "
        f"{NAVIT_IMAGES * 1e3 / k_ms:.1f} img/s, {tokens / k_ms:.1f} k tokens/s ({k_ms:.3f} ms/batch); plain bf16 "
        f"path {NAVIT_IMAGES * 1e3 / p_ms:.1f} img/s ({p_ms:.3f} ms/batch); turns ms plain {p1:.3f} kernel {k1:.3f} "
        f"kernel {k2:.3f} plain {p2:.3f}")
    del model

    packed, labels = navit_train_batch(dev)
    model = navit_model(dev, bf16, token_dropout_prob=NAVIT_TOKEN_DROPOUT)
    state, step = create_train_state(model), make_train_step(model, masked_ce)

    def kernel_step():
        step(state, packed, labels)

    def plain_step():
        with plain_flash():
            step(state, packed, labels)

    (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (train_step_ms(dev, f)
                                                  for f in (plain_step, kernel_step, kernel_step, plain_step))
    k_ms = (k1 + k2) / 2
    log(f"  training step, {packed.image_ids.shape[0]} packs ({NAVIT_IMAGES} images, token dropout "
        f"{NAVIT_TOKEN_DROPOUT}): kernel path {k_ms:.3f} ms/step ({NAVIT_IMAGES * 1e3 / k_ms:.1f} img/s), plain bf16 "
        f"path {(p1 + p2) / 2:.3f} ms/step; turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; "
        f"peak device memory kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
    del model, state, step

    ids = packed.image_ids
    shape = (ids.shape[0], HEADS, NAVIT_SEQ, DH)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    q, k = fa.rms_norm(q, 1.0), fa.rms_norm(k, 1.0)
    q, k, v, do = (t.to(bf16) for t in (q, k, v, do))
    kw = dict(scale=1.0, q_segment_ids=ids, kv_segment_ids=ids)
    per_kernel = {}
    with torch.inference_mode():
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        launches = (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, **kw), lambda: fa.flash_fwd_reference(q, k, v, **kw)),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw)),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
             lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw)),
        )
        log(f"  each flash launch at the packed shape ({shape[0]} packs x {HEADS} heads x {NAVIT_SEQ} tokens, NaViT's "
            f"ids; the backward kernels' plain twin computes dq, dk and dv at once):")
        # the library call beside flash_fwd: SDPA under the block-diagonal mask
        mask = ((ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0))[:, None]
        library = {"flash_fwd": cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0), 5)}
        bwd = sdpa_bwd_only_ms(q, k, v, do, 5, attn_mask=mask, scale=1.0)  # beside both backward kernels
        del mask
        for name, kern, plain in launches:
            km, pm = in_turns(kern, plain, 5)
            yard = dict(product_ms=bwd, product_of=SDPA_BWD_ONLY) if name != "flash_fwd" else {}
            record(per_kernel, name, km, pm, flash_work(name, ids, HEADS), library.get(name), **yard)
            log(f"  {name}: kernel {km:.4f} ms, plain {pm:.4f} ms")
        log(f"  scaled_dot_product_attention with the (b, 1, n, n) block-diagonal mask: {library['flash_fwd']:.4f} ms; "
            f"its backward (forward + backward less the forward) {bwd:.4f} ms")
    sync()
    return per_kernel


# -- the SimpleViT slice (phases 16-19) ----------------------------------------
# SimpleViT, BASELINE config 2 as the JAX bench runs it (tools/bench_zoo.py:
# 132-141): 64 tokens, served at bs=256; SimpleViT-qk-norm at the repo's qk-norm
# bench config (tools/bench_qknorm_model.py:28-29): 196 tokens, served at
# bs=128 behind the ViT buckets, trained at bs=256.  Its "head" is a LayerNorm
# over the mean-pooled tokens, so outputs and training labels are dim (768)
# wide, as in the JAX model.
SIMPLE = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=16, mlp_dim=2048, dim_head=64)
QKNORM = dict(image_size=224, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP)
SIMPLE_BS, QKNORM_BS, QKNORM_TRAIN_BS = 256, 128, 256
SIMPLE_N = (SIMPLE["image_size"] // SIMPLE["patch_size"]) ** 2
QKNORM_N = (QKNORM["image_size"] // QKNORM["patch_size"]) ** 2
SIMPLE_BUCKETS, SIMPLE_REQUESTS = (1, 8, 32, 256), (1, 5, 32, 256)
REGISTER_TOKENS, REGISTER_REQUEST = 4, 8
# the attention block's launches: forward 4; a training step adds the
# backward's 6 (the FF is plain PyTorch); the qk-norm model's attention
# launches are the [qknorm] variants
BLOCK_FWD_LAUNCHES = {"layernorm_rows": 1, "gemm_bf16": 1, "attention_rows": 1, "gemm_bf16[block_out]": 1}
BLOCK_TRAIN_LAUNCHES = {"layernorm_rows": 2, "gemm_bf16": 3, "attention_rows": 1, "gemm_bf16[block_out]": 1,
                        "attention_bwd_rows": 1, "gemm_f32out": 1, "layernorm_bwd_rows": 1}
# Phase 16: the qk-norm kernels against their twins, at the shapes of phase 3
# and at SimpleViT-qk-norm's served shape (b=128, n=196).
# dq, dk, dv: the backward bounds of phase 6.  The attention output m: the
# relative-L2 bound of phase 3, and elementwise 2^-5 of the largest element
# (4 ulps) instead of phase 3's 2 ulps of each: with gammas 1 + 0.2 N(0, 1) the
# normed rows have norm ~8 and the scale-1 logits reach ~64, so a q or k
# element whose bf16 rounding flips (the f32 sum of squares in another order)
# moves a logit by a few hundredths and the near-top softmax weights by
# percents; a right kernel reads max_abs/max|want| <= 6.5e-3 there (3.4e-3 at
# the init gammas) and rel L2 <= 1.7e-4.  The f32 dgamma_q/dgamma_k (sums over
# every row of the batch of dq * qhat) inherit those flips through dq and
# qhat: a right kernel reads rel L2 1.1e-4 to 1.7e-4 at the random gammas,
# 2.3e-5 to 2.9e-5 at the init gammas, max_abs/max|want| <= 5.9e-4 (H100 80GB
# HBM3, 700 W); bounds ~3x those.  A dgamma without its sqrt(dh) factor is off
# by 7/8 of itself.
QK_ATTN_ATOL_FRAC = 2.0**-5
QK_DGAMMA_ATOL_FRAC, QK_DGAMMA_RTOL, QK_DGAMMA_REL_L2 = 2e-3, 1e-3, 5e-4
QK_BLOCK_OPERANDS = ("x", "w_qkv", "w_out", "ln_scale", "ln_bias", "gamma_q", "gamma_k")
# Phases 17-18: logits, first-step loss and gradients of both models against
# the plain bf16 path and fp32.
SIMPLE_LOGITS_VS_PLAIN, SIMPLE_LOGITS_VS_FP32 = 3e-2, 5e-2
SIMPLE_TRAIN_VS_PLAIN = dict(loss=2e-3, grads=3e-2, worst=5e-2)
SIMPLE_TRAIN_VS_FP32 = dict(loss=2e-3, grads=3e-2, worst=5e-2)
TPU_QK_KERNELS = {"attention_rows[qknorm]": (SOURCE, TPU_BLOCK_KERNEL),
                  "attention_bwd_rows[qknorm]": (ATTN_BWD_SOURCE, TPU_BWD_KERNEL)}


def variant_launches(launches, qk_norm: bool):
    """A per-layer launch table with the attention kernels' [qknorm] names."""
    rename = {"attention_rows": "attention_rows[qknorm]", "attention_bwd_rows": "attention_bwd_rows[qknorm]"}
    return {(rename.get(k, k) if qk_norm else k): v for k, v in launches.items()}


def qk_gammas(rnd, kind, dev):
    """(heads, 1, dh) bf16 gammas: SimpleViT-qk-norm's init dh**-0.5 (unit
    rows, logits in [-1, 1]) or 1 + 0.2 N(0, 1) (rows of norm ~8, logits up
    to ~64, as tests/test_fused_qknorm.py draws them)."""
    if kind == "init":
        g = torch.full((HEADS, 1, DH), DH**-0.5, dtype=torch.bfloat16, device=dev)
        return g, g.clone()
    return 1 + rnd(HEADS, 1, DH, scale=0.2), 1 + rnd(HEADS, 1, DH, scale=0.2)


def qk_block_grads(block, x, w, gq, gk, g, rate):
    """Output and every operand gradient of one qk-norm attention block
    (``block`` is the kernel Function or its twin), called as
    SimpleViT-qk-norm calls it (no residual, no biases), for ``g``."""
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, w["w_qkv"], w["w_out"], w["ln1_scale"], w["ln1_bias"], gq, gk)]
    xl, w_qkv, w_out, ln_s, ln_b, gql, gkl = leaves
    out = block(xl, None, w_qkv, w_out, ln_s, ln_b, heads=HEADS, dim_head=DH, gamma_q=gql, gamma_k=gkl,
                dropout_rate=rate, dropout_seed=DROP_SEED if rate else None)
    return out, torch.autograd.grad(out, leaves, g)


def check_qknorm(fb, rnd, dev):
    """Phase 16: attention_rows[qknorm] and attention_bwd_rows[qknorm] (m,
    dqkv, dgamma_q, dgamma_k), with and without dropout 0.1, against their
    twins at phase 3's shapes and SimpleViT-qk-norm's served one; the dgammas twice, bitwise (no atomics); the qk-norm block
    Function's output and its 7 gradients against the same Function on the
    twins.  Returns the largest max_abs of each variant."""
    log(f"[16 qk-norm kernels] b={B_CHECK} n={N} and 50, b={QKNORM_BS} n={QKNORM_N}, dim={DIM} heads={HEADS} "
        f"dh={DH}, scale 1, bf16; gammas "
        f"at SimpleViT-qk-norm's init {DH**-0.5:.3f} and 1 + 0.2 N(0, 1); dropout 0 and {RATE}")
    inner = HEADS * DH
    akw = dict(heads=HEADS, dim_head=DH, scale=1.0)
    w, kw = layer_weights(rnd)
    x = rnd(B_CHECK, N, DIM)
    random_g, init_g = qk_gammas(rnd, "random", dev), qk_gammas(rnd, "init", dev)
    errs = {}
    with torch.inference_mode():
        h = fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])
        qkv_full = fb.gemm_bf16_reference(h, w["w_qkv"], "qkv", bias=kw["b_qkv"])
        qkv_main = rnd(QKNORM_BS, QKNORM_N, 3 * inner)  # SimpleViT-qk-norm's served shape
        erd = edge_rnd(SEED + 16)
        cases = ((f"n={N}, random gammas", qkv_full, random_g, rnd), (f"n={N}, init gammas", qkv_full, init_g, rnd),
                 ("n=50, random gammas", rnd(B_CHECK, 50, 3 * inner), random_g, rnd),
                 (f"b={QKNORM_BS} n={QKNORM_N}, init gammas", qkv_main, init_g, rnd),
                 (f"b={QKNORM_BS} n={QKNORM_N}, random gammas", qkv_main, random_g, rnd),
                 *((f"n={n}, random gammas", erd(B_CHECK, n, 3 * inner), random_g, erd) for n in ATTN_BWD_EDGE_N))
        for rate in (0.0, RATE):
            tag = "qknorm" if rate == 0.0 else "dropout,qknorm"
            fwd, bwd = f"attention_rows[{tag}]", f"attention_bwd_rows[{tag}]"
            fwd_errs, bwd_errs = [], []
            for label, qkv, (gq, gk), draw in cases:
                dkw = dict(dropout_rate=rate, seed=DROP_SEED if rate else None, gamma_q=gq, gamma_k=gk)
                fwd_errs.append(compare(f"{fwd} [{label}]", fb.attention_rows(qkv, **akw, **dkw),
                                        fb.attention_rows_reference(qkv, **akw, **dkw), None, ATTN_RTOL,
                                        atol_frac=QK_ATTN_ATOL_FRAC))
                dm = draw(qkv.shape[0], qkv.shape[1], inner)
                bwd_errs.append(check_attention_bwd(fb, bwd, qkv, dm, {**akw, **dkw}, label, None, QK_ATTN_ATOL_FRAC))
            errs[fwd], errs[bwd] = max(fwd_errs), max(bwd_errs)
            sync()
    g = rnd(B_CHECK, N, DIM)
    for rate in (0.0, RATE):
        fb.reset_launch_counts()
        out, grads = qk_block_grads(fb.fused_attention_block, x, w, *random_g, g, rate)
        sync()
        counts = {k: v for k, v in fb.LAUNCHES.items() if v}
        out_want, grads_want = qk_block_grads(fb.attention_block_reference, x, w, *random_g, g, rate)
        log(f"  qk-norm attention block [rate {rate}]: launches {counts}")
        compare(f"qk-norm block [rate {rate}] (out)", out, out_want, KERNEL_ATOL, KERNEL_RTOL)
        for name, a, b in zip(QK_BLOCK_OPERANDS, grads, grads_want):
            compare(f"qk-norm block grad d{name} [rate {rate}]", a, b, None, KERNEL_RTOL, BLOCK_GRAD_REL_L2,
                    atol_frac=BLOCK_GRAD_ATOL_FRAC)
    sync()
    return errs


def check_simple_attention(fb, rnd):
    """Phase 16: attention_rows and attention_bwd_rows against their twins
    on the same inputs at SimpleViT config 2's shapes (b=256, n=64 and 64 +
    4 register tokens, 16 heads), with the bounds of phases 3 and 6.  Returns
    the largest max_abs of each kernel, and attention_rows' at config 2's 64
    tokens as "attention_rows[config 2]"."""
    heads = SIMPLE["heads"]
    inner = heads * DH
    akw = dict(heads=heads, dim_head=DH, scale=DH**-0.5)
    fwd_errs, bwd_errs = [], []
    with torch.inference_mode():
        for n in (SIMPLE_N, SIMPLE_N + REGISTER_TOKENS):
            label = f"b={SIMPLE_BS} n={n} heads={heads}"
            qkv, dm = rnd(SIMPLE_BS, n, 3 * inner), rnd(SIMPLE_BS, n, inner)
            fwd_errs.append(compare(f"attention_rows [{label}]", fb.attention_rows(qkv, **akw),
                                    fb.attention_rows_reference(qkv, **akw), ATTN_ATOL, ATTN_RTOL))
            if n == SIMPLE_N:
                config2_err = fwd_errs[-1]
            bwd_errs.append(check_attention_bwd(fb, "attention_bwd_rows", qkv, dm, akw, label))
            if n == SIMPLE_N:
                config2_bwd_err = bwd_errs[-1]
    sync()
    return {"attention_rows": max(fwd_errs), "attention_bwd_rows": max(bwd_errs),
            "attention_rows[config 2]": config2_err, "attention_bwd_rows[config 2]": config2_bwd_err}


def simple_model(kind, dev, dtype, **kw):
    """SimpleViT config 2 ("simple"), its register-token variant
    ("registers") or SimpleViT-qk-norm ("qknorm"), random weights from SEED,
    initialised in f32 and cast as the JAX bench casts its params."""
    from vit_pytorch_tpu_torch.models import simple_vit, simple_vit_with_qk_norm, simple_vit_with_register_tokens

    cls, cfg = {"simple": (simple_vit.SimpleViT, SIMPLE), "qknorm": (simple_vit_with_qk_norm.SimpleViT, QKNORM),
                "registers": (simple_vit_with_register_tokens.SimpleViT, SIMPLE)}[kind]
    if kind == "registers":
        kw = {"num_register_tokens": REGISTER_TOKENS, **kw}
    return cls(**cfg, **kw, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).to(dtype)


def serve_simple(fb, kind, dev, rnd):
    """Serve one SimpleViT behind a Predictor: exact launch counters, logits
    against the plain bf16 path and fp32.  Returns the launch counts of the
    requests."""
    from vit_pytorch_tpu_torch.serving import Predictor

    cfg = QKNORM if kind == "qknorm" else SIMPLE
    buckets, requests = (BUCKETS, REQUESTS) if kind == "qknorm" else (SIMPLE_BUCKETS, SIMPLE_REQUESTS)
    size, depth = cfg["image_size"], cfg["depth"]
    fp32 = simple_model(kind, dev, torch.float32).eval()
    pred = Predictor(fp32, example_shape=(3, size, size), batch_sizes=buckets, device=dev).warmup()
    images = {k: rnd(k, 3, size, size, dtype=torch.float32) for k in requests}
    runs = sum(-(-k // buckets[-1]) for k in requests)
    fb.reset_launch_counts()
    outs = {k: pred(images[k]) for k in requests}
    sync()
    width = cfg["dim"] if kind == "qknorm" else cfg["num_classes"]
    for k, out in outs.items():
        if out.shape != (k, width) or not bool(torch.isfinite(out).all()):
            fail(f"{kind} request of {k} images: shape {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    per_layer = variant_launches(BLOCK_FWD_LAUNCHES, kind == "qknorm")
    want = {name: depth * per_layer.get(name, 0) * runs for name in fb.LAUNCHES}
    log(f"  requests {requests} -> {runs} bucket runs; launches {({k: v for k, v in fb.LAUNCHES.items() if v})} "
        f"(expected {depth} layers x {sum(per_layer.values())} launches x {runs} runs)")
    counts = dict(fb.LAUNCHES)
    if counts != want:
        fail(f"{kind} serving did not launch every attention kernel of every layer")
    k = 32
    fb.reset_launch_counts()
    with torch.inference_mode():
        with plain_layers():
            plain = pred.model(images[k].to(torch.bfloat16))
        want_fp32 = fp32(images[k])
    sync()
    if any(fb.LAUNCHES.values()):
        fail(f"the plain and fp32 paths launched kernels: {fb.LAUNCHES}")
    e_plain, e_fp32, floor = rel_l2(outs[k], plain), rel_l2(outs[k], want_fp32), rel_l2(plain, want_fp32)
    ok = e_plain <= SIMPLE_LOGITS_VS_PLAIN and e_fp32 <= SIMPLE_LOGITS_VS_FP32
    log(f"  outputs of the {k}-image request, rel L2: vs plain bf16 {e_plain:.4e} (bound {SIMPLE_LOGITS_VS_PLAIN}), "
        f"vs fp32 {e_fp32:.4e} (bound {SIMPLE_LOGITS_VS_FP32}; plain bf16 vs fp32 {floor:.4e}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{kind} served outputs disagree with the plain path or fp32")
    return counts


def check_simple_serving(fb, dev, rnd):
    """Phase 17: SimpleViT config 2 behind buckets up to 256, its register
    variant (n = 64 + 4) and SimpleViT-qk-norm behind the ViT buckets, each
    with exact launch counters and outputs against the plain bf16 path and
    fp32.  Returns the launch counts of config 2's and of the qk-norm
    model's requests."""
    log(f"[17 SimpleViT serving] config 2 {SIMPLE}, bf16, random weights (seed {SEED}), buckets {SIMPLE_BUCKETS}")
    simple_counts = serve_simple(fb, "simple", dev, rnd)
    model = simple_model("registers", dev, torch.bfloat16).eval()
    img = rnd(REGISTER_REQUEST, 3, SIMPLE["image_size"], SIMPLE["image_size"])
    with torch.inference_mode():
        fb.reset_launch_counts()
        got = model(img)
        sync()
        counts = dict(fb.LAUNCHES)
        with plain_layers():
            want = model(img)
    per_layer = BLOCK_FWD_LAUNCHES
    e = rel_l2(got, want)
    ok = counts == {k: SIMPLE["depth"] * per_layer.get(k, 0) for k in counts} and e <= SIMPLE_LOGITS_VS_PLAIN
    log(f"  with {REGISTER_TOKENS} register tokens (n = 64 + {REGISTER_TOKENS}), {REGISTER_REQUEST} images: "
        f"launches {({k: v for k, v in counts.items() if v})}; logits rel L2 vs plain bf16 {e:.4e} (bound "
        f"{SIMPLE_LOGITS_VS_PLAIN}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("SimpleViT with register tokens: launches or logits wrong")
    del model
    log(f"  SimpleViT-qk-norm {QKNORM}, bf16, buckets {BUCKETS}")
    return simple_counts, serve_simple(fb, "qknorm", dev, rnd)


def check_simple_training(fb, dev, gen):
    """Phase 18: SimpleViT config 2 and SimpleViT-qk-norm through
    make_train_step, 4 Adam steps on one batch each: loss finite and
    falling, exact launch counters, the first step's loss and gradients
    (the gammas' included) against the plain bf16 path and fp32.  Returns
    the launch counts of SimpleViT's steps and of the qk-norm steps."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    for kind in ("simple", "qknorm"):
        cfg = QKNORM if kind == "qknorm" else SIMPLE
        width = cfg["dim"] if kind == "qknorm" else cfg["num_classes"]
        log(f"[18 SimpleViT training] {kind}: depth {cfg['depth']}, bf16, seed {SEED}; bs={B_TRAIN}, {TRAIN_STEPS} "
            f"Adam steps on one batch, labels in [0, {width})")
        fp32 = simple_model(kind, dev, torch.float32)
        model = copy.deepcopy(fp32).to(bf16)
        initial = copy.deepcopy(model)
        names = [n for n, _ in model.named_parameters()]
        size = cfg["image_size"]
        images = torch.randn(B_TRAIN, 3, size, size, generator=gen, device=dev)
        labels = torch.randint(0, width, (B_TRAIN,), generator=gen, device=dev)
        state, step = create_train_state(model), make_train_step(model)
        fb.reset_launch_counts()
        losses = []
        for i in range(TRAIN_STEPS):
            losses.append(step(state, images.to(bf16), labels)["loss"].item())
            if i == 0:
                grads = grad_vector(model)
        sync()
        counts = dict(fb.LAUNCHES)
        per_layer = variant_launches(BLOCK_TRAIN_LAUNCHES, kind == "qknorm")
        want = {k: cfg["depth"] * per_layer.get(k, 0) * TRAIN_STEPS for k in fb.LAUNCHES}
        log(f"  losses {[f'{v:.6f}' for v in losses]}; launches {({k: v for k, v in counts.items() if v})} "
            f"(expected {cfg['depth']} layers x {sum(per_layer.values())} launches x {TRAIN_STEPS} steps)")
        if not all(v == v and abs(v) != float("inf") for v in losses) or not losses[-1] < losses[0]:
            fail(f"{kind} training loss is not finite or does not fall on the repeated batch")
        if counts != want:
            fail(f"{kind} training did not launch every attention kernel of every layer")
        if kind == "qknorm":
            qk_counts = counts
        else:
            simple_counts = counts
        plain = copy.deepcopy(initial)
        fb.reset_launch_counts()
        with plain_layers():
            loss_plain = make_train_step(plain)(create_train_state(plain), images.to(bf16), labels)["loss"].item()
        sync()
        if any(fb.LAUNCHES.values()):
            fail(f"the plain path launched kernels: {fb.LAUNCHES}")
        loss_fp32 = make_train_step(fp32)(create_train_state(fp32), images, labels)["loss"].item()
        plain_grads, fp32_grads = grad_vector(plain), grad_vector(fp32)
        log(f"  plain bf16 vs fp32: loss rel {abs(loss_plain - loss_fp32) / abs(loss_fp32):.3e}, gradients rel L2 "
            f"{grads_rel_l2(plain_grads, fp32_grads):.4e}")
        compare_grads(f"{kind} first step vs plain bf16", grads, plain_grads, losses[0], loss_plain,
                      SIMPLE_TRAIN_VS_PLAIN, names)
        compare_grads(f"{kind} first step vs fp32", grads, fp32_grads, losses[0], loss_fp32, SIMPLE_TRAIN_VS_FP32,
                      names)
        del model, plain, fp32, initial, state, step
        sync()
    return simple_counts, qk_counts


def time_simple(fb, dev, gen, smi):
    """Phase 19: serving img/s (SimpleViT config 2 at bs=256, SimpleViT-qk-norm
    at bs=128) and training ms/step with peak memory (both at bs=256), kernel
    against plain paths in turns; each qk-norm launch alone at the served
    shape; attention_rows at config 2's 64 tokens against its bound and the
    library call; both models' gemm_bf16[block_out] sites against their twins,
    bounds and library calls.  Returns the timing entries of the qk-norm
    variants and of the two block_out sites, and the sites' max_abs."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[19 SimpleViT timing] {smi}")
    for kind, bs in (("simple", SIMPLE_BS), ("qknorm", QKNORM_BS)):
        size = (QKNORM if kind == "qknorm" else SIMPLE)["image_size"]
        model = simple_model(kind, dev, bf16).eval()
        img = torch.randn(bs, 3, size, size, generator=gen, device=dev).to(bf16)
        with torch.inference_mode():
            def serve_plain():
                with plain_layers():
                    model(img)

            p1, k1, k2, p2 = (host_ms(f) for f in (serve_plain, lambda: model(img), lambda: model(img), serve_plain))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"  {kind} serving at bs={bs}: kernel path {bs * 1e3 / k_ms:.1f} img/s ({k_ms:.3f} ms/batch), plain bf16 "
            f"path {bs * 1e3 / p_ms:.1f} img/s ({p_ms:.3f} ms/batch); turns ms plain {p1:.3f} kernel {k1:.3f} "
            f"kernel {k2:.3f} plain {p2:.3f}")
        del model, img
    for kind, bs in (("simple", SIMPLE_BS), ("qknorm", QKNORM_TRAIN_BS)):
        cfg = QKNORM if kind == "qknorm" else SIMPLE
        width = cfg["dim"] if kind == "qknorm" else cfg["num_classes"]
        model = simple_model(kind, dev, bf16)
        images = torch.randn(bs, 3, cfg["image_size"], cfg["image_size"], generator=gen, device=dev).to(bf16)
        labels = torch.randint(0, width, (bs,), generator=gen, device=dev)
        state, step = create_train_state(model), make_train_step(model)

        def plain_step():
            with plain_layers():
                step(state, images, labels)

        kernel_step = lambda: step(state, images, labels)
        (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (train_step_ms(dev, f)
                                                      for f in (plain_step, kernel_step, kernel_step, plain_step))
        log(f"  {kind} training at bs={bs}: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path "
            f"{(p1 + p2) / 2:.3f} ms/step; turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; "
            f"peak device memory kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
        del model, state, step, images

    b, n, inner = QKNORM_BS, QKNORM_N, HEADS * DH
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(bf16)
    qkv, dm = rnd(b, n, 3 * inner), rnd(b, n, inner)
    gq = torch.full((HEADS, 1, DH), DH**-0.5, dtype=bf16, device=dev)
    akw = dict(heads=HEADS, dim_head=DH, scale=1.0, gamma_q=gq, gamma_k=gq.clone())
    per_kernel = {}
    with torch.inference_mode():
        log(f"  each qk-norm launch at SimpleViT-qk-norm's serving shape (b={b}, n={n}, heads={HEADS}; no single "
            f"torch call computes the qk-norm attention):")
        for name, kern, plain, w in (
            ("attention_rows[qknorm]", lambda: fb.attention_rows(qkv, **akw),
             lambda: fb.attention_rows_reference(qkv, **akw), attention_work(b, n, HEADS, qknorm=True)),
            ("attention_bwd_rows[qknorm]", lambda: fb.attention_bwd_rows(qkv, dm, **akw),
             lambda: fb.attention_bwd_rows_reference(qkv, dm, **akw),
             attention_work(b, n, HEADS, backward=True, qknorm=True)),
        ):
            km, pm = in_turns(kern, plain, 10)
            prod = sdpa_fwd_bwd_ms(qkv, dm, HEADS, 10, scale=1.0) if "bwd" in name else None
            record(per_kernel, name, km, pm, w, product_ms=prod,
                   product_of=f"{SDPA_FWD_BWD}, without the qk-norm" if prod is not None else None)
            bound, by = bound_ms(w)
            prod_note = "" if prod is None else f", {SDPA_FWD_BWD} without the qk-norm {prod:.4f} ms"
            log(f"  {name}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms ({by}){prod_note}")
        plain_akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
        km = cuda_ms(lambda: fb.attention_rows(qkv, **plain_akw), 10)
        log(f"  attention_rows (no qk-norm) at the same shape: {km:.4f} ms")
        b2, n2, h2 = SIMPLE_BS, SIMPLE_N, SIMPLE["heads"]
        qkv2 = rnd(b2, n2, 3 * h2 * DH)
        c2kw = dict(heads=h2, dim_head=DH, scale=DH**-0.5)
        km, pm = in_turns(lambda: fb.attention_rows(qkv2, **c2kw), lambda: fb.attention_rows_reference(qkv2, **c2kw), 20)
        w2, lib_ms = attention_work(b2, n2, h2), sdpa_ms(qkv2, h2, 20)
        record(per_kernel, "attention_rows[config 2]", km, pm, w2, lib_ms)
        bound, by = bound_ms(w2)
        log(f"  attention_rows at SimpleViT config 2's shape (b={b2}, n={n2}, heads={h2}; "
            f"{fb.attention_key_chunks(n2)} key chunks of 16): kernel {km:.4f} ms, plain {pm:.4f} ms, bound "
            f"{bound:.4f} ms ({by}), scaled_dot_product_attention {lib_ms:.4f} ms")
        dm2 = edge_rnd(SEED + 19)(b2, n2, h2 * DH)
        km, pm = in_turns(lambda: fb.attention_bwd_rows(qkv2, dm2, **c2kw),
                          lambda: fb.attention_bwd_rows_reference(qkv2, dm2, **c2kw), 20)
        w2, prod = attention_work(b2, n2, h2, backward=True), sdpa_fwd_bwd_ms(qkv2, dm2, h2, 20)
        record(per_kernel, "attention_bwd_rows[config 2]", km, pm, w2, product_ms=prod, product_of=SDPA_FWD_BWD)
        bound, by = bound_ms(w2)
        log(f"  attention_bwd_rows at the same shape: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms "
            f"({by}), {SDPA_FWD_BWD} {prod:.4f} ms")
        # the out projection of both models' blocks: no bias, so one torch
        # call computes it (SimpleViT adds the residual in the epilogue:
        # torch.addmm; SimpleViT-qk-norm adds it outside the block: F.linear)
        errs = {}
        for name, b_, n_, d, res in (("gemm_bf16[block_out, +x]", b2, n2, SIMPLE["dim"], True),
                                     ("gemm_bf16[block_out, bare]", b, n, DIM, False)):
            m, w_out = rnd(b_, n_, d), rnd(d, d) * d**-0.5
            x = rnd(b_, n_, d) if res else None
            okw = dict(residual=x)
            errs[name] = compare(name, fb.gemm_bf16(m, w_out, "block_out", **okw),
                                 fb.gemm_bf16_reference(m, w_out, "block_out", **okw), KERNEL_ATOL, KERNEL_RTOL,
                                 BLOCK_OUT_REL_L2)
            if res:
                lib = lambda: torch.addmm(x.view(-1, d), m.view(-1, d), w_out.t())
            else:
                lib = lambda: torch.nn.functional.linear(m, w_out)
            km, pm = in_turns(lambda: fb.gemm_bf16(m, w_out, "block_out", **okw),
                              lambda: fb.gemm_bf16_reference(m, w_out, "block_out", **okw), 20)
            lib_ms, w = cuda_ms(lib, 20), gemm_work(b_ * n_, d, d, residual=res)
            record(per_kernel, name, km, pm, w, lib_ms)
            bound, by = bound_ms(w)
            log(f"  {name} at b={b_} n={n_} dim={d}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms "
                f"({by}), {'torch.addmm' if res else 'F.linear'} {lib_ms:.4f} ms")
    sync()
    return per_kernel, errs


# -- the opt-in backwards of the whole layer (phases 20-21): the ports of
# _ff_bwd_kernel (VIT_TPU_FF_BWD=full|hybrid) and _layer_bwd_kernel
# (VIT_TPU_ENABLE_WHOLE_LAYER_BWD), switched on in-process, one at a time
TPU_FF_BWD_KERNEL = "vit_pytorch_tpu/ops/fused_block.py:1493"
TPU_LAYER_BWD_KERNEL = "vit_pytorch_tpu/ops/fused_block.py:1156"
WGRAD_SOURCE = "vit_pytorch_tpu_torch/csrc/gemm_wgrad.cu"
FF_CHECK_SHAPES = ((B_CHECK, N), (3, 61))  # 1,576 rows, and 183: a multiple of no tile (8, 64, 128)
# (mode, environment) of phase 21, and each mode's launches a layer a step
FF_MODES = (("full", {"VIT_TPU_FF_BWD": "full"}), ("hybrid", {"VIT_TPU_FF_BWD": "hybrid"}),
            ("layer", {"VIT_TPU_ENABLE_WHOLE_LAYER_BWD": "1"}))
_FF_CHAIN = {"layernorm_rows": 1, "gemm_bf16[fc1_save]": 1, "gemm_bf16[gelu_bwd]": 1, "gemm_f32out": 1,
             "layernorm_bwd_rows[res_f32]": 1}
_FWD = {"layernorm_rows": 2, "gemm_bf16": 4, "attention_rows": 1}
_ATTN_BWD = {"layernorm_rows": 1, "gemm_bf16": 2, "attention_bwd_rows": 1, "gemm_f32out": 1}


def _add(*parts):
    out = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out


FF_MODE_LAUNCHES_PER_LAYER = {
    "full": _add(_FWD, _FF_CHAIN, {"gemm_wgrad": 2}, _ATTN_BWD, {"layernorm_bwd_rows": 1}),
    "hybrid": _add(_FWD, _FF_CHAIN, _ATTN_BWD, {"layernorm_bwd_rows": 1}),
    "layer": _add(_FWD, _FF_CHAIN, {"gemm_wgrad": 2}, _ATTN_BWD, {"layernorm_bwd_rows[res_f32]": 1, "gemm_wgrad": 2}),
}
FF_KERNELS = {  # the new kernels and variants: (source, the TPU kernel it replaces)
    "gemm_bf16[fc1_save]": (SOURCE, TPU_FF_BWD_KERNEL), "gemm_bf16[gelu_bwd]": (SOURCE, TPU_FF_BWD_KERNEL),
    "layernorm_bwd_rows[res_f32]": (BWD_SOURCE, TPU_FF_BWD_KERNEL), "gemm_wgrad": (WGRAD_SOURCE, TPU_LAYER_BWD_KERNEL),
}


@contextlib.contextmanager
def env_switch(env, keys=("VIT_TPU_FF_BWD", "VIT_TPU_ENABLE_FF_BWD", "VIT_TPU_ENABLE_WHOLE_LAYER_BWD")):
    """The JAX package's switches ``keys`` (by default the backward ones)
    unset, then ``env`` set, in-process, and restored after (the port reads
    them at call time)."""
    saved = {k: os.environ.get(k) for k in keys}
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def wgrad_work(k, m, n):
    """dW (m, n) f32 = a^T b over k rows: both bf16 operands read once, the
    f32 result written once."""
    return work(2 * k * (m + n) + 4 * m * n, tensor=2 * m * n * k)


def ff_works(rows):
    """The work of the FF chain's new launches at ``rows`` rows of ViT-B
    (layernorm_bwd_rows[res_f32] with the bf16 residual and output of the
    ``full`` and ``hybrid`` chains)."""
    ln = ln_bwd_work(rows, DIM, residual=True)
    return {
        "gemm_bf16[fc1_save]": gemm_work(rows, MLP, DIM, bias=True, out_bytes=4),
        "gemm_bf16[gelu_bwd]": work(gemm_work(rows, MLP, DIM, residual=True)["bytes"] + 4 * MLP,
                                    tensor=2 * rows * MLP * DIM, f32=15 * rows * MLP),
        "layernorm_bwd_rows[res_f32]": work(ln["bytes"] + 4 * DIM, f32=ln["f32"] + 2 * rows * DIM),
    }


def check_ff_kernels(fb, rnd):
    """Phase 20: each new kernel of the opt-in backwards against its plain
    twin at phase 6's shapes and at 183 rows, the column sums and gemm_wgrad
    bitwise deterministic, and the whole layer's 13 gradients under each
    switch against the same Function on the twins; returns the largest
    max_abs of each kernel."""
    log(f"[20 FF backward kernels] rows {[b * n for b, n in FF_CHECK_SHAPES]}, dim={DIM}, mlp={MLP}, bf16")
    inner = HEADS * DH
    w, kw = layer_weights(rnd)
    errs = dict.fromkeys(FF_KERNELS, 0.0)

    def f32_check(name, got, want):
        return compare(name, got, want, None, F32_RTOL, F32_REL_L2, atol_frac=F32_ATOL_FRAC)

    def same(name, a, b):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"{name} is not bitwise deterministic")

    with torch.inference_mode():
        for b, n in FF_CHECK_SHAPES:
            tag = f"[rows={b * n}]"
            y, g = rnd(b, n, DIM), rnd(b, n, DIM)
            y2 = fb.layernorm_rows_reference(y, w["ln2_scale"], w["ln2_bias"])
            act, h1 = fb.gemm_bf16(y2, w["w1"], "fc1_save", bias=w["b1"])
            act_w, h1_w = fb.gemm_bf16_reference(y2, w["w1"], "fc1_save", bias=w["b1"])
            e = max(compare(f"gemm_bf16[fc1_save] act {tag}", act, act_w, KERNEL_ATOL, KERNEL_RTOL),
                    compare(f"gemm_bf16[fc1_save] h1 {tag}", h1, h1_w, KERNEL_ATOL, KERNEL_RTOL))
            errs["gemm_bf16[fc1_save]"] = max(errs["gemm_bf16[fc1_save]"], e)
            w2_t = w["w2"].t().contiguous()
            got = fb.gemm_bf16(g, w2_t, "gelu_bwd", aux=h1_w)
            dh1_w, db1_w = fb.gemm_bf16_reference(g, w2_t, "gelu_bwd", aux=h1_w)
            e = max(compare(f"gemm_bf16[gelu_bwd] dh1 {tag}", got[0], dh1_w, KERNEL_ATOL, KERNEL_RTOL),
                    f32_check(f"gemm_bf16[gelu_bwd] db1 {tag}", got[1], db1_w))
            errs["gemm_bf16[gelu_bwd]"] = max(errs["gemm_bf16[gelu_bwd]"], e)
            same("gemm_bf16[gelu_bwd]", got, fb.gemm_bf16(g, w2_t, "gelu_bwd", aux=h1_w))
            dyln = fb.gemm_f32out_reference(dh1_w, w["w1"].t().contiguous())
            for res, out_f32 in ((g, False), (rnd(b, n, DIM, dtype=torch.float32), True)):
                kind = f"{'f32' if res.dtype == torch.float32 else 'bf16'} residual, {'f32' if out_f32 else 'bf16'} dx"
                lkw = dict(residual=res, res_f32=True, out_f32=out_f32)
                got = fb.layernorm_bwd_rows(y, dyln, w["ln2_scale"], **lkw)
                want = fb.layernorm_bwd_rows_reference(y, dyln, w["ln2_scale"], **lkw)
                name = f"layernorm_bwd_rows[res_f32] {tag} {kind}"
                e = (f32_check(f"{name} dx", got[0], want[0]) if out_f32
                     else compare(f"{name} dx", got[0], want[0], KERNEL_ATOL, KERNEL_RTOL))
                for i, part in enumerate(("dgamma", "dbeta", "residual sum"), 1):
                    e = max(e, f32_check(f"{name} {part}", got[i], want[i]))
                errs["layernorm_bwd_rows[res_f32]"] = max(errs["layernorm_bwd_rows[res_f32]"], e)
                same("layernorm_bwd_rows[res_f32]", got, fb.layernorm_bwd_rows(y, dyln, w["ln2_scale"], **lkw))
            rows = lambda t: t.reshape(-1, t.shape[-1])
            m, dqkv = rnd(b, n, inner), rnd(b, n, 3 * inner)
            for site, a_, b_ in (("dW2 = g^T act", g, act_w), ("dW1 = dh1^T y2", dh1_w, y2),
                                 ("dW_out = dy^T m", g, m), ("dW_qkv = dqkv^T h", dqkv, y2)):
                got = fb.gemm_wgrad(rows(a_), rows(b_))
                e = f32_check(f"gemm_wgrad {site} {tag}", got, fb.gemm_wgrad_reference(rows(a_), rows(b_)))
                errs["gemm_wgrad"] = max(errs["gemm_wgrad"], e)
                same("gemm_wgrad", (got,), (fb.gemm_wgrad(rows(a_), rows(b_)),))
            sync()
        check_ln_bwd_paths(fb, f32_check, same)
    x, g = rnd(B_CHECK, N, DIM), rnd(B_CHECK, N, DIM)
    for mode, env in FF_MODES:
        with env_switch(env):
            out, grads = layer_grads(fb.fused_transformer_layer, x, w, kw, g)
            out_want, grads_want = layer_grads(fb.layer_reference, x, w, kw, g)
        compare(f"fused_transformer_layer [{mode}] (out)", out, out_want, LAYER_ATOL, LAYER_RTOL)
        for name, a, b in zip(("x", *w, *kw), grads, grads_want):
            compare(f"layer grad d{name} [{mode}]", a, b, None, KERNEL_RTOL, LAYER_GRAD_REL_L2,
                    atol_frac=LAYER_GRAD_ATOL_FRAC)
        sync()
    return errs


# layernorm_bwd_rows and [res_f32] at each of their paths: dims 200 (one
# 16-byte chunk a lane, lanes 25-31 idle), 768 (ViT-B, three), 1024 (four,
# the widest the registers hold), 1032 (the loop past them), 2416 ([res_f32]'s
# widest) and 3584 (the plain variant's widest), at LN_BWD_PATH_ROWS rows; and
# ViT-B at bs=128's 25,216 rows, where the grid stops at 396 blocks and each
# warp takes 15-16 rows.  From a generator of their own.
LN_BWD_PATH_DIMS = (200, 768, 1024, 1032, 2416, 3584)
LN_BWD_PATH_ROWS = 1576


def check_ln_bwd_paths(fb, f32_check, same):
    """Phase 20: both LayerNorm backward variants against their twins at
    LN_BWD_PATH_DIMS and at bs=128's rows, each run twice, bitwise from run
    to run (dx, dgamma, dbeta, the residual's sum)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rn = lambda *s, dtype=torch.bfloat16: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    cases = [(LN_BWD_PATH_ROWS, d) for d in LN_BWD_PATH_DIMS] + [(B_TIME * N, DIM)]
    for rows, dim in cases:
        tag = f"[rows={rows} dim={dim}]"
        x, dh, wt = rn(rows, dim), rn(rows, dim, dtype=torch.float32), (1 + 0.1 * rn(dim, dtype=torch.float32))
        wt = wt.to(torch.bfloat16)
        variants = [("layernorm_bwd_rows", "+dy", dict(residual=rn(rows, dim)))]
        if dim <= fb.LN_BWD_RES_MAX_DIM:
            variants += [("layernorm_bwd_rows[res_f32]", "bf16 residual, bf16 dx",
                          dict(residual=rn(rows, dim), res_f32=True)),
                         ("layernorm_bwd_rows[res_f32]", "f32 residual, f32 dx",
                          dict(residual=rn(rows, dim, dtype=torch.float32), res_f32=True, out_f32=True))]
        for name, kind, lkw in variants:
            got = fb.layernorm_bwd_rows(x, dh, wt, **lkw)
            want = fb.layernorm_bwd_rows_reference(x, dh, wt, **lkw)
            label = f"{name} {tag} {kind}"
            if lkw.get("out_f32"):
                f32_check(f"{label} dx", got[0], want[0])
            else:
                compare(f"{label} dx", got[0], want[0], KERNEL_ATOL, KERNEL_RTOL)
            for i, part in enumerate(("dgamma", "dbeta", "residual sum")[:len(got) - 1], 1):
                f32_check(f"{label} {part}", got[i], want[i])
            again = fb.layernorm_bwd_rows(x, dh, wt, **lkw)
            same(name, got, again)
            log(f"  {label}: run twice, every output bitwise: {all(torch.equal(a, b) for a, b in zip(got, again))}")
        sync()


def train_ff_modes(fb, dev, gen):
    """Phase 21, correctness: ViT-B/16 trained 4 steps under each switch
    (loss falls, exact launch counters), the first step's loss and gradients
    against the plain twins under the same switch; returns the new kernels'
    launches summed over the three modes' kernel-path steps."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[21 opt-in backwards] ViT-B/16 @224, depth {DEPTH}, remat=True, dropout 0, bf16, seed {SEED}; bs={B_TRAIN}, "
        f"{TRAIN_STEPS} Adam steps on one batch under each of {[env for _, env in FF_MODES]}")
    base = vit_b(dev, bf16)
    names = [n for n, _ in base.named_parameters()]
    images = torch.randn(B_TRAIN, 3, 224, 224, generator=gen, device=dev).to(bf16)
    labels = torch.randint(0, 1000, (B_TRAIN,), generator=gen, device=dev)
    launches = dict.fromkeys(FF_KERNELS, 0)
    for mode, env in FF_MODES:
        with env_switch(env):
            model = copy.deepcopy(base)
            state, step = create_train_state(model), make_train_step(model)
            fb.reset_launch_counts()
            losses = []
            for i in range(TRAIN_STEPS):
                losses.append(step(state, images, labels)["loss"].item())
                if i == 0:
                    grads = grad_vector(model)
            sync()
            counts = dict(fb.LAUNCHES)
            per_layer = FF_MODE_LAUNCHES_PER_LAYER[mode]
            want = {k: DEPTH * per_layer.get(k, 0) * TRAIN_STEPS for k in fb.LAUNCHES}
            log(f"  [{mode}] losses {[f'{v:.6f}' for v in losses]}; launches {counts} (expected {want}: {DEPTH} "
                f"layers x {sum(per_layer.values())} launches x {TRAIN_STEPS} steps)")
            if not all(v == v and abs(v) != float("inf") for v in losses) or not losses[-1] < losses[0]:
                fail(f"[{mode}] the training loss is not finite or does not fall on the repeated batch")
            if counts != want:
                fail(f"[{mode}] the training path did not launch every kernel of every layer")
            for k in launches:
                launches[k] += counts[k]
            plain = copy.deepcopy(base)
            fb.reset_launch_counts()
            with plain_layers():
                loss_plain = make_train_step(plain)(create_train_state(plain), images, labels)["loss"].item()
            sync()
            if any(fb.LAUNCHES.values()):
                fail(f"[{mode}] the plain path launched kernels: {fb.LAUNCHES}")
            compare_grads(f"[{mode}] first step vs plain bf16, same switch", grads, grad_vector(plain), losses[0],
                          loss_plain, TRAIN_VS_PLAIN, names)
            del model, plain, state, step
    return launches


def time_ff_modes(fb, dev, gen, smi):
    """Phase 21, timing: ms/step at bs=1024 of the default backward and of
    each switch, in turns (default, full, hybrid, layer, layer, hybrid,
    full, default), with peak memory; each new launch at bs=128 against its
    twin, its bound and the library call; one gemm_wgrad launch at bs=1024.
    Returns the timing entries."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[21 opt-in backwards timing] ViT-B/16 bs={B_TRAIN_TIME}, {smi}")
    model = vit_b(dev, bf16)
    images = torch.randn(B_TRAIN_TIME, 3, 224, 224, generator=gen, device=dev).to(bf16)
    labels = torch.randint(0, 1000, (B_TRAIN_TIME,), generator=gen, device=dev)
    state, step = create_train_state(model), make_train_step(model)
    modes = (("default", {}), *FF_MODES)
    runs = {name: [] for name, _ in modes}
    for name, env in (*modes, *reversed(modes)):
        with env_switch(env):
            runs[name].append(train_step_ms(dev, lambda: step(state, images, labels)))
    for name, r in runs.items():
        log(f"  train step [{name}]: {sum(t for t, _ in r) / len(r):.3f} ms/step (turns {[round(t, 3) for t, _ in r]}), "
            f"peak device memory {max(m for _, m in r):.2f} GiB")
    del model, state, step, images

    b = B_TIME
    rows = b * N
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)
    w, _ = layer_weights(rnd)
    y, g, m = rnd(b, N, DIM), rnd(b, N, DIM), rnd(b, N, HEADS * DH)
    dqkv = rnd(b, N, 3 * HEADS * DH)
    per_kernel = {}
    flat = lambda t: t.reshape(-1, t.shape[-1])
    with torch.inference_mode():
        y2 = fb.layernorm_rows(y, w["ln2_scale"], w["ln2_bias"])
        act, h1 = fb.gemm_bf16(y2, w["w1"], "fc1_save", bias=w["b1"])
        w2_t, w1_t = w["w2"].t().contiguous(), w["w1"].t().contiguous()
        dh1, _ = fb.gemm_bf16(g, w2_t, "gelu_bwd", aux=h1)
        dyln = fb.gemm_f32out(dh1, w1_t)
        works = ff_works(rows)
        launches = (  # (kernel, site, kernel call, plain call) in the FF chain's order; no one torch call
            # computes any of them
            ("gemm_bf16[fc1_save]", "act, h1 = gelu(y2.W1 + b1)",
             lambda: fb.gemm_bf16(y2, w["w1"], "fc1_save", bias=w["b1"]),
             lambda: fb.gemm_bf16_reference(y2, w["w1"], "fc1_save", bias=w["b1"])),
            ("gemm_bf16[gelu_bwd]", "dh1 = g.W2 * gelu'(h1), db1", lambda: fb.gemm_bf16(g, w2_t, "gelu_bwd", aux=h1),
             lambda: fb.gemm_bf16_reference(g, w2_t, "gelu_bwd", aux=h1)),
            ("layernorm_bwd_rows[res_f32]", "LN2 backward (+g, one cast)",
             lambda: fb.layernorm_bwd_rows(y, dyln, w["ln2_scale"], residual=g, res_f32=True),
             lambda: fb.layernorm_bwd_rows_reference(y, dyln, w["ln2_scale"], residual=g, res_f32=True)),
        )
        products = {"gemm_bf16[fc1_save]": (y2, w["w1"]), "gemm_bf16[gelu_bwd]": (g, w2_t)}
        log(f"  each new launch at bs={b} (rows {rows}):")
        for name, site, kern, plain in launches:
            km, pm = in_turns(kern, plain, 10)
            prod = linear_ms(*products[name], 10) if name in products else None
            lib_ms = ln_bwd_library_ms(y, dyln, w["ln2_scale"], fb.LN_EPS) if name.startswith("layernorm") else None
            record(per_kernel, name, km, pm, works[name], library_ms=lib_ms, product_ms=prod)
            bound, by = bound_ms(works[name])
            prod_note = "" if prod is None else f", product-only yardstick (F.linear, no epilogue) {prod:.4f} ms"
            log(f"  {name}[{site}]: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms ({by}){prod_note}")
        # gemm_wgrad: one layer's four sites (the whole-layer backward's; full mode runs the first two)
        for site, a_, b_ in (("dW2 = g^T act", g, act), ("dW1 = dh1^T y2", dh1, y2),
                             ("dW_out = dy^T m", g, m), ("dW_qkv = dqkv^T h", dqkv, y2)):
            a2, b2 = flat(a_), flat(b_)
            km, pm = in_turns(lambda: fb.gemm_wgrad(a2, b2), lambda: fb.gemm_wgrad_reference(a2, b2), 10)
            lib_ms = cuda_ms(lambda: torch.matmul(a2.t(), b2), 10)
            wk = wgrad_work(rows, a2.shape[1], b2.shape[1])
            record(per_kernel, "gemm_wgrad", km, pm, wk, lib_ms)
            bound, by = bound_ms(wk)
            log(f"  gemm_wgrad[{site}] ({a2.shape[1]} x {b2.shape[1]}, K={rows}): kernel {km:.4f} ms, plain "
                f"{pm:.4f} ms, bound {bound:.4f} ms ({by}), torch.matmul(a.t(), b) {lib_ms:.4f} ms")
        del y2, act, h1, dh1, dyln
        k_big = B_TRAIN_TIME * N
        a_big, b_big = rnd(k_big, MLP), rnd(k_big, DIM)
        km = cuda_ms(lambda: fb.gemm_wgrad(a_big, b_big), 5)
        lib_ms = cuda_ms(lambda: torch.matmul(a_big.t(), b_big), 5)
        bound, by = bound_ms(wgrad_work(k_big, MLP, DIM))
        log(f"  gemm_wgrad[dW1] at bs={B_TRAIN_TIME} (K={k_big}): kernel {km:.4f} ms "
            f"({2 * k_big * MLP * DIM / km / 1e9:.1f} TFLOP/s), bound {bound:.4f} ms ({by}), torch.matmul(a.t(), b) "
            f"{lib_ms:.4f} ms")
        del a_big, b_big
    sync()
    return per_kernel


# -- the NaViT dropout slice (phases 22-24) -------------------------------------
# NaViT-B trained at dropout 0.1, emb_dropout 0.1 (the upstream README's NaViT
# example) on phase 14's packed batch: each layer's attention runs the
# [dropout] instantiations of the flash kernels; attn_pool has none (JAX
# models/na_vit.py:92-100), so a step launches DEPTH of each [dropout] kernel
# and one of each rate-0 kernel.
FLASH_DROPOUT = ("flash_fwd[dropout]", "flash_bwd_dq[dropout]", "flash_bwd_dkv[dropout]")
TPU_FLASH_DROPOUT = {  # their dropout branches: :255-290, :352-361, :425-456
    **{f"{name}[dropout]": TPU_FLASH[name] for name in TPU_FLASH},
    "flash_dropout_masks": "vit_pytorch_tpu/ops/flash_attention.py:897",
}
# Phase 22 holds each [dropout] kernel to its twin with phase 12's bounds, and
# adds a packed case with q = 0, where every p is exactly 1: there the kernel
# and its twin round at the same points on identical p, so o differs only by
# f32 summation order, and its rel L2 to the twin is bounded tightly, to
# refuse a kernel that scales p by 1/(1 - rate) before its bf16 cast (a 0.16%
# shift at rate 0.1) where the random cases' bf16 flips would hide it.
FLASH_UNIFORM_REL_L2 = 5e-4
NESTED_DROPOUT_STEPS = 2


def check_flash_dropout(fa, fb, dev, gen):
    """Phase 22: the flash_dropout_masks replay bitwise against its twin and,
    at n = m, against the attention block's dropout_masks, with the keep
    fraction; each [dropout] flash kernel against its twin at rate 0.1 on
    phase 12's cases and a packed case with q = 0; the Function against
    autograd through the f32 materialized composite fed the same masks.
    Returns the largest max_abs of each kernel against its twin and the
    replay kernel's launches in its checks."""
    log(f"[22 flash dropout kernels] rate {RATE}, seed {DROP_SEED}; bf16, heads={HEADS}, dh={DH}: phase 12's cases and "
        f"the packed case with q = 0 (every p exactly 1)")
    cases, _ = flash_cases(fa, dev, gen)
    _, q, *rest = cases[0]  # the two 2048-token packs
    cases = (*cases, ("packed, q = 0", torch.zeros_like(q), *rest))
    dkw = dict(dropout_rate=RATE, seed=DROP_SEED)
    errs = {name: 0.0 for name in TPU_FLASH_DROPOUT}
    reset_all(fb, fa)
    with torch.inference_mode():
        for b, n, m in sorted({(q.shape[0], q.shape[2], k.shape[2]) for _, q, k, *_ in cases}):
            got = fa.flash_dropout_masks(DROP_SEED, b, HEADS, n, m, RATE, device=dev)
            same = torch.equal(got, fa.flash_dropout_masks_reference(DROP_SEED, b, HEADS, n, m, RATE, device=dev))
            block = n != m or torch.equal(got, fb.dropout_masks(DROP_SEED, b, n, 8, HEADS, RATE, device=dev)[0])
            frac = got.float().mean().item()
            ok = same and block and abs(frac - (1 - RATE)) <= KEEP_FRACTION_TOL
            log(f"  flash_dropout_masks ({b}, {HEADS}, {n}, {m}): bitwise equal to the twin: {same}; to "
                f"dropout_masks' attention mask: {block if n == m else 'n/a (n != m)'}; keep fraction {frac:.5f} (want "
                f"{1 - RATE} +- {KEEP_FRACTION_TOL}) {'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"flash_dropout_masks ({b}, {HEADS}, {n}, {m}) disagrees with its twin or keeps the wrong fraction")
            del got
        sync()
    mask_launches = fa.LAUNCHES["flash_dropout_masks"]
    for name, q, k, v, qs, ks, scale in cases:
        kw = dict(scale=scale, q_segment_ids=qs, kv_segment_ids=ks)
        do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, **kw, **dkw)
            o_want, lse_want = fa.flash_fwd_reference(q, k, v, **kw, **dkw)
            errs["flash_fwd[dropout]"] = max(errs["flash_fwd[dropout]"], compare_or_zero(
                f"flash_fwd[dropout] o [{name}]", o, o_want, ATTN_ATOL, ATTN_RTOL))
            if name == "packed, q = 0":
                l2, equal = rel_l2(o, o_want), (o == o_want).float().mean().item()
                ok = l2 <= FLASH_UNIFORM_REL_L2
                log(f"  flash_fwd[dropout] o [{name}]: rel L2 {l2:.3e} (bound {FLASH_UNIFORM_REL_L2}), {equal:.4f} of "
                    f"the elements bitwise equal {'ok' if ok else 'FAILED'}")
                if not ok:
                    fail("flash_fwd[dropout] rounds p elsewhere than its twin (the uniform case)")
            live = lse_want > 0.5 * fa.NEG_INF
            if not bool((lse[~live] == fa.NEG_INF).all()):
                fail(f"flash_fwd[dropout] lse [{name}]: a fully masked row does not read the sentinel")
            if live.any():
                errs["flash_fwd[dropout]"] = max(errs["flash_fwd[dropout]"], compare(
                    f"flash_fwd[dropout] lse [{name}]", lse[live], lse_want[live], FLASH_LSE_ATOL, FLASH_LSE_RTOL,
                    F32_REL_L2))
                drops = not torch.equal(o, fa.flash_fwd(q, k, v, **kw)[0])
                log(f"  flash_fwd[dropout] o [{name}] differs from the rate-0 kernel's: {drops}")
                if not drops:
                    fail(f"flash_fwd[dropout] [{name}] drops nothing")
            delta = (do.float() * o.float()).sum(-1)
            dq, dk, dv = flash_bwd_twice(fa, f"{name}, dropout", q, k, v, do, lse, delta, **kw, **dkw)
            want = fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw, **dkw)
            for kernel, part, got, w in (("flash_bwd_dq[dropout]", "dq", dq, want[0]),
                                         ("flash_bwd_dkv[dropout]", "dk", dk, want[1]),
                                         ("flash_bwd_dkv[dropout]", "dv", dv, want[2])):
                errs[kernel] = max(errs[kernel], compare_or_zero(f"{kernel} {part} [{name}]", got, w, None, ATTN_RTOL,
                                                                 atol_frac=BWD_ATOL_FRAC))
            del o, o_want, lse, lse_want, dq, dk, dv, want
        sync()
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, **kw, dropout_rate=RATE, dropout_seed=DROP_SEED)
        got = (out, *torch.autograd.grad(out, leaves, do))
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        out_ref = fa.flash_attention_reference(*ref, **kw, dropout_rate=RATE, dropout_seed=DROP_SEED)
        want = (out_ref, *torch.autograd.grad(out_ref, ref, do.float()))
        for part, a, b in zip(("o", "dq", "dk", "dv"), got, want):
            compare_or_zero(f"flash_attention[dropout] {part} vs f32 twin [{name}]", a, b, None, ATTN_RTOL,
                            FLASH_VS_F32_REL_L2, atol_frac=FLASH_VS_F32_ATOL_FRAC)
        del leaves, ref, out, out_ref, got, want
        sync()
    return errs, mask_launches


def navit_dropout_launches(depth, steps):
    """A training step's flash launches: depth of each [dropout] kernel (the
    layers) and one of each rate-0 kernel (attn_pool)."""
    return {**{k: depth * steps for k in FLASH_DROPOUT}, **{k: steps for k in TPU_FLASH}}


def check_navit_dropout_training(fb, fa, dev):
    """Phase 23: NaViT-B at dropout 0.1, emb_dropout 0.1 through
    make_train_step with the masked loss and a generator on phase 14's batch.
    Depth 12: 4 steps, loss finite, exact launch counters, the first step's
    loss against the plain bf16 path with an equal generator (the same
    nn.Dropout masks and the same flash seeds, hence the same keep masks);
    depth 2: the first step's loss and gradients against it; a depth-2
    nested-tensor NaViT: 2 steps with exact counters.  Returns the launch
    counts of the depth-12 steps."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    packed, labels = navit_train_batch(dev)
    drop = dict(token_dropout_prob=NAVIT_TOKEN_DROPOUT, dropout=RATE, emb_dropout=RATE)
    gen_seed = SEED + 3
    log(f"[23 NaViT dropout training] NaViT-B, dropout {RATE}, emb_dropout {RATE}, token dropout {NAVIT_TOKEN_DROPOUT}, "
        f"bf16, seed {SEED}; {packed.image_ids.shape[0]} packs x {NAVIT_SEQ}; dropout generator seed {gen_seed}; depth "
        f"{DEPTH}: {TRAIN_STEPS} steps; depth {NAVIT_SHALLOW}: one; nested-tensor NaViT depth {NESTED_DEPTH}: "
        f"{NESTED_DROPOUT_STEPS}")
    for depth in (DEPTH, NAVIT_SHALLOW):
        model = navit_model(dev, bf16, depth=depth, **drop)
        initial = copy.deepcopy(model)
        names = [n for n, _ in model.named_parameters()]
        steps = TRAIN_STEPS if depth == DEPTH else 1
        state, step = create_train_state(model), make_train_step(model, masked_ce)
        drop_gen = torch.Generator(device=dev).manual_seed(gen_seed)
        reset_all(fb, fa)
        losses = []
        for i in range(steps):
            losses.append(step(state, packed, labels, drop_gen)["loss"].item())
            if i == 0:
                grads = grad_vector(model)
        sync()
        launches = expect_launches(fb, fa, navit_dropout_launches(depth, steps),
                                   f"NaViT dropout training at depth {depth}")
        plain = copy.deepcopy(initial)
        reset_all(fb, fa)
        with plain_flash():
            loss_plain = make_train_step(plain, masked_ce)(create_train_state(plain), packed, labels,
                                                           torch.Generator(device=dev).manual_seed(gen_seed))
        loss_plain = loss_plain["loss"].item()
        sync()
        if any(all_launches(fb, fa).values()):
            fail(f"the plain path launched kernels: {all_launches(fb, fa)}")
        if not all(v == v and abs(v) != float("inf") for v in losses):
            fail("the NaViT dropout training loss is not finite")
        if depth == DEPTH:
            counts = launches
            d_plain = abs(losses[0] - loss_plain) / abs(loss_plain)
            ok = d_plain <= NAVIT_DEEP_LOSS and all(bool(torch.isfinite(g).all()) for g in grads)
            log(f"  depth {depth}: losses {[f'{v:.6f}' for v in losses]}; first step loss {losses[0]:.6f}, plain bf16 "
                f"{loss_plain:.6f}, rel {d_plain:.3e} (bound {NAVIT_DEEP_LOSS}) {'ok' if ok else 'FAILED'}; gradients "
                f"(finite; not bounded at this depth) rel L2 kernel vs plain bf16 "
                f"{grads_rel_l2(grads, grad_vector(plain)):.4e}")
            if not ok:
                fail(f"NaViT dropout training at depth {depth}: the first step's loss is out of bounds")
        else:
            compare_grads(f"depth {depth}, first step vs plain bf16, same masks", grads, grad_vector(plain), losses[0],
                          loss_plain, NAVIT_TRAIN_VS_PLAIN, names)
        del model, plain, initial, state, step
        sync()

    nested = navit_model(dev, bf16, nested=True, depth=NESTED_DEPTH, **drop)
    state, step = create_train_state(nested), make_train_step(nested, masked_ce)
    drop_gen = torch.Generator(device=dev).manual_seed(gen_seed)
    reset_all(fb, fa)
    losses = [step(state, packed, labels, drop_gen)["loss"].item() for _ in range(NESTED_DROPOUT_STEPS)]
    sync()
    expect_launches(fb, fa, navit_dropout_launches(NESTED_DEPTH, NESTED_DROPOUT_STEPS),
                    "nested-tensor NaViT dropout training")
    log(f"  nested-tensor NaViT (depth {NESTED_DEPTH}): losses {[f'{v:.6f}' for v in losses]}")
    if not all(v == v and abs(v) != float("inf") for v in losses):
        fail("the nested-tensor NaViT dropout training loss is not finite")
    del nested, state, step
    sync()
    return counts


def time_navit_dropout(fb, fa, dev, gen, smi):
    """Phase 24: NaViT-B training ms/step and peak memory at dropout 0.1,
    the kernel path against the plain path in turns (plain one step a turn:
    its int64 Philox masks take seconds a step), and against the dropout-0
    kernel path in turns; each [dropout] launch at the packed shape against
    its twin and its rate-0 kernel, flash_fwd[dropout] against SDPA with
    dropout_p under the block-diagonal mask, and the mask replay.  Returns
    the timing entries."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[24 NaViT dropout timing] {smi}")
    packed, labels = navit_train_batch(dev)
    drop = dict(token_dropout_prob=NAVIT_TOKEN_DROPOUT, dropout=RATE, emb_dropout=RATE)
    model = navit_model(dev, bf16, **drop)
    model0 = navit_model(dev, bf16, token_dropout_prob=NAVIT_TOKEN_DROPOUT)
    state, step = create_train_state(model), make_train_step(model, masked_ce)
    state0, step0 = create_train_state(model0), make_train_step(model0, masked_ce)
    drop_gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def kernel_step():
        step(state, packed, labels, drop_gen)

    def plain_step():
        with plain_flash():
            step(state, packed, labels, drop_gen)

    (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (
        train_step_ms(dev, f, iters)
        for f, iters in ((plain_step, 1), (kernel_step, 2), (kernel_step, 2), (plain_step, 1)))
    r1, (d1, _), (d2, _), r2 = (train_step_ms(dev, f) for f in (
        lambda: step0(state0, packed, labels), kernel_step, kernel_step, lambda: step0(state0, packed, labels)))
    k_ms = (k1 + k2) / 2
    log(f"  training step at dropout {RATE}, {packed.image_ids.shape[0]} packs: kernel path {k_ms:.3f} ms/step "
        f"({NAVIT_IMAGES * 1e3 / k_ms:.1f} img/s), plain bf16 path {(p1 + p2) / 2:.3f} ms/step (one step a turn); turns "
        f"ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; peak device memory kernel "
        f"{max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
    log(f"  against dropout 0 in turns: dropout 0 {(r1[0] + r2[0]) / 2:.3f} ms/step (peak {max(r1[1], r2[1]):.2f} GiB), "
        f"dropout {RATE} {(d1 + d2) / 2:.3f}; turns ms {r1[0]:.3f} {d1:.3f} {d2:.3f} {r2[0]:.3f}")
    del model, model0, state, state0, step, step0

    ids = packed.image_ids
    shape = (ids.shape[0], HEADS, NAVIT_SEQ, DH)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    q, k = fa.rms_norm(q, 1.0), fa.rms_norm(k, 1.0)
    q, k, v, do = (t.to(bf16) for t in (q, k, v, do))
    kw = dict(scale=1.0, q_segment_ids=ids, kv_segment_ids=ids)
    dkw = dict(dropout_rate=RATE, seed=DROP_SEED)
    per_kernel = {}
    with torch.inference_mode():
        o, lse = fa.flash_fwd(q, k, v, **kw, **dkw)
        delta = (do.float() * o.float()).sum(-1)
        launches = (  # (kernel, its call, its plain twin, the rate-0 kernel)
            ("flash_fwd[dropout]", lambda: fa.flash_fwd(q, k, v, **kw, **dkw),
             lambda: fa.flash_fwd_reference(q, k, v, **kw, **dkw), lambda: fa.flash_fwd(q, k, v, **kw)),
            ("flash_bwd_dq[dropout]", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw, **dkw),
             lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw, **dkw),
             lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
            ("flash_bwd_dkv[dropout]", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw, **dkw),
             lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw, **dkw),
             lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)),
        )
        log(f"  each [dropout] launch at the packed shape ({shape[0]} packs x {HEADS} heads x {NAVIT_SEQ} tokens, "
            f"rate {RATE}), in turns with its rate-0 kernel; the plain twin (dq, dk and dv at once) 2 calls:")
        mask = ((ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0))[:, None]
        library = {"flash_fwd[dropout]": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=RATE, scale=1.0), 5)}
        bwd = sdpa_bwd_only_ms(q, k, v, do, 5, attn_mask=mask, dropout_p=RATE, scale=1.0)
        log(f"  SDPA(dropout_p={RATE}) under the block-diagonal mask, its backward (forward + backward less the "
            f"forward): {bwd:.4f} ms")
        del mask
        for name, kern, plain, rate0 in launches:
            km, r0 = in_turns(kern, rate0, 10)
            pm = cuda_ms(plain, 2)
            w = flash_work(name.removesuffix("[dropout]"), ids, HEADS, dropout=True)
            yard = dict(product_ms=bwd, product_of=SDPA_BWD_ONLY) if "bwd" in name else {}
            record(per_kernel, name, km, pm, w, library.get(name), **yard)
            bound, by = bound_ms(w)
            log(f"  {name}: kernel {km:.4f} ms, rate-0 kernel {r0:.4f} ms (+{km - r0:.4f}), plain {pm:.4f} ms, bound "
                f"{bound:.4f} ms ({by})")
        log(f"  scaled_dot_product_attention(dropout_p={RATE}) with the (b, 1, n, n) block-diagonal mask: "
            f"{library['flash_fwd[dropout]']:.4f} ms")
        del o, lse, delta
        b, n = 2, NAVIT_SEQ
        km, pm = cuda_ms(lambda: fa.flash_dropout_masks(DROP_SEED, b, HEADS, n, n, RATE, device=dev), 10), cuda_ms(
            lambda: fa.flash_dropout_masks_reference(DROP_SEED, b, HEADS, n, n, RATE, device=dev), 2)
        elements = b * HEADS * n * n
        w = work(4 * elements, f32=PHILOX_OPS_PER_ELEMENT * elements)
        record(per_kernel, "flash_dropout_masks", km, pm, w)
        log(f"  flash_dropout_masks ({b}, {HEADS}, {n}, {n}), phase 22's packed shape: kernel {km:.4f} ms, plain "
            f"{pm:.4f} ms, bound {bound_ms(w)[0]:.4f} ms ({bound_ms(w)[1]})")
    sync()
    return per_kernel


# -- the NaViT in-tile qk-norm slice (phases 25-27) ----------------------------
# NaViT-B under VIT_TPU_FUSE_QKNORM=1 (the JAX opt-in, set in-process): every
# attention call hands its gammas to the flash kernels' [qknorm]
# instantiations (the layers' at dropout 0.1: [dropout,qknorm]; attn_pool has
# no dropout), which normalise q and k in the tile.  Off by default.
FLASH_QK = tuple(f"{name}[qknorm]" for name in TPU_FLASH)
FLASH_DROPOUT_QK = tuple(f"{name}[dropout,qknorm]" for name in TPU_FLASH)
TPU_FLASH_QK = {  # their qk-norm branches: _fwd_kernel :229-235, _bwd_dq_kernel :324-329, _bwd_dkv_kernel :404-406
    **{f"{name}[qknorm]": TPU_FLASH[name] for name in TPU_FLASH},
    **{f"{name}[dropout,qknorm]": TPU_FLASH[name] for name in TPU_FLASH},
}
# Phase 25's raw q and k rows are scaled by exp(QK_ROW_SPREAD * N(0, 1)), norms
# spread over ~e^+-4.5, so that a tile the kernel leaves unnormalised moves its
# logits by orders of magnitude; the gammas are 1 + 0.2 N(0, 1) in bf16, as a
# bf16 model's parameters are, one row a head, q's and k's apart.
QK_ROW_SPREAD = 1.5
# Phase 25 holds each instantiation to its twin with phase 12's and 22's
# bounds.  The kernel normalises q and k with the sum of squares in another
# f32 order than the twin's rms_tile_reference, which flips the bf16 rounding
# of a few elements of q^ and k^ by one ulp and moves their logits (up to ~80
# at scale 1) by hundredths.  So o and lse are held to the twin fed the
# kernels' own q^ and k^ (kernel_order_hats, bitwise the kernels' operands:
# the kernel with gammas and without them on those hats give the same o, bit
# for bit), with the attention bounds and FLASH_LSE_ATOL.  Against the twin
# on its own q^ and k^, which round a few hundred elements in 10^8 the other
# way, fresh draws read o up to 3.9x the bound (suspect 6) and lse up to
# 0.0455 (36x FLASH_LSE_ATOL; logged, not bounded), while the kernel reads
# lse within 1.53e-5 (0.0115x the bound) of the twin fed its own hats on 20
# fresh draws at rate 0 and 0.1, with and without the causal mask, of this
# phase's and phase 28's cases, and both within 1.2e-5 of an f64 composite
# on those hats (chip_suspect7.py; H100 80GB HBM3, 700 W): two valid
# roundings of q^ and k^, not a kernel fault (suspects 6 and 7, ROADMAP §3).
# Against the f32 composite (which normalises without rounding) this seeded
# draw reads rel L2 <= 1.52e-2 for every output and dgamma, inside phase 12's
# 2e-2; fresh draws read up to
# ~2.8e-2 (dq, dk of the attn_pool case), and the Function on its plain twins
# reads the same within ~1% on every draw: the distance is the bf16 rounding
# of q^ and k^, which the JAX kernel shares, not a kernel fault (suspect 5,
# PERF.md §7).  The bound holds for this draw, not for any draw.
# Suspect 5: that f32 check reads more on other draws.  Phase 25 repeats it,
# logged and not bounded, over QK_F32_DRAWS fresh draws of its cases at rate
# 0 and at RATE, for the kernels and for the same Function on its plain twins
# (flash_attention_twins: bf16 q^ and k^ at the kernels' rounding points),
# each against the f32 composite: if the twins read the same excursions, the
# distance is the bf16 numerics the JAX kernel shares.
QK_F32_DRAWS = 20
# The 3-D NaViT of phase 26: the 2-D nested variant's blocks at its widths
# (dim 1024, heads 16, mlp 2048), videos of up to 8 frames of 256 x 256 in
# 32 x 32 x 2 patches with 4 register tokens a video, depth cut to 2; 24
# videos from a seeded mix of (frames, height, width), packs of 1024 tokens.
NAVIT_3D = dict(image_size=256, max_frames=8, patch_size=32, frame_patch_size=2, num_classes=1000, dim=1024, depth=2,
                heads=16, mlp_dim=2048)
NAVIT_3D_VIDEOS, NAVIT_3D_SEQ, NAVIT_3D_STEPS = 24, 1024, 2
NAVIT_3D_SHAPES = ((8, 256, 256), (4, 256, 128), (8, 128, 128), (2, 256, 256), (4, 128, 256))


def fuse_qknorm(on=True):
    """VIT_TPU_FUSE_QKNORM set to 1 (or unset) for a ``with`` block."""
    return env_switch({"VIT_TPU_FUSE_QKNORM": "1"} if on else {}, ("VIT_TPU_FUSE_QKNORM",))


def kernel_order_rms(x, gamma, keeps_rows: bool):
    """q^ or k^ as the flash kernels round them: the twin's
    ``rms_tile_reference`` with the sum of squares taken in the kernels' f32
    order, so that it is bitwise the kernels' operand.  Each square of a
    bf16 element is exact in f32, so only the order of the additions counts:
    ``keeps_rows`` (q, which each thread keeps as mma A fragments,
    ``rms_norm_a_rows``): lane t of a quad adds the pair sums x[c]^2 +
    x[c+1]^2 of columns c = 8j + 2t for j = 0..7 in turn, then the quad
    adds (s0 + s1) + (s2 + s3); else (k, normalised in its ring stage,
    ``rms_norm_tile_sw``): lane c of 8 adds x[8c..8c+7]^2 in turn, then the
    shuffles add ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)).  x is
    (b, h, rows, 64) bf16, gamma any shape reshaping to (h, 64)."""
    x32 = x.float()
    sq = x32 * x32
    if keeps_rows:
        pairs = (sq[..., 0::2] + sq[..., 1::2]).unflatten(-1, (8, 4))  # [j][t]
        lanes = pairs[..., 0, :]
        for j in range(1, 8):
            lanes = lanes + pairs[..., j, :]
        ss = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
    else:
        chunks = sq.unflatten(-1, (8, 8))  # [lane][element]
        lanes = chunks[..., 0]
        for e in range(1, 8):
            lanes = lanes + chunks[..., e]
        ss = ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])) + (
            (lanes[..., 4] + lanes[..., 5]) + (lanes[..., 6] + lanes[..., 7]))
    r = torch.rsqrt(ss + 1e-12)[..., None]
    g = gamma.float().reshape(x.shape[1], 1, x.shape[-1])
    return (x32 * r * (g * x.shape[-1] ** 0.5)).to(x.dtype)


def kernel_order_hats(q, k, gq, gk):
    """(q^, k^) of the flash kernels' in-tile qk-norm, bitwise: see
    :func:`kernel_order_rms`."""
    return kernel_order_rms(q, gq, True), kernel_order_rms(k, gk, False)


def log_own_hats_lse(fwd, label, lse, lse_own_hats):
    """Logs, unbounded, the [qknorm] kernel's lse against the twin fed the
    twin's own q^ and k^: the pairing phases 25 and 28 bounded before
    suspect 7 was settled."""
    d = (lse.double() - lse_own_hats.double()).abs()
    excess = (d / (FLASH_LSE_ATOL + FLASH_LSE_RTOL * lse_own_hats.double().abs())).max().item()
    log(f"  {fwd} lse [{label}] vs the twin on its own q^, k^ (logged): max_abs={d.max().item():.4e}, "
        f"{excess:.3f}x FLASH_LSE_ATOL's bound")


def qk_gamma_pair(gen, dev):
    return tuple((1 + 0.2 * torch.randn(HEADS, 1, DH, generator=gen, device=dev)).to(torch.bfloat16)
                 for _ in range(2))


def flash_qk_cases(fa, dev, gen):
    """Phase 25's cases: phase 12's and phase 22's packed q = 0 case, q and k
    raw (their rows' norms spread by QK_ROW_SPREAD), and the gamma pair."""
    cases, _ = flash_cases(fa, dev, gen)
    spread = lambda t: (t.float() * torch.exp(QK_ROW_SPREAD * torch.randn(
        *t.shape[:3], 1, generator=gen, device=dev))).to(torch.bfloat16)
    cases = [(name, spread(q), spread(k), v, qs, ks, scale) for name, q, k, v, qs, ks, scale in cases]
    _, q, *rest = cases[0]  # the two 2048-token packs
    return (*cases, ("packed, q = 0", torch.zeros_like(q), *rest)), qk_gamma_pair(gen, dev)


def check_flash_qknorm(fa, dev, gen):
    """Phase 25: each [qknorm] and [dropout,qknorm] instantiation against its
    twin on phase 12's cases and the packed q = 0 case; o also differs from
    the kernel without gammas (and, with dropout, from the [qknorm] one); the
    Function's o, dq, dk, dv, dgamma_q and dgamma_k against autograd through
    the f32 materialized composite with the eager rms_norm (and the same keep
    masks).  Returns the largest max_abs of each kernel against its twin."""
    log(f"[25 flash qk-norm kernels] bf16, heads={HEADS}, dh={DH}, gammas 1 + 0.2 N(0, 1), q and k rows scaled by "
        f"exp({QK_ROW_SPREAD} N(0, 1)); rate 0 and {RATE} (seed {DROP_SEED}); phase 12's cases and the packed case "
        f"with q = 0")
    cases, (gq, gk) = flash_qk_cases(fa, dev, gen)
    gkw = dict(gamma_q=gq, gamma_k=gk)
    errs = {name: 0.0 for name in TPU_FLASH_QK}
    for name, q, k, v, qs, ks, scale in cases:
        kw = dict(scale=scale, q_segment_ids=qs, kv_segment_ids=ks)
        do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
        for rate, tag in ((0.0, "[qknorm]"), (RATE, "[dropout,qknorm]")):
            dkw = dict(dropout_rate=rate, seed=DROP_SEED if rate else None)
            fwd, dq_name, dkv_name = (f"{kernel}{tag}" for kernel in TPU_FLASH)
            with torch.inference_mode():
                o, lse = fa.flash_fwd(q, k, v, **kw, **dkw, **gkw)
                # o and lse against the twin fed the kernels' own q^ and k^ (suspects 6, 7)
                o_want, lse_want = fa.flash_fwd_reference(*kernel_order_hats(q, k, gq, gk), v, **kw, **dkw)
                lse_own_hats = fa.flash_fwd_reference(q, k, v, **kw, **dkw, **gkw)[1]
                errs[fwd] = max(errs[fwd], compare_or_zero(f"{fwd} o [{name}]", o, o_want, ATTN_ATOL, ATTN_RTOL))
                if name == "packed, q = 0" and rate:
                    l2 = rel_l2(o, o_want)
                    log(f"  {fwd} o [{name}]: rel L2 {l2:.3e} (bound {FLASH_UNIFORM_REL_L2}) "
                        f"{'ok' if l2 <= FLASH_UNIFORM_REL_L2 else 'FAILED'}")
                    if not l2 <= FLASH_UNIFORM_REL_L2:
                        fail(f"{fwd} rounds p elsewhere than its twin (the uniform case)")
                live = lse_want > 0.5 * fa.NEG_INF
                if not bool((lse[~live] == fa.NEG_INF).all()):
                    fail(f"{fwd} lse [{name}]: a fully masked row does not read the sentinel")
                if live.any():
                    errs[fwd] = max(errs[fwd], compare(f"{fwd} lse [{name}]", lse[live], lse_want[live],
                                                       FLASH_LSE_ATOL, FLASH_LSE_RTOL, F32_REL_L2))
                    log_own_hats_lse(fwd, name, lse[live], lse_own_hats[live])
                    others = {"the kernel without gammas": fa.flash_fwd(q, k, v, **kw, **dkw)[0]}
                    if rate:
                        others["the rate-0 [qknorm] kernel"] = fa.flash_fwd(q, k, v, **kw, **gkw)[0]
                    for other, o_other in others.items():
                        differs = not torch.equal(o, o_other)
                        log(f"  {fwd} o [{name}] differs from {other}'s: {differs}")
                        if not differs and name != "packed, q = 0":
                            fail(f"{fwd} [{name}] gives what {other} gives")
                delta = (do.float() * o.float()).sum(-1)
                dq, dk, dv = flash_bwd_twice(fa, f"{name}{tag}", q, k, v, do, lse, delta, **kw, **dkw, **gkw)
                want = fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw, **dkw, **gkw)
                for kernel, part, got, w in ((dq_name, "dq^", dq, want[0]), (dkv_name, "dk^", dk, want[1]),
                                             (dkv_name, "dv", dv, want[2])):
                    errs[kernel] = max(errs[kernel], compare_or_zero(f"{kernel} {part} [{name}]", got, w, None,
                                                                     ATTN_RTOL, atol_frac=BWD_ATOL_FRAC))
                del o, o_want, lse, lse_want, lse_own_hats, dq, dk, dv, want
            sync()
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, gq, gk)]
            fkw = dict(**kw, dropout_rate=rate, dropout_seed=DROP_SEED if rate else None)
            out = fa.flash_attention(*leaves[:3], gamma_q=leaves[3], gamma_k=leaves[4], **fkw)
            got = (out, *torch.autograd.grad(out, leaves, do))
            ref = [t.detach().float().requires_grad_() for t in (q, k, v, gq, gk)]
            out_ref = fa.flash_attention_reference(*ref[:3], gamma_q=ref[3], gamma_k=ref[4], **fkw)
            want = (out_ref, *torch.autograd.grad(out_ref, ref, do.float()))
            for part, a, b in zip(("o", "dq", "dk", "dv", "dgamma_q", "dgamma_k"), got, want):
                compare_or_zero(f"flash_attention{tag} {part} vs f32 composite [{name}]", a, b, None, ATTN_RTOL,
                                FLASH_VS_F32_REL_L2, atol_frac=FLASH_VS_F32_ATOL_FRAC)
            del leaves, ref, out, out_ref, got, want
            sync()
    qk_vs_f32_draws(fa, dev)
    return errs


def qk_vs_f32_draws(fa, dev):
    """Suspect 5: the Function-vs-f32 check of phase 25 over fresh draws of
    its cases, for the kernels and for the twins, each output's worst rel L2
    over the cases (and which case) a draw; then the worst over the draws and
    the draws above FLASH_VS_F32_REL_L2.  Beside it, the kernels' o against
    the twins' o: the worst of |d| / (ATTN_ATOL + ATTN_RTOL |want|) over the
    cases, the bound of phase 25's o check against its twin (above 1 that
    check would fail on the draw).  Logged, not bounded.  The draws come
    from a generator of their own, so the later phases' inputs stay those
    their bounds were read on."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    parts = ("o", "dq", "dk", "dv", "dgamma_q", "dgamma_k")
    routes = {"kernel": fa.flash_attention, "twins": fa.flash_attention_twins}
    fmt = lambda w: ", ".join(f"{part} {v:.3e} ({c})" for part, (v, c) in w.items())
    for rate, draws in ((0.0, QK_F32_DRAWS), (RATE, QK_F32_DRAWS)):
        overall = {r: dict.fromkeys(parts, (0.0, "")) for r in routes}
        above = dict.fromkeys(routes, 0)
        o_excess, o_above = (0.0, ""), 0
        h_excess, h_above = (0.0, ""), 0
        for draw in range(draws):
            cases, (gq, gk) = flash_qk_cases(fa, dev, gen)
            worst = {r: dict.fromkeys(parts, (0.0, "")) for r in routes}
            draw_excess = hat_excess = (0.0, "")
            for name, q, k, v, qs, ks, scale in cases:
                do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
                fkw = dict(scale=scale, q_segment_ids=qs, kv_segment_ids=ks, dropout_rate=rate,
                           dropout_seed=DROP_SEED if rate else None)
                ref = [t.detach().float().requires_grad_() for t in (q, k, v, gq, gk)]
                out_ref = fa.flash_attention_reference(*ref[:3], gamma_q=ref[3], gamma_k=ref[4], **fkw)
                want = (out_ref, *torch.autograd.grad(out_ref, ref, do.float()))
                outs = {}
                for route, fn in routes.items():
                    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, gq, gk)]
                    out = fn(*leaves[:3], gamma_q=leaves[3], gamma_k=leaves[4], **fkw)
                    got = (out, *torch.autograd.grad(out, leaves, do))
                    outs[route] = out.detach()
                    for part, a, b in zip(parts, got, want):
                        if b.float().norm().item() > 0:
                            worst[route][part] = max(worst[route][part], (rel_l2(a, b), name))
                o_k, o_t = outs["kernel"].float(), outs["twins"].float()
                ratio = ((o_k - o_t).abs() / (ATTN_ATOL + ATTN_RTOL * o_t.abs())).max().item()
                draw_excess = max(draw_excess, (ratio, name))
                with torch.inference_mode():  # suspect 6: the twin fed the kernels' own q^ and k^
                    o_h = fa.flash_fwd_reference(*kernel_order_hats(q, k, gq, gk), v, scale=scale, q_segment_ids=qs,
                                                 kv_segment_ids=ks, dropout_rate=rate,
                                                 seed=DROP_SEED if rate else None)[0].float()
                hat_excess = max(hat_excess, (((o_k - o_h).abs() / (ATTN_ATOL + ATTN_RTOL * o_h.abs())).max().item(),
                                              name))
                del ref, out_ref, want, leaves, out, got, outs
            sync()
            for route in routes:
                for part in parts:
                    overall[route][part] = max(overall[route][part], worst[route][part])
                above[route] += max(v for v, _ in worst[route].values()) > FLASH_VS_F32_REL_L2
            o_excess, o_above = max(o_excess, draw_excess), o_above + (draw_excess[0] > 1)
            h_excess, h_above = max(h_excess, hat_excess), h_above + (hat_excess[0] > 1)
            log(f"  suspect 5, rate {rate}, draw {draw}: worst rel L2 vs f32: kernel {fmt(worst['kernel'])}; "
                f"twins {fmt(worst['twins'])}; o kernel vs twins {draw_excess[0]:.3f} of the bound ({draw_excess[1]}), "
                f"vs the twin on the kernels' q^ and k^ {hat_excess[0]:.3f} ({hat_excess[1]})")
        for route in routes:
            log(f"  suspect 5, rate {rate}, {route} over {draws} draws: worst {fmt(overall[route])}; "
                f"{above[route]} draws above {FLASH_VS_F32_REL_L2}")
        log(f"  suspect 5, rate {rate}, o kernel vs twins over {draws} draws: worst {o_excess[0]:.3f} of the bound "
            f"|d| <= {ATTN_ATOL} + {ATTN_RTOL}|want| ({o_excess[1]}); {o_above} draws above it; vs the twin on the "
            f"kernels' q^ and k^ (phase 25's o check): worst {h_excess[0]:.3f} ({h_excess[1]}); {h_above} draws above it")


def navit_3d_videos(seed):
    rng = np.random.default_rng(seed)
    shapes = [NAVIT_3D_SHAPES[rng.integers(len(NAVIT_3D_SHAPES))] for _ in range(NAVIT_3D_VIDEOS)]
    return [rng.normal(size=(3, *s)).astype(np.float32) for s in shapes]


def check_navit_qknorm(fb, fa, dev):
    """Phase 26: NaViT-B under VIT_TPU_FUSE_QKNORM=1.  Serving at depth 12
    and 2 (exact counters: depth + 1 flash_fwd[qknorm], no rate-0 flash_fwd;
    logits against the plain twins under the switch, the eager default and
    fp32: at depth 12 against the noise floor and the eager default's own
    distance to fp32, at depth 2 against fixed bounds); training at dropout 0
    and 0.1 (exact counters a step: depth + 1 of each [qknorm] kernel;
    depth of each [dropout,qknorm] and one of each [qknorm]; at depth 12 the
    first step's loss against the plain twins under the switch, at depth 2
    the first step's gradients); a depth-2 3-D NaViT served and trained 2
    steps under the switch, which it leaves on the rate-0 kernels (its
    qk-norm is a LayerNorm).  Returns the launch counts of the depth-12 runs."""
    from vit_pytorch_tpu_torch.models.na_vit import forward_packed
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[26 NaViT-B under VIT_TPU_FUSE_QKNORM=1] NaViT-B ({NAVIT}), bf16, seed {SEED}: serving the {NAVIT_IMAGES}-"
        f"image mix, training on phase 14's batch at dropout 0 ({TRAIN_STEPS} steps at depth {DEPTH}) and {RATE} (2 "
        f"steps); depth {NAVIT_SHALLOW}: one; a depth-{NAVIT_3D['depth']} 3-D NaViT")
    counts = {}
    images, _, _ = navit_images(SEED, labels=False)
    noise = np.random.default_rng(SEED + 1)
    noisy = [img * (1 + NAVIT_INPUT_NOISE * noise.standard_normal(img.shape, dtype=np.float32)) for img in images]
    with torch.inference_mode():
        for depth in (DEPTH, NAVIT_SHALLOW):
            fp32 = navit_model(dev, torch.float32, depth=depth).eval()
            model = copy.deepcopy(fp32).to(bf16)
            reset_all(fb, fa)
            eager = forward_packed(model, images)  # the switch unset: today's path
            sync()
            expect_launches(fb, fa, {"flash_fwd": depth + 1}, f"NaViT serving at depth {depth}, the switch unset")
            with fuse_qknorm():
                reset_all(fb, fa)
                logits = forward_packed(model, images)
                sync()
                launches = expect_launches(fb, fa, {"flash_fwd[qknorm]": depth + 1},
                                           f"NaViT serving under the switch at depth {depth}")
                reset_all(fb, fa)
                with plain_flash():
                    plain = forward_packed(model, images)
                    floor = rel_l2(forward_packed(model, noisy), plain) if depth == DEPTH else None
                want = forward_packed(fp32, images)  # fp32: the composite with the eager f32 norm
                sync()
                if any(all_launches(fb, fa).values()):
                    fail(f"the plain and fp32 paths launched kernels: {all_launches(fb, fa)}")
            if logits.shape != (NAVIT_IMAGES, NAVIT["num_classes"]) or not bool(torch.isfinite(logits).all()):
                fail(f"NaViT serving under the switch: logits {tuple(logits.shape)}, not all finite")
            e_kp, e_kf, e_ke, e_ef = (rel_l2(a, b) for a, b in ((logits, plain), (logits, want), (logits, eager),
                                                                 (eager, want)))
            if depth == DEPTH:
                counts["serving"] = launches
                ok = e_kf <= NAVIT_NOISE_RATIO * e_ef and e_kp <= NAVIT_NOISE_RATIO * floor
                log(f"  depth {depth}, logits rel L2: fused vs fp32 {e_kf:.4e} (bound {NAVIT_NOISE_RATIO} x the eager "
                    f"default vs fp32, {e_ef:.4e}); fused vs plain twins under the switch {e_kp:.4e} (bound "
                    f"{NAVIT_NOISE_RATIO} x plain vs plain with {NAVIT_INPUT_NOISE} relative noise on the pixels, "
                    f"{floor:.4e}); fused vs the eager default {e_ke:.4e} {'ok' if ok else 'FAILED'}")
            else:
                ok = e_kp <= NAVIT_SHALLOW_VS_PLAIN and e_kf <= NAVIT_SHALLOW_VS_FP32
                log(f"  depth {depth}, logits rel L2: fused vs plain twins under the switch {e_kp:.4e} (bound "
                    f"{NAVIT_SHALLOW_VS_PLAIN}); fused vs fp32 {e_kf:.4e} (bound {NAVIT_SHALLOW_VS_FP32}); the eager "
                    f"default vs fp32 {e_ef:.4e}; fused vs the eager default {e_ke:.4e} {'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"NaViT serving under the switch at depth {depth} disagrees with the plain path or fp32")
            del model, fp32
        sync()

    packed, labels = navit_train_batch(dev)
    for rate, steps_deep in ((0.0, TRAIN_STEPS), (RATE, 2)):
        drop = dict(token_dropout_prob=NAVIT_TOKEN_DROPOUT, dropout=rate, emb_dropout=rate)
        gen_seed = SEED + 3
        for depth in (DEPTH, NAVIT_SHALLOW):
            fp32 = navit_model(dev, torch.float32, depth=depth, **drop)
            model = copy.deepcopy(fp32).to(bf16)
            initial = copy.deepcopy(model)
            names = [n for n, _ in model.named_parameters()]
            steps = steps_deep if depth == DEPTH else 1
            new_gen = lambda: torch.Generator(device=dev).manual_seed(gen_seed) if rate else None
            with fuse_qknorm():
                state, step = create_train_state(model), make_train_step(model, masked_ce)
                drop_gen = new_gen()
                reset_all(fb, fa)
                losses = []
                for i in range(steps):
                    losses.append(step(state, packed, labels, drop_gen)["loss"].item())
                    if i == 0:
                        grads = grad_vector(model)
                sync()
                want = ({k: (depth + 1) * steps for k in FLASH_QK} if not rate else
                        {**{k: depth * steps for k in FLASH_DROPOUT_QK}, **{k: steps for k in FLASH_QK}})
                launches = expect_launches(fb, fa, want, f"NaViT training under the switch, dropout {rate}, depth "
                                                         f"{depth}")
                plain = copy.deepcopy(initial)
                reset_all(fb, fa)
                with plain_flash():
                    loss_plain = make_train_step(plain, masked_ce)(create_train_state(plain), packed, labels,
                                                                   new_gen())["loss"].item()
                sync()
                if any(all_launches(fb, fa).values()):
                    fail(f"the plain path launched kernels: {all_launches(fb, fa)}")
            if not all(v == v and abs(v) != float("inf") for v in losses):
                fail(f"NaViT training under the switch at dropout {rate}: the loss is not finite")
            what = f"dropout {rate}, depth {depth}"
            if depth == DEPTH:
                counts[rate] = launches
                d_plain = abs(losses[0] - loss_plain) / abs(loss_plain)
                ok = d_plain <= NAVIT_DEEP_LOSS and all(bool(torch.isfinite(g).all()) for g in grads)
                log(f"  {what}: losses {[f'{v:.6f}' for v in losses]}; first step vs the plain twins under the switch "
                    f"{loss_plain:.6f}, rel {d_plain:.3e} (bound {NAVIT_DEEP_LOSS}) {'ok' if ok else 'FAILED'}; "
                    f"gradients (finite; not bounded at this depth) rel L2 {grads_rel_l2(grads, grad_vector(plain)):.4e}")
                if not ok:
                    fail(f"NaViT training under the switch, {what}: the first step's loss is out of bounds")
            else:
                compare_grads(f"{what}, first step vs the plain twins under the switch", grads, grad_vector(plain),
                              losses[0], loss_plain, NAVIT_TRAIN_VS_PLAIN, names)
                if not rate:  # fp32 through the twins in f32 (the f32 in-tile norm)
                    with fuse_qknorm(), plain_flash(admit_fp32=True):
                        metrics = make_train_step(fp32, masked_ce)(create_train_state(fp32),
                                                                   packed.to(dtype=torch.float32), labels)
                    compare_grads(f"{what}, first step vs fp32", grads, grad_vector(fp32), losses[0],
                                  metrics["loss"].item(), NAVIT_TRAIN_VS_FP32, names)
            del model, plain, fp32, initial, state, step
            sync()

    # the 3-D NaViT: its qk-norm is a LayerNorm, so the switch leaves it on
    # the rate-0 kernels
    from vit_pytorch_tpu_torch.models.na_vit_nested_tensor_3d import NaViT as NaViT3d
    from vit_pytorch_tpu_torch.models.na_vit_nested_tensor_3d import pack_volumes

    videos = navit_3d_videos(SEED)
    kw3 = dict(max_seq_len=NAVIT_3D_SEQ, dtype=bf16, device=dev)
    model = NaViT3d(**NAVIT_3D, token_dropout_prob=0.25, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED)).to(bf16)
    serve_packed = pack_volumes(videos, NAVIT_3D["patch_size"], NAVIT_3D["frame_patch_size"], **kw3)
    depth3 = NAVIT_3D["depth"]
    with fuse_qknorm():
        with torch.inference_mode():
            model.eval()
            reset_all(fb, fa)
            got = model(serve_packed)
            sync()
            expect_launches(fb, fa, {"flash_fwd": depth3 + 1}, "3-D NaViT serving under the switch")
            with plain_flash():
                want = model(serve_packed)
        e = rel_l2(got[serve_packed.is_video], want[serve_packed.is_video])
        log(f"  3-D NaViT (depth {depth3}, {NAVIT_3D_VIDEOS} videos in {serve_packed.segment_ids.shape[0]} packs of "
            f"{NAVIT_3D_SEQ} + {serve_packed.max_videos} x 4 registers) logits: rel L2 vs plain bf16 {e:.4e} (bound "
            f"{NESTED_VS_PLAIN})")
        if not e <= NESTED_VS_PLAIN or not bool(torch.isfinite(got).all()):
            fail("3-D NaViT logits disagree with the plain path")
        train_packed = pack_volumes(videos, NAVIT_3D["patch_size"], NAVIT_3D["frame_patch_size"], train=True,
                                    token_dropout_prob=0.25, rng=np.random.default_rng(SEED + 5), **kw3)
        labels3 = torch.where(train_packed.is_video, torch.randint(
            0, NAVIT_3D["num_classes"], train_packed.is_video.shape, generator=torch.Generator(device=dev).manual_seed(
                SEED), device=dev), -1)
        state, step = create_train_state(model), make_train_step(model, masked_ce)
        reset_all(fb, fa)
        losses = [step(state, train_packed, labels3)["loss"].item() for _ in range(NAVIT_3D_STEPS)]
        sync()
        expect_launches(fb, fa, {k: (depth3 + 1) * NAVIT_3D_STEPS for k in TPU_FLASH}, "3-D NaViT training")
    log(f"  3-D NaViT training, token dropout 0.25: losses {[f'{v:.6f}' for v in losses]}")
    if not all(v == v and abs(v) != float("inf") for v in losses):
        fail("the 3-D NaViT training loss is not finite")
    del model, state, step
    sync()
    return counts


def time_navit_qknorm(fa, dev, gen, smi):
    """Phase 27: NaViT-B with the switch on and off in turns (off, on, on,
    off): serving img/s and real tokens/s, training ms/step and peak memory
    at dropout 0 and 0.1; each new launch at the packed shape against its
    twin and, in turns, against its kernel without qk-norm on q and k
    normalised before; the eager bf16 rms_norm pair and the plain f32 VJP
    epilogue alone.  Returns the timing entries."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    log(f"[27 NaViT qk-norm timing] {smi}")
    images, _, rng = navit_images(SEED, labels=False)
    packed = pack_navit(images, rng, dev, train=False)
    tokens = int((packed.image_ids >= 0).sum())
    model = navit_model(dev, bf16).eval()
    with torch.inference_mode():
        def serve(on):
            def run():
                with fuse_qknorm(on):
                    model(packed)
            return run

        e1, f1, f2, e2 = (host_ms(serve(on), 5) for on in (False, True, True, False))
    f_ms, e_ms = (f1 + f2) / 2, (e1 + e2) / 2
    log(f"  serving {NAVIT_IMAGES} images ({tokens} real tokens, {NAVIT_PACKS} packs): switch on "
        f"{NAVIT_IMAGES * 1e3 / f_ms:.1f} img/s, {tokens / f_ms:.1f} k tokens/s ({f_ms:.3f} ms/batch); off "
        f"{NAVIT_IMAGES * 1e3 / e_ms:.1f} img/s, {tokens / e_ms:.1f} k tokens/s ({e_ms:.3f} ms/batch); turns ms off "
        f"{e1:.3f} on {f1:.3f} on {f2:.3f} off {e2:.3f}")
    del model

    packed, labels = navit_train_batch(dev)
    for rate in (0.0, RATE):
        model = navit_model(dev, bf16, token_dropout_prob=NAVIT_TOKEN_DROPOUT, dropout=rate, emb_dropout=rate)
        state, step = create_train_state(model), make_train_step(model, masked_ce)
        drop_gen = torch.Generator(device=dev).manual_seed(SEED + 4) if rate else None

        def train(on):
            def run():
                with fuse_qknorm(on):
                    step(state, packed, labels, drop_gen)
            return run

        (e1, em1), (f1, fm1), (f2, fm2), (e2, em2) = (train_step_ms(dev, train(on)) for on in (False, True, True, False))
        log(f"  training at dropout {rate}: switch on {(f1 + f2) / 2:.3f} ms/step, off {(e1 + e2) / 2:.3f}; turns ms "
            f"off {e1:.3f} on {f1:.3f} on {f2:.3f} off {e2:.3f}; peak device memory on {max(fm1, fm2):.2f} GiB, off "
            f"{max(em1, em2):.2f} GiB")
        del model, state, step

    ids = packed.image_ids
    shape = (ids.shape[0], HEADS, NAVIT_SEQ, DH)
    q, k = ((torch.randn(shape, generator=gen, device=dev) * torch.exp(QK_ROW_SPREAD * torch.randn(
        *shape[:3], 1, generator=gen, device=dev))).to(bf16) for _ in range(2))
    v, do = (torch.randn(shape, generator=gen, device=dev).to(bf16) for _ in range(2))
    gq, gk = qk_gamma_pair(gen, dev)
    rows = fa.gamma_rows(gq, gk, q)
    gkw = dict(zip(("gamma_q", "gamma_k"), rows))
    qn, kn = fa.rms_norm(q, gq), fa.rms_norm(k, gk)  # the eager default's bf16 norm
    kw = dict(scale=1.0, q_segment_ids=ids, kv_segment_ids=ids)
    per_kernel = {}
    with torch.inference_mode():
        log(f"  each new launch at the packed shape ({shape[0]} packs x {HEADS} heads x {NAVIT_SEQ} tokens), in turns "
            f"with its kernel without qk-norm on q and k normalised eagerly; the plain twin (dq, dk and dv at once) 2 "
            f"calls:")
        mask = ((ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0))[:, None]
        for rate, tag in ((0.0, "[qknorm]"), (RATE, "[dropout,qknorm]")):
            dkw = dict(dropout_rate=rate, seed=DROP_SEED if rate else None)
            # beside the backward kernels: SDPA's backward on the eagerly normalised q and k (no norm inside)
            bwd = sdpa_bwd_only_ms(qn, kn, v, do, 5, attn_mask=mask, dropout_p=rate, scale=1.0)
            log(f"  SDPA under the block-diagonal mask at dropout {rate}, its backward on q^, k^: {bwd:.4f} ms")
            o, lse = fa.flash_fwd(q, k, v, **kw, **dkw, **gkw)
            delta = (do.float() * o.float()).sum(-1)
            o0, lse0 = fa.flash_fwd(qn, kn, v, **kw, **dkw)
            delta0 = (do.float() * o0.float()).sum(-1)
            launches = (  # (kernel, its call, its plain twin, the kernel without qk-norm)
                (f"flash_fwd{tag}", lambda: fa.flash_fwd(q, k, v, **kw, **dkw, **gkw),
                 lambda: fa.flash_fwd_reference(q, k, v, **kw, **dkw, **gkw), lambda: fa.flash_fwd(qn, kn, v, **kw, **dkw)),
                (f"flash_bwd_dq{tag}", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw, **dkw, **gkw),
                 lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw, **dkw, **gkw),
                 lambda: fa.flash_bwd_dq(qn, kn, v, do, lse0, delta0, **kw, **dkw)),
                (f"flash_bwd_dkv{tag}", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw, **dkw, **gkw),
                 lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw, **dkw, **gkw),
                 lambda: fa.flash_bwd_dkv(qn, kn, v, do, lse0, delta0, **kw, **dkw)),
            )
            for name, kern, plain, without in launches:
                km, wm = in_turns(kern, without, 10)
                pm = cuda_ms(plain, 2)
                w = flash_work(name.split("[")[0], ids, HEADS, dropout=bool(rate), qknorm=True)
                yard = dict(product_ms=bwd, product_of=SDPA_BWD_ONLY + ", on q and k normalised outside it")
                record(per_kernel, name, km, pm, w, **(yard if "bwd" in name else {}))
                bound, by = bound_ms(w)
                log(f"  {name}: kernel {km:.4f} ms, without qk-norm {wm:.4f} ms ({km - wm:+.4f}), plain {pm:.4f} ms, "
                    f"bound {bound:.4f} ms ({by})")
            del o, lse, delta, o0, lse0, delta0
        norm_ms = cuda_ms(lambda: (fa.rms_norm(q, gq), fa.rms_norm(k, gk)), 10)
    # the epilogue differentiates with autograd: outside inference mode
    dq_hat, dk_hat = (torch.randn(shape, generator=gen, device=dev).to(bf16) for _ in range(2))
    epilogue_ms = cuda_ms(lambda: (fa.rms_norm_vjp(q, gq, dq_hat), fa.rms_norm_vjp(k, gk, dk_hat)), 5)
    log(f"  the eager bf16 rms_norm of q and k (the switch unset, once a layer forward): {norm_ms:.4f} ms; the plain "
        f"f32 VJP epilogue of q and k (the switch set, once a layer backward): {epilogue_ms:.4f} ms")
    sync()
    return per_kernel


# -- the short kernel and the flash kernels' causal and bias variants (phases
# 28-30): the short kernel on its model path, SimpleViT-B/16 @512 (1024
# patches, no cls token: m = 1024, the dispatcher's short route), served and
# trained; the causal and bias variants on the ops entry point that reaches
# them, dot_product_attention at m >= 1024 (no model of the zoo sends them
# there: ViViT-MOSS's causal attention has far fewer than 1024 frames, the
# windowed rel-pos tables 49-196 keys)
TPU_SHORT = "vit_pytorch_tpu/ops/short_attention.py:31"
SHORT_SOURCE = "vit_pytorch_tpu_torch/csrc/short_attention.cu"
SHORT_KERNELS = ("short_attention", "short_attention[bias]")
CAUSAL_TAGS = ("[causal]", "[dropout,causal]", "[qknorm,causal]", "[dropout,qknorm,causal]")
FLASH_CAUSAL = tuple(f"{name}{tag}" for tag in CAUSAL_TAGS for name in TPU_FLASH)
FLASH_BIAS = ("flash_fwd[bias]", "flash_fwd[bias,causal]")
TPU_NEW = {  # each new variant and the TPU kernel it replaces
    **{name: TPU_SHORT for name in SHORT_KERNELS},
    **{name: TPU_FLASH[name.split("[")[0]] for name in FLASH_CAUSAL + FLASH_BIAS},
}
B_SHORT = 32  # b x h = 32 x 12 slices: SimpleViT-B/16 @512's training batch
SHORT_SHAPES = ((49, 49), (197, 197), (577, 577), (1024, 1024), (65, 130), (577, 1024))
# Phase 28 holds the short kernel to its twin with phase 3's attention bounds
# and adds q = 0 at m = 49, 197 and 577, where every p is exactly 1 and the
# twin's o is bf16 of the f32 mean of v: a kernel that divides by l before the
# p.v product casts 1/m, which bf16 rounds (by 1.1e-3 at m = 49, 2.0e-3 at
# 197), so the rel L2 bound of phase 22's uniform case refuses it.
SHORT_UNIFORM_M = (49, 197, 577)
# Phase 28's edges of the kernels' 64-key ring and head-ordered grid (their
# own generator): keys that fill no whole tile (130, 1000), one query, 129
# queries, and a small grid whose batch and head counts differ (b = 3, h =
# 2); the short kernel as (b, h, n, m), each without a bias and with an f32
# and a bf16 per-head table (batch stride 0; at m = 130 an f32 row of 520
# bytes is no whole number of 16-byte chunks: the element-wise staging)
SHORT_EDGES = ((B_SHORT, HEADS, 1, 130), (B_SHORT, HEADS, 129, 1000), (B_SHORT, HEADS, 1000, 1000), (3, 2, 129, 130))
# flash_fwd's as (label, b, h, n, m, bias shape before (n, m) or None, bias
# dtype, causal)
FLASH_EDGES = (
    ("(1, h) f32 bias, b=3 h=2, n=129 m=130", 3, 2, 129, 130, (1, 2), torch.float32, False),
    ("(b, 1) f32 bias, n=129 m=1000", 2, HEADS, 129, 1000, (2, 1), torch.float32, False),
    ("(1, h) bf16 bias, n=1 m=1000", 2, HEADS, 1, 1000, (1, HEADS), torch.bfloat16, False),
    ("(b, h) f32 bias, causal, n=1000 m=130", 2, HEADS, 1000, 130, (2, HEADS), torch.float32, True),
    ("(1, h) f32 bias, causal, n=129 m=1000", 3, 2, 129, 1000, (1, 2), torch.float32, True),
    ("causal, n=1000 m=130", 2, HEADS, 1000, 130, None, None, True),
    ("causal, b=3 h=2, n=129 m=1000", 3, 2, 129, 1000, None, None, True),
)
SIMPLE_512 = dict(image_size=512, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP)
SIMPLE_512_N = (SIMPLE_512["image_size"] // SIMPLE_512["patch_size"]) ** 2  # 1024
SIMPLE_512_BUCKETS, SIMPLE_512_REQUESTS = (1, 8, 32), (1, 5, 32)
N_LONG, N_MID = 2048, 1100  # phase 28's flash problems: n, m in {2048, 1100}
B_CAUSAL_TIME, N_CAUSAL_TIME = 8, 2048  # phase 30's shape for the flash variants
N_EDGE = 1024  # the dispatcher's edge: m = 1024 is the short route, 1025 flash


def causal_pairs(n, m):
    """(query, key) pairs the causal mask leaves, top-left aligned."""
    i = np.arange(n)
    return int(np.minimum(i + 1, m).sum())


def pair_work(name, b, n, m, pairs, *, dropout=False, qknorm=False, bias_bytes=0):
    """The work of one launch of the short kernel or a flash variant on
    (b, HEADS, n | m, DH) operands, of which ``pairs`` (query, key) pairs a
    slice are visible: 4, 6, 8 DH bf16 products a pair for the forward, dq,
    dkv (4 for the short kernel), ~5 f32 operations a pair, a Philox draw a
    pair with dropout; each operand read once, each output written once (q,
    k, v, o; dO, dq; dk, dv; the f32 lse and delta), the bias's unique bytes;
    qk-norm adds the gammas and ~6 f32 operations an element of q and k."""
    tq, tk, vec = b * HEADS * n * DH * 2, b * HEADS * m * DH * 2, b * HEADS * n * 4
    per_pair, bytes_ = {"short_attention": (4, 2 * tq + 2 * tk), "flash_fwd": (4, 2 * tq + 2 * tk + vec),
                        "flash_bwd_dq": (6, 3 * tq + 2 * tk + 2 * vec),
                        "flash_bwd_dkv": (8, 2 * tq + 4 * tk + 2 * vec)}[name.split("[")[0]]
    total = b * HEADS * pairs
    f32 = (5 + (PHILOX_OPS_PER_ELEMENT if dropout else 0)) * total
    if qknorm:
        bytes_ += 2 * HEADS * DH * 4
        f32 += 6 * b * HEADS * (n + m) * DH
    return work(bytes_ + bias_bytes, tensor=per_pair * DH * total, f32=f32)


@contextlib.contextmanager
def plain_short(admit_fp32=False):
    """Every short-route call of the dispatcher through the plain twin: the
    same Function with the kernel swapped for ``short_attention_reference``.
    With ``admit_fp32`` the gate admits fp32 too, so that an fp32 model runs
    the twin in f32 (saving q, k, v a layer) instead of the materialized
    composite (saving its (n, m) matrices)."""
    from vit_pytorch_tpu_torch.ops import attention
    from vit_pytorch_tpu_torch.ops import short_attention as sa

    saved = attention.short_attention, attention.short_supported
    attention.short_attention = sa.short_attention_twins
    if admit_fp32:
        attention.short_supported = lambda *args: True
    try:
        yield
    finally:
        attention.short_attention, attention.short_supported = saved


def check_short_flash_edges(fa, sa, dev, errs):
    """Phase 28's edge cases of the ring and the head-ordered grid, from a
    generator of their own (the later phases keep their inputs): the short
    kernel at SHORT_EDGES, no bias and an f32 and a bf16 per-head table;
    flash_fwd[bias] / [bias,causal] and [causal] at FLASH_EDGES.  Adds each
    variant's max_abs to ``errs``."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    scale = DH**-0.5
    for b, h, n, m in SHORT_EDGES:
        q, k, v = rn(b, h, n, DH).to(bf16), rn(b, h, m, DH).to(bf16), rn(b, h, m, DH).to(bf16)
        bias = rn(h, n, m)
        for label, bb in (("", None), (", bias f32", bias), (", bias bf16", bias.to(bf16))):
            name = "short_attention" if bb is None else "short_attention[bias]"
            errs[name] = max(errs[name], compare(
                f"{name} [b={b} h={h} n={n} m={m}{label}]", sa.short_fwd(q, k, v, scale=scale, bias=bb),
                sa.short_attention_reference(q, k, v, scale=scale, bias=bb), ATTN_ATOL, ATTN_RTOL))
    for label, b, h, n, m, bias_shape, bias_dtype, causal in FLASH_EDGES:
        q, k, v = rn(b, h, n, DH).to(bf16), rn(b, h, m, DH).to(bf16), rn(b, h, m, DH).to(bf16)
        bias = None if bias_shape is None else rn(*bias_shape, n, m).to(bias_dtype)
        name = fa._counter("flash_fwd", causal=causal, bias=bias is not None)
        kw = dict(scale=scale, causal=causal, bias=bias)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        o_want, lse_want = fa.flash_fwd_reference(q, k, v, **kw)
        errs[name] = max(errs[name], compare(f"{name} o [{label}]", o, o_want, ATTN_ATOL, ATTN_RTOL))
        errs[name] = max(errs[name], compare(f"{name} lse [{label}]", lse, lse_want, FLASH_LSE_ATOL, FLASH_LSE_RTOL,
                                             F32_REL_L2))
    sync()


def check_short_causal_bias(fa, dev, gen):
    """Phase 28: the short kernel (no bias, an f32 and a bf16 per-head bias)
    against its twin at b x h = 32 x 12 and n, m in SHORT_SHAPES, and at q =
    0 (SHORT_UNIFORM_M); the flash kernels' causal variants (rate 0 and 0.1,
    with and without qk-norm gammas) against their twins at n = m = 2048,
    n = 1100 < m = 2048, n = 2048 > m = 1100 and two packs of 2048 with
    segment ids; flash_fwd[bias] and [bias,causal] (bias (1, h), (b, 1),
    (b, h) in f32, (1, h) in bf16, with the causal mask, with segment ids);
    the Functions (flash causal, flash bias + causal, short with a bias)
    against autograd through the f32 composite, dbias included.  Returns the
    largest max_abs of each variant against its twin."""
    from vit_pytorch_tpu_torch.ops import short_attention as sa

    bf16 = torch.bfloat16
    log(f"[28 short kernel, flash causal and bias] bf16, heads={HEADS}, dh={DH}; short: b={B_SHORT}, (n, m) in "
        f"{SHORT_SHAPES}; flash: b=2 at {N_LONG} / {N_MID} keys and the two {NAVIT_SEQ}-token packs; dropout {RATE}")
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    errs = {name: 0.0 for name in TPU_NEW}
    scale = DH**-0.5
    with torch.inference_mode():
        for n, m in SHORT_SHAPES:
            q, k, v = rn(B_SHORT, HEADS, n, DH).to(bf16), rn(B_SHORT, HEADS, m, DH).to(bf16), rn(B_SHORT, HEADS, m,
                                                                                                  DH).to(bf16)
            bias = rn(HEADS, n, m)
            for label, b in (("", None), (", bias f32", bias), (", bias bf16", bias.to(bf16))):
                name = "short_attention" if b is None else "short_attention[bias]"
                errs[name] = max(errs[name], compare(
                    f"{name} [n={n} m={m}{label}]", sa.short_fwd(q, k, v, scale=scale, bias=b),
                    sa.short_attention_reference(q, k, v, scale=scale, bias=b), ATTN_ATOL, ATTN_RTOL))
            if n == m and m in SHORT_UNIFORM_M:
                z = torch.zeros_like(q)
                got, want = sa.short_fwd(z, k, v, scale=scale), sa.short_attention_reference(z, k, v, scale=scale)
                l2, equal = rel_l2(got, want), (got == want).float().mean().item()
                ok = l2 <= FLASH_UNIFORM_REL_L2
                log(f"  short_attention o [q = 0, m={m}]: rel L2 {l2:.3e} (bound {FLASH_UNIFORM_REL_L2}), {equal:.4f} "
                    f"of the elements bitwise equal {'ok' if ok else 'FAILED'}")
                if not ok:
                    fail("short_attention rounds p elsewhere than its twin (the uniform case)")
            del q, k, v, bias
        sync()
        check_short_flash_edges(fa, sa, dev, errs)

        cases, _ = flash_cases(fa, dev, gen)
        _, qp, kp, vp, ids, _, _ = cases[0]  # the two 2048-token packs
        ops3 = lambda b, n, m: (rn(b, HEADS, n, DH).to(bf16), rn(b, HEADS, m, DH).to(bf16),
                                rn(b, HEADS, m, DH).to(bf16))
        causal_cases = (
            (f"n=m={N_LONG}", *ops3(2, N_LONG, N_LONG), None, None, scale),
            (f"n={N_MID} m={N_LONG}", *ops3(2, N_MID, N_LONG), None, None, scale),
            (f"n={N_LONG} m={N_MID}", *ops3(2, N_LONG, N_MID), None, None, scale),
            ("packed ids", qp, kp, vp, ids, ids, 1.0),
        )
        gq, gk = qk_gamma_pair(gen, dev)
        same = torch.equal(fa.flash_dropout_masks(DROP_SEED, 2, HEADS, N_MID, N_LONG, RATE, device=dev),
                           fa.flash_dropout_masks_reference(DROP_SEED, 2, HEADS, N_MID, N_LONG, RATE, device=dev))
        log(f"  flash_dropout_masks (2, {HEADS}, {N_MID}, {N_LONG}), the [dropout,causal] kernels' bits: bitwise equal "
            f"to the twin: {same}")
        if not same:
            fail("flash_dropout_masks disagrees with its twin at n != m")
        for label, q, k, v, qs, ks, sc in causal_cases:
            kw = dict(scale=sc, q_segment_ids=qs, kv_segment_ids=ks, causal=True)
            do = rn(*q.shape).to(bf16)
            for rate, gammas in ((0.0, False), (RATE, False), (0.0, True), (RATE, True)):
                dkw = dict(dropout_rate=rate, seed=DROP_SEED if rate else None)
                if gammas:
                    dkw.update(gamma_q=gq, gamma_k=gk)
                tag = fa._counter("", rate > 0, gammas, True)
                fwd, dq_name, dkv_name = (f"{name}{tag}" for name in TPU_FLASH)
                o, lse = fa.flash_fwd(q, k, v, **kw, **dkw)
                o_want, lse_want = fa.flash_fwd_reference(q, k, v, **kw, **dkw)
                if gammas:  # o and lse against the twin fed the kernels' own q^ and k^ (suspects 6, 7)
                    lse_own_hats = lse_want
                    o_want, lse_want = fa.flash_fwd_reference(*kernel_order_hats(q, k, gq, gk), v, **kw,
                                                              dropout_rate=rate, seed=DROP_SEED if rate else None)
                errs[fwd] = max(errs[fwd], compare(f"{fwd} o [{label}]", o, o_want, ATTN_ATOL, ATTN_RTOL))
                live = lse_want > 0.5 * fa.NEG_INF
                if not bool((lse[~live] == fa.NEG_INF).all()):
                    fail(f"{fwd} lse [{label}]: a fully masked row does not read the sentinel")
                errs[fwd] = max(errs[fwd], compare(f"{fwd} lse [{label}]", lse[live], lse_want[live], FLASH_LSE_ATOL,
                                                   FLASH_LSE_RTOL, F32_REL_L2))
                if gammas:
                    log_own_hats_lse(fwd, label, lse[live], lse_own_hats[live])
                if rate == 0.0 and not gammas:
                    unmasked = fa.flash_fwd(q, k, v, scale=sc, q_segment_ids=qs, kv_segment_ids=ks)[0]
                    if torch.equal(o, unmasked):
                        fail(f"{fwd} [{label}] gives what the kernel without the causal mask gives")
                delta = (do.float() * o.float()).sum(-1)
                dq, dk, dv = flash_bwd_twice(fa, f"{label}{tag}", q, k, v, do, lse, delta, **kw, **dkw)
                want = fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw, **dkw)
                for kernel, part, got, w in ((dq_name, "dq", dq, want[0]), (dkv_name, "dk", dk, want[1]),
                                             (dkv_name, "dv", dv, want[2])):
                    errs[kernel] = max(errs[kernel], compare_or_zero(f"{kernel} {part} [{label}]", got, w, None,
                                                                     ATTN_RTOL, atol_frac=BWD_ATOL_FRAC))
                del o, o_want, lse, lse_want, dq, dk, dv, want
            sync()

        q, k, v = ops3(2, N_MID, N_MID)
        bias_cases = (
            ("(1, h) f32", q, k, v, rn(1, HEADS, N_MID, N_MID), False, None, scale),
            ("(b, 1) f32", q, k, v, rn(2, 1, N_MID, N_MID), False, None, scale),
            ("(b, h) f32", q, k, v, rn(2, HEADS, N_MID, N_MID), False, None, scale),
            ("(1, h) bf16", q, k, v, rn(1, HEADS, N_MID, N_MID).to(bf16), False, None, scale),
            ("(1, h) f32, causal", q, k, v, rn(1, HEADS, N_MID, N_MID), True, None, scale),
            ("(b, h) f32, packed ids", qp, kp, vp, 4 * rn(*qp.shape[:3], kp.shape[2]), False, ids, 1.0),
        )
        for label, q_, k_, v_, bias, causal, qs, sc in bias_cases:
            name = "flash_fwd[bias,causal]" if causal else "flash_fwd[bias]"
            kw = dict(scale=sc, q_segment_ids=qs, kv_segment_ids=qs, causal=causal, bias=bias)
            o, lse = fa.flash_fwd(q_, k_, v_, **kw)
            o_want, lse_want = fa.flash_fwd_reference(q_, k_, v_, **kw)
            errs[name] = max(errs[name], compare_or_zero(f"{name} o [{label}]", o, o_want, ATTN_ATOL, ATTN_RTOL))
            live = lse_want > 0.5 * fa.NEG_INF
            if not bool((lse[~live] == fa.NEG_INF).all()):
                fail(f"{name} lse [{label}]: a fully masked row does not read the sentinel")
            errs[name] = max(errs[name], compare(f"{name} lse [{label}]", lse[live], lse_want[live], FLASH_LSE_ATOL,
                                                 FLASH_LSE_RTOL, F32_REL_L2))
            del o, o_want, lse, lse_want
        sync()

    # the Functions against autograd through the f32 composite
    functions = (
        (f"flash_attention[causal] vs f32 composite [n={N_MID} m={N_LONG}]", fa.flash_attention, causal_cases[1][1:4],
         dict(causal=True), None),
        ("flash_attention[bias,causal] vs f32 composite [(1, h)]", fa.flash_attention, (q, k, v), dict(causal=True),
         rn(1, HEADS, N_MID, N_MID)),
        ("short_attention[bias] vs f32 composite [n=m=197]", sa.short_attention,
         tuple(rn(B_SHORT, HEADS, 197, DH).to(bf16) for _ in range(3)), {}, rn(HEADS, 197, 197)),
    )
    for label, fn, qkv, kw, bias in functions:
        leaves = [t.detach().clone().requires_grad_() for t in (*qkv, *(() if bias is None else (bias,)))]
        do = rn(*qkv[0].shape).to(bf16)
        bkw = {} if bias is None else dict(bias=leaves[3])
        out = fn(*leaves[:3], **kw, **bkw)
        got = (out, *torch.autograd.grad(out, leaves, do))
        ref = [t.detach().float().requires_grad_() for t in leaves]
        rkw = {} if bias is None else dict(bias=ref[3])
        out_ref = fa.flash_attention_reference(*ref[:3], **kw, **rkw)
        want = (out_ref, *torch.autograd.grad(out_ref, ref, do.float()))
        for part, a, b in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
            compare_or_zero(f"{label} {part}", a, b, None, ATTN_RTOL, FLASH_VS_F32_REL_L2,
                            atol_frac=FLASH_VS_F32_ATOL_FRAC)
        del leaves, ref, out, out_ref, got, want
        sync()
    return errs


def simple_512_model(kind, dev, dtype):
    """SimpleViT ("simple") or SimpleViT-qk-norm ("qknorm") at the ViT-B/16
    widths, image 512, patch 16: 1024 tokens; random weights from SEED,
    initialised in f32 and cast."""
    from vit_pytorch_tpu_torch.models import simple_vit, simple_vit_with_qk_norm

    cls = simple_vit_with_qk_norm.SimpleViT if kind == "qknorm" else simple_vit.SimpleViT
    return cls(**SIMPLE_512, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).to(dtype)


def check_simple_512(fb, fa, dev, rnd, gen):
    """Phase 29, the model path: SimpleViT-B/16 @512 and SimpleViT-qk-norm
    @512 served behind buckets SIMPLE_512_BUCKETS (exact counters: 12
    short_attention a forward, no other launch; outputs against the plain
    bf16 path, the short Function on its twin, and fp32, which the gate sends
    to the composite) and trained TRAIN_STEPS steps at bs=B_TRAIN (short
    forward, composite backward; loss falls, exact counters, first-step
    loss and gradients against the plain bf16 path and fp32).  Returns the
    launch counts of SimpleViT's requests."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step
    from vit_pytorch_tpu_torch.serving import Predictor

    bf16 = torch.bfloat16
    size = SIMPLE_512["image_size"]
    log(f"[29 SimpleViT @512 on the short kernel] {SIMPLE_512} ({SIMPLE_512_N} tokens, no cls token: m = "
        f"{SIMPLE_512_N}, the dispatcher's short route), bf16, seed {SEED}; buckets {SIMPLE_512_BUCKETS}, requests "
        f"{SIMPLE_512_REQUESTS}; training at bs={B_TRAIN}, {TRAIN_STEPS} steps")
    for kind in ("simple", "qknorm"):
        fp32 = simple_512_model(kind, dev, torch.float32).eval()
        pred = Predictor(fp32, example_shape=(3, size, size), batch_sizes=SIMPLE_512_BUCKETS, device=dev).warmup()
        images = {k: rnd(k, 3, size, size, dtype=torch.float32) for k in SIMPLE_512_REQUESTS}
        runs = sum(-(-k // SIMPLE_512_BUCKETS[-1]) for k in SIMPLE_512_REQUESTS)
        reset_all(fb, fa)
        outs = {k: pred(images[k]) for k in SIMPLE_512_REQUESTS}
        sync()
        counts = expect_launches(fb, fa, {"short_attention": DEPTH * runs},
                               f"SimpleViT{'-qk-norm' if kind == 'qknorm' else ''} @512 serving ({runs} bucket runs)")
        if kind == "simple":
            serving_counts = counts
        width = SIMPLE_512["dim"] if kind == "qknorm" else SIMPLE_512["num_classes"]
        for k, out in outs.items():
            if out.shape != (k, width) or not bool(torch.isfinite(out).all()):
                fail(f"{kind} @512 request of {k} images: shape {tuple(out.shape)}, finite "
                     f"{bool(torch.isfinite(out).all())}")
        k = SIMPLE_512_REQUESTS[-1]
        reset_all(fb, fa)
        with torch.inference_mode():
            with plain_short():
                plain = pred.model(images[k].to(bf16))
            want = fp32(images[k])
        sync()
        if any(all_launches(fb, fa).values()):
            fail(f"the plain and fp32 paths launched kernels: {all_launches(fb, fa)}")
        e_plain, e_fp32, floor = rel_l2(outs[k], plain), rel_l2(outs[k], want), rel_l2(plain, want)
        ok = e_plain <= SIMPLE_LOGITS_VS_PLAIN and e_fp32 <= SIMPLE_LOGITS_VS_FP32
        log(f"  {kind}: outputs of the {k}-image request, rel L2: vs plain bf16 {e_plain:.4e} (bound "
            f"{SIMPLE_LOGITS_VS_PLAIN}), vs fp32 {e_fp32:.4e} (bound {SIMPLE_LOGITS_VS_FP32}; plain bf16 vs fp32 "
            f"{floor:.4e}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{kind} @512 served outputs disagree with the plain path or fp32")
        del pred, fp32, outs, plain, want
        sync()

    for kind in ("simple", "qknorm"):
        width = SIMPLE_512["dim"] if kind == "qknorm" else SIMPLE_512["num_classes"]
        fp32 = simple_512_model(kind, dev, torch.float32)
        model = copy.deepcopy(fp32).to(bf16)
        initial = copy.deepcopy(model)
        names = [n for n, _ in model.named_parameters()]
        images = torch.randn(B_TRAIN, 3, size, size, generator=gen, device=dev)
        labels = torch.randint(0, width, (B_TRAIN,), generator=gen, device=dev)
        state, step = create_train_state(model), make_train_step(model)
        reset_all(fb, fa)
        losses = []
        for i in range(TRAIN_STEPS):
            losses.append(step(state, images.to(bf16), labels)["loss"].item())
            if i == 0:
                grads = grad_vector(model)
        sync()
        log(f"  {kind} training: losses {[f'{v:.6f}' for v in losses]}")
        expect_launches(fb, fa, {"short_attention": DEPTH * TRAIN_STEPS}, f"{kind} @512 training")
        if not all(v == v and abs(v) != float("inf") for v in losses) or not losses[-1] < losses[0]:
            fail(f"{kind} @512 training loss is not finite or does not fall on the repeated batch")
        plain = copy.deepcopy(initial)
        reset_all(fb, fa)
        with plain_short():
            loss_plain = make_train_step(plain)(create_train_state(plain), images.to(bf16), labels)["loss"].item()
        sync()
        if any(all_launches(fb, fa).values()):
            fail(f"the plain path launched kernels: {all_launches(fb, fa)}")
        with plain_short(admit_fp32=True):
            loss_fp32 = make_train_step(fp32)(create_train_state(fp32), images, labels)["loss"].item()
        plain_grads, fp32_grads = grad_vector(plain), grad_vector(fp32)
        log(f"  plain bf16 vs fp32: loss rel {abs(loss_plain - loss_fp32) / abs(loss_fp32):.3e}, gradients rel L2 "
            f"{grads_rel_l2(plain_grads, fp32_grads):.4e}")
        compare_grads(f"{kind} @512 first step vs plain bf16", grads, plain_grads, losses[0], loss_plain,
                      SIMPLE_TRAIN_VS_PLAIN, names)
        compare_grads(f"{kind} @512 first step vs fp32", grads, fp32_grads, losses[0], loss_fp32,
                      SIMPLE_TRAIN_VS_FP32, names)
        del model, plain, fp32, initial, state, step, grads, plain_grads, fp32_grads
        sync()
    return serving_counts


def check_dispatch_on_card(fb, fa, dev, gen):
    """Phase 29, the ops entry point: dot_product_attention on the card at
    the edge of the short route (m = 1024: short_attention; m = 1025:
    flash_fwd; fp32 and dim_head 32 at m = 1024: the composite, no launch),
    each against the f32 composite; then, counters zeroed just before, the
    calls that reach the causal and bias variants, forward and backward:
    causal at m = N_LONG (rate 0 and 0.1, and with qk-norm gammas under
    VIT_TPU_FUSE_QKNORM=1), a (1, h, n, m) bias with and without the causal
    mask, a per-head (h, n, m) bias at m = 1024 (the short kernel's [bias]).
    Returns the launch counts of that second run."""
    from vit_pytorch_tpu_torch.ops.attention import dot_product_attention

    bf16 = torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    log(f"[29 dispatcher on the card] dot_product_attention, b=2, heads={HEADS}, dh={DH}, bf16")

    def against_f32(label, got, q, k, v, **kw):
        want = dot_product_attention(q.float(), k.float(), v.float(), use_flash=False, **kw)
        e = rel_l2(got, want)
        ok = bool(torch.isfinite(got).all()) and e <= FLASH_VS_F32_REL_L2
        log(f"  {label}: rel L2 vs the f32 composite {e:.3e} (bound {FLASH_VS_F32_REL_L2}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"dot_product_attention {label} disagrees with the f32 composite")

    q = rn(2, HEADS, N_EDGE, DH).to(bf16)
    with torch.inference_mode():
        for m, want in ((N_EDGE, {"short_attention": 1}), (N_EDGE + 1, {"flash_fwd": 1})):
            k, v = rn(2, HEADS, m, DH).to(bf16), rn(2, HEADS, m, DH).to(bf16)
            reset_all(fb, fa)
            out = dot_product_attention(q, k, v)
            sync()
            expect_launches(fb, fa, want, f"the dispatcher at m = {m}")
            against_f32(f"m = {m}", out, q, k, v)
        k, v = rn(2, HEADS, N_EDGE, DH).to(bf16), rn(2, HEADS, N_EDGE, DH).to(bf16)
        reset_all(fb, fa)
        dot_product_attention(q.float(), k.float(), v.float())
        dot_product_attention(q[..., :32], k[..., :32], v[..., :32])
        sync()
        expect_launches(fb, fa, {}, "the dispatcher at m = 1024 in fp32 and at dim_head 32 (the composite)")

    n = m = N_LONG
    q, k, v, do = (rn(2, HEADS, n, DH).to(bf16) for _ in range(4))
    gq, gk = qk_gamma_pair(gen, dev)
    drop_gen = torch.Generator(device="cpu").manual_seed(SEED)
    calls = (  # (label, keywords, gammas, under VIT_TPU_FUSE_QKNORM)
        ("causal", dict(causal=True), False),
        ("causal, dropout 0.1", dict(causal=True, dropout_rate=RATE, generator=drop_gen), False),
        ("causal, qk-norm gammas", dict(causal=True, scale=1.0), True),
        ("causal, dropout 0.1, qk-norm gammas", dict(causal=True, scale=1.0, dropout_rate=RATE, generator=drop_gen),
         True),
        ("bias (1, h, n, m)", dict(bias=rn(1, HEADS, n, m)), False),
        ("bias (1, h, n, m), causal", dict(bias=rn(1, HEADS, n, m), causal=True), False),
    )
    reset_all(fb, fa)
    for label, kw, gammas in calls:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        gkw = dict(gamma_q=gq, gamma_k=gk) if gammas else {}
        with fuse_qknorm(gammas):
            out = dot_product_attention(*leaves, **kw, **gkw)
            torch.autograd.grad(out, leaves, do)
        if "dropout_rate" not in kw:
            fkw = {key: val for key, val in kw.items() if key != "generator"}
            with torch.inference_mode():
                against_f32(label, out.detach(), q, k, v, **fkw, **gkw)
        del leaves, out
    qs = q[:, :, :N_EDGE]
    ks, vs = k[:, :, :N_EDGE], v[:, :, :N_EDGE]
    bias = rn(HEADS, N_EDGE, N_EDGE)
    leaves = [t.detach().clone().requires_grad_() for t in (qs, ks, vs, bias)]
    out = dot_product_attention(*leaves[:3], bias=leaves[3])
    torch.autograd.grad(out, leaves, do[:, :, :N_EDGE])
    with torch.inference_mode():
        against_f32("per-head bias (h, n, m) at m = 1024", out.detach(), qs, ks, vs, bias=bias)
    sync()
    want = {**{name: 1 for name in FLASH_CAUSAL}, **{name: 1 for name in FLASH_BIAS}, "short_attention[bias]": 1}
    return expect_launches(fb, fa, want, "dot_product_attention's causal and bias calls, forward and backward")


def time_short_causal_bias(fa, dev, gen, smi):
    """Phase 30: SimpleViT-B/16 @512 and SimpleViT-qk-norm @512 serving img/s
    at bs=32 and training ms/step with peak memory at bs=B_TRAIN, kernel
    against plain paths in turns; each new launch alone against its twin,
    its bound and its library call (SDPA; is_causal for the causal mask, a
    float attn_mask for a bias): the short kernel at SimpleViT @512's shape
    (32 x 12 x 1024), the flash variants at 8 x 12 x 2048.  Returns the
    timing entries."""
    from vit_pytorch_tpu_torch.ops import short_attention as sa
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    size = SIMPLE_512["image_size"]
    log(f"[30 short kernel, flash causal and bias timing] {smi}")
    bs = SIMPLE_512_BUCKETS[-1]
    for kind in ("simple", "qknorm"):
        model = simple_512_model(kind, dev, bf16).eval()
        img = torch.randn(bs, 3, size, size, generator=gen, device=dev).to(bf16)
        with torch.inference_mode():
            def serve_plain():
                with plain_short():
                    model(img)

            p1, k1, k2, p2 = (host_ms(f, 5) for f in (serve_plain, lambda: model(img), lambda: model(img), serve_plain))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"  {kind} @512 serving at bs={bs}: kernel path {bs * 1e3 / k_ms:.1f} img/s ({k_ms:.3f} ms/batch), plain "
            f"bf16 path {bs * 1e3 / p_ms:.1f} img/s ({p_ms:.3f} ms/batch); turns ms plain {p1:.3f} kernel {k1:.3f} "
            f"kernel {k2:.3f} plain {p2:.3f}")
        del model, img
        width = SIMPLE_512["dim"] if kind == "qknorm" else SIMPLE_512["num_classes"]
        model = simple_512_model(kind, dev, bf16)
        images = torch.randn(B_TRAIN, 3, size, size, generator=gen, device=dev).to(bf16)
        labels = torch.randint(0, width, (B_TRAIN,), generator=gen, device=dev)
        state, step = create_train_state(model), make_train_step(model)

        def plain_step():
            with plain_short():
                step(state, images, labels)

        kernel_step = lambda: step(state, images, labels)
        (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (train_step_ms(dev, f)
                                                      for f in (plain_step, kernel_step, kernel_step, plain_step))
        log(f"  {kind} @512 training at bs={B_TRAIN}: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path "
            f"{(p1 + p2) / 2:.3f} ms/step; turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; "
            f"peak device memory kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
        del model, state, step, images

    per_kernel = {}
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    with torch.inference_mode():
        b, n = B_SHORT, SIMPLE_512_N
        q, k, v = (rn(b, HEADS, n, DH).to(bf16) for _ in range(3))
        bias = rn(HEADS, n, n)
        log(f"  the short kernel at SimpleViT @512's shape ({b} x {HEADS} heads x {n} tokens); its library call "
            f"scaled_dot_product_attention, with the bias as a float attn_mask:")
        for name, b_, lib in (("short_attention", None, lambda: sdpa(q, k, v)),
                              ("short_attention[bias]", bias,
                               lambda m=bias.to(bf16)[None]: sdpa(q, k, v, attn_mask=m))):
            km, pm = in_turns(lambda: sa.short_fwd(q, k, v, scale=DH**-0.5, bias=b_),
                              lambda: sa.short_attention_reference(q, k, v, scale=DH**-0.5, bias=b_), 5)
            lib_ms = cuda_ms(lib, 5)
            w = pair_work(name, b, n, n, n * n, bias_bytes=0 if b_ is None else b_.numel() * 4)
            record(per_kernel, name, km, pm, w, lib_ms)
            bound, by = bound_ms(w)
            log(f"  {name}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms ({by}), library {lib_ms:.4f} ms")
        del q, k, v, bias

        b, n = B_CAUSAL_TIME, N_CAUSAL_TIME
        q, k, v, do = (rn(b, HEADS, n, DH).to(bf16) for _ in range(4))
        gq, gk = qk_gamma_pair(gen, dev)
        pairs = causal_pairs(n, n)
        log(f"  each flash variant at {b} x {HEADS} heads x {n} tokens, no ids ({pairs / n / n:.4f} of the pairs "
            f"visible under the causal mask); the backward twin computes dq, dk and dv at once:")
        # flash_fwd without options at this shape, the base of the [bias] and
        # [causal] ratios (logged; the kernels line's flash_fwd entry is the
        # NaViT packs')
        km, pm = in_turns(lambda: fa.flash_fwd(q, k, v, scale=DH**-0.5),
                          lambda: fa.flash_fwd_reference(q, k, v, scale=DH**-0.5), 3)
        lib_ms = cuda_ms(lambda: sdpa(q, k, v), 5)
        bound, by = bound_ms(pair_work("flash_fwd", b, n, n, n * n))
        log(f"  flash_fwd (no options): kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms ({by}), library "
            f"{lib_ms:.4f} ms (SDPA)")
        # the backward kernels without options at this shape (logged; their
        # kernels line entries are the NaViT packs'), beside the library's
        o, lse = fa.flash_fwd(q, k, v, scale=DH**-0.5)
        delta = (do.float() * o.float()).sum(-1)
        lib_ms, lib_of = flash_backend_bwd_ms(q, k, v, do, 5)
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            kern = getattr(fa, name)
            km, pm = in_turns(lambda: kern(q, k, v, do, lse, delta, scale=DH**-0.5),
                              lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, scale=DH**-0.5), 3)
            bound, by = bound_ms(pair_work(name, b, n, n, n * n))
            log(f"  {name} (no options): kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms ({by}); "
                f"{lib_of}: {lib_ms:.4f} ms")
        del o, lse, delta
        for tag in CAUSAL_TAGS:
            rate, gammas = (RATE if "dropout" in tag else 0.0), "qknorm" in tag
            kw = dict(scale=DH**-0.5, causal=True, dropout_rate=rate, seed=DROP_SEED if rate else None)
            if gammas:
                kw.update(gamma_q=gq, gamma_k=gk)
            o, lse = fa.flash_fwd(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1)
            library = {"flash_fwd[causal]": lambda: sdpa(q, k, v, is_causal=True),
                       "flash_fwd[dropout,causal]": lambda: sdpa(q, k, v, is_causal=True, dropout_p=RATE)}
            # beside the backward kernels: the library's causal backward (no norm inside it)
            bwd_ms, bwd_of = flash_backend_bwd_ms(q, k, v, do, 5, causal=True, dropout_p=rate)
            for name, kern, plain in (
                (f"flash_fwd{tag}", lambda: fa.flash_fwd(q, k, v, **kw), lambda: fa.flash_fwd_reference(q, k, v, **kw)),
                (f"flash_bwd_dq{tag}", lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                 lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw)),
                (f"flash_bwd_dkv{tag}", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                 lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw)),
            ):
                km, pm = in_turns(kern, plain, 3)
                lib_ms = cuda_ms(library[name], 5) if name in library else None
                w = pair_work(name, b, n, n, pairs, dropout=bool(rate), qknorm=gammas)
                yard = dict(product_ms=bwd_ms, product_of=bwd_of) if "bwd" in name else {}
                record(per_kernel, name, km, pm, w, lib_ms, **yard)
                bound, by = bound_ms(w)
                lib_note = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
                lib_note += f", {bwd_of} {bwd_ms:.4f} ms" if yard else ""
                log(f"  {name}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms ({by}){lib_note}")
            del o, lse, delta
        bias = rn(1, HEADS, n, n)
        causal_mask = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
        for name, causal in (("flash_fwd[bias]", False), ("flash_fwd[bias,causal]", True)):
            kw = dict(scale=DH**-0.5, causal=causal, bias=bias)
            mask = bias.to(bf16) if not causal else bias.masked_fill(~causal_mask, float("-inf")).to(bf16)
            km, pm = in_turns(lambda: fa.flash_fwd(q, k, v, **kw), lambda: fa.flash_fwd_reference(q, k, v, **kw), 3)
            lib_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask), 5)
            w = pair_work(name, b, n, n, pairs if causal else n * n, bias_bytes=bias.numel() * 4)
            record(per_kernel, name, km, pm, w, lib_ms)
            bound, by = bound_ms(w)
            log(f"  {name}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound:.4f} ms ({by}), library {lib_ms:.4f} "
                f"ms (SDPA, the bias{' with -inf above the diagonal' if causal else ''} as a bf16 attn_mask)")
            del mask
    sync()
    return per_kernel


# -- the multi-layer stack (phases 31-33): VIT_TPU_STACK_LAYERS=g runs g whole
# layers in one stack_layers launch (the port of _stack_kernel)
STACK_SOURCE = "vit_pytorch_tpu_torch/csrc/stack_layers.cu"
TPU_STACK = "vit_pytorch_tpu/ops/fused_block.py:1979"
STACK_KEYS = ("VIT_TPU_STACK_LAYERS", "VIT_TPU_DISABLE_STACK")
STACK_SHAPES = ((B_CHECK, N), (3, 50))  # 1,576 rows (12 full 128-row tiles and 40) and 150 (one and 22)
STACK_GROUPS = (1, 2, 3, 6)
STACK_BIASES = ((False, False), (True, True), (True, False), (False, True))  # (b_qkv, b_out)
STACK_GRAD_GROUP = 3
# A shape whose steps all end on a ragged wave of the 132-block grid, with
# several waves before it: 37 x 197 = 7,289 rows (57 row tiles, the last of
# 121 rows) give 1,026 / 342 / 1,368 / 342 GEMM tiles at qkv / out / fc1 / fc2
# (102, 78, 48, 78 past the last whole wave), 444 attention items on 264
# warpgroups, 7,289 LN rows on 1,056 warps; from a generator of its own.
STACK_RAGGED = (37, N)
# Relaunches of the g = 6 stack at bs=128, each bitwise the first and the
# chain (both instantiations): a missing proxy fence, a stale residual tile or
# a ring phase off by one shows as an intermittent flip, not as a crash.
STACK_RELAUNCHES = 20
# Against its twin, stack_layers is held twice: its last layer against the
# twin of that layer on the kernels' output of the g - 1 before it, within
# the whole layer's bounds; and the whole stack against the twins' chain of
# g layers, where each layer adds its own flips of a bf16 rounding: a right
# kernel (bitwise the chain) reads rel L2 2.2e-4 to 2.0e-3 at g = 1, 2.5e-3
# to 3.8e-3 at 2, 4.2e-3 to 5.2e-3 at 3 and 6.9e-3 to 7.8e-3 at 6, max_abs
# up to 0.16, and 2.1e-3 at most on the last layer's step (H100 80GB HBM3,
# 700 W), so that bound is g times one layer's (LAYER_ATOL, KERNEL_REL_L2).
STACK_SERVE = (  # (label, switches, stack_layers launches a bucket run; 0: the 12 x 7 chain)
    ("unset", {}, 0), ("g=6", {"VIT_TPU_STACK_LAYERS": "6"}, 2), ("g=5", {"VIT_TPU_STACK_LAYERS": "5"}, 3),
    ("g=6, disabled", {"VIT_TPU_STACK_LAYERS": "6", "VIT_TPU_DISABLE_STACK": "1"}, 0),
)
STACK_TIME_GROUPS = (2, 3, 6)
STACK_TURN_PAIRS = 3  # phase 33's served buckets: turn pairs of the switch unset and set
STACK_TRAIN_STEPS = 2


def stack_tuples(rnd, layers, b_qkv, b_out):
    """``layers`` random ViT-B layers (phase 3's scales) as stack tuples,
    with or without the optional biases."""
    out = []
    for _ in range(layers):
        w, kw = layer_weights(rnd)
        out.append((w["w_qkv"], kw["b_qkv"] if b_qkv else None, w["w_out"], kw["b_out"] if b_out else None,
                    w["ln1_scale"], w["ln1_bias"], w["ln2_scale"], w["ln2_bias"], w["w1"], w["b1"], w["w2"], w["b2"]))
    return out


def layer_chain(fb, x, layers, epilogues="package"):
    """The same layers as the chain of 7 launches a layer."""
    for lw in layers:
        x = fb._layer_forward(fb.KERNELS, x, *lw, HEADS, DH, DH**-0.5, fb.LN_EPS, epilogues)[0]
    return x


def check_stack_relaunches(fb, own):
    """Phase 31's ragged shape (STACK_RAGGED, every bias option, g in
    STACK_GROUPS) bitwise the chain, and STACK_RELAUNCHES launches of g = 6
    at bs=128 of both instantiations, each bitwise the first and the chain;
    operands from ``own``, a generator of their own."""
    skw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
    b, n = STACK_RAGGED
    for b_qkv, b_out in STACK_BIASES:
        layers = stack_tuples(own, max(STACK_GROUPS), b_qkv, b_out)
        x = own(b, n, DIM)
        for g in STACK_GROUPS:
            tag = f"g={g} b={b} n={n} b_qkv={int(b_qkv)} b_out={int(b_out)}"
            got, chain = fb.stack_layers(x, layers[:g], **skw), layer_chain(fb, x, layers[:g])
            same = torch.equal(got, chain)
            log(f"  stack_layers[{tag}] (a ragged last wave at every step) vs the chain of {7 * g} launches: "
                f"{'bitwise' if same else 'DIFFERS'}")
            if not same:
                fail(f"stack_layers[{tag}] differs from the chain")
        sync()
    for epilogues, (b_qkv, b_out) in (("package", (False, True)), ("tools", (False, False))):
        name = "stack_layers[tools]" if epilogues == "tools" else "stack_layers"
        layers = stack_tuples(own, 6, b_qkv, b_out)
        x = own(B_TIME, N, DIM)
        chain = layer_chain(fb, x, layers, epilogues)
        first = fb.stack_layers(x, layers, **skw, epilogues=epilogues)
        differ = sum(not torch.equal(fb.stack_layers(x, layers, **skw, epilogues=epilogues), first)
                     for _ in range(STACK_RELAUNCHES - 1))
        same = torch.equal(first, chain)
        log(f"  {name} g=6 bs={B_TIME}: {STACK_RELAUNCHES} launches, {differ} differ from the first; the first "
            f"{'bitwise' if same else 'DIFFERS from'} the chain of 42 launches")
        if differ or not same:
            fail(f"{name} at g=6 bs={B_TIME} is not bitwise the chain on every relaunch")
        sync()


def check_stack(fb, rnd, dev):
    """Phase 31: stack_layers bitwise against the chain of 7g launches and
    within the whole layer's bounds of its twin, at each shape, group and
    bias option; the grad route's output and 12g + 1 gradients bitwise the
    per-layer Functions'; the refusals.  Returns the largest max_abs
    against the twin."""
    log(f"[31 stack_layers] ViT-B widths, (b, n) in {STACK_SHAPES}, g in {STACK_GROUPS}, (b_qkv, b_out) in "
        f"{STACK_BIASES}, bf16")
    skw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
    worst = 0.0
    with torch.inference_mode():
        for b_qkv, b_out in STACK_BIASES:
            layers = stack_tuples(rnd, max(STACK_GROUPS), b_qkv, b_out)
            for b, n in STACK_SHAPES:
                x = rnd(b, n, DIM)
                for g in STACK_GROUPS:
                    tag = f"g={g} b={b} n={n} b_qkv={int(b_qkv)} b_out={int(b_out)}"
                    got = fb.stack_layers(x, layers[:g], **skw)
                    chain = layer_chain(fb, x, layers[:g])
                    sync()
                    same = torch.equal(got, chain)
                    log(f"  stack_layers[{tag}] vs the chain of {7 * g} launches: "
                        f"{'bitwise' if same else 'DIFFERS, max_abs %.4e' % (got.float() - chain.float()).abs().max().item()}")
                    if not same:
                        fail(f"stack_layers[{tag}] differs from the chain")
                    # the last layer's step: the twin of layer g on the kernels' output of g - 1 layers
                    prev = layer_chain(fb, x, layers[:g - 1])
                    step = fb.stack_layers_reference(prev, layers[g - 1:g], **skw)
                    worst = max(worst, compare(f"stack_layers[{tag}] vs twin step", got, step, LAYER_ATOL, LAYER_RTOL))
                    twin = fb.stack_layers_reference(x, layers[:g], **skw)
                    compare(f"stack_layers[{tag}] vs twin chain", got, twin, g * LAYER_ATOL, LAYER_RTOL,
                            g * KERNEL_REL_L2)
        sync()
        mixed = stack_tuples(rnd, 2, True, True)
        mixed[1] = (mixed[1][0], None) + mixed[1][2:]
        x209 = rnd(2, 209, DIM)
        refusals = {
            "a mixed-bias stack": lambda: fb.fused_transformer_stack(rnd(2, N, DIM), mixed, heads=HEADS, dim_head=DH),
            "stack_layers at n = 209": lambda: fb.stack_layers(x209, layers[:2], **skw),
            "fused_transformer_stack at n = 209": lambda: fb.fused_transformer_stack(x209, layers[:2], heads=HEADS,
                                                                                     dim_head=DH),
        }
        for what, call in refusals.items():
            try:
                call()
            except ValueError as e:
                log(f"  {what}: refused ({str(e)[:80]}...)")
            else:
                fail(f"{what} was not refused")
        check_stack_relaunches(fb, edge_rnd(SEED + 31))
    # the grad route: the per-layer Functions, bitwise
    layers = stack_tuples(rnd, STACK_GRAD_GROUP, True, True)
    x, cot = rnd(B_CHECK, N, DIM), rnd(B_CHECK, N, DIM)
    results = []
    for stacked in (True, False):
        leaves = [t.detach().clone().requires_grad_() for t in (x, *(t for lw in layers for t in lw))]
        ls = [tuple(leaves[1 + 12 * i: 13 + 12 * i]) for i in range(STACK_GRAD_GROUP)]
        before = fb.LAUNCHES["stack_layers"]
        if stacked:
            out = fb.fused_transformer_stack(leaves[0], ls, heads=HEADS, dim_head=DH)
        else:
            out = leaves[0]
            for w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 in ls:
                out = fb.fused_transformer_layer(out, w_qkv, w_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
                                                 heads=HEADS, dim_head=DH, b_qkv=b_qkv, b_out=b_out)
        results.append((out, torch.autograd.grad(out, leaves, cot)))
        if fb.LAUNCHES["stack_layers"] != before:
            fail("the stack's grad route launched stack_layers")
    sync()
    (out, grads), (out_want, grads_want) = results
    same = torch.equal(out, out_want) and all(torch.equal(a, b) for a, b in zip(grads, grads_want))
    log(f"  grad route at g={STACK_GRAD_GROUP}: output and {len(grads)} gradients "
        f"{'bitwise the per-layer Functions' if same else 'DIFFER from the per-layer Functions'}")
    if not same or len(grads) != 12 * STACK_GRAD_GROUP + 1:
        fail("the stack's grad route differs from the per-layer route")
    return {"stack_layers": worst}


def serve_stack(fb, dev, rnd, smi):
    """Phase 32: ViT-B/16 @224 behind the Predictor buckets under each stack
    switch (set in-process): exact launch counters, logits bitwise the
    switch unset's at every bucket and within phase 4's bounds of plain bf16
    and fp32; two training steps at g = 6 with the default's counters, loss
    and gradients.  Returns the main path's counters (g = 6), the predictor
    and the requests for phase 33."""
    from vit_pytorch_tpu_torch import ViT
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step
    from vit_pytorch_tpu_torch.serving import Predictor

    log(f"[32 stack serving] ViT-B/16 @224, depth {DEPTH}, buckets {BUCKETS}, one request a bucket, bf16")
    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP,
                device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).eval()
    pred = Predictor(model, example_shape=(3, 224, 224), batch_sizes=BUCKETS, device=dev).warmup()
    images = {k: rnd(k, 3, 224, 224, dtype=torch.float32) for k in BUCKETS}
    chain = {name: DEPTH * LAUNCHES_PER_LAYER.get(name, 0) * len(BUCKETS) for name in fb.LAUNCHES}
    logits, main_counts = {}, None
    for label, env, stacks in STACK_SERVE:
        with env_switch(env, STACK_KEYS):
            fb.reset_launch_counts()
            logits[label] = {k: pred(images[k]) for k in BUCKETS}
            sync()
            counts = dict(fb.LAUNCHES)
        want = ({name: stacks * len(BUCKETS) if name == "stack_layers" else 0 for name in fb.LAUNCHES} if stacks
                else chain)
        log(f"  {label}: launches {({k: v for k, v in counts.items() if v})} (expected "
            f"{({k: v for k, v in want.items() if v})})")
        if counts != want:
            fail(f"serving under {label}: launch counters off")
        if label == "g=6":
            main_counts = counts
        for k in BUCKETS:
            out = logits[label][k]
            if out.shape != (k, 1000) or not bool(torch.isfinite(out).all()):
                fail(f"{label}, bucket {k}: shape {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
            if not torch.equal(out, logits["unset"][k]):
                fail(f"{label}, bucket {k}: logits differ from the switch unset "
                     f"(max_abs {(out.float() - logits['unset'][k].float()).abs().max().item():.4e})")
    log(f"  logits bitwise the switch unset's at every bucket under {[lab for lab, _, _ in STACK_SERVE[1:]]}")
    served, tr = pred.model, pred.model.transformer
    with torch.inference_mode():
        x = served.embed(images[32].to(torch.bfloat16))
        for i in range(DEPTH):
            ws, kws = tr.layer_weights(i, torch.bfloat16)
            x = fb.layer_reference(x, *ws, heads=HEADS, dim_head=DH, **kws)
        plain = served.mlp_head(tr.norm(x)[:, 0])
        fp32 = model(images[32])
    e_plain, e_fp32 = rel_l2(logits["g=6"][32], plain), rel_l2(logits["g=6"][32], fp32)
    log(f"  g=6 logits of the 32-image bucket: rel L2 vs plain bf16 {e_plain:.4e} (bound {LOGITS_VS_PLAIN_BF16}), "
        f"vs fp32 {e_fp32:.4e} (bound {LOGITS_VS_FP32})")
    if not (e_plain <= LOGITS_VS_PLAIN_BF16 and e_fp32 <= LOGITS_VS_FP32):
        fail("the stack's logits disagree with the plain path")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    images_t = torch.randn(B_TRAIN, 3, 224, 224, generator=gen, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, 1000, (B_TRAIN,), generator=gen, device=dev)
    initial = vit_b(dev, torch.bfloat16)
    runs = {}
    for label, env in (("default", {}), ("g=6", {"VIT_TPU_STACK_LAYERS": "6"})):
        train_model = copy.deepcopy(initial)
        with env_switch(env, STACK_KEYS):
            state, step = create_train_state(train_model), make_train_step(train_model)
            fb.reset_launch_counts()
            losses = [step(state, images_t, labels)["loss"].item() for _ in range(STACK_TRAIN_STEPS)]
            sync()
        runs[label] = (losses, grad_vector(train_model), dict(fb.LAUNCHES))
    want = {k: DEPTH * TRAIN_LAUNCHES_PER_LAYER.get(k, 0) * STACK_TRAIN_STEPS for k in fb.LAUNCHES}
    (l_def, g_def, c_def), (l_st, g_st, c_st) = runs["default"], runs["g=6"]
    same = l_def == l_st and all(torch.equal(a, b) for a, b in zip(g_def, g_st))
    log(f"  training, {STACK_TRAIN_STEPS} steps at bs={B_TRAIN}: g=6 losses {l_st}, default {l_def}; launches under "
        f"g=6 {({k: v for k, v in c_st.items() if v})} (expected {({k: v for k, v in want.items() if v})}); loss and "
        f"gradients {'bitwise the default' if same else 'DIFFER from the default'}")
    if c_st != want or c_def != want:
        fail("training under the stack switch: launch counters off")
    if not same:
        fail("training under the stack switch differs from the default step")
    return main_counts, pred, images


def stack_work(b, n, layers):
    """g layers' work as one function: x in, the output and every layer's
    weights (bias vectors included) read once; the chain's operations."""
    rows, inner = b * n, HEADS * DH
    weights = 2 * (4 * inner * DIM + 2 * DIM * MLP + 3 * inner + MLP + 7 * DIM)
    per_layer = [ln_work(rows, DIM), ln_work(rows, DIM), gemm_work(rows, 3 * inner, DIM),
                 gemm_work(rows, DIM, inner), gemm_work(rows, MLP, DIM), gemm_work(rows, DIM, MLP),
                 attention_work(b, n, HEADS)]
    return work(2 * 2 * rows * DIM + layers * weights, tensor=layers * sum(w["tensor"] for w in per_layer),
                f32=layers * sum(w["f32"] for w in per_layer))


def time_stack(fb, dev, rnd, smi, pred, images):
    """Phase 33: serving img/s at each bucket, the switch unset against g in
    STACK_TIME_GROUPS in turns; one stack_layers launch at bs=128 for g = 1
    .. 6 against its chain of 7g launches in turns, in ms a layer, its
    bound; the g = 6 launch against its twin.  Returns the kernels-line
    timing of stack_layers (the g = 6 launch at bs=128)."""
    log(f"[33 stack timing] {smi}")
    with torch.inference_mode():
        for k in BUCKETS:
            def served(env, k=k):
                def run():
                    with env_switch(env, STACK_KEYS):
                        pred(images[k])
                return run

            for g in STACK_TIME_GROUPS:
                env = {"VIT_TPU_STACK_LAYERS": str(g)}
                unset, stack = [], []
                for pair in range(STACK_TURN_PAIRS):  # unset, g, g, unset, unset, g, ...
                    first, second = (unset, stack) if pair % 2 == 0 else (stack, unset)
                    for runs in (first, second):
                        runs.append(host_ms(served({} if runs is unset else env)))
                mu, ms_ = statistics.median(unset), statistics.median(stack)
                log(f"  bucket {k}, g={g}: stack {k * 1e3 / ms_:.1f} img/s (median {ms_:.4f} ms, range "
                    f"{min(stack):.4f}-{max(stack):.4f}), unset {k * 1e3 / mu:.1f} img/s (median {mu:.4f} ms, range "
                    f"{min(unset):.4f}-{max(unset):.4f}); {STACK_TURN_PAIRS} turn pairs, ms unset "
                    f"{', '.join(f'{v:.4f}' for v in unset)}, g {', '.join(f'{v:.4f}' for v in stack)}")
        layers = stack_tuples(rnd, max(STACK_GROUPS + STACK_TIME_GROUPS), False, True)
        x = rnd(B_TIME, N, DIM)
        skw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
        per_kernel = {}
        for g in range(1, 7):
            km, cm = in_turns(lambda: fb.stack_layers(x, layers[:g], **skw), lambda: layer_chain(fb, x, layers[:g]),
                              10)
            bound, by = bound_ms(stack_work(B_TIME, N, g))
            log(f"  bs={B_TIME}, g={g}: stack_layers {km:.4f} ms ({km / g:.4f} a layer), chain of {7 * g} launches "
                f"{cm:.4f} ms ({cm / g:.4f} a layer), bound {bound:.4f} ms ({bound / g:.4f} a layer, {by})")
            if g == 6:
                pm = cuda_ms(lambda: fb.stack_layers_reference(x, layers[:g], **skw), 3)
                log(f"  g=6: twin {pm:.4f} ms; no torch call computes a layer (library_ms null), the chain "
                    f"{cm:.4f} ms stands beside it")
                record(per_kernel, "stack_layers", km, pm, stack_work(B_TIME, N, g))
    sync()
    return per_kernel


# -- the layer prototypes of tools/ (phases 34-35): the port's bench tools,
# vit_pytorch_tpu_torch/tools/, on the kernels with the prototypes' f32
# epilogues (gemm_bf16[fc1_f32], gemm_bf16[block_out] at their out and fc2
# sites, attention_rows[n_keys], stack_layers[tools])
TPU_TOOLS = {  # each JAX kernel of tools/ (the function reaching pl.pallas_call) and the port's counterpart
    "make_whole_resident": "tools/bench_layer_fused.py:123",
    "make_whole_tiled": "tools/bench_layer_fused.py:178",
    "make_whole_padded": "tools/bench_layer_fused.py:252",
    "make_whole_padded_tiled": "tools/bench_layer_fused.py:324",
    "make_attn_padded": "tools/bench_layer_fused.py:405",
    "make_stack": "tools/bench_stack_fusion.py:105",
    "_attn_block_kernel": "tools/fused_block_proto.py:26",
    "_ff_block_kernel": "tools/fused_block_proto.py:99",
    "_ff_rows_kernel": "tools/fused_block_proto.py:135",
    "make_fused": "tools/bench_fused_tuning.py:40",
}
TOOLS_N_PAD, TOOLS_N_REAL = 200, 197
TOOLS_STACK_GROUPS = (1, 2, 3, 4, 6)
TOOLS_ENTRIES = (  # the kernels line: (entry, source, TPU kernel, the tool whose main() launches it, its counter)
    ("gemm_bf16[fc1_f32]", SOURCE, "make_whole_resident", "bench_layer_fused", "gemm_bf16[fc1_f32]"),
    ("attention_rows[n_keys]", SOURCE, "make_whole_padded", "bench_layer_fused", "attention_rows[n_keys]"),
    ("gemm_bf16[block_out, att+x]", SOURCE, "make_whole_resident", "bench_layer_fused", "gemm_bf16[block_out]"),
    ("gemm_bf16[block_out, fc2+b2+y]", SOURCE, "make_whole_resident", "bench_layer_fused", "gemm_bf16[block_out]"),
    ("gemm_bf16[block_out, +b_out+x]", SOURCE, "_attn_block_kernel", "fused_block_proto", "gemm_bf16[block_out]"),
    ("stack_layers[tools]", STACK_SOURCE, "make_stack", "bench_stack_fusion", "stack_layers[tools]"),
)
_ATTN_CHAIN = {"layernorm_rows": 1, "gemm_bf16": 1, "attention_rows": 1, "gemm_bf16[block_out]": 1}
_FF_CHAIN_TOOLS = {"layernorm_rows": 1, "gemm_bf16": 1, "gemm_bf16[block_out]": 1}
# gemm_bf16[fc1_f32] against its exact reference, bf16(gelu_tanh(bf16(gemm_f32out + b1))) with the kernel's
# GELU formula in f32 (gemm_f32out shares gemm_bf16's main loop, so its dot is bitwise the kernel's): only the
# GELU's f32 ulps differ, flipping the final rounding of a few elements in 10^4; rounding the dot before the
# bias (the package's fc1) moves most GELU inputs by an ulp.  Bound on the share of elements that differ.
FC1_F32_MISMATCH = 1e-3
# the tools' block_out sites are bitwise bf16(gemm_f32out + f32 bias + f32 residual), the adds in that order


def tools_args(rnd, b, n):
    """One layer's bench-tool operands at ViT-B widths (phase 3's scales; no
    b_qkv or b_out, which the prototypes' layer lacks): (x, wqkv, wout,
    ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2), and the proto's b_out."""
    w, kw = layer_weights(rnd)
    return (rnd(b, n, DIM), w["w_qkv"], w["w_out"], w["ln1_scale"], w["ln1_bias"], w["ln2_scale"], w["ln2_bias"],
            w["w1"], w["b1"], w["w2"], w["b2"]), kw["b_out"]


def tools_cases(args, pargs, b_out):
    """The ten counterparts: (TPU kernel, the port's call on the card, its
    plain twin on the same tensors, kernel launches of one call)."""
    from vit_pytorch_tpu_torch.tools import _common as tc
    from vit_pytorch_tpu_torch.tools import bench_fused_tuning, bench_layer_fused, fused_block_proto

    x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 = args
    n_real = TOOLS_N_REAL
    layer = _add(_ATTN_CHAIN, _FF_CHAIN_TOOLS)
    padded = {**layer, "attention_rows": 0, "attention_rows[n_keys]": 1}
    return (
        ("make_whole_resident", lambda: bench_layer_fused.make_whole_resident(2)(*args),
         lambda: tc.layer_twin(*args), layer),
        ("make_whole_tiled", lambda: bench_layer_fused.make_whole_tiled(8, 768)(*args),
         lambda: tc.layer_twin(*args), layer),
        ("make_whole_padded", lambda: bench_layer_fused.make_whole_padded(8, TOOLS_N_PAD, n_real)(*pargs),
         lambda: tc.layer_twin(*pargs, n_real=n_real), padded),
        ("make_whole_padded_tiled",
         lambda: bench_layer_fused.make_whole_padded_tiled(8, 768, TOOLS_N_PAD, n_real)(*pargs),
         lambda: tc.layer_twin(*pargs, n_real=n_real), padded),
        ("make_attn_padded", lambda: bench_layer_fused.make_attn_padded(8, TOOLS_N_PAD, n_real)(*pargs),
         lambda: tc.plain_ff(tc.attention_twin(*pargs[:5], n_real=n_real), w1, b1, w2, b2, ln2s, ln2b),
         {**_ATTN_CHAIN, "attention_rows": 0, "attention_rows[n_keys]": 1}),
        ("_attn_block_kernel", lambda: fused_block_proto.fused_attention_block(x, wqkv, wout, b_out, ln1s, ln1b,
                                                                               heads=HEADS, dim_head=DH),
         lambda: tc.attention_twin(x, wqkv, wout, ln1s, ln1b, b_out=b_out), _ATTN_CHAIN),
        ("_ff_block_kernel", lambda: fused_block_proto.fused_ff_block(x, w1, b1, w2, b2, ln2s, ln2b),
         lambda: tc.ff_twin(x, w1, b1, w2, b2, ln2s, ln2b), _FF_CHAIN_TOOLS),
        ("_ff_rows_kernel", lambda: fused_block_proto.fused_ff_block_rows(x, w1, b1, w2, b2, ln2s, ln2b),
         lambda: tc.ff_twin(x, w1, b1, w2, b2, ln2s, ln2b), _FF_CHAIN_TOOLS),
        ("make_fused", lambda: bench_fused_tuning.make_fused(2)(x, wqkv, wout, ln1s, ln1b),
         lambda: tc.attention_twin(x, wqkv, wout, ln1s, ln1b), _ATTN_CHAIN),
    )


def tools_stack(rnd, layers):
    """``layers`` layers' weights in make_stack's flat order, 10 a layer."""
    return [t for _ in range(layers) for t in tools_args(rnd, 1, 1)[0][1:]]


def gelu_tanh_f32(v):
    """The kernel's tanh GELU (layer_tiles.cuh::gelu_tanh), in f32."""
    return 0.5 * v * (1.0 + torch.tanh(0.7978845608028654 * (v + 0.044715 * v * v * v)))


def check_tools(fb, rnd, dev):
    """Phase 34: each of the ten counterparts of the tools/ prototypes
    against its plain twin within phase 3's bounds, at b = 8, n = 197 and
    n_pad = 200 (n_real = 197), with exact launch counters; the padded calls'
    real rows unchanged when the padded rows' inputs change; make_stack
    (stack_layers[tools]) bitwise the chain of 7L launches and within L
    times the layer bounds of its twin at L in TOOLS_STACK_GROUPS; the new
    epilogues against their exact references (block_out bitwise, fc1_f32 by
    the share of elements that differ); attention_rows[n_keys] against its
    twin, n_keys of 0 and n + 1 refused.  Returns the largest max_abs of
    each new kernel entry."""
    from vit_pytorch_tpu_torch.tools import _common as tc
    from vit_pytorch_tpu_torch.tools import bench_stack_fusion

    log(f"[34 tools prototypes] b={B_CHECK}, n={N} and n_pad={TOOLS_N_PAD} (n_real={TOOLS_N_REAL}), ViT-B widths, "
        f"bf16")
    errs = {}
    with torch.inference_mode():
        args, b_out = tools_args(rnd, B_CHECK, N)
        pargs = (rnd(B_CHECK, TOOLS_N_PAD, DIM),) + args[1:]
        for name, kernel, twin, launches in tools_cases(args, pargs, b_out):
            fb.reset_launch_counts()
            got = kernel()
            sync()
            counts = {k: v for k, v in fb.LAUNCHES.items() if v}
            want = {k: v for k, v in launches.items() if v}
            log(f"  {name} ({TPU_TOOLS[name]}): launches {counts} (expected {want})")
            if counts != want:
                fail(f"{name}: launch counters off")
            whole = sum(launches.values()) == 7
            compare(f"{name} vs twin", got, twin(), LAYER_ATOL if whole else KERNEL_ATOL,
                    LAYER_RTOL if whole else KERNEL_RTOL)
            if "padded" in name:
                moved = pargs[0].clone()
                moved[:, TOOLS_N_REAL:] = rnd(B_CHECK, TOOLS_N_PAD - TOOLS_N_REAL, DIM, scale=3.0)
                pargs_moved = (moved,) + pargs[1:]
                again = dict((c[0], c[1]) for c in tools_cases(args, pargs_moved, b_out))[name]()
                same = torch.equal(got[:, :TOOLS_N_REAL], again[:, :TOOLS_N_REAL])
                log(f"  {name}: real rows with the padded rows' inputs changed: {'bitwise unchanged' if same else 'MOVED'}")
                if not same:
                    fail(f"{name}: the padded rows reach the real rows")
        sync()

        # make_stack: one stack_layers[tools] launch, bitwise the chain
        skw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
        flat = tools_stack(rnd, max(TOOLS_STACK_GROUPS))
        x = args[0]
        worst = 0.0
        for g in TOOLS_STACK_GROUPS:
            fb.reset_launch_counts()
            got = bench_stack_fusion.make_stack(g)(x, *flat[:10 * g])
            sync()
            if {k: v for k, v in fb.LAUNCHES.items() if v} != {"stack_layers[tools]": 1}:
                fail(f"make_stack({g}): launches {({k: v for k, v in fb.LAUNCHES.items() if v})}, expected one "
                     f"stack_layers[tools]")
            chain, twin = x, x
            for i in range(g):
                w = flat[10 * i: 10 * (i + 1)]
                prev, chain = chain, tc.layer_chain(chain, *w)
                twin = tc.layer_twin(twin, *w, exp2=True)
            sync()
            same = torch.equal(got, chain)
            log(f"  make_stack({g}) = stack_layers[tools] vs the chain of {7 * g} launches: "
                f"{'bitwise' if same else 'DIFFERS, max_abs %.4e' % (got.float() - chain.float()).abs().max().item()}")
            if not same:
                fail(f"stack_layers[tools] at L={g} differs from the chain")
            step = tc.layer_twin(prev, *flat[10 * (g - 1): 10 * g], exp2=True)
            worst = max(worst, compare(f"stack_layers[tools, L={g}] vs twin step", got, step, LAYER_ATOL, LAYER_RTOL))
            compare(f"stack_layers[tools, L={g}] vs twin chain", got, twin, g * LAYER_ATOL, LAYER_RTOL,
                    g * KERNEL_REL_L2)
        errs["stack_layers[tools]"] = worst
        try:
            fb.stack_layers(x, [(flat[0], flat[0][:, 0].contiguous(), flat[1], None, *flat[2:10])], **skw,
                            epilogues="tools")
        except ValueError as e:
            log(f"  stack_layers[tools] with a b_qkv: refused ({str(e)[:60]}...)")
        else:
            fail("stack_layers[tools] took a b_qkv")

        # the epilogues against their exact references
        x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 = args
        h = fb.layernorm_rows(x, ln1s, ln1b)
        qkv = fb.gemm_bf16(h, wqkv, "qkv")
        m = fb.attention_rows(qkv, heads=HEADS, dim_head=DH, scale=DH**-0.5)
        y = fb.gemm_bf16(m, wout, "block_out", residual=x)
        h2 = fb.layernorm_rows(y, ln2s, ln2b)
        a = fb.gemm_bf16(h2, w1, "fc1_f32", bias=b1)
        sites = (("att+x", m, wout, None, x), ("fc2+b2+y", a, w2, b2, y), ("+b_out+x", m, wout, b_out, x))
        for site, inp, w, bias, res in sites:
            got = fb.gemm_bf16(inp, w, "block_out", bias=bias, residual=res)
            exact = fb.gemm_f32out(inp, w)
            if bias is not None:
                exact = exact + bias.float()
            exact = (exact + res.float()).to(torch.bfloat16)
            same = torch.equal(got, exact)
            log(f"  gemm_bf16[block_out, {site}] vs bf16(gemm_f32out + bias + residual): "
                f"{'bitwise' if same else 'DIFFERS'}")
            if not same:
                fail(f"gemm_bf16[block_out, {site}] rounds elsewhere than once")
            errs[f"gemm_bf16[block_out, {site}]"] = compare(
                f"gemm_bf16[block_out, {site}] vs twin", got,
                fb.gemm_bf16_reference(inp, w, "block_out", bias=bias, residual=res), KERNEL_ATOL, KERNEL_RTOL,
                BLOCK_OUT_REL_L2)
        gelu_in = (fb.gemm_f32out(h2, w1) + b1.float()).to(torch.bfloat16)
        exact = gelu_tanh_f32(gelu_in.float()).to(torch.bfloat16)
        share = (a != exact).float().mean().item()
        package = (fb.gemm_bf16(h2, w1, "fc1", bias=b1) != exact).float().mean().item()
        log(f"  gemm_bf16[fc1_f32] vs bf16(gelu(bf16(gemm_f32out + b1))): {share:.3e} of the elements differ "
            f"(bound {FC1_F32_MISMATCH}; the package's fc1, which rounds the dot first: {package:.3e}) "
            f"{'ok' if share <= FC1_F32_MISMATCH else 'FAILED'}")
        if not share <= FC1_F32_MISMATCH:
            fail("gemm_bf16[fc1_f32] rounds elsewhere than its reference")
        errs["gemm_bf16[fc1_f32]"] = compare("gemm_bf16[fc1_f32] vs twin", a,
                                             fb.gemm_bf16_reference(h2, w1, "fc1_f32", bias=b1), KERNEL_ATOL,
                                             KERNEL_RTOL)

        # attention_rows[n_keys] alone, and its refusals
        qkv_p = fb.gemm_bf16(fb.layernorm_rows(pargs[0], ln1s, ln1b), wqkv, "qkv")
        akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
        errs["attention_rows[n_keys]"] = compare(
            f"attention_rows[n_keys={TOOLS_N_REAL}, n={TOOLS_N_PAD}]",
            fb.attention_rows(qkv_p, **akw, n_keys=TOOLS_N_REAL),
            fb.attention_rows_reference(qkv_p, **akw, n_keys=TOOLS_N_REAL), ATTN_ATOL, ATTN_RTOL)
        for n_keys in (0, TOOLS_N_PAD + 1):
            try:
                fb.attention_rows(qkv_p, **akw, n_keys=n_keys)
            except ValueError as e:
                log(f"  attention_rows with n_keys={n_keys} at n={TOOLS_N_PAD}: refused ({str(e)[:60]}...)")
            else:
                fail(f"attention_rows took n_keys={n_keys} at n={TOOLS_N_PAD}")
        sync()
    return errs


def tools_work(name, b, n):
    """The work of one call of a counterpart at (b, n): x in, the output and
    the weights read once; the products' operations (the padded attention's
    over n rows and TOOLS_N_REAL keys)."""
    rows, inner = b * n, HEADS * DH
    attn = attention_work(b, n, HEADS)
    if "padded" in name:
        attn = work(attn["bytes"], tensor=attn["tensor"] * TOOLS_N_REAL // n, f32=attn["f32"] * TOOLS_N_REAL // n)
    # (operations, weight and vector bytes) of each half
    attn_half = ([ln_work(rows, DIM), gemm_work(rows, 3 * inner, DIM), attn, gemm_work(rows, DIM, inner)],
                 2 * (4 * inner * DIM + 2 * DIM))
    ff_half = ([ln_work(rows, DIM), gemm_work(rows, MLP, DIM), gemm_work(rows, DIM, MLP)],
               2 * (2 * DIM * MLP + MLP + 3 * DIM))
    if "_ff_" in name:
        halves = (ff_half,)
    elif name in ("_attn_block_kernel", "make_fused", "make_attn_padded"):  # make_attn_padded's FF is plain
        halves = (attn_half,)
    else:
        halves = (attn_half, ff_half)
    parts = [w for ops, _ in halves for w in ops]
    return work(2 * 2 * rows * DIM + sum(b for _, b in halves), tensor=sum(w["tensor"] for w in parts),
                f32=sum(w["f32"] for w in parts))


def time_tools(fb, dev, rnd, smi):
    """Phase 35: each tool's main() on the card at bs=128 (the main path:
    every counter zeroed just before each and read just after); then at
    bs=128 each new kernel entry against its twin in turns, its bound and its
    library call; each counterpart against its twin; the tools' layer
    against fused_transformer_layer and the g = 6 stack against its chain,
    in ms a layer.  Returns (the kernels-line timings, the main path's
    counters by tool)."""
    from vit_pytorch_tpu_torch.tools import _common as tc
    from vit_pytorch_tpu_torch.tools import bench_fused_tuning, bench_layer_fused, bench_stack_fusion
    from vit_pytorch_tpu_torch.tools import fused_block_proto

    log(f"[35 tools timing] {smi}")
    mains = {"bench_layer_fused": bench_layer_fused.main, "bench_stack_fusion": bench_stack_fusion.main,
             "fused_block_proto": fused_block_proto.main, "bench_fused_tuning": bench_fused_tuning.tune_kernel}
    counts = {}
    for tool, main_fn in mains.items():
        log(f"  -- python -m vit_pytorch_tpu_torch.tools.{tool}")
        fb.reset_launch_counts()
        results = main_fn()
        sync()
        counts[tool] = {**fb.LAUNCHES, **{f"gemm_bf16[{e}]": v for e, v in fb.GEMM_LAUNCHES.items()}}
        flat = [v for r in results.values() for v in (r if isinstance(r, tuple) else (r,)) if v is not None]
        if not flat or not all(np.isfinite(flat)):
            fail(f"{tool}.main(): results {results}")
        log(f"  {tool}: launches {({k: v for k, v in counts[tool].items() if v})}")

    per_kernel = {}
    with torch.inference_mode():
        args, b_out = tools_args(rnd, B_TIME, N)
        pargs = (rnd(B_TIME, TOOLS_N_PAD, DIM),) + args[1:]
        x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 = args
        rows, inner = B_TIME * N, HEADS * DH
        h = fb.layernorm_rows(x, ln1s, ln1b)
        m = fb.attention_rows(fb.gemm_bf16(h, wqkv, "qkv"), heads=HEADS, dim_head=DH, scale=DH**-0.5)
        y = fb.gemm_bf16(m, wout, "block_out", residual=x)
        h2 = fb.layernorm_rows(y, ln2s, ln2b)
        a = fb.gemm_bf16(h2, w1, "fc1_f32", bias=b1)
        qkv_p = fb.gemm_bf16(fb.layernorm_rows(pargs[0], ln1s, ln1b), wqkv, "qkv")
        akw = dict(heads=HEADS, dim_head=DH, scale=DH**-0.5)
        mask = (torch.arange(TOOLS_N_PAD, device=dev) < TOOLS_N_REAL).expand(TOOLS_N_PAD, TOOLS_N_PAD)
        attn_p = attention_work(B_TIME, TOOLS_N_PAD, HEADS)
        entries = (  # (entry, kernel call, twin call, work, the one torch call computing the same, or None)
            ("gemm_bf16[fc1_f32]", lambda: fb.gemm_bf16(h2, w1, "fc1_f32", bias=b1),
             lambda: fb.gemm_bf16_reference(h2, w1, "fc1_f32", bias=b1), gemm_work(rows, MLP, DIM, bias=True), None),
            ("attention_rows[n_keys]", lambda: fb.attention_rows(qkv_p, **akw, n_keys=TOOLS_N_REAL),
             lambda: fb.attention_rows_reference(qkv_p, **akw, n_keys=TOOLS_N_REAL),
             work(attn_p["bytes"], tensor=attn_p["tensor"] * TOOLS_N_REAL // TOOLS_N_PAD,
                  f32=attn_p["f32"] * TOOLS_N_REAL // TOOLS_N_PAD),
             lambda: sdpa_ms(qkv_p, HEADS, 20, attn_mask=mask)),
            ("gemm_bf16[block_out, att+x]", lambda: fb.gemm_bf16(m, wout, "block_out", residual=x),
             lambda: fb.gemm_bf16_reference(m, wout, "block_out", residual=x),
             gemm_work(rows, DIM, inner, residual=True),
             lambda: cuda_ms(lambda: torch.addmm(x.view(rows, DIM), m.view(rows, inner), wout.t()), 20)),
            ("gemm_bf16[block_out, fc2+b2+y]", lambda: fb.gemm_bf16(a, w2, "block_out", bias=b2, residual=y),
             lambda: fb.gemm_bf16_reference(a, w2, "block_out", bias=b2, residual=y),
             gemm_work(rows, DIM, MLP, bias=True, residual=True), None),
            ("gemm_bf16[block_out, +b_out+x]", lambda: fb.gemm_bf16(m, wout, "block_out", bias=b_out, residual=x),
             lambda: fb.gemm_bf16_reference(m, wout, "block_out", bias=b_out, residual=x),
             gemm_work(rows, DIM, inner, bias=True, residual=True), None),
        )
        for name, kern, plain, w, library in entries:
            km, pm = in_turns(kern, plain, 20)
            lib_ms = library() if library else None
            prod = linear_ms(h2, w1) if name == "gemm_bf16[fc1_f32]" else None
            record(per_kernel, name, km, pm, w, lib_ms, product_ms=prod)
            bound, by = bound_ms(w)
            prod_note = "" if prod is None else f", product-only yardstick (F.linear, no epilogue) {prod:.4f} ms"
            log(f"  {name}: kernel {km:.4f} ms, twin {pm:.4f} ms, bound {bound:.4f} ms ({by}), library "
                f"{'none' if lib_ms is None else '%.4f ms' % lib_ms}{prod_note}")

        # the ten counterparts against their twins, and the layers against their neighbours
        for name, kern, plain, launches in tools_cases(args, pargs, b_out):
            km, pm = in_turns(kern, plain, 5)
            bound, by = bound_ms(tools_work(name, B_TIME, TOOLS_N_PAD if "padded" in name else N))
            log(f"  row {name} ({TPU_TOOLS[name]}): {sum(launches.values())} launches {km:.4f} ms, twin {pm:.4f} ms, "
                f"bound {bound:.4f} ms ({by}), library none")
        layer_kw = dict(heads=HEADS, dim_head=DH)
        tk, pk = in_turns(lambda: bench_layer_fused.make_whole_resident(2)(*args),
                          lambda: fb.fused_transformer_layer(x, wqkv, wout, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2,
                                                             **layer_kw), 20)
        log(f"  the tools' layer {tk:.4f} ms a layer, fused_transformer_layer (the package's rounding) {pk:.4f} ms "
            f"(turns: package, tools, tools, package)")
        g = max(TOOLS_STACK_GROUPS)
        flat = tools_stack(rnd, g)
        stack = lambda: bench_stack_fusion.make_stack(g)(x, *flat)

        def chain():
            out = x
            for i in range(g):
                out = tc.layer_chain(out, *flat[10 * i: 10 * (i + 1)])
            return out

        def twin():
            out = x
            for i in range(g):
                out = tc.layer_twin(out, *flat[10 * i: 10 * (i + 1)], exp2=True)
            return out

        km, cm = in_turns(stack, chain, 10)
        pm = cuda_ms(twin, 3)
        w = stack_work(B_TIME, N, g)
        bound, by = bound_ms(w)
        log(f"  make_stack({g}) = stack_layers[tools]: {km:.4f} ms ({km / g:.4f} a layer), its chain of {7 * g} "
            f"launches {cm:.4f} ms ({cm / g:.4f} a layer), twin {pm:.4f} ms, bound {bound:.4f} ms ({bound / g:.4f} "
            f"a layer, {by}); library none (the chain stands beside it)")
        record(per_kernel, "stack_layers[tools]", km, pm, w)
    sync()
    return per_kernel, counts


def ptxas_report(build_log):
    """One line a kernel from nvcc's ptxas report: the kernel's name with
    its template arguments (flash kernels: <kDropout, kQkNorm>, flash_fwd
    <kDropout, kQkNorm, kBias>, short_attention <kBias>), its
    registers and its spill stores and loads.  An empty report (a reused
    build) gives no line."""
    lines, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            tail = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)$", mangled)
            if tail:
                n = int(tail.group(1))
                base, args = tail.group(2)[:n], tail.group(2)[n:]
                flags = re.findall(r"L[bi](\d+)E", args.split("EEv")[0]) if args.startswith("I") else []
                name = base + (f"<{', '.join(flags)}>" if flags else "")
            else:
                name = mangled
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{name}: {regs} registers; {spill}")
            name = None
    return lines


def host_ms(fn, iters=10):
    """Host ms of fn (after one warm-up call), bracketed by synchronize()."""
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t) * 1e3 / iters


def main():
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a CUDA card")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    log(smi)
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        log(f"  ({name}: {time.perf_counter() - t_phase:.2f} s)")
        t_phase = time.perf_counter()

    # plain twins are held to f32 accumulation: no TF32, no reduced-precision
    # bf16 reductions in cuBLAS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # -- 2. build ----------------------------------------------------------
    from vit_pytorch_tpu_torch import ViT
    from vit_pytorch_tpu_torch.ops import fused_block as fb
    from vit_pytorch_tpu_torch.ops._build import load_library
    from vit_pytorch_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    lib = load_library()
    nvcc = "reused an existing build" if lib.build_seconds is None else f"nvcc {lib.build_seconds:.2f} s"
    log(f"[2 build] {lib.path.name}: {nvcc}, build+load {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(lib.build_log):
        log(f"  {line}")
    phase_done("phase 2")

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # -- 3. kernels against their plain twins --------------------------------
    errs = check_kernels(fb, rnd)
    phase_done("phase 3")

    # -- 4. serving ----------------------------------------------------------
    log(f"[4 serving] ViT-B/16 @224, depth {DEPTH}, random weights (seed {SEED}), buckets {BUCKETS}, bf16")
    model = ViT(image_size=224, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS,
                mlp_dim=MLP, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).eval()
    t0 = time.perf_counter()
    pred = Predictor(model, example_shape=(3, 224, 224), batch_sizes=BUCKETS, device=dev).warmup()
    log(f"  warmup of {len(BUCKETS)} buckets: {time.perf_counter() - t0:.2f} s")
    for b in BUCKETS:
        if not fb.whole_layer_supported((b, N, DIM), bf16, HEADS, DH, DIM, MLP):
            fail(f"the kernel gate refuses the flagship at bucket {b}")
    images = {k: rnd(k, 3, 224, 224, dtype=torch.float32) for k in REQUESTS}
    runs = sum(-(-k // BUCKETS[-1]) for k in REQUESTS)  # chunks of the largest bucket
    fb.reset_launch_counts()
    outs = {k: pred(images[k]) for k in REQUESTS}
    sync()
    counts = dict(fb.LAUNCHES)
    gemm_counts = {f"gemm_bf16[{site}]": v for site, v in fb.GEMM_LAUNCHES.items()}
    for k, out in outs.items():
        if out.shape != (k, 1000) or not bool(torch.isfinite(out).all()):
            fail(f"request of {k} images: shape {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    want_counts = {name: DEPTH * LAUNCHES_PER_LAYER.get(name, 0) * runs for name in fb.LAUNCHES}  # no backward
    want_gemm = {f"gemm_bf16[{site}]": DEPTH * runs * (site in GEMM_SITES) for site in fb.GEMM_LAUNCHES}
    log(f"  requests {REQUESTS} -> {runs} bucket runs; launches {counts} (expected {want_counts}, "
        f"{DEPTH} layers x 7 launches x {runs} runs = {DEPTH * 7 * runs}); gemm_bf16 by site {gemm_counts}")
    if counts != want_counts or gemm_counts != want_gemm:
        fail("the serving path did not launch every kernel of every layer")

    served = pred.model
    tr = served.transformer

    def plain_forward(img):
        """The same bf16 weights through the plain twins, layer by layer."""
        x = served.embed(img.to(bf16))
        for i in range(len(tr.layers)):
            ws, kws = tr.layer_weights(i, bf16)
            x = fb.layer_reference(x, *ws, heads=tr.heads, dim_head=tr.dim_head, **kws)
        return served.mlp_head(tr.norm(x)[:, 0])

    with torch.inference_mode():
        k = 32
        plain = plain_forward(images[k])
        fp32 = model(images[k])
    e_plain, e_fp32 = rel_l2(outs[k], plain), rel_l2(outs[k], fp32)
    log(f"  logits of the {k}-image request: rel L2 vs plain bf16 {e_plain:.4e} (bound {LOGITS_VS_PLAIN_BF16}), "
        f"vs fp32 {e_fp32:.4e} (bound {LOGITS_VS_FP32})")
    if not (e_plain <= LOGITS_VS_PLAIN_BF16 and e_fp32 <= LOGITS_VS_FP32):
        fail("served logits disagree with the plain path")
    sync()
    phase_done("phase 4")

    # -- 5. timing -----------------------------------------------------------
    log(f"[5 timing] bs={B_TIME}, {smi}")
    img = images[130][:B_TIME].to(bf16)
    with torch.inference_mode():
        run_kernel, run_plain = (lambda: served(img)), (lambda: plain_forward(img))
        p1, k1, k2, p2 = (host_ms(f) for f in (run_plain, run_kernel, run_kernel, run_plain))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"  model: kernel path {B_TIME * 1e3 / k_ms:.1f} img/s ({k_ms:.3f} ms/batch), "
            f"plain bf16 path {B_TIME * 1e3 / p_ms:.1f} img/s ({p_ms:.3f} ms/batch); turns ms "
            f"plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}")

        x = served.embed(img)
        ws, kws = tr.layer_weights(0, bf16)
        lkw = dict(heads=HEADS, dim_head=DH, **kws)
        lk, lp = in_turns(lambda: fb.fused_transformer_layer(x, *ws, **lkw),
                          lambda: fb.layer_reference(x, *ws, **lkw), 20)
        log(f"  one layer: kernels {lk:.4f} ms, plain {lp:.4f} ms")

        w_qkv, w_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 = ws
        h = fb.layernorm_rows(x, ln1s, ln1b)
        qkv = fb.gemm_bf16(h, w_qkv, "qkv")
        m = fb.attention_rows(qkv, heads=HEADS, dim_head=DH, scale=DH**-0.5)
        y = fb.gemm_bf16(m, w_out, "out", bias=kws["b_out"], residual=x)
        h2 = fb.layernorm_rows(y, ln2s, ln2b)
        a = fb.gemm_bf16(h2, w1, "fc1", bias=b1)
        launches = (  # (kernel, site, kernel call, plain call) in layer order
            ("layernorm_rows", "ln1", lambda: fb.layernorm_rows(x, ln1s, ln1b),
             lambda: fb.layernorm_rows_reference(x, ln1s, ln1b)),
            ("gemm_bf16", "qkv", lambda: fb.gemm_bf16(h, w_qkv, "qkv"),
             lambda: fb.gemm_bf16_reference(h, w_qkv, "qkv")),
            ("attention_rows", "attention", lambda: fb.attention_rows(qkv, heads=HEADS, dim_head=DH, scale=DH**-0.5),
             lambda: fb.attention_rows_reference(qkv, heads=HEADS, dim_head=DH, scale=DH**-0.5)),
            ("gemm_bf16", "out", lambda: fb.gemm_bf16(m, w_out, "out", bias=kws["b_out"], residual=x),
             lambda: fb.gemm_bf16_reference(m, w_out, "out", bias=kws["b_out"], residual=x)),
            ("layernorm_rows", "ln2", lambda: fb.layernorm_rows(y, ln2s, ln2b),
             lambda: fb.layernorm_rows_reference(y, ln2s, ln2b)),
            ("gemm_bf16", "fc1", lambda: fb.gemm_bf16(h2, w1, "fc1", bias=b1),
             lambda: fb.gemm_bf16_reference(h2, w1, "fc1", bias=b1)),
            ("gemm_bf16", "fc2", lambda: fb.gemm_bf16(a, w2, "fc2", bias=b2, residual=y),
             lambda: fb.gemm_bf16_reference(a, w2, "fc2", bias=b2, residual=y)),
        )
        rows, inner = B_TIME * N, HEADS * DH
        layer_norm_ms = lambda t, w, b: cuda_ms(lambda: torch.nn.functional.layer_norm(t, (DIM,), w, b, 1e-5), 20)
        works = {  # each site's work and the one PyTorch call that computes the same function, where there is one
            # (out and fc2 round after the product, the bias and the residual; fc1 adds the tanh GELU)
            "ln1": (ln_work(rows, DIM), layer_norm_ms(x, ln1s, ln1b)),
            "qkv": (gemm_work(rows, 3 * inner, DIM), cuda_ms(lambda: torch.nn.functional.linear(h, w_qkv), 20)),
            "attention": (attention_work(B_TIME, N, HEADS), sdpa_ms(qkv, HEADS, 20)),
            "out": (gemm_work(rows, DIM, inner, bias=True, residual=True), None),
            "ln2": (ln_work(rows, DIM), layer_norm_ms(y, ln2s, ln2b)),
            "fc1": (gemm_work(rows, MLP, DIM, bias=True), None),
            "fc2": (gemm_work(rows, DIM, MLP, bias=True, residual=True), None),
        }
        products = {"out": (m, w_out), "fc1": (h2, w1), "fc2": (a, w2)}  # the sites without a library call
        per_kernel = {}
        for name, site, kern, plain in launches:
            km, pm = in_turns(kern, plain, 20)
            prod = linear_ms(*products[site]) if site in products else None
            record(per_kernel, f"gemm_bf16[{site}]" if name == "gemm_bf16" else name, km, pm, *works[site],
                   product_ms=prod)
            lib_note = "" if works[site][1] is None else f", library call {works[site][1]:.4f} ms"
            prod_note = "" if prod is None else f", product-only yardstick (F.linear, no epilogue) {prod:.4f} ms"
            log(f"  {name}[{site}]: kernel {km:.4f} ms, plain {pm:.4f} ms{lib_note}{prod_note}")
    sync()
    del pred, served, tr, model, outs, images
    phase_done("phase 5")

    # -- 6. backward kernels against their plain twins ------------------------
    errs.update(check_backward(fb, rnd))
    phase_done("phase 6")

    # -- 7. training -----------------------------------------------------------
    train_counts = check_training(fb, dev, gen)
    phase_done("phase 7")

    # -- 8. training timing ----------------------------------------------------
    per_kernel.update(time_training(fb, dev, gen, smi))
    phase_done("phase 8")

    # -- 9. dropout kernels against their plain twins --------------------------
    dropout_errs, mask_launches = check_dropout(fb, rnd, dev)
    errs.update(dropout_errs)
    if not mask_launches:
        fail("phase 9 did not launch the dropout_masks kernel")
    phase_done("phase 9")

    # -- 10. training with dropout ---------------------------------------------
    dropout_counts = check_dropout_training(fb, dev, gen)
    phase_done("phase 10")

    # -- 11. dropout training timing --------------------------------------------
    per_kernel.update(time_dropout_training(fb, dev, gen, smi))
    phase_done("phase 11")

    # -- 12. flash kernels against their plain twins ---------------------------
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    errs.update(check_flash(fa, dev, gen))
    phase_done("phase 12")

    # -- 13. NaViT-B serving -------------------------------------------------------
    navit_serving_counts = check_navit_serving(fb, fa, dev)
    phase_done("phase 13")

    # -- 14. NaViT-B training ------------------------------------------------------
    navit_train_counts = check_navit_training(fb, fa, dev)
    phase_done("phase 14")

    # -- 15. NaViT timing ----------------------------------------------------------
    per_kernel.update(time_navit(fb, fa, dev, gen, smi))
    phase_done("phase 15")

    # -- 16. qk-norm kernels against their plain twins ---------------------------
    errs.update(check_qknorm(fb, rnd, dev))
    for name, e in check_simple_attention(fb, rnd).items():
        errs[name] = max(errs.get(name, 0.0), e)
    phase_done("phase 16")

    # -- 17. SimpleViT serving -----------------------------------------------------
    simple_serving_counts, qk_serving_counts = check_simple_serving(fb, dev, rnd)
    phase_done("phase 17")

    # -- 18. SimpleViT training ----------------------------------------------------
    simple_train_counts, qk_train_counts = check_simple_training(fb, dev, gen)
    phase_done("phase 18")

    # -- 19. SimpleViT timing ------------------------------------------------------
    simple_times, simple_errs = time_simple(fb, dev, gen, smi)
    per_kernel.update(simple_times)
    errs.update(simple_errs)
    phase_done("phase 19")

    # -- 20. the opt-in backwards' kernels against their plain twins ------------
    errs.update(check_ff_kernels(fb, rnd))
    phase_done("phase 20")

    # -- 21. ViT-B/16 training under each opt-in backward ------------------------
    ff_counts = train_ff_modes(fb, dev, gen)
    per_kernel.update(time_ff_modes(fb, dev, gen, smi))
    phase_done("phase 21")

    # -- 22. flash dropout kernels against their plain twins --------------------
    flash_dropout_errs, flash_mask_launches = check_flash_dropout(fa, fb, dev, gen)
    errs.update(flash_dropout_errs)
    phase_done("phase 22")

    # -- 23. NaViT-B training with dropout ----------------------------------------
    navit_dropout_counts = check_navit_dropout_training(fb, fa, dev)
    phase_done("phase 23")

    # -- 24. NaViT dropout timing ---------------------------------------------------
    per_kernel.update(time_navit_dropout(fb, fa, dev, gen, smi))
    phase_done("phase 24")

    # -- 25. flash qk-norm kernels against their plain twins --------------------
    errs.update(check_flash_qknorm(fa, dev, gen))
    phase_done("phase 25")

    # -- 26. NaViT-B under VIT_TPU_FUSE_QKNORM=1, and the 3-D NaViT ----------------
    navit_qk_counts = check_navit_qknorm(fb, fa, dev)
    phase_done("phase 26")

    # -- 27. NaViT qk-norm timing -----------------------------------------------------
    per_kernel.update(time_navit_qknorm(fa, dev, gen, smi))
    phase_done("phase 27")

    # -- 28. the short kernel, flash causal and bias against their twins ---------------
    for name, e in check_short_causal_bias(fa, dev, gen).items():  # phase 12 holds causal cases too
        errs[name] = max(errs.get(name, 0.0), e)
    phase_done("phase 28")

    # -- 29. SimpleViT @512 on the short kernel; the dispatcher on the card ------------
    simple_512_counts = check_simple_512(fb, fa, dev, rnd, gen)
    ops_counts = check_dispatch_on_card(fb, fa, dev, gen)
    phase_done("phase 29")

    # -- 30. their timing ------------------------------------------------------------
    per_kernel.update(time_short_causal_bias(fa, dev, gen, smi))
    phase_done("phase 30")

    # -- 31. stack_layers against the chain and its twin ------------------------------
    errs.update(check_stack(fb, rnd, dev))
    phase_done("phase 31")

    # -- 32. ViT-B/16 served and trained under VIT_TPU_STACK_LAYERS --------------------
    stack_counts, stack_pred, stack_images = serve_stack(fb, dev, rnd, smi)
    phase_done("phase 32")

    # -- 33. its timing -----------------------------------------------------------------
    per_kernel.update(time_stack(fb, dev, rnd, smi, stack_pred, stack_images))
    del stack_pred, stack_images
    phase_done("phase 33")

    # -- 34. the tools/ prototypes' counterparts against their twins --------------------
    errs.update(check_tools(fb, rnd, dev))
    phase_done("phase 34")

    # -- 35. the port's bench tools on the card: their main(), each new launch -----------
    tools_times, tools_counts = time_tools(fb, dev, rnd, smi)
    per_kernel.update(tools_times)
    phase_done("phase 35")

    # forward kernels: the serving path's launches (phase 4); backward kernels:
    # the training path's (phase 7); the dropout variants: the dropout
    # training path's (phase 10); the mask replay: phase 9's checks; the
    # qk-norm variants: SimpleViT-qk-norm's serving requests and training
    # steps (phases 17 and 18)
    def entry(name, source, replaces, path, launches):
        t = per_kernel[name]
        bound, by = bound_ms(t["work"])
        if source == SOURCE and name.startswith("gemm_"):
            source = GEMM_SOURCE
        elif source == SOURCE and name.startswith("attention_rows"):
            source = ATTN_SOURCE
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "path": path,
                "launches": launches, "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": bound, "bound_by": by, "library_ms": t["library_ms"],
                "product_only_ms": t.get("product_only_ms"), "product_only_of": t.get("product_only_of")}

    dropout_kernels = (
        ("attention_rows[dropout]", SOURCE, TPU_BLOCK_KERNEL), ("gemm_bf16[block_out]", SOURCE, TPU_BLOCK_KERNEL),
        ("dropout_apply", DROPOUT_SOURCE, TPU_BWD_KERNEL), ("attention_bwd_rows[dropout]", ATTN_BWD_SOURCE, TPU_BWD_KERNEL),
    )
    kernels = (
        [entry(name, SOURCE, TPU_KERNEL, "serving", {**counts, **gemm_counts}[name])
         for name in ("layernorm_rows", *(f"gemm_bf16[{site}]" for site in GEMM_SITES), "attention_rows")]
        + [entry(name, {"gemm_f32out": SOURCE, "attention_bwd_rows": ATTN_BWD_SOURCE}.get(name, BWD_SOURCE),
                 TPU_BWD_KERNEL, "training", train_counts[name])
           for name in ("attention_bwd_rows", "gemm_f32out", "layernorm_bwd_rows")]
        + [entry(name, source, replaces, "dropout training", dropout_counts[name])
           for name, source, replaces in dropout_kernels]
        + [entry(name, FLASH_SOURCE, TPU_FLASH[name], "NaViT serving" if name == "flash_fwd" else "NaViT training",
                 (navit_serving_counts if name == "flash_fwd" else navit_train_counts)[name]) for name in TPU_FLASH]
        + [entry("dropout_masks", DROPOUT_SOURCE, TPU_MASKS_KERNEL, "mask replay", mask_launches)]
        + [entry(name, source, replaces, "SimpleViT-qk-norm serving" if "bwd" not in name
                 else "SimpleViT-qk-norm training", (qk_train_counts if "bwd" in name else qk_serving_counts)[name])
           for name, (source, replaces) in TPU_QK_KERNELS.items()]
        + [entry("attention_rows[config 2]", SOURCE, TPU_KERNEL, "SimpleViT serving",
                 simple_serving_counts["attention_rows"]),
           entry("attention_bwd_rows[config 2]", ATTN_BWD_SOURCE, TPU_BWD_KERNEL, "SimpleViT training",
                 simple_train_counts["attention_bwd_rows"]),
           entry("gemm_bf16[block_out, +x]", SOURCE, TPU_BLOCK_KERNEL, "SimpleViT serving",
                 simple_serving_counts["gemm_bf16[block_out]"]),
           entry("gemm_bf16[block_out, bare]", SOURCE, TPU_BLOCK_KERNEL, "SimpleViT-qk-norm serving",
                 qk_serving_counts["gemm_bf16[block_out]"])]
        + [entry(name, source, replaces, "ViT-B/16 training under VIT_TPU_FF_BWD=full|hybrid and "
                 "VIT_TPU_ENABLE_WHOLE_LAYER_BWD=1", ff_counts[name]) for name, (source, replaces) in FF_KERNELS.items()]
        + [entry(name, FLASH_SOURCE, TPU_FLASH_DROPOUT[name], "NaViT training at dropout 0.1",
                 navit_dropout_counts[name]) for name in FLASH_DROPOUT]
        + [entry("flash_dropout_masks", DROPOUT_SOURCE, TPU_FLASH_DROPOUT["flash_dropout_masks"], "flash mask replay",
                 flash_mask_launches)]
        + [entry(name, FLASH_SOURCE, TPU_FLASH_QK[name], "NaViT serving under VIT_TPU_FUSE_QKNORM=1"
                 if name == "flash_fwd[qknorm]" else "NaViT training under VIT_TPU_FUSE_QKNORM=1",
                 (navit_qk_counts["serving"] if name == "flash_fwd[qknorm]" else
                  navit_qk_counts[RATE if "dropout" in name else 0.0])[name]) for name in TPU_FLASH_QK]
        + [entry(name, SHORT_SOURCE if name in SHORT_KERNELS else FLASH_SOURCE, replaces,
                 "SimpleViT-B/16 @512 serving" if name == "short_attention" else
                 "dot_product_attention at m >= 1024 (causal, a bias), forward and backward",
                 (simple_512_counts if name == "short_attention" else ops_counts)[name])
           for name, replaces in TPU_NEW.items()]
        + [entry("stack_layers", STACK_SOURCE, TPU_STACK, "ViT-B/16 serving under VIT_TPU_STACK_LAYERS=6",
                 stack_counts["stack_layers"])]
        + [entry(name, source, TPU_TOOLS[tpu], f"python -m vit_pytorch_tpu_torch.tools.{tool}",
                 tools_counts[tool][counter])
           for name, source, tpu, tool, counter in TOOLS_ENTRIES]
    )
    for k in kernels:
        if not k["launches"]:
            fail(f"{k['name']} was not launched on its path ({k['path']})")
    log("  (ms, plain_ms: the kernel's launches in one layer at bs=128, forward or backward, the flash kernels' "
        "at NaViT-B's packed shape, the qk-norm variants' and block_out bare at SimpleViT-qk-norm's bs=128, "
        "block_out +x at SimpleViT config 2's bs=256; gemm_bf16 one entry a site; bound_ms: the larger of "
        "their bytes over 3.35 TB/s and their operations over 989 TFLOP/s bf16 tensor / 67 T/s CUDA-core peaks; "
        "library_ms: the one torch call computing the same function, where there is one; product_only_ms: at a "
        "gemm_bf16 site that no one torch call computes (out, fc1, fc2, gemm_f32out, fc1_save, gelu_bwd, fc1_f32), "
        "the bare product through F.linear at its (M, N, K), a yardstick of the product alone; at attention_bwd_rows "
        "and its variants, scaled_dot_product_attention's forward and backward to q, k, v (torch.autograd.grad) on "
        "the same q, k, v and dm, dropout_p=0.1 beside [dropout], without the qk-norm beside [qknorm], a yardstick "
        "computing the same products (no one torch call gives m and dqkv); product_only_of names it where it is "
        "not F.linear; null elsewhere; "
        "attention_rows[config 2]: attention_rows at SimpleViT config 2's b=256 n=64 16 heads, launches from its "
        "serving requests; attention_bwd_rows[config 2]: attention_bwd_rows at the same shape, launches from "
        "SimpleViT config 2's 4 training steps; launches: the serving "
        "requests for the forward kernels, the training steps for the backward kernels, the dropout training steps "
        "for the dropout variants, phase 9's mask checks for dropout_masks, NaViT-B's serving forward for "
        "flash_fwd and its 4 training steps for the flash backward, SimpleViT-qk-norm's requests and 4 training "
        "steps for the qk-norm variants, each SimpleViT's requests for its block_out site, the three opt-in "
        "backwards' 4 training steps each for their kernels, NaViT-B's 4 training steps at dropout 0.1 for the "
        "flash [dropout] kernels, phase 22's checks for flash_dropout_masks; gemm_wgrad's times are one layer's "
        "four sites at bs=128, its library call torch.matmul(a.t(), b) at each; the flash [dropout] kernels' at "
        "NaViT-B's packed training shape, flash_fwd[dropout]'s library call SDPA with dropout_p=0.1 under the "
        "block-diagonal mask; flash_dropout_masks' at (2, 12, 2048, 2048); the flash [qknorm] and "
        "[dropout,qknorm] kernels' at NaViT-B's packed training shape, launches from NaViT-B under "
        "VIT_TPU_FUSE_QKNORM=1: its serving forward for flash_fwd[qknorm], its 4 training steps at dropout 0 for "
        "the backward [qknorm] kernels, its 2 at dropout 0.1 for the [dropout,qknorm] kernels; short_attention "
        "and [bias] at SimpleViT-B/16 @512's shape (32 x 12 x 1024), launches from its served requests and, for "
        "[bias], from dot_product_attention with a per-head bias at m = 1024; the flash [causal] and [bias] variants "
        "at 8 x 12 x 2048, launches from dot_product_attention's causal and bias calls at m = 2048, forward and "
        "backward; library_ms SDPA with is_causal, dropout_p or the bias as a float attn_mask; stack_layers: one "
        "g = 6 launch at bs=128, its twin the 6-layer chain of twins, bound the 6 layers' operations (x, the output "
        "and the weights as bytes), launches from ViT-B/16's bucket runs under VIT_TPU_STACK_LAYERS=6; the tools' "
        "entries at bs=128 (n = 197; attention_rows[n_keys] at n = 200, 197 keys; stack_layers[tools] one L = 6 "
        "launch), launches from the main() of the tool named in the entry's path, library_ms SDPA with the key "
        "mask and torch.addmm beside att+x)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
