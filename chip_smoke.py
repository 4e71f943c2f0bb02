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
 11. dropout training timing at bs=1024: ms/step kernel vs plain (plain
     one step a turn, after one kernel step has made the optimizer's
     state), peak device memory, and each launch of one attention block's
     forward and backward at bs=128;
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
     (plain one step a turn, after one kernel step) and against dropout 0
     in turns; each [dropout]
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
     check again over 5 fresh draws at rate
     0 and 5 at rate 0.1, for the kernels and for the Function on its plain
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
     layer;
 36. the whole-layer chain at heads x dim_head != dim and at 9 to 65
     tokens: every kernel of the layer, forward and backward, against its
     twin (phases 3's and 6's bounds) and the layer's output and 12
     gradients, at ViViT's spatial (b=128, n=65) and temporal (16, 9)
     shapes and MAE's encoder (256, 16), all dim 1024 with 8 heads (inner
     512), MAE's decoder (256, 64, dim 512) and config 1 (8, 65, dim 1024,
     16 heads); attention_rows, gemm_bf16[block_out] and
     attention_bwd_rows at ViViT's factorized self-attention calls (128 x
     65 and 1,040 x 8); stack_layers (g = 6 at ViViT's spatial shape)
     bitwise its chain of 42 launches, and its gate admitting the group;
     two mutants of a chain that assumed inner == dim (gemm_bf16[out] at K
     = dim, attention_rows at row stride 3 dim), each refused;
 37. ViViT (tools/bench_zoo.py:232-234: 128 x 128, 16 frames, frame patch
     2, dim 1024, 6 + 6 layers, 8 heads, mlp 2048) behind buckets (1, 8,
     16): exact counters (12 whole layers a forward), logits against plain
     bf16 and fp32; a frame mask (the temporal layers on the composite: 6
     whole layers); the factorized self-attention (24 attention blocks a
     forward); 2 training steps at bs=16 through make_train_step (exact
     counters, first-step loss and gradients against plain bf16 and fp32);
 38. MAE (tools/bench_zoo.py:250-253: encoder ViT 256/32, dim 1024, depth
     6, heads 8; decoder_dim 512, depth 6; masking 0.75) at bs=256 with a
     fixed permutation: 6 whole layers at (256, 16, 1024) and 6 at (256,
     64, 512), exact counters, loss and gradients against plain bf16 and
     fp32; 3 AdamW(1e-4) steps with permutations from a generator;
 39. MaxViT (tools/bench_zoo.py:219-221: stem 64, dim 96, dim_head 32,
     depth (2, 2, 5, 2), window 7, 224 x 224) behind buckets (1, 8, 32,
     128) with bf16 BatchNorm statistics: no launch, logits against fp32;
     one train-mode forward and backward at dropout 0, bs=32, the updated
     statistics and the gradients against fp32; MaxViT with registers
     served the same way; config 1 (the README's ViT: 256/32, dim 1024,
     depth 6, heads 16, mlp 2048) behind the buckets: exact counters,
     logits against plain bf16 and fp32;
 40. their timing: MaxViT img/s at bs=128; config 1 img/s at bs=128 and
     ViViT videos/s at bs=16, kernel against plain in turns; ViViT ms/step
     at bs=16 and MAE ms/step at bs=256 with peak memory, kernel against
     plain in turns; each chain kernel at ViViT's spatial and MAE's
     encoder shapes against its twin, its bound and its library call,
     each an entry of its own in the kernels line;
 41. Dino (the upstream README's example: the net ViT 256/32, dim 1024,
     depth 6, heads 8, mlp 2048; hidden_layer "transformer", projector 4
     layers of 256 to K = 65,336, student 0.9 / teacher 0.04, decays 0.9)
     at bs=20: the chain's kernels at its (20, 65) shape against their
     twins; one step on views that byol_augment and random_resized_crop
     draw on the card from a CPU generator (exact counters: the student's
     two calls with gradients, 2 x 6 x 13 launches, and the teacher's two
     without, 2 x 6 x 7; the captured hidden (20, 66560)), the loss, the
     new last centres and every student gradient against the plain bf16
     path and against fp32 within 1.5x of plain bf16's own distance from
     it; then 3 Adam(3e-4) steps, the EMA after each bitwise its formula
     and the teacher apart from the student;
 42. EsViT and LeJEPA (sigreg_num_slices 1024) on the same net and batch:
     one step each against plain bf16 (EsViT: only where no region
     pairing flips between the paths; the flips logged) and the fp32
     floor, exact counters (LeJEPA: one call of 40 images with gradients,
     one without), then 2 Adam steps with finite losses;
 43. SimMIM (masking 0.5) and MPP (patch 32, mask 0.15, replace 0.5,
     random patch 0.5) on the same ViT at bs=20: one step each at dropout 0
     against plain bf16, exact counters; MPP trained 2 steps at dropout
     and emb_dropout 0.1 on the attention-block kernels (exact counters);
     MP3 (its own ViT at the same widths, masking 0.75) against fp32, with
     no launch at all (its cross-attention takes the composite);
 44. their timing: each trainer's ms/step (host clock, 2 steps after a
     warm-up, kernel and plain paths in turns), peak memory, the device's
     busy share of one profiled Dino step, and each chain kernel at Dino's
     (20, 65) shape against its twin, its bound and its library call, an
     entry of its own in the kernels line.
 45. the attention kernels at the VLA cross-attention shapes (8 heads of 64,
     no ids): flash_fwd (o, lse), flash_bwd_dq and flash_bwd_dkv (twice,
     bitwise) against their twins at (b, n, m) = (8, 54, 1536), (4, 13,
     1576) and (8, 56, 1536), short_attention at (8, 54, 1024) and (4, 13,
     1024), each Function against autograd through the f32 composite; no
     flash_fwd launch writes an o row or an lse value past n (the padded
     rows of its last query tile; a NaN slack around caller-given buffers),
     and a mutant that drops the lse store's row guard (built in a thread
     from phase 2 on) is refused; the dispatcher at 1,023, 1,024 and 1,025
     keys takes the composite, the short kernel and the flash kernels, one
     launch each;
 46. SigLIPVAT at the reference's defaults (pi0's action head: dim 512, depth
     27, 8 heads of 64, mlp 2048, 50 actions of 32; SigLIP so400m/14 @224:
     1152, depth 27, 16 heads, mlp 4304) at (3, 2) views x frames behind a
     Predictor with buckets (1, 8): exact counters (27 flash_fwd a bucket
     run), pred_action against the plain bf16 path and fp32 on the noise
     floor of phase 13, a depth-2 full-width copy against fixed bounds; (2,
     2) on the short kernel (27 launches), (3, 1) on the composite (none);
     the first training step's loss and gradients against plain bf16 and
     the fp32 floor (fp32 at full depth), 3 AdamW(1e-4) steps (27 of each
     flash kernel a step), a step with freeze_vit (the tower no gradient,
     the counters unchanged), and load_siglip on an HF dict of the tower,
     the loaded tower's tokens bitwise the module's;
 47. VAT_B (the VAT ViT at ViT-B/16 widths, VAT dim 512, depth 12, 2 views
     x 4 frames, 4 tasks, 2 advantage bins, a 32-dim extra token: 13
     queries against 1,576 keys) and VAAT_B (an AST of ViT-B widths on 1 s
     of 16 kHz audio besides) at bs=4: served (12 flash_fwd) against plain
     bf16 and fp32 on the noise floor, 2 training steps (the first against
     plain bf16 and the fp32 floor); the spectrogram on the card against
     the CPU's; Recorder(ViT-B/16) (no launch; the maps against the plain
     chain's and fp32, the preds within phase 4's bounds; the 12 x 7 chain
     after eject), Extractor (the chain's counters; the embeddings bitwise
     the transformer's output) and AcceptVideoWrapper (16 frames in one
     chain, against plain bf16);
 48. their timing: SigLIPVAT ms a batch served and ms/step trained with
     peak memory (kernel and plain in turns, K P P K), the busy share of
     one profiled step, VAT_B's and VAAT_B's ms/step; each flash kernel and
     the short kernel at phase 45's shapes by device time against its twin,
     its bound and its library call, the SigLIPVAT and VAT_B shapes an
     entry each in the kernels line.
 49. the rest of the simple-ViT family at config 2's width (256/32, dim
     1024, depth 6, 16 heads, bs=256): the 1-D model (256 steps of 16, 8
     heads), the 3-D pair (ViViT's clip: 512 tokens, bs=16), patch dropout
     0.5, the FFT stream (freq patch 32: 128 tokens), the flash-attn
     variant, the orthogonal update, hyper-connections (4 streams, 4
     registers: 68 tokens), value residual, specialized cls and the
     attention-residual model, each served one batch: exact counters (4
     block launches a layer where the block fuses, the 3-D pair's 512
     tokens on the wide attention kernels too; none in value residual,
     specialized cls and attention-residual), logits
     against the plain bf16 path (the block on its twins) and fp32, ms a
     batch; the 1-D, patch-dropout, orthogonal-update and hyper-connection
     models trained 3 steps (loss falls, exact counters, first-step loss
     and gradients against plain bf16 and fp32, the hyper-connections'
     mixing parameters against fp32 within the all-gradients bound and
     logged, ms/step); the attention
     block on a strided x, served and with its backward, bitwise its
     contiguous copy; a Transformer with qkv_bias=True and scale 0.1 at
     ViT-B widths: one layer on the whole-layer kernels (7 launches
     forward, 13 with the backward) and on the attention-block kernels at
     dropout 0.1 (11), output and 13 gradients against the twins, 6 layers
     under VIT_TPU_STACK_LAYERS=6 (one stack_layers launch) bitwise the
     42-launch chain; the new shapes (attention_rows and attention_bwd_rows
     at the 1-D model's 16 tokens of 8 heads, attention_rows at the FFT
     model's 128 of 16, gemm_bf16's qkv site with a bias) against their
     twins and by device time against their twins, bounds and library
     calls, each an entry of the kernels line.
 50. ROADMAP item 9's families 1 and 2 and the distillation served one
     batch each at full width (ViT-1D, -3D, -ND, -ND-rotary, -ND-PoPE,
     DeepViT, CaiT, ParallelViT, the efficient shell, T2T, CCT, CCT-3D,
     DistillableViT): exact counters, logits against plain bf16 and fp32;
 51. six of them trained 3 steps at dropout 0.1 (the DistillWrapper among
     them): exact counters, the first step against the plain path;
 52. their new kernel shapes (flash_fwd, short_attention, the flash
     [dropout] trio, the chain at T2T's trunk and ViT-1D) against their
     twins and timed;
 53. item 9's family 3 (CrossViT, PiT, XCiT, LocalViT, the small-dataset
     ViT, RvT, NesT, MobileViT-XS, CvT, Twins-SVT) served one batch each at
     bs=64 at the upstream README's widths (CvT and Twins-SVT at their
     defaults): exact counters (CrossViT's large branch, 12 layers, and
     PiT's third stage, 3, on the whole layer; none elsewhere), logits
     against plain bf16 and fp32, ms a batch; CrossViT, PiT, XCiT,
     MobileViT and CvT trained 3 AdamW steps at bs=32: exact counters (the
     attention block's dropout kernels in CrossViT and PiT), the first
     step's loss and gradients against the plain path, the BatchNorms'
     running statistics after the steps against the plain path's, ms/step
     and peak memory; XCiT, MobileViT and CvT (no kernel: both paths run
     the same code) also trained from an fp32 copy at dropout 0, their
     first step and statistics against it;
 54. the chain at CrossViT's large branch (b=64 n=17, dim 384, inner 512)
     and PiT's third stage (b=64 n=65, dim 1024) forward and backward
     against the twins, its forward launches timed; the attention block's
     dropout kernels and the backward's at the same shapes at bs=32 against
     the twins and timed, each an entry of the kernels line (as every
     chain entry, timed with L2 flushed before each call).
 55-58. ROADMAP item 9's families 3b, 4, 5 and 6 and the MOSS wrapper
     (see the verify skill).
 59. the training infrastructure (ROADMAP item 11a) on ViT-B/16 @224,
     depth 12, bf16, dropout 0: a seeded host set of 192 images fed as
     minibatches (rng default_rng((1, epoch)), bs=32) through
     prefetch_to_device(depth=2, host_workers=True) to make_train_step,
     saved each epoch by CheckpointManager(max_to_keep=2, async_save=True);
     4 epochs uninterrupted against 2 epochs, a new model and optimizer
     restored from the latest step, and 2 more: parameters and Adam moments
     bitwise equal, exact counters every step, the last 2 steps kept; a
     prefetch stress (50 distinct batches at depth 3, each summed on the
     card as it is yielded, every checksum its host batch's); an epoch fed by
     direct .to(), by prefetch_to_device and by it with host_workers, in
     turns, at bs=32 and at bs=256 (ms);
 60. serving and artifacts: Predictor.from_checkpoint of phase 59's last
     step into a model built on meta (compiled_buckets after construction
     (1, 8, 32, 128)); requests of 1, 5, 32 and 130 images bitwise the
     logits of a Predictor of the in-memory trained model, 12 x 7 launches
     a bucket run; cost_analysis(8) on the card equal to the CPU count and
     to the count from the widths; the served model exported on the card
     and loaded in a subprocess that imports torch and
     vit_pytorch_tpu_torch.ops and no model code, batches of 1, 5 and 130
     within phase 4's plain-bf16 logit bound of the Predictor's (rel L2;
     max |d| printed) with 12 x 7 launches each; entry() once ((8, 1000),
     finite, on the card); the host us of one layer's 7 launches at bs=1
     through the eager implementation against the registered ops, in
     turns;
 61. the mesh (ROADMAP item 11b) as a world of one, in a subprocess:
     initialize_distributed (NCCL over a file store), make_mesh(1, 1) on
     the card; ViT-B/16 @224 (depth 12, bf16) through shard_train_state
     (fsdp=True) and make_sharded_train_step for 3 steps of bs=32 fed by
     prefetch_to_device(mesh=) (DTensors of the global shape on the card),
     against make_train_step from the same weights and batches: losses,
     accuracies, every parameter and Adam moment bitwise, 12 x 13 launches a
     step on both; Predictor(mesh=) bitwise the one-device Predictor at
     every bucket, 12 x 7 launches a run; export_model(mesh=) ->
     load_model(mesh=) bitwise the one-device artifact at 1, 5 and 32
     images, recording its mesh of 1 x 1; then dryrun_multichip(4) (4 gloo
     CPU processes with no visible card) and its ok line;
 62. the examples (ROADMAP item 11c), each main() at its own
     configuration on the card: serve_vit exactly as written (exact
     counters, 12 x 7 a bucket run; its logits at 5 and 300 images bitwise
     the Predictor's own calls); train_digits' 20 epochs on the real digits
     (test accuracy over 0.5, no launch), then 2 + 2 epochs with a resume
     bitwise 4 uninterrupted (every parameter and Adam moment);
     train_navit_packed, pretrain_mae and pretrain_dino 3 steps each (exact
     counters; each step's loss finite and, before the update, within the
     bf16 bound of the same step on a flash=False copy from the same weights
     and inputs, which launches nothing); train_vit_decorr 3 steps in a
     subprocess (NCCL world of one; the composite: each loss bitwise a
     replay of its step, no launch; the --checkpoint params); tune_train's
     three modes at bs=1024 (ms/step, img/s, peak memory, exact counters);
 63. the JAX width ladder on the wide attention kernels
     (csrc/attention_wide.cuh): attention_rows and attention_bwd_rows,
     plain, [dropout], [qknorm] and both, against their twins at ViT-H/14's
     (16 x 80), ViT-g/14's (16 x 88) and ViT-L/14's (16 x 64) 257 tokens,
     the d32 / d128 ViT-Bs' (24 x 32, 6 x 128) 197, ViT-B/16 @384's 577 and
     the 64-key chunks' edges; the chain's other kernels and the whole layer
     at ViT-H's and ViT-g's widths; ViT-H/14 and ViT-g/14 (full width and
     depth) served at bs=64 through Predictor and the d32 / d128 ViT-Bs at
     128 (exact counters, every layer a whole layer by a spy, no dispatcher
     call; logits against the plain twins and fp32); ViT-H/14 trained 3
     AdamW steps at bs=32 at dropout 0 and 0.1 and the ViT-Bs at 128 (exact
     counters, the first step against the plain twins, peak memory); the
     attention kernels timed at each (the '@ ViT-H/14', '@ ViT-g/14', '@
     d32' and '@ d128' entries of the kernels line).
Each phase prints its seconds.  Then one JSON line with the kernels (their
times, bounds and library-call times), and the last line {"ok": true,
"device": {...}}.  Any failed check exits non-zero before it.

Imports nothing of JAX.
"""

import contextlib
import copy
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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


def attention_work(b, n, heads, *, backward=False, dropout=False, qknorm=False, dh=DH):
    """attention_rows (qkv in, merged heads out; q.k and p.v) or
    attention_bwd_rows (qkv and dm in, m and dqkv out; q.k, p.v, dv, dp, dq,
    dk): 4 or 12 n^2 dh bf16 products a head, ~5 f32 operations a logit, a
    Philox draw a logit with dropout; qk-norm adds the gammas (and the
    dgammas) and ~6 f32 operations an element of q and k (twice backward)."""
    inner = heads * dh
    bytes_ = b * n * inner * 2 * (8 if backward else 4)
    logits = b * heads * n * n
    f32 = 5 * logits + (PHILOX_OPS_PER_ELEMENT * logits if dropout else 0)
    if qknorm:
        bytes_ += 2 * inner * 2 + (2 * inner * 4 if backward else 0)
        f32 += 6 * 2 * b * n * inner * (2 if backward else 1)
    return work(bytes_, tensor=(12 if backward else 4) * logits * dh, f32=f32)


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


def sdpa_ms(qkv, heads, iters, dh=DH, **kw):
    """Device ms of torch's scaled_dot_product_attention on the heads of a
    packed (b, n, 3*inner) qkv: the library call beside attention_rows."""
    b, n, _ = qkv.shape
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw), iters)


SDPA_FWD_BWD = "scaled_dot_product_attention forward + backward (torch.autograd.grad to q, k, v)"


def sdpa_fwd_bwd_ms(qkv, dm, heads, iters, dh=DH, **kw):
    """Device ms of torch's scaled_dot_product_attention forward and its
    backward to q, k and v, with the merged-heads gradient dm as the
    output's cotangent, on the heads of a packed (b, n, 3*inner) qkv: a
    yardstick beside attention_bwd_rows (which computes m and dqkv; no one
    torch call does)."""
    b, n, _ = qkv.shape
    with torch.inference_mode(False), torch.enable_grad():
        q, k, v = (t.clone().requires_grad_() for t in qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4))
        go = dm.view(b, n, heads, dh).transpose(1, 2).clone()

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


def flash_backend_bwd_ms(q, k, v, do, iters, causal=False, dropout_p=0.0, timer=None):
    """(ms, what) of the library's backward beside the flash backward kernels
    without ids: PyTorch's flash-attention backward, one aten call for dq,
    dk and dv fed its own forward's output and logsumexp, where this torch
    exposes it (timed by ``timer``, default :func:`cuda_ms`); else
    :func:`sdpa_bwd_only_ms`."""
    aten = torch.ops.aten
    scale = q.shape[-1] ** -0.5
    timer = timer or cuda_ms
    try:
        o, lse, cq, ck, mq, mk, seed, offset = aten._scaled_dot_product_flash_attention(
            q, k, v, dropout_p, causal, False, scale=scale)[:8]
        ms = timer(lambda: aten._scaled_dot_product_flash_attention_backward(
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


def layer_weights(rnd, dim=DIM, heads=HEADS, mlp=MLP):
    """Random bf16 operands of one layer (ViT-B's by default), the scales of
    phase 3."""
    inner = heads * DH
    w = dict(
        w_qkv=rnd(3 * inner, dim, scale=dim**-0.5), w_out=rnd(dim, inner, scale=inner**-0.5),
        ln1_scale=1 + rnd(dim, scale=0.1), ln1_bias=rnd(dim, scale=0.1),
        ln2_scale=1 + rnd(dim, scale=0.1), ln2_bias=rnd(dim, scale=0.1),
        w1=rnd(mlp, dim, scale=dim**-0.5), b1=rnd(mlp, scale=0.1),
        w2=rnd(dim, mlp, scale=mlp**-0.5), b2=rnd(dim, scale=0.1),
    )
    return w, dict(b_qkv=rnd(3 * inner, scale=0.1), b_out=rnd(dim, scale=0.1))


def layer_grads(layer, x, w, kw, g, heads=HEADS):
    """Output and every operand gradient of one layer (``layer`` is the
    kernel Function or its twin; ``kw`` its optional biases by name), for
    the cotangent ``g``."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, *w.values(), *kw.values())]
    out = layer(leaves[0], *leaves[1:11], heads=heads, dim_head=DH, **dict(zip(kw, leaves[11:])))
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


def train_step_ms(dev, fn, iters=2, warmup=True):
    """Host ms of one training step (after one warm-up step, unless
    ``warmup`` is false) and the peak device memory of those steps, GiB."""
    if warmup:
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

    # the plain path (~7 s a step) one step a turn, without a warm-up step of
    # its own: one kernel step first makes AdamW's state, so both plain turns
    # step a warm state
    kernel_step()
    (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (
        train_step_ms(dev, f, iters, warmup)
        for f, iters, warmup in ((plain_step, 1, False), (kernel_step, 2, True), (kernel_step, 2, True),
                                 (plain_step, 1, False)))
    log(f"  train step with dropout: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path {(p1 + p2) / 2:.3f} "
        f"ms/step (one step a turn after a kernel step); turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain "
        f"{p2:.3f}; peak device memory "
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

    # the plain path (~7.7 s a step) one step a turn, without a warm-up step of
    # its own: one kernel step first makes AdamW's state (as in phase 11)
    kernel_step()
    (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (
        train_step_ms(dev, f, iters, warmup)
        for f, iters, warmup in ((plain_step, 1, False), (kernel_step, 2, True), (kernel_step, 2, True),
                                 (plain_step, 1, False)))
    r1, (d1, _), (d2, _), r2 = (train_step_ms(dev, f) for f in (
        lambda: step0(state0, packed, labels), kernel_step, kernel_step, lambda: step0(state0, packed, labels)))
    k_ms = (k1 + k2) / 2
    log(f"  training step at dropout {RATE}, {packed.image_ids.shape[0]} packs: kernel path {k_ms:.3f} ms/step "
        f"({NAVIT_IMAGES * 1e3 / k_ms:.1f} img/s), plain bf16 path {(p1 + p2) / 2:.3f} ms/step (one step a turn after a "
        f"kernel step); turns "
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
# logged and not bounded, over fresh draws of its cases at rate
# 0 and at RATE, for the kernels and for the same Function on its plain twins
# (flash_attention_twins: bf16 q^ and k^ at the kernels' rounding points),
# each against the f32 composite: if the twins read the same excursions, the
# distance is the bf16 numerics the JAX kernel shares.  Settled over 20
# draws a rate (ROADMAP §3), phase 25 logs PHASE25_DRAWS a rate;
# chip_suspect6.py and chip_suspect7.py replay QK_F32_DRAWS.
QK_F32_DRAWS, PHASE25_DRAWS = 20, 5
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
    qk_vs_f32_draws(fa, dev, PHASE25_DRAWS)
    return errs


def qk_vs_f32_draws(fa, dev, draws=QK_F32_DRAWS):
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
    for rate in (0.0, RATE):
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


def pair_work(name, b, n, m, pairs, *, dropout=False, qknorm=False, bias_bytes=0, heads=HEADS):
    """The work of one launch of the short kernel or a flash variant on
    (b, heads, n | m, DH) operands, of which ``pairs`` (query, key) pairs a
    slice are visible: 4, 6, 8 DH bf16 products a pair for the forward, dq,
    dkv (4 for the short kernel), ~5 f32 operations a pair, a Philox draw a
    pair with dropout; each operand read once, each output written once (q,
    k, v, o; dO, dq; dk, dv; the f32 lse and delta), the bias's unique bytes;
    qk-norm adds the gammas and ~6 f32 operations an element of q and k."""
    tq, tk, vec = b * heads * n * DH * 2, b * heads * m * DH * 2, b * heads * n * 4
    per_pair, bytes_ = {"short_attention": (4, 2 * tq + 2 * tk), "flash_fwd": (4, 2 * tq + 2 * tk + vec),
                        "flash_bwd_dq": (6, 3 * tq + 2 * tk + 2 * vec),
                        "flash_bwd_dkv": (8, 2 * tq + 4 * tk + 2 * vec)}[name.split("[")[0]]
    total = b * heads * pairs
    f32 = (5 + (PHILOX_OPS_PER_ELEMENT if dropout else 0)) * total
    if qknorm:
        bytes_ += 2 * heads * DH * 4
        f32 += 6 * b * heads * (n + m) * DH
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


# -- BASELINE configs 4 and 5 and config 1 (phases 36-40) -------------------------
# ViViT, MAE and MaxViT at the JAX package's bench configurations
# (tools/bench_zoo.py:232-234, :250-253, :219-221) and BASELINE config 1 (the
# README's ViT, BASELINE.json configs[0]).  ViViT's and MAE's transformers run
# the whole-layer chain at heads x dim_head = 512 against dim = 1024, and at
# 9, 16, 64 and 65 tokens; MaxViT's 49-token windows take the attention
# composite (no kernel), as in the JAX package.
VIVIT = dict(image_size=128, image_patch_size=16, frames=16, frame_patch_size=2, num_classes=1000, dim=1024,
             spatial_depth=6, temporal_depth=6, heads=8, mlp_dim=2048)
VIVIT_SHAPE = (3, 16, 128, 128)
VIVIT_BS, VIVIT_BUCKETS, VIVIT_REQUESTS = 16, (1, 8, 16), (1, 5, 16)
VIVIT_LAYERS = VIVIT["spatial_depth"] + VIVIT["temporal_depth"]
VIVIT_TRAIN_STEPS = 2
MAE_ENCODER = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=8, mlp_dim=2048)
MAE_KW = dict(decoder_dim=512, decoder_depth=6, masking_ratio=0.75)
MAE_BS, MAE_STEPS, MAE_LR = 256, 3, 1e-4
MAE_PATCHES = (256 // 32) ** 2
MAE_LAYERS = MAE_ENCODER["depth"] + MAE_KW["decoder_depth"]
MAXVIT = dict(num_classes=1000, dim_conv_stem=64, dim=96, dim_head=32, depth=(2, 2, 5, 2), window_size=7, dropout=0.1)
MAXVIT_BS, MAXVIT_TRAIN_BS = 128, 32
CONFIG1 = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=16, mlp_dim=2048)
CONFIG1_N = (256 // 32) ** 2 + 1
# phase 36: the chain's new shapes, (label, b, n, dim, heads, mlp)
CHAIN_SHAPES = (
    ("ViViT spatial", VIVIT_BS * 8, 65, 1024, 8, 2048),
    ("ViViT temporal", VIVIT_BS, 9, 1024, 8, 2048),
    ("MAE encoder", MAE_BS, 16, 1024, 8, 2048),
    ("MAE decoder", MAE_BS, 64, 512, 8, 2048),
    ("config 1", B_CHECK, CONFIG1_N, 1024, 16, 2048),
)
# the attention-block kernels at ViViT's factorized self-attention: spatial
# (b f, 65) and temporal (b 65, 8) calls, dim 1024, 8 heads
BLOCK_SHAPES = (("FSA spatial", VIVIT_BS * 8, 65), ("FSA temporal", VIVIT_BS * 65, 8))
STACK_NEW = ("ViViT spatial", VIVIT_BS * 8, 65, 1024, 8, 2048, 6)  # g = 6, the spatial transformer's depth
# the shapes whose every chain kernel is an entry of its own in the kernels line
ENTRY_SHAPES = ("ViViT spatial", "MAE encoder")
CHAIN_FWD = ("layernorm_rows", "gemm_bf16[qkv]", "attention_rows", "gemm_bf16[out]", "gemm_bf16[fc1]",
             "gemm_bf16[fc2]")
CHAIN_BWD = ("attention_bwd_rows", "gemm_f32out", "layernorm_bwd_rows")
# MAE's loss is a bf16 mean, so it carries one rounding of 2^-8 relative:
# its bound is 2 bf16 ulps; the gradients' those of phase 7
MAE_VS_PLAIN = dict(loss=2.0**-7, grads=3e-2, worst=5e-2)
MAE_VS_FP32 = dict(loss=2.0**-7, grads=3e-2, worst=5e-2)
# MaxViT has no kernel: its bf16 path is plain PyTorch, held to fp32 only.
# Its bf16 gradients are far from its fp32 ones by the model's own numerics,
# on the JAX side as on the port's (tests/test_torch_max_vit.py::
# test_bf16_gradients_deviate_from_fp32_as_jax_does): at this configuration
# all gradients together read 0.157 rel L2 (H100 80GB HBM3, 700 W), and a
# per-parameter bound means nothing where a bias adds a per-channel
# constant right before a train-mode BatchNorm (a zero gradient in exact
# arithmetic: rounding noise on both paths).  Bounds: the loss and the
# updated statistics ~5x their readings (2.1e-4, 2.2e-3), all gradients
# together ~2x, no per-parameter bound
MAXVIT_LOGITS_VS_FP32 = 5e-2
MAXVIT_TRAIN_VS_FP32 = dict(loss=1e-3, grads=0.3, worst=math.inf)
MAXVIT_STATS_VS_FP32 = 1e-2

# -- the SSL trainers (phases 41-44) -------------------------------------------------
# The upstream vit-pytorch README's Dino example (its net is MAE_ENCODER's),
# hidden_layer the JAX default "transformer": the projector's first Linear
# takes the flattened (65, 1024) tokens, 66,560 features.  EsViT and LeJEPA
# wrap the same net with the same keywords; SimMIM and MPP read it as their
# encoder; MP3 runs its own ViT at the same widths.
SSL_NET = MAE_ENCODER
DINO_KW = dict(image_size=256, hidden_layer="transformer", projection_hidden_size=256, projection_layers=4,
               num_classes_K=65336, student_temp=0.9, teacher_temp=0.04, local_upper_crop_scale=0.4,
               global_lower_crop_scale=0.5, moving_average_decay=0.9, center_moving_average_decay=0.9)
LEJEPA_KW = {**{k: v for k, v in DINO_KW.items() if "temp" not in k and "moving" not in k}, "sigreg_num_slices": 1024}
SIMMIM_KW = dict(masking_ratio=0.5)
MPP_KW = dict(patch_size=32, dim=1024, mask_prob=0.15, replace_prob=0.5, random_patch_prob=0.5)
MP3_VIT = dict(num_classes=1000, image_size=256, patch_size=32, dim=1024, depth=6, heads=8, mlp_dim=2048)
MP3_RATIO = 0.75
SSL_BS, SSL_LR, DINO_STEPS, SSL_STEPS = 20, 3e-4, 3, 2
SSL_N = (256 // 32) ** 2 + 1
SSL_DEPTH = SSL_NET["depth"]
SSL_HIDDEN = SSL_N * SSL_NET["dim"]
SSL_ENTRY = ("Dino", SSL_BS, SSL_N, 1024, 8, 2048)  # the chain's shape on Dino's path: an entry of its own
# Against fp32 the kernel path is held to the floor that plain bf16 itself
# reads against fp32 in the same run (as phase 13 holds NaViT-B): the
# loss's, all gradients' and the worst parameter's relative difference at
# most SSL_FLOOR_RATIO times plain bf16's, the loss's floor at least
# SSL_LOSS_FLOOR.  Dino's, EsViT's and LeJEPA's losses are float32 (Dino's
# and EsViT's centres are float32, as JAX's create_state makes them, and
# the teacher's logits less the centres promote), averaged over 65,336
# classes and 20 images of bf16 logits: at full width plain bf16 reads
# 9.3e-5 / 9.5e-5 / 2.4e-6 relative against fp32, and the kernel path 1.6e-6
# / 0 / 1.2e-6 against plain bf16 (NVIDIA H100 80GB HBM3, 700.00 W).  So the
# floor is 2^-12, ~2.5x the largest plain reading, lest a plain reading
# that is small by chance bound the kernel path tighter than bf16's own
# noise; against plain bf16 their loss is held to 2^-14 (~40x the largest
# reading), the gradients to MAE's bounds (SSL_VS_PLAIN).  SimMIM's and
# MPP's losses are bf16 scalars, as in JAX: MAE_VS_PLAIN.  The student's
# softmax over 65,336 classes is bf16, as in JAX: the floor, not a fixed
# bound, says how far bf16 carries that.
SSL_FLOOR_RATIO = 1.5
SSL_LOSS_FLOOR = 2.0**-12
SSL_VS_PLAIN = {**MAE_VS_PLAIN, "loss": 2.0**-14}
# MP3 runs no kernel (its cross-attention's 16 keys take the composite): its
# bf16 path is plain PyTorch, held to fp32 by fixed bounds
MP3_VS_FP32 = dict(loss=2.0**-7, grads=5e-2, worst=1e-1)

def chain_weights(rnd, dim, heads, mlp):
    """One layer's operands at these widths (:func:`layer_weights`) and its
    b_out; no qkv bias, as ViViT's, MAE's and the ViT's layers have none."""
    w, kw = layer_weights(rnd, dim, heads, mlp)
    return w, kw["b_out"]


def refused(name, got, want, atol, rtol, max_rel_l2, atol_frac=None):
    """Whether :func:`compare` refuses ``got``, a mutant's output, logged."""
    if atol_frac is not None:
        atol = atol_frac * want.float().abs().max().item()
    d = (got.float() - want.float()).abs()
    ok = (bool(torch.isfinite(got).all()) and bool((d <= atol + rtol * want.float().abs()).all())
          and rel_l2(got, want) <= max_rel_l2)
    log(f"  mutant {name}: max_abs={d.max().item():.4e} rel L2={rel_l2(got, want):.3e} "
        f"{'PASSES the check' if ok else 'refused'}")
    return not ok


def check_chain_shape(fb, rnd, label, b, n, dim, heads, mlp):
    """Every chain kernel, forward and backward, against its twin at one
    shape, and the layer's output and 12 gradients: phase 3's and 6's
    bounds.  Returns {kernel: max_abs}."""
    inner = heads * DH
    akw = dict(heads=heads, dim_head=DH, scale=DH**-0.5)
    w, b_out = chain_weights(rnd, dim, heads, mlp)
    x = rnd(b, n, dim)
    tag = f"[{label}]"
    errs = {}
    keep = lambda name, e: errs.__setitem__(name, max(errs.get(name, 0.0), e))
    with torch.inference_mode():
        h = fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"])
        keep("layernorm_rows", compare(f"layernorm_rows ln1 {tag}", fb.layernorm_rows(x, w["ln1_scale"],
                                       w["ln1_bias"]), h, KERNEL_ATOL, KERNEL_RTOL))
        qkv = fb.gemm_bf16_reference(h, w["w_qkv"], "qkv")
        keep("gemm_bf16[qkv]", compare(f"gemm_bf16[qkv] {tag}", fb.gemm_bf16(h, w["w_qkv"], "qkv"), qkv,
                                       KERNEL_ATOL, KERNEL_RTOL))
        m = fb.attention_rows_reference(qkv, **akw)
        keep("attention_rows", compare(f"attention_rows {tag}", fb.attention_rows(qkv, **akw), m, ATTN_ATOL,
                                       ATTN_RTOL))
        y = fb.gemm_bf16_reference(m, w["w_out"], "out", bias=b_out, residual=x)
        keep("gemm_bf16[out]", compare(f"gemm_bf16[out] {tag}", fb.gemm_bf16(m, w["w_out"], "out", bias=b_out,
                                       residual=x), y, KERNEL_ATOL, KERNEL_RTOL))
        h2 = fb.layernorm_rows_reference(y, w["ln2_scale"], w["ln2_bias"])
        keep("layernorm_rows", compare(f"layernorm_rows ln2 {tag}", fb.layernorm_rows(y, w["ln2_scale"],
                                       w["ln2_bias"]), h2, KERNEL_ATOL, KERNEL_RTOL))
        a = fb.gemm_bf16_reference(h2, w["w1"], "fc1", bias=w["b1"])
        keep("gemm_bf16[fc1]", compare(f"gemm_bf16[fc1] {tag}", fb.gemm_bf16(h2, w["w1"], "fc1", bias=w["b1"]), a,
                                       KERNEL_ATOL, KERNEL_RTOL))
        keep("gemm_bf16[fc2]", compare(f"gemm_bf16[fc2] {tag}", fb.gemm_bf16(a, w["w2"], "fc2", bias=w["b2"],
                                       residual=y), fb.gemm_bf16_reference(a, w["w2"], "fc2", bias=w["b2"],
                                                                           residual=y), KERNEL_ATOL, KERNEL_RTOL))
        lkw = dict(heads=heads, dim_head=DH, b_out=b_out)
        compare(f"fused_transformer_layer {tag}", fb.fused_transformer_layer(x, **w, **lkw),
                fb.layer_reference(x, **w, **lkw), LAYER_ATOL, LAYER_RTOL)
        sync()
        # the backward's launches: dm = dy . W_out (K = dim, N = inner), the
        # attention backward, dh = dqkv . W_qkv (K = 3 inner, N = dim), LN1's backward
        dy = rnd(b, n, dim)
        w_out_t, w_qkv_t = w["w_out"].t().contiguous(), w["w_qkv"].t().contiguous()
        dm = fb.gemm_bf16_reference(dy, w_out_t, "cast")
        compare(f"gemm_bf16[cast] dm {tag}", fb.gemm_bf16(dy, w_out_t, "cast"), dm, KERNEL_ATOL, KERNEL_RTOL)
        keep("attention_bwd_rows", check_attention_bwd(fb, "attention_bwd_rows", qkv, dm, akw, label))
        dqkv = fb.attention_bwd_rows_reference(qkv, dm, **akw)[1]
        dh = fb.gemm_f32out_reference(dqkv, w_qkv_t)
        keep("gemm_f32out", compare(f"gemm_f32out [dh] {tag}", fb.gemm_f32out(dqkv, w_qkv_t), dh, None, F32_RTOL,
                                    F32_REL_L2, atol_frac=F32_ATOL_FRAC))
        got = fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=dy)
        want = fb.layernorm_bwd_rows_reference(x, dh, w["ln1_scale"], residual=dy)
        keep("layernorm_bwd_rows", max(
            compare(f"layernorm_bwd_rows dx {tag}", got[0], want[0], KERNEL_ATOL, KERNEL_RTOL),
            compare(f"layernorm_bwd_rows dgamma {tag}", got[1], want[1], None, F32_RTOL, F32_REL_L2,
                    atol_frac=F32_ATOL_FRAC),
            compare(f"layernorm_bwd_rows dbeta {tag}", got[2], want[2], None, F32_RTOL, F32_REL_L2,
                    atol_frac=F32_ATOL_FRAC)))
        sync()
    g = rnd(b, n, dim)
    out, grads = layer_grads(fb.fused_transformer_layer, x, w, {"b_out": b_out}, g, heads)
    out_want, grads_want = layer_grads(fb.layer_reference, x, w, {"b_out": b_out}, g, heads)
    compare(f"fused_transformer_layer (out, autograd) {tag}", out, out_want, LAYER_ATOL, LAYER_RTOL)
    for name, a_, b_ in zip(("x", *w, "b_out"), grads, grads_want):
        compare(f"layer grad d{name} {tag}", a_, b_, None, KERNEL_RTOL, LAYER_GRAD_REL_L2,
                atol_frac=LAYER_GRAD_ATOL_FRAC)
    sync()
    if label == STACK_NEW[0]:
        check_stack_new(fb, rnd, x, heads, mlp)
        check_chain_mutants(fb, x, w, b_out, m, qkv, y, heads)
    return errs


def check_stack_new(fb, rnd, x, heads, mlp):
    """stack_layers at inner != dim: g layers in one launch bitwise the chain
    of 7g launches, and the gate admits the group."""
    label, b, n, dim, _, _, g = STACK_NEW
    layers = []
    for _ in range(g):
        w, b_out = chain_weights(rnd, dim, heads, mlp)
        layers.append((w["w_qkv"], None, w["w_out"], b_out, w["ln1_scale"], w["ln1_bias"], w["ln2_scale"],
                       w["ln2_bias"], w["w1"], w["b1"], w["w2"], w["b2"]))
    step = lambda ops, t, lw: fb._layer_forward(ops, t, *lw, heads, DH, DH**-0.5, fb.LN_EPS)[0]
    with torch.inference_mode():
        got = fb.stack_layers(x, layers, heads=heads, dim_head=DH, scale=DH**-0.5)
        chain_in = x
        for lw in layers[:-1]:
            chain_in = step(fb.KERNELS, chain_in, lw)
        chain = step(fb.KERNELS, chain_in, layers[-1])
        last = step(fb.TWINS, chain_in, layers[-1])
        twin = fb.stack_layers_reference(x, layers, heads=heads, dim_head=DH, scale=DH**-0.5)
    same = torch.equal(got, chain)
    log(f"  stack_layers[{label}: g={g} b={b} n={n} dim={dim} inner={heads * DH}] vs the chain of {7 * g} launches: "
        f"{'bitwise' if same else 'DIFFERS'}")
    if not same:
        fail(f"stack_layers at inner != dim ({label}) differs from its chain")
    # phase 31's bounds: the last layer's step against the twin's on the
    # same input, the whole stack against the twins' chain within g times
    compare(f"stack_layers [{label}] vs twin step", got, last, LAYER_ATOL, LAYER_RTOL)
    compare(f"stack_layers [{label}] vs twin chain", got, twin, g * LAYER_ATOL, LAYER_RTOL, g * KERNEL_REL_L2)
    with env_switch({"VIT_TPU_STACK_LAYERS": str(g)}, STACK_KEYS):
        group = fb.whole_layer_stack_group(x.shape, x.dtype, heads, DH, dim, mlp, g)
    log(f"  whole_layer_stack_group at {tuple(x.shape)}, inner {heads * DH}, VIT_TPU_STACK_LAYERS={g}: {group}")
    if group != g:
        fail(f"the stack gate refuses {label} though stack_layers is bitwise its chain there")
    sync()


def check_chain_mutants(fb, x, w, b_out, m, qkv, y, heads):
    """Two mutants of a chain that assumed inner == dim, each refused by
    this phase's bounds: the out projection reading the merged heads at
    K = dim (row stride dim instead of inner: gemm_bf16[out] with K = dim on
    m's packed buffer), and attention_rows reading qkv at row stride 3 dim
    and writing dim columns."""
    b, n, dim = x.shape
    inner = heads * DH
    rows = b * n
    with torch.inference_mode():
        buf = torch.zeros(rows * dim, dtype=m.dtype, device=m.device)
        buf[: rows * inner] = m.reshape(-1)
        w_wide = torch.zeros(dim, dim, dtype=m.dtype, device=m.device)
        w_wide[:, :inner] = w["w_out"]
        got = fb.gemm_bf16(buf.view(b, n, dim), w_wide, "out", bias=b_out, residual=x)
        out_refused = refused("gemm_bf16[out] at K = dim", got, y, KERNEL_ATOL, KERNEL_RTOL, KERNEL_REL_L2)
        buf = torch.zeros(rows * 3 * dim, dtype=qkv.dtype, device=qkv.device)
        buf[: rows * 3 * inner] = qkv.reshape(-1)
        wide = fb.attention_rows(buf.view(b, n, 3 * dim), heads=dim // DH, dim_head=DH, scale=DH**-0.5)
        got = wide.reshape(-1)[: rows * inner].view(b, n, inner)
        attn_refused = refused("attention_rows at row stride 3 dim", got,
                               fb.attention_rows_reference(qkv, heads=heads, dim_head=DH, scale=DH**-0.5),
                               ATTN_ATOL, ATTN_RTOL, KERNEL_REL_L2)
    sync()
    if not (out_refused and attn_refused):
        fail("phase 36 passes a chain that assumed inner == dim")


def check_block_shapes(fb, rnd):
    """attention_rows, gemm_bf16[block_out] and attention_bwd_rows at ViViT's
    factorized self-attention calls (dim 1024, 8 heads, inner 512)."""
    dim, heads = VIVIT["dim"], VIVIT["heads"]
    inner = heads * DH
    akw = dict(heads=heads, dim_head=DH, scale=DH**-0.5)
    errs = {}
    w_out, b_out = rnd(dim, inner, scale=inner**-0.5), rnd(dim, scale=0.1)
    with torch.inference_mode():
        for label, b, n in BLOCK_SHAPES:
            qkv, dm = rnd(b, n, 3 * inner), rnd(b, n, inner)
            m = fb.attention_rows_reference(qkv, **akw)
            errs[f"attention_rows @ {label}"] = compare(f"attention_rows [{label}: b={b} n={n}]",
                                                        fb.attention_rows(qkv, **akw), m, ATTN_ATOL, ATTN_RTOL)
            for res in (None, rnd(b, n, dim)):
                okw = dict(bias=b_out, residual=res)
                errs[f"gemm_bf16[block_out] @ {label}"] = compare(
                    f"gemm_bf16[block_out{'' if res is None else ', +x'}] [{label}]",
                    fb.gemm_bf16(m, w_out, "block_out", **okw), fb.gemm_bf16_reference(m, w_out, "block_out", **okw),
                    KERNEL_ATOL, KERNEL_RTOL, BLOCK_OUT_REL_L2)
            errs[f"attention_bwd_rows @ {label}"] = check_attention_bwd(fb, "attention_bwd_rows", qkv, dm, akw, label)
            sync()
    return errs


def check_chain_new_shapes(fb, dev):
    """Phase 36: the chain at inner != dim and at 9, 16, 64, 65 tokens;
    returns {f"{kernel} @ {label}": max_abs}."""
    log(f"[36 chain at new shapes] (label, b, n, dim, heads, mlp) in {CHAIN_SHAPES}, dh={DH}, bf16")
    own = edge_rnd(SEED + 36)
    errs = {}
    for label, b, n, dim, heads, mlp in CHAIN_SHAPES:
        for name, e in check_chain_shape(fb, own, label, b, n, dim, heads, mlp).items():
            errs[f"{name} @ {label}"] = e
    errs.update(check_block_shapes(fb, own))
    return errs


def vivit_model(dev, dtype, variant="factorized_encoder", **kw):
    """ViViT at tools/bench_zoo.py:232-234's configuration, random weights
    from SEED, initialised in f32 and cast."""
    from vit_pytorch_tpu_torch.models.vivit import ViViT

    return ViViT(**VIVIT, variant=variant, **kw, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(SEED)).to(dtype)


def served_vs(what, got, plain, fp32, bound_plain, bound_fp32):
    e_plain = None if plain is None else rel_l2(got, plain)
    e_fp32 = rel_l2(got, fp32)
    ok = (plain is None or e_plain <= bound_plain) and e_fp32 <= bound_fp32
    note = "" if plain is None else f"vs plain bf16 {e_plain:.4e} (bound {bound_plain}), "
    log(f"  {what}: rel L2 {note}vs fp32 {e_fp32:.4e} (bound {bound_fp32}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{what} disagree with the plain path or fp32")


def check_vivit(fb, fa, dev):
    """Phase 37: ViViT served behind buckets (the factorized encoder; 12
    whole layers a forward: exact counters), with a frame mask (the
    temporal layers on the composite: 6 whole layers), the factorized
    self-attention (24 attention blocks a forward), and 2 training steps
    through make_train_step.  Returns the launch counts of the serving
    requests, of the factorized self-attention's and of the training
    steps, and the served Predictor and videos for phase 40."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step
    from vit_pytorch_tpu_torch.serving import Predictor

    bf16 = torch.bfloat16
    log(f"[37 ViViT] {VIVIT}, bf16, random weights (seed {SEED}), buckets {VIVIT_BUCKETS}")
    vgen = torch.Generator(device=dev).manual_seed(SEED + 37)
    fp32 = vivit_model(dev, torch.float32).eval()
    pred = Predictor(fp32, example_shape=VIVIT_SHAPE, batch_sizes=VIVIT_BUCKETS, device=dev).warmup()
    videos = {k: torch.randn(k, *VIVIT_SHAPE, generator=vgen, device=dev) for k in VIVIT_REQUESTS}
    runs = sum(-(-k // VIVIT_BUCKETS[-1]) for k in VIVIT_REQUESTS)
    reset_all(fb, fa)
    outs = {k: pred(videos[k]) for k in VIVIT_REQUESTS}
    sync()
    serve_counts = expect_launches(fb, fa, {k: VIVIT_LAYERS * v * runs for k, v in LAUNCHES_PER_LAYER.items()},
                                   f"ViViT serving ({VIVIT_LAYERS} layers x 7 launches x {runs} runs)")
    gemm = {site: fb.GEMM_LAUNCHES[site] for site in GEMM_SITES}
    log(f"  gemm_bf16 by site {gemm}")
    if any(v != VIVIT_LAYERS * runs for v in gemm.values()):
        fail("ViViT serving did not launch each GEMM site once a layer")
    serve_counts = {**serve_counts, **{f"gemm_bf16[{s}]": v for s, v in gemm.items()}}
    for k, out in outs.items():
        if out.shape != (k, 1000) or not bool(torch.isfinite(out).all()):
            fail(f"ViViT request of {k} videos: shape {tuple(out.shape)}")
    k = VIVIT_BS
    x16 = videos[k].to(bf16)
    mask = torch.ones(k, VIVIT["frames"], dtype=torch.bool, device=dev)
    mask[::2, 12:] = False  # every other video's last 4 frames (2 frame patches) masked
    with torch.inference_mode():
        with plain_layers():
            plain, plain_m = pred.model(x16), pred.model(x16, mask=mask)
        want, want_m = fp32(videos[k]), fp32(videos[k], mask=mask)
        served_vs(f"logits of the {k}-video request", outs[k], plain, want, LOGITS_VS_PLAIN_BF16, LOGITS_VS_FP32)
        reset_all(fb, fa)
        got_m = pred.model(x16, mask=mask)
        sync()
        expect_launches(fb, fa, {n_: VIVIT["spatial_depth"] * v for n_, v in LAUNCHES_PER_LAYER.items()},
                        "ViViT with a frame mask (the spatial layers alone)")
        served_vs("logits with the frame mask", got_m, plain_m, want_m, LOGITS_VS_PLAIN_BF16, LOGITS_VS_FP32)
        if rel_l2(got_m, outs[k]) < 1e-3:
            fail("the frame mask did not change the logits")
    del plain, plain_m, want, want_m, got_m

    log("  factorized self-attention at the same widths, bucket 16")
    fsa32 = vivit_model(dev, torch.float32, "factorized_self_attention").eval()
    fsa = Predictor(fsa32, example_shape=VIVIT_SHAPE, batch_sizes=(VIVIT_BS,), device=dev)
    reset_all(fb, fa)
    out = fsa(videos[k])
    sync()
    fsa_counts = expect_launches(fb, fa, {n_: 2 * VIVIT["spatial_depth"] * v for n_, v in BLOCK_FWD_LAUNCHES.items()},
                                 "ViViT factorized self-attention (2 attention blocks a layer)")
    with torch.inference_mode():
        with plain_layers():
            plain = fsa.model(x16)
        served_vs("factorized self-attention logits", out, plain, fsa32(videos[k]), LOGITS_VS_PLAIN_BF16,
                  LOGITS_VS_FP32)
    del fsa, fsa32, plain, out
    sync()

    log(f"  training: bs={VIVIT_BS}, dropout 0, {VIVIT_TRAIN_STEPS} Adam steps through make_train_step")
    t32 = vivit_model(dev, torch.float32)
    model = copy.deepcopy(t32).to(bf16)
    initial = copy.deepcopy(model)
    names = [n_ for n_, _ in model.named_parameters()]
    labels = torch.randint(0, 1000, (k,), generator=vgen, device=dev)
    state, step = create_train_state(model), make_train_step(model)
    reset_all(fb, fa)
    losses = []
    for i in range(VIVIT_TRAIN_STEPS):
        losses.append(step(state, x16, labels)["loss"].item())
        if i == 0:
            grads = grad_vector(model)
    sync()
    train_counts = expect_launches(fb, fa, {n_: VIVIT_LAYERS * v * VIVIT_TRAIN_STEPS
                                            for n_, v in TRAIN_LAUNCHES_PER_LAYER.items()}, "ViViT training")
    log(f"  losses {[f'{v:.6f}' for v in losses]}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail("the ViViT training loss is not finite or does not fall")
    plain = copy.deepcopy(initial)
    reset_all(fb, fa)
    with plain_layers():
        loss_plain = make_train_step(plain)(create_train_state(plain), x16, labels)["loss"].item()
    sync()
    expect_launches(fb, fa, {}, "the plain ViViT step")
    compare_grads("ViViT first step vs plain bf16", grads, grad_vector(plain), losses[0], loss_plain, TRAIN_VS_PLAIN,
                  names)
    loss_fp32 = make_train_step(t32)(create_train_state(t32), videos[k], labels)["loss"].item()
    compare_grads("ViViT first step vs fp32", grads, grad_vector(t32), losses[0], loss_fp32, TRAIN_VS_FP32, names)
    del t32, plain, initial, state, step
    sync()
    return serve_counts, fsa_counts, train_counts, dict(pred=pred, videos=x16, model=model, labels=labels)


def mae_model(dev, dtype):
    """MAE at tools/bench_zoo.py:250-253's configuration (encoder ViT
    256/32, dim 1024, depth 6, heads 8, mlp 2048; decoder_dim 512, depth 6,
    masking 0.75), random weights from SEED, initialised in f32 and cast."""
    from vit_pytorch_tpu_torch import MAE, ViT

    gen = torch.Generator(device=dev).manual_seed(SEED)
    encoder = ViT(**MAE_ENCODER, device=dev, generator=gen)
    return MAE(encoder=encoder, **MAE_KW, device=dev, generator=gen).to(dtype)


def trained_grads(model):
    """Names and f32 copies of the gradients of the parameters that have one
    (MAE never reads its encoder's cls token and head)."""
    pairs = [(n, p.grad.detach().float().clone()) for n, p in model.named_parameters() if p.grad is not None]
    return [n for n, _ in pairs], [g for _, g in pairs]


@contextlib.contextmanager
def layer_shapes():
    """Record the x shape of every whole-layer call of the model path."""
    from vit_pytorch_tpu_torch.nn import blocks

    calls, orig = [], blocks.fused_transformer_layer

    def spy(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return orig(x, *args, **kwargs)

    blocks.fused_transformer_layer = spy
    try:
        yield calls
    finally:
        blocks.fused_transformer_layer = orig


def check_mae(fb, fa, dev):
    """Phase 38: MAE pretraining at bs=256 with a fixed permutation: the
    encoder's 6 layers at (256, 16, 1024) and the decoder's at (256, 64,
    512) on the whole-layer kernels (exact counters), the loss and every
    gradient against the plain bf16 path and fp32, then AdamW(1e-4) steps
    with permutations drawn from a generator.  Returns the launch counts of
    the kernel path's step, and the model and batch for phase 40."""
    bf16 = torch.bfloat16
    log(f"[38 MAE] encoder {MAE_ENCODER}, {MAE_KW}, bf16, random weights (seed {SEED}); bs={MAE_BS}")
    mgen = torch.Generator(device=dev).manual_seed(SEED + 38)
    fp32 = mae_model(dev, torch.float32)
    model = copy.deepcopy(fp32).to(bf16)
    plain = copy.deepcopy(model)
    size = MAE_ENCODER["image_size"]
    img = torch.randn(MAE_BS, 3, size, size, generator=mgen, device=dev)
    idx = torch.rand((MAE_BS, MAE_PATCHES), generator=mgen, device=dev).argsort(dim=-1)
    reset_all(fb, fa)
    with layer_shapes() as shapes:
        loss = model(img.to(bf16), rand_indices=idx)
        loss.backward()
    sync()
    counts = expect_launches(fb, fa, {k: MAE_LAYERS * v for k, v in TRAIN_LAUNCHES_PER_LAYER.items()},
                             f"MAE ({MAE_LAYERS} layers x 13 launches)")
    counts = {**counts, **{f"gemm_bf16[{site}]": fb.GEMM_LAUNCHES[site] for site in GEMM_SITES}}
    enc_shape, dec_shape = (MAE_BS, MAE_PATCHES // 4, 1024), (MAE_BS, MAE_PATCHES, MAE_KW["decoder_dim"])
    log(f"  whole-layer calls: {shapes.count(enc_shape)} at the encoder's {enc_shape}, {shapes.count(dec_shape)} at "
        f"the decoder's {dec_shape}, {len(shapes)} in all")
    if shapes != [enc_shape] * MAE_ENCODER["depth"] + [dec_shape] * MAE_KW["decoder_depth"]:
        fail("MAE's encoder and decoder did not run every layer on the kernels")
    names, grads = trained_grads(model)
    reset_all(fb, fa)
    with plain_layers():
        loss_plain = plain(img.to(bf16), rand_indices=idx)
        loss_plain.backward()
    sync()
    expect_launches(fb, fa, {}, "the plain MAE step")
    loss32 = fp32(img, rand_indices=idx)
    loss32.backward()
    pnames, pgrads = trained_grads(plain)
    fnames, fgrads = trained_grads(fp32)
    if pnames != names or fnames != names:
        fail("MAE: the paths differ in which parameters have gradients")
    compare_grads("MAE step vs plain bf16", grads, pgrads, loss.item(), loss_plain.item(), MAE_VS_PLAIN, names)
    compare_grads("MAE step vs fp32", grads, fgrads, loss.item(), loss32.item(), MAE_VS_FP32, names)
    del plain, fp32, pgrads, fgrads
    opt = torch.optim.AdamW([p for p in model.parameters()], lr=MAE_LR, weight_decay=1e-4)  # optax.adamw(1e-4)
    losses = []
    x16 = img.to(bf16)
    for _ in range(MAE_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = model(x16, generator=mgen)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    sync()
    log(f"  AdamW(lr={MAE_LR}) steps, permutations from a generator: losses {[f'{v:.6f}' for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        fail("the MAE loss is not finite")
    return counts, dict(model=model, opt=opt, img=x16, gen=mgen)


def maxvit_model(dev, dtype, registers=False, **kw):
    """MaxViT (or MaxViT with registers) at tools/bench_zoo.py:219-221's
    configuration, random weights from SEED, initialised in f32 and cast."""
    from vit_pytorch_tpu_torch.models import max_vit, max_vit_with_registers

    cls = (max_vit_with_registers if registers else max_vit).MaxViT
    cfg = {**MAXVIT, **kw}
    return cls(**cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).to(dtype)


def bn_stats(model):
    return torch.cat([b.detach().float().reshape(-1) for n, b in model.named_buffers() if "running" in n])


def check_maxvit_config1(fb, fa, dev):
    """Phase 39: MaxViT served behind buckets with bf16 BatchNorm statistics
    (no launch), against fp32; one train-mode forward and backward at
    dropout 0, its updated statistics and gradients against fp32; MaxViT
    with registers served; config 1 served behind buckets (6 whole layers a
    forward) against plain bf16 and fp32.  Returns config 1's serving
    counts and the served Predictors for phase 40."""
    from vit_pytorch_tpu_torch import ViT
    from vit_pytorch_tpu_torch.serving import Predictor

    bf16 = torch.bfloat16
    xgen = torch.Generator(device=dev).manual_seed(SEED + 39)
    images = {k: torch.randn(k, 3, 224, 224, generator=xgen, device=dev) for k in REQUESTS}
    runs = sum(-(-k // BUCKETS[-1]) for k in REQUESTS)
    served = {}
    for registers in (False, True):
        what = "MaxViT with registers" if registers else "MaxViT"
        log(f"[39 {what}] {MAXVIT}, bf16 (BatchNorm statistics too), random weights (seed {SEED}), "
            f"buckets {BUCKETS}")
        fp32 = maxvit_model(dev, torch.float32, registers).eval()
        pred = Predictor(fp32, example_shape=(3, 224, 224), batch_sizes=BUCKETS, device=dev).warmup()
        stats = [b.dtype for n, b in pred.model.named_buffers() if "running" in n]
        log(f"  {len(stats)} BatchNorm statistics, dtypes {sorted({str(d) for d in stats})}")
        if not stats or any(d != bf16 for d in stats):
            fail(f"{what}: the served BatchNorm statistics are not bf16")
        reset_all(fb, fa)
        outs = {k: pred(images[k]) for k in REQUESTS}
        sync()
        expect_launches(fb, fa, {}, f"{what} serving (49-token windows: the composite)")
        for k, out in outs.items():
            if out.shape != (k, 1000) or not bool(torch.isfinite(out).all()):
                fail(f"{what} request of {k} images: shape {tuple(out.shape)}")
        with torch.inference_mode():
            served_vs(f"{what} logits of the 32-image request", outs[32], None, fp32(images[32]), None,
                      MAXVIT_LOGITS_VS_FP32)
        served[what] = pred
        del fp32, outs
    sync()

    log(f"  MaxViT train-mode forward and backward, dropout 0, bs={MAXVIT_TRAIN_BS}, bf16 against fp32")
    m32 = maxvit_model(dev, torch.float32, dropout=0.0).train()
    m16 = copy.deepcopy(m32).to(bf16)
    names = [n for n, _ in m32.named_parameters()]
    x = torch.randn(MAXVIT_TRAIN_BS, 3, 224, 224, generator=xgen, device=dev)
    labels = torch.randint(0, 1000, (MAXVIT_TRAIN_BS,), generator=xgen, device=dev)
    before = bn_stats(m32)
    reset_all(fb, fa)
    loss16 = torch.nn.functional.cross_entropy(m16(x.to(bf16)).float(), labels)
    loss16.backward()
    sync()
    expect_launches(fb, fa, {}, "MaxViT training")
    loss32 = torch.nn.functional.cross_entropy(m32(x), labels)
    loss32.backward()
    s16, s32 = bn_stats(m16), bn_stats(m32)
    e_stats = rel_l2(s16, s32)
    log(f"  updated BatchNorm statistics: rel L2 bf16 vs fp32 {e_stats:.4e} (bound {MAXVIT_STATS_VS_FP32}); moved "
        f"from their init by {rel_l2(s32, before):.4e}")
    if not e_stats <= MAXVIT_STATS_VS_FP32 or torch.equal(s32, before):
        fail("MaxViT's updated statistics disagree with fp32's, or did not move")
    compare_grads("MaxViT train-mode step vs fp32", grad_vector(m16), grad_vector(m32), loss16.item(), loss32.item(),
                  MAXVIT_TRAIN_VS_FP32, names)
    del m16, m32
    sync()

    log(f"[39 config 1] {CONFIG1}, bf16, random weights (seed {SEED}), buckets {BUCKETS}")
    size = CONFIG1["image_size"]
    c32 = ViT(**CONFIG1, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).eval()
    pred = Predictor(c32, example_shape=(3, size, size), batch_sizes=BUCKETS, device=dev).warmup()
    imgs = {k: torch.randn(k, 3, size, size, generator=xgen, device=dev) for k in REQUESTS}
    reset_all(fb, fa)
    outs = {k: pred(imgs[k]) for k in REQUESTS}
    sync()
    counts = expect_launches(fb, fa, {k: CONFIG1["depth"] * v * runs for k, v in LAUNCHES_PER_LAYER.items()},
                             f"config 1 serving ({CONFIG1['depth']} layers x 7 launches x {runs} runs)")
    with torch.inference_mode():
        with plain_layers():
            plain = pred.model(imgs[32].to(bf16))
        served_vs("config 1 logits of the 32-image request", outs[32], plain, c32(imgs[32]), LOGITS_VS_PLAIN_BF16,
                  LOGITS_VS_FP32)
    served["config 1"] = pred
    del c32
    sync()
    return counts, served, dict(maxvit=images[REQUESTS[-1]][:MAXVIT_BS].to(bf16),
                                config1=imgs[REQUESTS[-1]][:B_TIME].to(bf16))


L2_FLUSH_BYTES = 256 << 20  # over 5x the H100's 50 MB L2
MARKERS = 64  # one-cycle spin kernels closing each group of a profiler session's records
SPIN_CYCLES_PER_MS = 2_000_000  # the card's ~2 GHz clock
EDGE_SPIN_MS = [4.0]  # the spin that opens and closes a session's window; doubled after a session lost records


def device_ms(fn, iters=10, tries=8, flush=False):
    """Device ms of one call of fn: the summed device time of its kernels
    under torch.profiler over ``iters`` calls (after 3 warm-up calls),
    divided by ``iters``.  At these shapes a launch is shorter than the
    host's time to issue it, so CUDA events around a chain of calls would
    time the host.  Late in a long run the profiler loses device records of
    a trace window: its first ones (at times all of them), and at times a
    run of them within it.  So each session traces 3 calls in the
    profiler's warm-up step, and its active window holds, in this order on
    the stream: a spin of EDGE_SPIN_MS, MARKERS one-cycle spins
    (``torch.cuda._sleep``), one call, MARKERS spins, the ``iters`` calls it
    counts, MARKERS spins and a spin of EDGE_SPIN_MS.  The session counts
    only if its records read so: spins, the lone call's k >= 1 records, all
    MARKERS spins, exactly ``iters`` x k records, MARKERS spins or more.
    The lone call gives the per-call count, and the whole groups of spins
    around the counted calls show that none of their records was lost
    (records before the first spin, which the stream ran before the window,
    are left out).  A session that does not read so doubles EDGE_SPIN_MS
    (for the rest of the run) and is run again; after ``tries`` such
    sessions the run fails.
    With ``flush`` a write of L2_FLUSH_BYTES precedes each call, so that
    the call finds none of its operands in L2: it is the first of each
    call's k records and is not summed."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if flush:
        flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        call = lambda: (flush_buf.fill_(1), fn())
    else:
        call = fn
    for _ in range(3):
        call()
    sync()
    for _ in range(tries):
        edge = int(EDGE_SPIN_MS[0] * SPIN_CYCLES_PER_MS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(3):
                call()
            sync()
            prof.step()
            torch.cuda._sleep(edge)
            for group in (1, iters, 0):
                for _ in range(MARKERS):
                    torch.cuda._sleep(1)
                for _ in range(group):
                    call()
            torch.cuda._sleep(edge)
            sync()
            prof.step()
        records = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name) for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False))
        runs = []  # (spin kernels?, the durations of one run of records)
        for _, us, name in records:
            spin = "spin_kernel" in name
            if runs and runs[-1][0] == spin:
                runs[-1][1].append(us)
            else:
                runs.append((spin, [us]))
        if runs and not runs[0][0]:  # the warm-up step's last records, before the window's first spin
            runs.pop(0)
        shape = [(spin, len(us)) for spin, us in runs]
        if ([spin for spin, _ in shape] == [True, False, True, False, True] and shape[2][1] == MARKERS
                and shape[4][1] >= MARKERS and shape[3][1] == iters * shape[1][1]):
            k = shape[1][1]
            return sum(us for i, us in enumerate(runs[3][1]) if not (flush and i % k == 0)) / iters / 1e3
        EDGE_SPIN_MS[0] *= 2
        log(f"  the profiler delivered runs of (spin kernels?, records) {shape} for 1 + {iters} calls: profiling "
            f"again behind {EDGE_SPIN_MS[0]:g} ms spins")
    fail(f"the profiler lost device records in {tries} sessions: no device time")


def queued_event_ms(fn, iters=10, tries=4):
    """Device ms of one call of fn from CUDA events around ``iters`` calls
    that the host queued while a spin kernel (``torch.cuda._sleep``) held
    the stream, so the events time the device and not the host's issue
    rate.  The start event must still be pending once every call is queued;
    otherwise the spin is doubled and the run repeated.  Unlike the
    profiler's sum, this includes the device's gaps between kernels."""
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    host_s = time.perf_counter() - t0
    cycles = int(max(host_s, 1e-3) * 4e9)  # twice the host's time at the card's ~2 GHz clock
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        sync()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
    fail(f"the device caught up with the host in {tries} event timings: no device time")


def flushed_event_ms(fn, iters=10, tries=4):
    """Device ms of one call of fn that finds none of its operands in L2:
    a 256 MB buffer is written before each call, outside the timed window,
    and CUDA events around each call, queued behind a spin kernel as in
    :func:`queued_event_ms`, time the call on the device (its kernels and
    the device's gaps between them)."""
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        flush_buf.fill_(1)
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        flush_buf.fill_(1)
        fn()
    sync()
    cycles = int(max(time.perf_counter() - t0, 1e-3) * 4e9)
    for _ in range(tries):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(cycles)
        for i, (start, end) in enumerate(events):
            flush_buf.fill_(i & 1)
            start.record()
            fn()
            end.record()
        queued = not events[0][0].query()
        sync()
        if queued:
            return sum(start.elapsed_time(end) for start, end in events) / iters
        cycles *= 2
    fail(f"the device caught up with the host in {tries} flushed event timings: no device time")


def chain_entry_times(fb, rnd, label, b, n, dim, heads, mlp, backward=True, dropout_rate=0.0):
    """Each chain kernel's launch at one shape, forward and (unless
    ``backward`` is false) backward: its device time against its twin's in
    turns (plain, kernel, kernel, plain), with its work and the device time
    of its library call (F.layer_norm, F.linear, SDPA,
    native_layer_norm_backward) or of its yardstick (the bare product
    through F.linear; SDPA's forward and backward), all from
    :func:`device_ms`; keys ``f"{kernel} @ {label}"``.  With
    ``dropout_rate`` the attention-block route's kernels at that rate
    instead: attention_rows[dropout] and gemm_bf16[block_out] forward, then
    dropout_apply and the backward's kernels with attention_bwd_rows[dropout]
    (SDPA with dropout_p beside them).  Every call, library calls and
    yardsticks too, finds none of its operands in L2 (``device_ms(...,
    flush=True)``): at these shapes a site's working set fits in the 50 MB
    L2, and timed warm the LayerNorms at ViViT's, MAE's, T2T's and PiT's
    shapes read under their byte bounds."""
    inner = heads * DH
    rows = b * n
    drop = "[dropout]" if dropout_rate else ""
    akw = dict(heads=heads, dim_head=DH, scale=DH**-0.5)
    if dropout_rate:
        akw.update(dropout_rate=dropout_rate, seed=DROP_SEED)
    timer = lambda f: device_ms(f, flush=True)
    w, b_out = chain_weights(rnd, dim, heads, mlp)
    x, dy = rnd(b, n, dim), rnd(b, n, dim)
    okw = dict(bias=b_out, residual=x, dropout_rate=dropout_rate, seed=DROP_SEED, heads=heads)
    per_kernel = {}
    F_ = torch.nn.functional
    sdpa_kw = dict(dropout_p=dropout_rate) if dropout_rate else {}
    with torch.inference_mode():
        h = fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"])
        qkv = fb.gemm_bf16(h, w["w_qkv"], "qkv")
        m = fb.attention_rows(qkv, **akw)
        y = fb.gemm_bf16(m, w["w_out"], "out", bias=b_out, residual=x)
        h2 = fb.layernorm_rows(y, w["ln2_scale"], w["ln2_bias"])
        a = fb.gemm_bf16(h2, w["w1"], "fc1", bias=w["b1"])
        q, k, v = qkv.view(b, n, 3, heads, DH).permute(2, 0, 3, 1, 4)
        if backward:
            w_out_t, w_qkv_t = w["w_out"].t().contiguous(), w["w_qkv"].t().contiguous()
            gm = fb.dropout_apply(dy, DROP_SEED, heads=heads, rate=dropout_rate) if dropout_rate else dy
            dm = fb.gemm_bf16(gm, w_out_t, "cast")
            _, dqkv = fb.attention_bwd_rows(qkv, dm, **akw)
            dh = fb.gemm_f32out(dqkv, w_qkv_t)
            aten = torch.ops.aten
            _, mean, rstd = aten.native_layer_norm(x, [dim], w["ln1_scale"], w["ln1_bias"], fb.LN_EPS)
            g16 = dh.to(x.dtype)  # native_layer_norm_backward takes dh in x's dtype
            ln_bwd = lambda: aten.native_layer_norm_backward(g16, x, [dim], mean, rstd, w["ln1_scale"],
                                                             w["ln1_bias"], [True, True, True])
    if backward:
        with torch.inference_mode(False), torch.enable_grad():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            go = dm.view(b, n, heads, DH).transpose(1, 2).clone()
            sdpa_fwd_bwd_dev = timer(lambda: torch.autograd.grad(F_.scaled_dot_product_attention(*leaves, **sdpa_kw),
                                                                 leaves, go))
    with torch.inference_mode():
        ln = lambda t, s_, b_: timer(lambda: F_.layer_norm(t, (dim,), s_, b_, fb.LN_EPS))
        lin = lambda t, w_: timer(lambda: F_.linear(t, w_))
        attention = ("attention_rows" + drop, lambda: fb.attention_rows(qkv, **akw),
                     lambda: fb.attention_rows_reference(qkv, **akw),
                     attention_work(b, n, heads, dropout=bool(dropout_rate)),
                     timer(lambda: F_.scaled_dot_product_attention(q, k, v, **sdpa_kw)), None)
        if dropout_rate:
            sites = (  # (kernel, kernel call, twin call, work, library ms, yardstick (ms, what))
                attention,
                ("gemm_bf16[block_out]", lambda: fb.gemm_bf16(m, w["w_out"], "block_out", **okw),
                 lambda: fb.gemm_bf16_reference(m, w["w_out"], "block_out", **okw),
                 gemm_work(rows, dim, inner, bias=True, residual=True, dropout=True), None,
                 (lin(m, w["w_out"]), None)),
            )
        else:
            sites = (
                ("layernorm_rows", lambda: fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]),
                 lambda: fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"]), ln_work(rows, dim),
                 ln(x, w["ln1_scale"], w["ln1_bias"]), None),
                ("layernorm_rows", lambda: fb.layernorm_rows(y, w["ln2_scale"], w["ln2_bias"]),
                 lambda: fb.layernorm_rows_reference(y, w["ln2_scale"], w["ln2_bias"]), ln_work(rows, dim),
                 ln(y, w["ln2_scale"], w["ln2_bias"]), None),
                ("gemm_bf16[qkv]", lambda: fb.gemm_bf16(h, w["w_qkv"], "qkv"),
                 lambda: fb.gemm_bf16_reference(h, w["w_qkv"], "qkv"), gemm_work(rows, 3 * inner, dim),
                 lin(h, w["w_qkv"]), None),
                attention,
                ("gemm_bf16[out]", lambda: fb.gemm_bf16(m, w["w_out"], "out", bias=b_out, residual=x),
                 lambda: fb.gemm_bf16_reference(m, w["w_out"], "out", bias=b_out, residual=x),
                 gemm_work(rows, dim, inner, bias=True, residual=True), None, (lin(m, w["w_out"]), None)),
                ("gemm_bf16[fc1]", lambda: fb.gemm_bf16(h2, w["w1"], "fc1", bias=w["b1"]),
                 lambda: fb.gemm_bf16_reference(h2, w["w1"], "fc1", bias=w["b1"]),
                 gemm_work(rows, mlp, dim, bias=True), None, (lin(h2, w["w1"]), None)),
                ("gemm_bf16[fc2]", lambda: fb.gemm_bf16(a, w["w2"], "fc2", bias=w["b2"], residual=y),
                 lambda: fb.gemm_bf16_reference(a, w["w2"], "fc2", bias=w["b2"], residual=y),
                 gemm_work(rows, dim, mlp, bias=True, residual=True), None, (lin(a, w["w2"]), None)),
            )
        sites += () if not backward or not dropout_rate else (
            ("dropout_apply", lambda: fb.dropout_apply(dy, DROP_SEED, heads=heads, rate=dropout_rate),
             lambda: fb.out_dropout_bwd_reference(dy, DROP_SEED, heads=heads, rate=dropout_rate),
             work(2 * 2 * rows * dim, f32=PHILOX_OPS_PER_ELEMENT * rows * dim), None, None),
        )
        sites += () if not backward else (
            ("attention_bwd_rows" + drop, lambda: fb.attention_bwd_rows(qkv, dm, **akw),
             lambda: fb.attention_bwd_rows_reference(qkv, dm, **akw),
             attention_work(b, n, heads, backward=True, dropout=bool(dropout_rate)), None,
             (sdpa_fwd_bwd_dev, SDPA_FWD_BWD + (f", dropout_p={dropout_rate}" if dropout_rate else ""))),
            ("gemm_f32out", lambda: fb.gemm_f32out(dqkv, w_qkv_t), lambda: fb.gemm_f32out_reference(dqkv, w_qkv_t),
             gemm_work(rows, dim, 3 * inner, out_bytes=4), None, (lin(dqkv, w_qkv_t), None)),
            ("layernorm_bwd_rows", lambda: fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=dy),
             lambda: fb.layernorm_bwd_rows_reference(x, dh, w["ln1_scale"], residual=dy),
             ln_bwd_work(rows, dim, residual=True), timer(ln_bwd), None),
        )
        for name, kern, twin, wk, lib_ms, prod in sites:
            p1, k1, k2, p2 = (timer(f) for f in (twin, kern, kern, twin))
            km, pm = (k1 + k2) / 2, (p1 + p2) / 2
            record(per_kernel, f"{name} @ {label}", km, pm, wk, library_ms=lib_ms,
                   product_ms=None if prod is None else prod[0], product_of=None if prod is None else prod[1])
            log(f"  {name} @ {label}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound_ms(wk)[0]:.4f} ms"
                + ("" if lib_ms is None else f", library call {lib_ms:.4f} ms")
                + ("" if prod is None else f", yardstick ({prod[1] or 'F.linear, the bare product'}) {prod[0]:.4f} ms"))
    sync()
    return per_kernel


def time_zoo(fb, fa, dev, smi, vivit, mae, served, inputs):
    """Phase 40: MaxViT img/s at bs=128; ViViT videos/s at bs=16 and ms/step,
    kernel against plain in turns; MAE ms/step and peak memory at bs=256;
    config 1 img/s at bs=128; each chain kernel at ViViT's spatial shape and
    at MAE's encoder shape.  Returns the kernels-line records."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    log(f"[40 timing] {smi}")

    def turns(label, kernel, plain, count, unit):
        p1, k1, k2, p2 = (host_ms(f, 5) for f in (plain, kernel, kernel, plain))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"  {label}: kernel path {count * 1e3 / k_ms:.2f} {unit}/s ({k_ms:.3f} ms), plain bf16 path "
            f"{count * 1e3 / p_ms:.2f} {unit}/s ({p_ms:.3f} ms); turns ms plain {p1:.3f} kernel {k1:.3f} kernel "
            f"{k2:.3f} plain {p2:.3f}")

    with torch.inference_mode():
        model, img = served["MaxViT"].model, inputs["maxvit"]
        ms = host_ms(lambda: model(img), 5)
        log(f"  MaxViT bs={MAXVIT_BS} (no kernel: plain PyTorch, cuDNN convolutions): {MAXVIT_BS * 1e3 / ms:.2f} img/s "
            f"({ms:.3f} ms)")
        model = served["MaxViT with registers"].model
        ms = host_ms(lambda: model(img), 5)
        log(f"  MaxViT with registers bs={MAXVIT_BS}: {MAXVIT_BS * 1e3 / ms:.2f} img/s ({ms:.3f} ms)")
        model, img = served["config 1"].model, inputs["config1"]

        def plain_c1():
            with plain_layers():
                model(img)

        turns(f"config 1 serving bs={B_TIME}", lambda: model(img), plain_c1, B_TIME, "img")
        model, vid = vivit["pred"].model, vivit["videos"]

        def plain_vivit():
            with plain_layers():
                model(vid)

        turns(f"ViViT serving bs={VIVIT_BS}", lambda: model(vid), plain_vivit, VIVIT_BS, "videos")

    tmodel = vivit["model"]
    state, step = create_train_state(tmodel), make_train_step(tmodel)

    def vivit_plain_step():
        with plain_layers():
            step(state, vivit["videos"], vivit["labels"])

    (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (
        train_step_ms(dev, f) for f in (vivit_plain_step, lambda: step(state, vivit["videos"], vivit["labels"]),
                                        lambda: step(state, vivit["videos"], vivit["labels"]), vivit_plain_step))
    log(f"  ViViT training bs={VIVIT_BS}: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path {(p1 + p2) / 2:.3f} "
        f"ms/step; turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; peak device memory "
        f"kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
    del state, step, tmodel
    vivit.clear()

    mmodel, opt, img, mgen = mae["model"], mae["opt"], mae["img"], mae["gen"]

    def mae_step():
        opt.zero_grad(set_to_none=True)
        mmodel(img, generator=mgen).backward()
        opt.step()

    def mae_plain_step():
        with plain_layers():
            mae_step()

    (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (train_step_ms(dev, f)
                                                  for f in (mae_plain_step, mae_step, mae_step, mae_plain_step))
    log(f"  MAE pretraining bs={MAE_BS} (AdamW): kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path "
        f"{(p1 + p2) / 2:.3f} ms/step; turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; "
        f"peak device memory kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
    mae.clear()
    served.clear()
    sync()

    own = edge_rnd(SEED + 40)
    per_kernel = {}
    for label, b, n, dim, heads, mlp in CHAIN_SHAPES:
        if label in ENTRY_SHAPES:
            log(f"  each chain launch at {label}: b={b} n={n} dim={dim} heads={heads} mlp={mlp}")
            per_kernel.update(chain_entry_times(fb, own, label, b, n, dim, heads, mlp))
    return per_kernel


def ssl_model(kind, dev, dtype=torch.float32, **net_kw):
    """A trainer of phases 41-44 on SSL_NET (``kind``: Dino, EsViT, LeJEPA,
    SimMIM, MPP) or MP3 on its own ViT, random weights from SEED,
    initialised in f32 and cast."""
    from vit_pytorch_tpu_torch import ViT
    from vit_pytorch_tpu_torch.ssl import es_vit, lejepa, mp3, mpp, simmim
    from vit_pytorch_tpu_torch.ssl.dino import Dino

    gen = torch.Generator(device=dev).manual_seed(SEED)
    if kind == "MP3":
        vit = mp3.ViT(**MP3_VIT, device=dev, generator=gen)
        return mp3.MP3(vit=vit, masking_ratio=MP3_RATIO, device=dev, generator=gen).to(dtype)
    net = ViT(**SSL_NET, device=dev, generator=gen, **net_kw)
    build = {
        "Dino": lambda: Dino(net, **DINO_KW, device=dev, generator=gen),
        "EsViT": lambda: es_vit.EsViTTrainer(net, **DINO_KW, device=dev, generator=gen),
        "LeJEPA": lambda: lejepa.LeJEPA(net, **LEJEPA_KW, device=dev, generator=gen),
        "SimMIM": lambda: simmim.SimMIM(encoder=net, **SIMMIM_KW, device=dev, generator=gen),
        "MPP": lambda: mpp.MPP(net, **MPP_KW, device=dev, generator=gen),
    }[kind]
    return build().to(dtype)


def ssl_launches(grad_calls, no_grad_calls, per_grad=TRAIN_LAUNCHES_PER_LAYER):
    """The exact counters of encoder calls with and without gradients, each
    SSL_DEPTH whole layers."""
    keys = set(per_grad) | set(LAUNCHES_PER_LAYER)
    return {k: SSL_DEPTH * (grad_calls * per_grad.get(k, 0) + no_grad_calls * LAUNCHES_PER_LAYER.get(k, 0))
            for k in keys}


def ssl_paths(fb, fa, label, fp32, run, want, shapes_want):
    """One step of a trainer on the kernel path (a bf16 copy of ``fp32``),
    on the plain bf16 path (the same copy through the twins) and in fp32:
    ``run(model, dtype)`` gives the loss.  Checks the kernel path's exact
    counters and whole-layer shapes and that the plain path launches
    nothing; returns the three paths' models, losses and gradients."""
    bf16 = torch.bfloat16
    model = copy.deepcopy(fp32).to(bf16)
    plain = copy.deepcopy(model)
    reset_all(fb, fa)
    with layer_shapes() as shapes:
        loss = run(model, bf16)
        loss.backward()
    sync()
    counts = expect_launches(fb, fa, want, label)
    counts = {**counts, **{f"gemm_bf16[{site}]": fb.GEMM_LAUNCHES[site] for site in GEMM_SITES}}
    log(f"  whole-layer calls: {len(shapes)} ({sorted(set(shapes))}), expected {len(shapes_want)}")
    if shapes != shapes_want:
        fail(f"{label}: the whole-layer calls are not the expected ones")
    reset_all(fb, fa)
    with plain_layers():
        loss_plain = run(plain, bf16)
        loss_plain.backward()
    sync()
    expect_launches(fb, fa, {}, f"the plain {label} step")
    loss32 = run(fp32, torch.float32)
    loss32.backward()
    paths = {}
    for key, m, lo in (("kernel", model, loss), ("plain", plain, loss_plain), ("fp32", fp32, loss32)):
        names, grads = trained_grads(m)
        paths[key] = dict(model=m, loss=lo.item(), loss_dtype=lo.dtype, names=names, grads=grads)
    if not paths["kernel"]["names"] == paths["plain"]["names"] == paths["fp32"]["names"]:
        fail(f"{label}: the paths differ in which parameters have gradients")
    paths["counts"] = counts
    return paths


def compare_floor(name, paths, ratio=SSL_FLOOR_RATIO):
    """The kernel path against fp32 within ``ratio`` times plain bf16
    against fp32, for the loss (its floor at least SSL_LOSS_FLOOR), all
    gradients together and the worst single parameter."""
    k, p, f = paths["kernel"], paths["plain"], paths["fp32"]
    rel = lambda a, b: abs(a - b) / abs(b)
    per = lambda got: [((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(got, f["grads"])]
    d_k, d_p = rel(k["loss"], f["loss"]), rel(p["loss"], f["loss"])
    t_k, t_p = grads_rel_l2(k["grads"], f["grads"]), grads_rel_l2(p["grads"], f["grads"])
    per_k, per_p = per(k["grads"]), per(p["grads"])
    w_k, w_p = max(range(len(per_k)), key=per_k.__getitem__), max(range(len(per_p)), key=per_p.__getitem__)
    ok = (d_k <= ratio * max(d_p, SSL_LOSS_FLOOR) and t_k <= ratio * t_p and per_k[w_k] <= ratio * per_p[w_p]
          and all(bool(torch.isfinite(a).all()) for a in k["grads"]))
    log(f"  {name} vs fp32 (floor: plain bf16 vs fp32, bound {ratio}x): loss {k['loss']:.6f} vs {f['loss']:.6f} "
        f"rel {d_k:.3e} (plain {d_p:.3e}); grads rel L2 {t_k:.4e} (plain {t_p:.4e}); worst {k['names'][w_k]} "
        f"{per_k[w_k]:.4e} (plain's worst {p['names'][w_p]} {per_p[w_p]:.4e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name}: the kernel path is further from fp32 than {ratio}x plain bf16")


def ssl_images(dev, seed):
    """SSL_BS images of 256 x 256, uniform in [0, 1], f32."""
    return torch.rand(SSL_BS, 3, 256, 256, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def ema_formula(old, new, beta, dtype=None):
    """old * beta + (1 - beta) * new, the JAX package's arithmetic: each
    constant rounded to the dtype of the array it multiplies, ``new`` held
    in ``dtype`` (by default its own; Dino's float32 last centres are the
    bf16 values JAX's forward returns), the sum promoted to old's dtype."""
    dtype = dtype or new.dtype
    return (old * torch.tensor(beta, dtype=old.dtype).item()
            + torch.tensor(1 - beta, dtype=dtype).item() * new.to(dtype))


def check_f32_centres(name, kernel, buffers):
    """The bf16 trainer's centre buffers and its loss float32, as the JAX
    package's ``create_state`` makes the centres and bf16 logits less them
    promote the loss; the last centres bf16 values (JAX's forward returns
    them in the projections' dtype)."""
    model = kernel["model"]
    dtypes = {b: getattr(model, b).dtype for b in buffers}
    last = [getattr(model, b) for b in buffers if b.startswith("last_")]
    ok = (all(d == torch.float32 for d in dtypes.values()) and kernel["loss_dtype"] == torch.float32
          and all(torch.equal(t, t.bfloat16().float()) for t in last))
    log(f"  {name} in bf16: centre buffers {dtypes}, loss {kernel['loss_dtype']}, last centres bf16 values "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name}: the centres or the loss are not float32 in bf16, as JAX's are")


def check_dino(fb, fa, dev):
    """Phase 41: Dino at full width: the chain's kernels at its shape, one
    step on views drawn on the card (exact counters: the student's two
    graphs and the teacher's two no-grad calls; the captured hidden), the
    loss, the new last centres and the gradients against plain bf16 and
    the fp32 floor, then DINO_STEPS Adam steps with the EMA after each,
    checked bit for bit.  Returns the step's counts, the chain's errors at
    Dino's shape and the state phase 44 times."""
    bf16 = torch.bfloat16
    log(f"[41 Dino] net ViT {SSL_NET}, Dino {DINO_KW}, bs={SSL_BS} images uniform in [0, 1], bf16, random "
        f"weights (seed {SEED}); Adam(lr={SSL_LR})")
    label, b, n, dim, heads, mlp = SSL_ENTRY
    errs = {f"{k} @ {label}": e for k, e in check_chain_shape(fb, edge_rnd(SEED + 41), label, b, n, dim, heads,
                                                              mlp).items()}
    img = ssl_images(dev, SEED + 41)
    fp32 = ssl_model("Dino", dev)
    views32 = fp32.make_views(img, torch.Generator().manual_seed(SEED + 41))
    log(f"  views: byol_augment and random_resized_crop on the card, parameters from a CPU generator: "
        f"{[tuple(v.shape) for v in views32]}, {views32[0].dtype}")
    captured = []

    def run(model, dtype):
        handle = model.student_encoder.register_forward_hook(lambda m, a, out: captured.append(tuple(out[1].shape)))
        try:
            return model(None, views=tuple(v.to(dtype) for v in views32))
        finally:
            handle.remove()

    paths = ssl_paths(fb, fa, "Dino step", fp32, run, ssl_launches(2, 2), [(b, n, dim)] * (4 * SSL_DEPTH))
    check_f32_centres("Dino", paths["kernel"], ("teacher_centers", "last_teacher_centers"))
    log(f"  captured hidden (flattened) of the student's calls: {captured[:2]}, expected {(SSL_BS, SSL_HIDDEN)}")
    if captured[:2] != [(SSL_BS, SSL_HIDDEN)] * 2:
        fail("Dino: the captured hidden layer is not the transformer's (b, 65 x 1024)")
    k, p = paths["kernel"], paths["plain"]
    compare_grads("Dino step vs plain bf16", k["grads"], p["grads"], k["loss"], p["loss"], SSL_VS_PLAIN, k["names"])
    centers = [paths[key]["model"].last_teacher_centers.float() for key in ("kernel", "plain", "fp32")]
    e_kp, e_kf, e_pf = rel_l2(centers[0], centers[1]), rel_l2(centers[0], centers[2]), rel_l2(centers[1], centers[2])
    ok = e_kp <= LOGITS_VS_PLAIN_BF16 and e_kf <= SSL_FLOOR_RATIO * e_pf
    log(f"  new last_teacher_centers, rel L2: vs plain bf16 {e_kp:.4e} (bound {LOGITS_VS_PLAIN_BF16}), vs fp32 "
        f"{e_kf:.4e} (bound {SSL_FLOOR_RATIO} x plain bf16 vs fp32, {e_pf:.4e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("Dino: the new centres disagree with the plain path or fp32")
    compare_floor("Dino step", paths)
    counts, model = paths["counts"], paths["kernel"]["model"]
    del paths, fp32, centers

    opt = torch.optim.Adam([q for q in model.parameters() if q.requires_grad], lr=SSL_LR)
    cpu_gen = torch.Generator().manual_seed(SEED + 410)
    teacher = [q for _, q in model.teacher_encoder.named_parameters()]
    student = [q for _, q in model.student_encoder.named_parameters()]
    losses = []
    for i in range(DINO_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = model(img, generator=cpu_gen)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        old = [t.detach().clone() for t in teacher]
        centers = model.teacher_centers.clone(), model.last_teacher_centers.clone()
        model.update_moving_average()
        beta, cbeta = DINO_KW["moving_average_decay"], DINO_KW["center_moving_average_decay"]
        ema_ok = all(torch.equal(t, ema_formula(o, s, beta)) for t, o, s in zip(teacher, old, student))
        centers_ok = torch.equal(model.teacher_centers, ema_formula(*centers, cbeta, bf16))
        apart = not all(torch.equal(t, s) for t, s in zip(teacher, student))
        log(f"  step {i}: loss {losses[-1]:.6f}; EMA of {len(teacher)} teacher tensors bitwise the formula "
            f"{ema_ok}, centres {centers_ok}, teacher apart from the student {apart}")
        if not (ema_ok and centers_ok and apart):
            fail("Dino: the EMA update is not the formula, or the teacher equals the student")
        del old
    sync()
    if not all(math.isfinite(v) for v in losses):
        fail("the Dino loss is not finite")
    opt.zero_grad(set_to_none=True)
    return counts, errs, dict(dino=model, dino_opt=opt, img=img, cpu_gen=cpu_gen)


@torch.no_grad()
def esvit_matches(model, views):
    """EsViT's region pairings (``es_vit.region_pairs``) of both region
    losses."""
    from vit_pytorch_tpu_torch.ssl.es_vit import region_pairs

    s1, s2 = (model.student_encoder(v)[2] for v in views[:2])
    t1, t2 = (model.teacher_encoder(v)[2] for v in views[2:])
    return torch.cat([region_pairs(s2, t1), region_pairs(s1, t2)])


def check_esvit_lejepa(fb, fa, dev, state):
    """Phase 42: EsViT and LeJEPA on Dino's net and batch: one step each
    against plain bf16 and the fp32 floor with exact counters (EsViT: the
    region pairings that flip between the paths logged, and plain bf16
    bounds only when none flips), then SSL_STEPS Adam steps with finite
    losses."""
    bf16 = torch.bfloat16
    img = state["img"]
    log(f"[42 EsViT, LeJEPA] the net and batch of phase 41; EsViT {DINO_KW}; LeJEPA {LEJEPA_KW}")
    fp32 = ssl_model("EsViT", dev)
    views32 = fp32.make_views(img, torch.Generator().manual_seed(SEED + 42))
    paths = ssl_paths(fb, fa, "EsViT step", fp32, lambda m, dt: m(None, views=tuple(v.to(dt) for v in views32)),
                      ssl_launches(2, 2), [(SSL_BS, SSL_N, 1024)] * (4 * SSL_DEPTH))
    k, p = paths["kernel"], paths["plain"]
    check_f32_centres("EsViT", k, ("teacher_view_centers", "last_teacher_view_centers", "teacher_region_centers",
                                   "last_teacher_region_centers"))
    views16 = tuple(v.to(bf16) for v in views32)
    kernel_idx = esvit_matches(k["model"], views16)
    with plain_layers():
        plain_idx = esvit_matches(p["model"], views16)
    fp32_idx = esvit_matches(paths["fp32"]["model"], views32)
    flips, vs32 = int((kernel_idx != plain_idx).sum()), int((plain_idx != fp32_idx).sum())
    log(f"  region pairings that flip: kernel vs plain bf16 {flips} of {kernel_idx.numel()}, plain bf16 vs fp32 "
        f"{vs32}")
    if flips == 0:
        compare_grads("EsViT step vs plain bf16", k["grads"], p["grads"], k["loss"], p["loss"], SSL_VS_PLAIN,
                      k["names"])
    else:
        log(f"  EsViT step vs plain bf16 (not bounded: {flips} pairings flipped): loss {k['loss']:.6f} vs "
            f"{p['loss']:.6f}, grads rel L2 {grads_rel_l2(k['grads'], p['grads']):.4e}")
    compare_floor("EsViT step", paths)
    esvit_counts = paths["counts"]
    esvit = k["model"]
    del paths, fp32, views32, views16

    fp32 = ssl_model("LeJEPA", dev)
    views32 = fp32.make_views(img, torch.Generator().manual_seed(SEED + 420))
    projs = torch.randn(LEJEPA_KW["sigreg_num_slices"], DINO_KW["num_classes_K"], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 42))
    projs = projs / projs.norm(dim=-1, keepdim=True)
    paths = ssl_paths(fb, fa, "LeJEPA step", fp32,
                      lambda m, dt: m(None, views=tuple(v.to(dt) for v in views32), sigreg_projs=projs),
                      ssl_launches(1, 1), [(2 * SSL_BS, SSL_N, 1024)] * (2 * SSL_DEPTH))
    k, p = paths["kernel"], paths["plain"]
    compare_grads("LeJEPA step vs plain bf16", k["grads"], p["grads"], k["loss"], p["loss"], SSL_VS_PLAIN, k["names"])
    compare_floor("LeJEPA step", paths)
    lejepa = k["model"]
    del paths, fp32, views32, projs

    for name, model in (("EsViT", esvit), ("LeJEPA", lejepa)):
        opt = torch.optim.Adam([q for q in model.parameters() if q.requires_grad], lr=SSL_LR)
        cpu_gen = torch.Generator().manual_seed(SEED + 421)
        losses = []
        for _ in range(SSL_STEPS):
            opt.zero_grad(set_to_none=True)
            loss = model(img, generator=cpu_gen)
            loss.backward()
            opt.step()
            if hasattr(model, "update_moving_average"):
                model.update_moving_average()
            losses.append(loss.item())
        sync()
        log(f"  {name}: {SSL_STEPS} Adam steps, views from a CPU generator: losses {[f'{v:.6f}' for v in losses]}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"the {name} loss is not finite")
        opt.zero_grad(set_to_none=True)
        state[name] = (model, opt)
    return esvit_counts


def check_masked_trainers(fb, fa, dev, state):
    """Phase 43: SimMIM and MPP on Dino's net at bs=SSL_BS, one step each at
    dropout 0 against plain bf16 with exact counters; MPP trained SSL_STEPS
    steps at dropout and emb_dropout RATE on the attention-block kernels
    (exact counters); MP3 against fp32 with no launch at all."""
    bf16 = torch.bfloat16
    img = state["img"]
    log(f"[43 SimMIM, MPP, MP3] SimMIM {SIMMIM_KW}, MPP {MPP_KW} on the net of phase 41; MP3 ViT {MP3_VIT}, "
        f"masking {MP3_RATIO}; bs={SSL_BS}")
    n = SSL_N - 1
    idx = torch.rand((SSL_BS, n), generator=torch.Generator(device=dev).manual_seed(SEED + 43),
                     device=dev).argsort(dim=-1, descending=True)[:, : int(SIMMIM_KW["masking_ratio"] * n)]
    paths = ssl_paths(fb, fa, "SimMIM step", ssl_model("SimMIM", dev),
                      lambda m, dt: m(img.to(dt), masked_indices=idx), ssl_launches(1, 0),
                      [(SSL_BS, n, 1024)] * SSL_DEPTH)
    k, p = paths["kernel"], paths["plain"]
    compare_grads("SimMIM step vs plain bf16", k["grads"], p["grads"], k["loss"], p["loss"], MAE_VS_PLAIN, k["names"])
    state["SimMIM"] = k["model"]
    del paths

    positions = torch.rand((SSL_BS, n), generator=torch.Generator(device=dev).manual_seed(SEED + 430),
                           device=dev) < MPP_KW["mask_prob"]
    draws = lambda: torch.Generator(device=dev).manual_seed(SEED + 431)  # the replace and random-patch draws
    paths = ssl_paths(fb, fa, "MPP step", ssl_model("MPP", dev),
                      lambda m, dt: m(img.to(dt), masked_positions=positions, generator=draws()),
                      ssl_launches(1, 0), [(SSL_BS, SSL_N, 1024)] * SSL_DEPTH)
    k, p = paths["kernel"], paths["plain"]
    compare_grads("MPP step vs plain bf16", k["grads"], p["grads"], k["loss"], p["loss"], MAE_VS_PLAIN, k["names"])
    state["MPP"] = k["model"]
    del paths

    model = ssl_model("MPP", dev, bf16, dropout=RATE, emb_dropout=RATE).train()
    opt = torch.optim.Adam(model.parameters(), lr=SSL_LR)
    gen = torch.Generator(device=dev).manual_seed(SEED + 432)
    reset_all(fb, fa)
    losses = []
    for _ in range(SSL_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = model(img.to(bf16), generator=gen)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    sync()
    log(f"  MPP at dropout {RATE}, emb_dropout {RATE}: {SSL_STEPS} Adam steps, losses {[f'{v:.6f}' for v in losses]}")
    expect_launches(fb, fa, {k_: SSL_DEPTH * SSL_STEPS * v for k_, v in DROPOUT_LAUNCHES_PER_LAYER.items()},
                    f"MPP at dropout {RATE} ({SSL_DEPTH} attention blocks x 11 launches x {SSL_STEPS} steps)")
    if not all(math.isfinite(v) for v in losses):
        fail("the MPP loss at dropout is not finite")
    del model, opt

    fp32 = ssl_model("MP3", dev)
    model = copy.deepcopy(fp32).to(bf16)
    perm = torch.rand((SSL_BS, n), generator=torch.Generator(device=dev).manual_seed(SEED + 433),
                      device=dev).argsort(dim=-1)
    reset_all(fb, fa)
    loss = model(img.to(bf16), rand_indices=perm)
    loss.backward()
    sync()
    expect_launches(fb, fa, {}, "MP3 (its cross-attention takes the composite)")
    loss32 = fp32(img, rand_indices=perm)
    loss32.backward()
    names, grads = trained_grads(model)
    fnames, fgrads = trained_grads(fp32)
    if names != fnames:
        fail("MP3: the paths differ in which parameters have gradients")
    compare_grads("MP3 step (bf16, no kernel) vs fp32", grads, fgrads, loss.item(), loss32.item(), MP3_VS_FP32, names)
    model.zero_grad(set_to_none=True)
    state["MP3"] = model


def busy_share(spans):
    """(the device's busy share, the window): the union of the device
    events' (start, end) spans over the window from the first start to the
    last end, in the spans' unit."""
    spans = sorted(spans)
    window = max(end for _, end in spans) - spans[0][0]
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / window, window


def profiled_busy(fn):
    """The device's busy share of one profiled call of ``fn`` (after a
    warm-up call; chip_zoo_profile.py's method): the union of the device
    events' spans over the window from the first one's start to the last
    one's end, with the device kernel time and the window in ms, and the
    host ops of most self CPU time.  None where CUPTI gave no device
    records twice."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        if spans:
            break
    else:
        return None
    busy, window = busy_share(spans)
    # where the host's time goes: the ops of most self CPU time
    ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0), key=lambda e: -e.self_cpu_time_total)
    top = ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ms x{e.count}" for e in ops[:8])
    return busy, sum(b - a for a, b in spans) / 1e3, window / 1e3, top


def time_ssl(fb, dev, smi, state):
    """Phase 44: each trainer's ms/step on the host clock around SSL_STEPS
    steps after a warm-up, the kernel and plain paths in turns (P K K P),
    Dino's peak memory, the busy share of one profiled Dino step, and each
    chain kernel at Dino's shape.  Returns the kernels-line records."""
    log(f"[44 SSL timing] bs={SSL_BS}, {smi}")

    def step_fn(model, opt, run):
        def step():
            opt.zero_grad(set_to_none=True)
            run(model).backward()
            opt.step()
            if hasattr(model, "update_moving_average"):
                model.update_moving_average()
        return step

    def plain(fn):
        def run():
            with plain_layers():
                fn()
        return run

    img, cpu_gen = state["img"], state["cpu_gen"]
    img16 = img.to(torch.bfloat16)
    n = SSL_N - 1
    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    adam = lambda m: torch.optim.Adam([q for q in m.parameters() if q.requires_grad], lr=SSL_LR)
    steps = (
        ("Dino", state["dino"], state["dino_opt"], lambda m: m(img, generator=cpu_gen)),
        ("EsViT", *state["EsViT"], lambda m: m(img, generator=cpu_gen)),
        ("LeJEPA", *state["LeJEPA"], lambda m: m(img, generator=cpu_gen)),
        ("SimMIM", state["SimMIM"], adam(state["SimMIM"]), lambda m: m(img16, generator=gen)),
        ("MPP", state["MPP"], adam(state["MPP"]), lambda m: m(img16, generator=gen)),
        ("MP3", state["MP3"], adam(state["MP3"]), lambda m: m(img16, generator=gen)),
    )
    for name, model, opt, run in steps:
        kernel = step_fn(model, opt, run)
        (p1, pm1), (k1, km1), (k2, km2), (p2, pm2) = (train_step_ms(dev, f, SSL_STEPS)
                                                      for f in (plain(kernel), kernel, kernel, plain(kernel)))
        note = " (no kernel: both paths plain)" if name == "MP3" else ""
        log(f"  {name} training bs={SSL_BS}{note}: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path "
            f"{(p1 + p2) / 2:.3f} ms/step; turns ms plain {p1:.3f} kernel {k1:.3f} kernel {k2:.3f} plain {p2:.3f}; "
            f"peak device memory kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
        if name == "Dino":
            busy = profiled_busy(kernel)
            log("  one profiled Dino step: the profiler saw no device time (busy share not measured)" if busy is None
                else f"  one profiled Dino step: device busy {busy[0]:.4f} of the window ({busy[2]:.3f} ms), device "
                     f"kernel time {busy[1]:.3f} ms; host ops by self CPU time: {busy[3]}")
        opt.zero_grad(set_to_none=True)
    state.clear()
    sync()
    label, b, n_, dim, heads, mlp = SSL_ENTRY
    log(f"  each chain launch at {label}'s shape: b={b} n={n_} dim={dim} heads={heads} mlp={mlp}")
    return chain_entry_times(fb, edge_rnd(SEED + 44), label, b, n_, dim, heads, mlp)


# -- the VLA slice (phases 45-48): SigLIPVAT, VAT and VAAT, the wrappers ---------
# SIGLIP_VAT: SigLIPVAT at the reference's defaults (vat_siglip.py:263-286),
# uncut: pi0's action head (Black et al. 2024, dim 512, depth 27, 8 heads of
# 64, mlp 2048, a chunk of 50 actions of 32 dims, 4 register tokens,
# self-attention 4 heads of 32) on SigLIP so400m/14 @224 (1152, depth 27, 16
# heads, mlp 4304, eps 1e-6).  Views x frames: pi0's three cameras x Octo's
# two-frame history, 1,536 context keys a layer (the flash route); (2, 2),
# 1,024 (the short route); (3, 1), 768 (the composite).
SIGLIP_VIEWS = {"flash": (3, 2), "short": (2, 2), "composite": (3, 1)}
SIGLIP_DEPTH = 27
SIGLIP_QUERIES = 4 + 50  # registers and actions
SIGLIP_BUCKETS = (1, 8)
SIGLIP_BS, SIGLIP_STEPS, SIGLIP_LR = 8, 3, 1e-4
SIGLIP_SHALLOW = 2  # the full-width copy held to fixed bounds
VLA_HEADS = 8
# VAT_B: the VAT ViT at ViT-B/16 @224 widths, 2 views x 4 frames (2 x 4 x 197
# = 1,576 keys), 4 tasks, 2 advantage bins, a 32-dim extra token: 4 + 1 + 7
# + 1 = 13 queries.  VAAT_B: VAT_B and an AST of the same widths on 1 s of
# 16 kHz audio (65 x 1,334 cropped to 64 x 1,328: 332 patches + 4 registers)
VAT_B_VIT = dict(image_size=224, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP)
VAT_B = dict(dim=512, depth=DEPTH, heads=VLA_HEADS, dim_head=DH, mlp_dim=2048, dim_action=32, time_seq_len=4,
             num_tasks=4, num_advantage_bins=2, dim_extra_token=32)
VAT_B_VIEWS, VAT_B_QUERIES, VAT_B_KEYS = 2, 4 + 1 + 7 + 1, 2 * 4 * N
VAAT_B_AST = dict(dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP, patch_size=16)
VAT_BS, VAT_STEPS, AUDIO_SAMPLES = 4, 2, 16000
# phase 45's kernel shapes, (label, b, n, m) at 8 heads of 64: SigLIPVAT's
# cross-attention at (3, 2), VAT_B's, and SigLIPVAT with an advantage and an
# extra token (56 queries); the short kernel at (2, 2) and at 13 queries
VLA_FLASH = (("SigLIPVAT", SIGLIP_BS, SIGLIP_QUERIES, 1536), ("VAT_B", VAT_BS, VAT_B_QUERIES, VAT_B_KEYS),
             ("SigLIPVAT + 2 tokens", SIGLIP_BS, SIGLIP_QUERIES + 2, 1536))
VLA_SHORT = (("SigLIPVAT", SIGLIP_BS, SIGLIP_QUERIES, 1024), ("13 queries", VAT_BS, VAT_B_QUERIES, 1024))
VLA_ENTRIES = ("SigLIPVAT", "VAT_B")  # the flash shapes a model path launches: entries of the kernels line
VLA_EDGE_KEYS = {1023: {}, 1024: {"short_attention": 1}, 1025: {"flash_fwd": 1}}
VLA_SLACK = 128  # a flash_fwd block's query rows: rows past n (lse values past the last pair) no launch may write
# The padded-row mutant: flash_fwd writing the lse of its last query tile's
# rows past n (the row guard dropped), into the next pair's rows and past the
# tensor; phase 45's slack check must refuse it
VLA_MUTANT = (
    "flash_attention.cu",
    "    if (row_lo < a.n) lse[row_lo] = l0 == 0.f ? kNegInf : m0 + logf(l0);\n"
    "    if (row_lo + 8 < a.n) lse[row_lo + 8] = l1 == 0.f ? kNegInf : m1 + logf(l1);\n",
    "    lse[row_lo] = l0 == 0.f ? kNegInf : m0 + logf(l0);\n"
    "    lse[row_lo + 8] = l1 == 0.f ? kNegInf : m1 + logf(l1);\n",
)
# SigLIPVAT at depth 27 in bf16 from random weights may be chaotic, as NaViT-B
# is (phase 13): its pred_action is held to the noise floor measured in the
# run (VLA_NOISE_RATIO, VLA_INPUT_NOISE); the depth-2 full-width copy to
# fixed bounds; each first training step's loss and gradients to the fp32
# floor of phase 41 (SSL_FLOOR_RATIO x plain bf16's distance from fp32), and
# against plain bf16 within VLA_NOISE_RATIO x that distance
VLA_NOISE_RATIO, VLA_INPUT_NOISE = 1.5, 1e-3
SIGLIP_SHALLOW_VS_PLAIN, SIGLIP_SHALLOW_VS_FP32 = 2e-2, 5e-2
# the spectrogram on the card (cuFFT) against the CPU's, both f32: only the
# FFT's summation order differs
SPEC_REL_L2, SPEC_ATOL_FRAC = 1e-5, 1e-5
# the Recorder's maps: the recording path (the bf16 composite) against the
# maps of the plain chain's layer inputs and against fp32
RECORDER_VS_PLAIN, RECORDER_VS_FP32 = 2e-2, 5e-2


def vla_qkv(gen, dev, b, n, m, heads=VLA_HEADS):
    """q (b, heads, n, 64) and k, v (b, heads, m, 64) bf16, N(0, 1), in the
    layouts the VLA cross-attention hands the kernels: q a view of its to_q
    output (b, n, heads * 64), k and v the halves of its to_kv output."""
    inner = heads * DH
    q = torch.randn(b, n, inner, generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn(b, m, 2 * inner, generator=gen, device=dev).to(torch.bfloat16)
    split = lambda t: t.reshape(b, t.shape[1], heads, DH).transpose(1, 2)
    return split(q), *(split(t) for t in kv.chunk(2, dim=-1))


def flash_fwd_into(fa, q, k, v, o, lse):
    """flash_fwd's launch writing into the caller's o (a (b, h, n, 64) view
    with the kernels' strides) and lse (b * h * n f32 values at its start):
    the slack around them shows what a launch writes past n."""
    from vit_pytorch_tpu_torch.ops._build import load_library

    b, h, n, d = q.shape
    lib = load_library()
    err = lib.lib.vit_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), None, None, None, None, None, 0,
        b, h, n, k.shape[2], d, DH**-0.5, 0, *fa._dropout("flash_fwd", 0.0, None, h),
        fa._strides(q, k, v, None, o, None), torch.cuda.current_stream().cuda_stream)
    lib.check("flash_fwd", err)


def slack_writes(fa, q, k, v):
    """(o, lse, rows past n written): flash_fwd into an o with VLA_SLACK rows
    past n an image and an lse with VLA_SLACK values past its end, all
    filled with NaN first; a right launch leaves every one of them NaN."""
    b, h, n, _ = q.shape
    o_buf = torch.full((b, n + VLA_SLACK, h, DH), float("nan"), dtype=torch.bfloat16, device=q.device)
    lse_buf = torch.full((b * h * n + VLA_SLACK,), float("nan"), dtype=torch.float32, device=q.device)
    o = o_buf[:, :n].transpose(1, 2)
    flash_fwd_into(fa, q, k, v, o, lse_buf)
    sync()
    written = int((~o_buf[:, n:].isnan()).any(-1).any(-1).sum()) + int((~lse_buf[b * h * n:].isnan()).sum())
    return o, lse_buf[: b * h * n].view(b, h, n), written


def start_padded_row_mutant():
    """Copy csrc/ under build/mutants/, make VLA_MUTANT's edit and build its
    library in a thread (only flash_attention.cu compiles: the other objects
    are shared), while the phases before 45 run.  Returns the dict the
    thread fills with ``lib`` (or ``error``) and the thread."""
    import shutil
    import threading
    from vit_pytorch_tpu_torch.ops import _build

    d = _build.build_dir() / "mutants" / "vla-padded-rows"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, d)
    fname, old, new = VLA_MUTANT
    text = (d / fname).read_text()
    if text.count(old) != 1:
        fail(f"the padded-row mutant's text occurs {text.count(old)} times in {fname}")
    (d / fname).write_text(text.replace(old, new))
    out = {}

    def build():
        try:
            out["lib"] = _build.build_library(d)
        except Exception as e:  # reported in phase 45
            out["error"] = e

    out["thread"] = threading.Thread(target=build, daemon=True)
    out["thread"].start()
    return out


def check_vla_kernels(fb, fa, dev, mutant):
    """Phase 45: flash_fwd (o, lse), flash_bwd_dq and flash_bwd_dkv (twice,
    bitwise) against their twins at the VLA shapes, the short kernel too;
    the Functions against autograd through the f32 composite; no launch
    writes a row past n (the padded rows of the last query tile) and the
    padded-row mutant is refused; the dispatcher's route at 1,023, 1,024 and
    1,025 keys.  Returns the largest max_abs of each kernel entry."""
    from vit_pytorch_tpu_torch.ops import _build
    from vit_pytorch_tpu_torch.ops import short_attention as sa
    from vit_pytorch_tpu_torch.ops.attention import dot_product_attention, xla_attention

    log(f"[45 VLA attention kernels] bf16, {VLA_HEADS} heads of {DH}: flash at (b, n, m) = "
        f"{[case[1:] for case in VLA_FLASH]}, short at {[case[1:] for case in VLA_SHORT]}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 45)
    scale = DH**-0.5
    errs = {}
    for label, b, n, m in VLA_FLASH:
        q, k, v = vla_qkv(gen, dev, b, n, m)
        do = torch.randn(b, VLA_HEADS, n, DH, generator=gen, device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, scale=scale)
            o_want, lse_want = fa.flash_fwd_reference(q, k, v, scale=scale)
            e = {"flash_fwd": compare(f"flash_fwd o [{label}]", o, o_want, ATTN_ATOL, ATTN_RTOL)}
            e["flash_fwd"] = max(e["flash_fwd"], compare(f"flash_fwd lse [{label}]", lse, lse_want, FLASH_LSE_ATOL,
                                                         FLASH_LSE_RTOL, F32_REL_L2))
            o_s, lse_s, written = slack_writes(fa, q, k, v)
            same = torch.equal(o_s, o) and torch.equal(lse_s, lse)
            log(f"  flash_fwd [{label}]: {n} queries in {-(-n // 64)} tile(s), {-n % 64} padded rows; rows and lse "
                f"values written past n into the NaN slack: {written}; o and lse bitwise the wrapper's: {same}")
            if written or not same:
                fail(f"flash_fwd [{label}] wrote past n, or into its caller's buffers otherwise than the wrapper")
            delta = (do.float() * o.float()).sum(-1)
            dq, dk, dv = flash_bwd_twice(fa, label, q, k, v, do, lse, delta, scale=scale)
            want = fa.flash_bwd_reference(q, k, v, do, lse, delta, scale=scale)
            for kernel, part, got, w in (("flash_bwd_dq", "dq", dq, want[0]), ("flash_bwd_dkv", "dk", dk, want[1]),
                                         ("flash_bwd_dkv", "dv", dv, want[2])):
                e[kernel] = max(e.get(kernel, 0.0), compare(f"{kernel} {part} [{label}]", got, w, None, ATTN_RTOL,
                                                            atol_frac=BWD_ATOL_FRAC))
        errs.update({f"{kernel} @ {label}": err for kernel, err in e.items()})
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves)
        got = (out, *torch.autograd.grad(out, leaves, do))
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        out_ref = fa.flash_attention_reference(*ref)
        for part, a, w in zip(("o", "dq", "dk", "dv"), got, (out_ref, *torch.autograd.grad(out_ref, ref, do.float()))):
            compare(f"flash_attention {part} vs f32 composite [{label}]", a, w, None, ATTN_RTOL, FLASH_VS_F32_REL_L2,
                    atol_frac=FLASH_VS_F32_ATOL_FRAC)
        if label == VLA_FLASH[0][0]:
            mutant_case = (q, k, v, o, lse)
        sync()

    for label, b, n, m in VLA_SHORT:
        q, k, v = vla_qkv(gen, dev, b, n, m)
        do = torch.randn(b, VLA_HEADS, n, DH, generator=gen, device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            e = compare(f"short_attention [{label}]", sa.short_fwd(q, k, v, scale=scale),
                        sa.short_attention_reference(q, k, v, scale=scale), ATTN_ATOL, ATTN_RTOL)
        errs[f"short_attention @ {label}"] = e
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = sa.short_attention(*leaves)
        got = (out, *torch.autograd.grad(out, leaves, do))
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        out_ref = xla_attention(*ref)
        for part, a, w in zip(("o", "dq", "dk", "dv"), got, (out_ref, *torch.autograd.grad(out_ref, ref, do.float()))):
            compare(f"short_attention {part} vs f32 composite [{label}]", a, w, None, ATTN_RTOL, FLASH_VS_F32_REL_L2,
                    atol_frac=FLASH_VS_F32_ATOL_FRAC)
        sync()

    # the dispatcher at the edge of the routes, 54 queries (JAX attention.py:235-288)
    for m, want in VLA_EDGE_KEYS.items():
        q, k, v = vla_qkv(gen, dev, SIGLIP_BS, SIGLIP_QUERIES, m)
        reset_all(fb, fa)
        with torch.inference_mode():
            out = dot_product_attention(q, k, v)
        sync()
        expect_launches(fb, fa, want, f"dot_product_attention at {m} keys")
        e = rel_l2(out, xla_attention(q.float(), k.float(), v.float()))
        log(f"  dot_product_attention at {m} keys: {'the composite' if not want else next(iter(want))}; rel L2 vs the "
            f"f32 composite {e:.3e} (bound {FLASH_VS_F32_REL_L2})")
        if not e <= FLASH_VS_F32_REL_L2:
            fail(f"dot_product_attention at {m} keys disagrees with the f32 composite")

    # the padded-row mutant, built in a thread since phase 2
    t0 = time.perf_counter()
    mutant["thread"].join()
    if "error" in mutant:
        fail(f"the padded-row mutant did not build: {mutant['error']}")
    log(f"  padded-row mutant ({VLA_MUTANT[0]}: flash_fwd's lse written for the rows past n): built in a thread, "
        f"waited {time.perf_counter() - t0:.2f} s for it")
    q, k, v, o, lse = mutant_case
    saved = _build._library
    _build._library = mutant["lib"]
    try:
        with torch.inference_mode():
            o_m, lse_m, written = slack_writes(fa, q, k, v)
    finally:
        _build._library = saved
    rows_ok = torch.equal(o_m, o) and torch.equal(lse_m, lse)
    log(f"  mutant at [{VLA_FLASH[0][0]}]: values written past n into the slack {written}; o and lse of the rows "
        f"below n (which it may overwrite racing the next pair's block) bitwise the right kernel's: {rows_ok}; "
        f"{'refused' if written else 'NOT REFUSED'}")
    if not written:
        fail("the padded-row mutant passes phase 45's slack check")
    sync()
    return errs


def siglip_vat(dev, dtype, views, **kw):
    """SigLIPVAT at SIGLIP_VAT's widths for ``views`` = (views, frames),
    random weights from SEED, initialised in f32 and cast."""
    from vit_pytorch_tpu_torch.ssl.vat_siglip import SigLIPVAT

    v, t = views
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return SigLIPVAT(num_views=v, time_seq_len=t, device=dev, generator=gen, **kw).to(dtype)


def siglip_images(dev, b, views, seed):
    v, t = views
    return torch.randn(b, v, 3, t, 224, 224, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


@contextlib.contextmanager
def plain_attention():
    """Every kernel route of the dispatcher through its plain twin (the
    flash and short Functions on their twins)."""
    with plain_flash(), plain_short():
        yield


def floor_check(what, kernel, plain, fp32, plain_noisy):
    """The noise floor of phase 13: the kernel path within VLA_NOISE_RATIO of
    plain bf16's distance from fp32, and within it of plain bf16's distance
    from itself on the input with VLA_INPUT_NOISE relative noise."""
    e_kf, e_pf, e_kp, floor = (rel_l2(kernel, fp32), rel_l2(plain, fp32), rel_l2(kernel, plain),
                               rel_l2(plain_noisy, plain))
    ok = (e_kf <= VLA_NOISE_RATIO * e_pf and e_kp <= VLA_NOISE_RATIO * floor
          and bool(torch.isfinite(kernel).all()))
    log(f"  {what}, rel L2: kernel vs fp32 {e_kf:.4e} (bound {VLA_NOISE_RATIO} x plain bf16 vs fp32, {e_pf:.4e}); "
        f"kernel vs plain bf16 {e_kp:.4e} (bound {VLA_NOISE_RATIO} x plain bf16 vs plain bf16 with "
        f"{VLA_INPUT_NOISE} relative noise on the input, {floor:.4e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{what}: the kernel path is off the bf16 noise floor")


def vla_step_paths(fb, fa, label, fp32, run, want):
    """One training step of ``run(model, dtype)`` (the loss) on a bf16 copy
    of ``fp32`` through the kernels (exact counters ``want``), on another
    through the plain twins (no launch), and in fp32; the three paths'
    losses and gradients as ssl_paths gives them, and the kernel model."""
    bf16 = torch.bfloat16
    model = copy.deepcopy(fp32).to(bf16)
    plain = copy.deepcopy(model)
    reset_all(fb, fa)
    loss = run(model, bf16)
    loss.backward()
    sync()
    counts = expect_launches(fb, fa, want, label)
    reset_all(fb, fa)
    with plain_attention():
        loss_plain = run(plain, bf16)
        loss_plain.backward()
    sync()
    expect_launches(fb, fa, {}, f"the plain path of the {label}")
    loss32 = run(fp32, torch.float32)
    loss32.backward()
    sync()
    paths = {}
    for key, m, lo in (("kernel", model, loss), ("plain", plain, loss_plain), ("fp32", fp32, loss32)):
        names, grads = trained_grads(m)
        paths[key] = dict(model=m, loss=lo.item(), loss_dtype=lo.dtype, names=names, grads=grads)
        if key != "kernel":
            m.zero_grad(set_to_none=True)
    if not paths["kernel"]["names"] == paths["plain"]["names"] == paths["fp32"]["names"]:
        fail(f"{label}: the paths differ in which parameters have gradients")
    paths["counts"] = counts
    del plain
    return paths


def compare_plain_step(name, paths, ratio=VLA_NOISE_RATIO):
    """The first step's loss and gradients, the kernel path against plain
    bf16, within ``ratio`` times plain bf16's own distance from fp32 (the
    step's bf16 noise; the loss's at least SSL_LOSS_FLOOR)."""
    k, p, f = paths["kernel"], paths["plain"], paths["fp32"]
    rel = lambda a, b: abs(a - b) / abs(b)
    d_kp, d_pf = rel(k["loss"], p["loss"]), rel(p["loss"], f["loss"])
    g_kp, g_pf = grads_rel_l2(k["grads"], p["grads"]), grads_rel_l2(p["grads"], f["grads"])
    ok = d_kp <= ratio * max(d_pf, SSL_LOSS_FLOOR) and g_kp <= ratio * g_pf
    log(f"  {name} vs plain bf16 (bound {ratio} x plain bf16 vs fp32): loss rel {d_kp:.3e} (plain vs fp32 {d_pf:.3e}); "
        f"grads rel L2 {g_kp:.4e} (plain vs fp32 {g_pf:.4e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name}: the kernel path's step is further from plain bf16 than the bf16 noise")


def adamw_steps(fb, fa, label, model, run, steps, want):
    """``steps`` AdamW(1e-4) steps of ``run(model)`` (its loss), each with
    the exact counters ``want``; the losses, all finite."""
    opt = torch.optim.AdamW(model.parameters(), lr=SIGLIP_LR, weight_decay=1e-4)  # optax.adamw(1e-4)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        reset_all(fb, fa)
        loss = run(model)
        loss.backward()
        opt.step()
        sync()
        expect_launches(fb, fa, want, f"{label} AdamW step")
        losses.append(loss.item())
    log(f"  {label}: AdamW(lr={SIGLIP_LR}) steps, losses {[f'{v:.6f}' for v in losses]}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"the {label} loss is not finite")
    return opt


def hf_siglip_from(tower):
    """The HF SigLIP vision tower's tensors (``vision_model.`` names) of a
    port SigLIP: the inverse of load_siglip's remap, at the tower's shapes."""
    sd = {k: v.detach().float() for k, v in tower.state_dict().items()}
    p, d = tower.patch_size, tower.dim
    hf = {
        "embeddings.patch_embedding.weight": sd["patch_embed.weight"].reshape(d, p, p, 3).permute(0, 3, 1, 2),
        "embeddings.patch_embedding.bias": sd["patch_embed.bias"],
        "embeddings.position_embedding.weight": sd["pos_embed"],
        "post_layernorm.weight": sd["norm.weight"], "post_layernorm.bias": sd["norm.bias"],
    }
    for i in range(len(tower.layers)):
        pre, attn, ff = f"encoder.layers.{i}", f"layers.{i}.0", f"layers.{i}.1"
        for leaf in ("weight", "bias"):
            k_, v_ = sd[f"{attn}.to_kv.{leaf}"].chunk(2)
            hf.update({f"{pre}.layer_norm1.{leaf}": sd[f"{attn}.norm.{leaf}"],
                       f"{pre}.self_attn.q_proj.{leaf}": sd[f"{attn}.to_q.{leaf}"],
                       f"{pre}.self_attn.k_proj.{leaf}": k_, f"{pre}.self_attn.v_proj.{leaf}": v_,
                       f"{pre}.self_attn.out_proj.{leaf}": sd[f"{attn}.to_out.{leaf}"],
                       f"{pre}.layer_norm2.{leaf}": sd[f"{ff}.norm.{leaf}"],
                       f"{pre}.mlp.fc1.{leaf}": sd[f"{ff}.fc1.{leaf}"], f"{pre}.mlp.fc2.{leaf}": sd[f"{ff}.fc2.{leaf}"]})
    return {f"vision_model.{k}": v for k, v in hf.items()}


def check_siglip_vat(fb, fa, dev):
    """Phase 46: SigLIPVAT at full width.  Served behind a Predictor at (3,
    2) (exact counters: SIGLIP_DEPTH flash_fwd a bucket run), pred_action
    against the plain bf16 path and fp32 on the noise floor, the depth-2
    copy to fixed bounds; (2, 2) on the short kernel and (3, 1) on the
    composite; a training step against plain bf16 and fp32, AdamW steps
    (exact counters), a step with freeze_vit, and load_siglip on an HF dict
    of the tower.  Returns the counts of a (2, 2) forward, and the state
    phase 48 times with the counts of the first training step."""
    from vit_pytorch_tpu_torch.serving import Predictor
    from vit_pytorch_tpu_torch.ssl.vat_siglip import SigLIP, load_siglip

    bf16 = torch.bfloat16
    views = SIGLIP_VIEWS["flash"]
    log(f"[46 SigLIPVAT] the reference's defaults (pi0's action head on SigLIP so400m/14 @224), depth "
        f"{SIGLIP_DEPTH}, bf16, random weights (seed {SEED}); views x frames {views}: {SIGLIP_QUERIES} queries "
        f"against {views[0] * views[1] * 256} keys a layer")
    fp32 = siglip_vat(dev, torch.float32, views).eval()
    n_params = sum(p.numel() for p in fp32.parameters())
    log(f"  parameters: {n_params / 1e6:.1f} M, the tower {sum(p.numel() for p in fp32.vit.parameters()) / 1e6:.1f} M")
    x = siglip_images(dev, SIGLIP_BS, views, SEED + 46)
    noise = 1 + VLA_INPUT_NOISE * torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(SEED + 146),
                                              device=dev)
    pred = Predictor(fp32, example_shape=x.shape[1:], batch_sizes=SIGLIP_BUCKETS, device=dev).warmup()
    served = pred.model
    reset_all(fb, fa)
    outs = {k: pred(x[:k]) for k in SIGLIP_BUCKETS}
    sync()
    expect_launches(fb, fa, {"flash_fwd": SIGLIP_DEPTH * len(SIGLIP_BUCKETS)},
                    f"SigLIPVAT serving, requests {SIGLIP_BUCKETS} ({SIGLIP_DEPTH} flash_fwd a bucket run)")
    for k, out in outs.items():
        if out.shape != (k, 50, 32) or not bool(torch.isfinite(out).all()):
            fail(f"SigLIPVAT request of {k}: pred_action {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    with torch.inference_mode():
        with plain_attention():
            plain = served(x.to(bf16))
            plain_noisy = served((x * noise).to(bf16))
        want = fp32(x)
    floor_check(f"pred_action of the {SIGLIP_BS}-request at depth {SIGLIP_DEPTH}", outs[SIGLIP_BS], plain, want,
                plain_noisy)
    del pred, served, outs, plain, plain_noisy, want

    shallow32 = siglip_vat(dev, torch.float32, views, depth=SIGLIP_SHALLOW, siglip_depth=SIGLIP_SHALLOW).eval()
    shallow = copy.deepcopy(shallow32).to(bf16)
    short32 = siglip_vat(dev, torch.float32, SIGLIP_VIEWS["short"]).eval()
    routes = {"short": copy.deepcopy(short32).to(bf16), "composite": siglip_vat(dev, bf16, SIGLIP_VIEWS["composite"])}
    with torch.inference_mode():
        reset_all(fb, fa)
        got = shallow(x.to(bf16))
        sync()
        expect_launches(fb, fa, {"flash_fwd": SIGLIP_SHALLOW}, f"SigLIPVAT at depth {SIGLIP_SHALLOW}")
        with plain_attention():
            plain = shallow(x.to(bf16))
        e_kp, e_kf, e_pf = rel_l2(got, plain), rel_l2(got, shallow32(x)), rel_l2(plain, shallow32(x))
        ok = e_kp <= SIGLIP_SHALLOW_VS_PLAIN and e_kf <= SIGLIP_SHALLOW_VS_FP32
        log(f"  depth {SIGLIP_SHALLOW} at full width, pred_action rel L2: kernel vs plain bf16 {e_kp:.4e} (bound "
            f"{SIGLIP_SHALLOW_VS_PLAIN}), vs fp32 {e_kf:.4e} (bound {SIGLIP_SHALLOW_VS_FP32}; plain bf16 vs fp32 "
            f"{e_pf:.4e}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"SigLIPVAT at depth {SIGLIP_SHALLOW} disagrees with the plain path or fp32")
        del shallow32, shallow

        short_counts = None
        for route, model in routes.items():
            v_ = SIGLIP_VIEWS[route]
            xs = siglip_images(dev, SIGLIP_BS, v_, SEED + 246)
            reset_all(fb, fa)
            got = model.eval()(xs.to(bf16))
            sync()
            counts = expect_launches(fb, fa, {"short_attention": SIGLIP_DEPTH} if route == "short" else {},
                                     f"SigLIPVAT at {v_} ({v_[0] * v_[1] * 256} keys): the {route} route")
            if route == "short":
                short_counts = counts
                with plain_attention():
                    plain, plain_noisy = model(xs.to(bf16)), model((xs * noise[:, : v_[0], :, : v_[1]]).to(bf16))
                floor_check(f"{v_}: pred_action at depth {SIGLIP_DEPTH}", got, plain, short32(xs), plain_noisy)
            if not bool(torch.isfinite(got).all()):
                fail(f"SigLIPVAT at {v_}: pred_action is not finite")
            del model, xs
    del routes, short32

    # training at (3, 2)
    actions = torch.randn(SIGLIP_BS, 50, 32, generator=torch.Generator(device=dev).manual_seed(SEED + 346), device=dev)
    fp32.train()
    run = lambda m, dtype: m(x.to(dtype), actions=actions.to(dtype))
    want_step = {name: SIGLIP_DEPTH for name in TPU_FLASH}
    paths = vla_step_paths(fb, fa, "SigLIPVAT training step", fp32, run, want_step)
    log(f"  the fp32 gradients at full depth ({SIGLIP_DEPTH}), full width, bs={SIGLIP_BS}")
    compare_floor("SigLIPVAT step", paths)
    compare_plain_step("SigLIPVAT step", paths)
    model, step_counts = paths["kernel"]["model"], paths["counts"]
    del paths, fp32
    model.zero_grad(set_to_none=True)
    opt = adamw_steps(fb, fa, "SigLIPVAT", model, lambda m: run(m, bf16), SIGLIP_STEPS, want_step)
    opt.zero_grad(set_to_none=True)
    reset_all(fb, fa)
    loss = model(x.to(bf16), actions=actions.to(bf16), freeze_vit=True)
    loss.backward()
    sync()
    expect_launches(fb, fa, want_step, "SigLIPVAT step with freeze_vit")
    tower_grads = sum(p.grad is not None for p in model.vit.parameters())
    head_grads = sum(p.grad is not None for p in model.parameters()) - tower_grads
    log(f"  freeze_vit step: loss {loss.item():.6f}; tower parameters with a gradient {tower_grads}, others {head_grads}")
    if tower_grads or not head_grads or not math.isfinite(loss.item()):
        fail("SigLIPVAT with freeze_vit: the tower got a gradient, or the head none")
    model.zero_grad(set_to_none=True)

    mv = model.vit
    tower = SigLIP(image_size=math.isqrt(mv.pos_embed.shape[0]) * mv.patch_size, patch_size=mv.patch_size, dim=mv.dim,
                   depth=len(mv.layers), heads=mv.layers[0][0].heads, mlp_dim=mv.layers[0][1].fc1.out_features,
                   device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 1)).to(bf16)
    with torch.inference_mode():
        hf = hf_siglip_from(mv)
        shapes = {k: tuple(v.shape) for k, v in hf.items() if "layers.0." in k or "embeddings" in k}
        tower.load_state_dict(load_siglip(hf, depth=len(mv.layers)))
        xi = x[:2, 0, :, 0].to(bf16)
        same = torch.equal(tower(xi), mv(xi))
    log(f"  load_siglip on an HF dict of the tower ({len(hf)} tensors; {shapes}): the loaded tower's tokens "
        f"bitwise the module's: {same}")
    if not same:
        fail("load_siglip: the loaded tower disagrees with the module it was read from")
    del hf, tower, mv
    sync()
    return short_counts, dict(model=model, opt=opt, x=x.to(bf16), actions=actions.to(bf16), step_counts=step_counts)


def vat_b_model(dev, dtype, audio=False):
    """VAT_B (or VAAT_B with ``audio``), random weights from SEED,
    initialised in f32 and cast."""
    from vit_pytorch_tpu_torch.ssl.vaat import AST, VAAT
    from vit_pytorch_tpu_torch.ssl.vat import VAT, ViT

    gen = torch.Generator(device=dev).manual_seed(SEED)
    vit = ViT(**VAT_B_VIT, device=dev, generator=gen)
    if audio:
        ast = AST(**VAAT_B_AST, device=dev, generator=gen)
        model = VAAT(vit=vit, ast=ast, num_image_views=VAT_B_VIEWS, **VAT_B, device=dev, generator=gen)
    else:
        model = VAT(vit=vit, num_views=VAT_B_VIEWS, **VAT_B, device=dev, generator=gen)
    return model.to(dtype)


def vat_b_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(SEED + 47)
    return dict(
        images=torch.randn(VAT_BS, VAT_B_VIEWS, 3, VAT_B["time_seq_len"], 224, 224, generator=g, device=dev),
        audio=torch.rand(VAT_BS, AUDIO_SAMPLES, generator=g, device=dev) * 2 - 1,
        tasks=torch.randint(0, VAT_B["num_tasks"], (VAT_BS,), generator=g, device=dev),
        advantages=torch.randint(0, VAT_B["num_advantage_bins"], (VAT_BS,), generator=g, device=dev),
        extra=torch.randn(VAT_BS, VAT_B["dim_extra_token"], generator=g, device=dev),
        actions=torch.randn(VAT_BS, 7, VAT_B["dim_action"], generator=g, device=dev),
    )


def vat_b_run(inputs, audio):
    """``run(model, dtype, actions=True)``: VAT_B's (VAAT_B's) call on the
    inputs cast to ``dtype``, the loss with ``actions``."""
    def run(model, dtype, actions=True):
        cast = lambda t: t.to(dtype)
        kw = dict(tasks=inputs["tasks"], advantages=inputs["advantages"], extra=cast(inputs["extra"]))
        if actions:
            kw["actions"] = cast(inputs["actions"])
        media = (cast(inputs["images"]), cast(inputs["audio"])) if audio else (cast(inputs["images"]),)
        return model(*media, **kw)
    return run


def check_vat_wrappers(fb, fa, dev):
    """Phase 47: VAT_B and VAAT_B served at bs=VAT_BS (exact counters: 12
    flash_fwd a forward) and trained VAT_STEPS steps (the first against
    plain bf16 and fp32), the spectrogram on the card against the CPU's, and
    the wrappers on ViT-B/16: Recorder (no launch; maps and preds against
    plain bf16 and fp32; the chain again after eject), Extractor (the
    chain's counters; the embeddings bitwise the transformer's output) and
    AcceptVideoWrapper (16 frames through the chain).  Returns VAT_B's
    training-step counts and the state phase 48 times."""
    from vit_pytorch_tpu_torch.ops.spectrogram import spectrogram
    from vit_pytorch_tpu_torch.wrappers.accept_video_wrapper import AcceptVideoWrapper
    from vit_pytorch_tpu_torch.wrappers.extractor import Extractor
    from vit_pytorch_tpu_torch.wrappers.recorder import Recorder

    bf16 = torch.bfloat16
    log(f"[47 VAT_B, VAAT_B and the wrappers] VAT_B: the VAT ViT {VAT_B_VIT}, VAT {VAT_B}, {VAT_B_VIEWS} views; VAAT_B "
        f"adds an AST {VAAT_B_AST} on {AUDIO_SAMPLES} samples; bf16, random weights (seed {SEED}), bs={VAT_BS}: "
        f"{VAT_B_QUERIES} queries against {VAT_B_KEYS} image keys a layer")
    inputs = vat_b_inputs(dev)
    with torch.inference_mode():
        spec = spectrogram(inputs["audio"])
        spec_cpu = spectrogram(inputs["audio"].cpu())
    compare("spectrogram (cuFFT) vs the CPU's (f32)", spec.cpu(), spec_cpu, None, 0.0, SPEC_REL_L2,
            atol_frac=SPEC_ATOL_FRAC)
    log(f"  spectrogram {tuple(spec.shape)}, cropped to the patch grid: {spec.shape[1] // 16 * 16} x "
        f"{spec.shape[2] // 16 * 16}")
    state, step_counts = {}, None
    want_step = {name: DEPTH for name in TPU_FLASH}
    for label, audio in (("VAT_B", False), ("VAAT_B", True)):
        run = vat_b_run(inputs, audio)
        fp32 = vat_b_model(dev, torch.float32, audio).eval()
        model = copy.deepcopy(fp32).to(bf16)
        noisy = dict(inputs, images=inputs["images"] * (1 + VLA_INPUT_NOISE * torch.randn(
            inputs["images"].shape, generator=torch.Generator(device=dev).manual_seed(SEED + 147), device=dev)))
        with torch.inference_mode():
            reset_all(fb, fa)
            got = run(model, bf16, actions=False)
            sync()
            expect_launches(fb, fa, {"flash_fwd": DEPTH}, f"{label} serving ({DEPTH} flash_fwd a forward)")
            with plain_attention():
                plain = run(model, bf16, actions=False)
                plain_noisy = vat_b_run(noisy, audio)(model, bf16, actions=False)
            floor_check(f"{label} pred_action at bs={VAT_BS}", got, plain, run(fp32, torch.float32, actions=False),
                        plain_noisy)
        del model
        fp32.train()
        paths = vla_step_paths(fb, fa, f"{label} training step", fp32, run, want_step)
        compare_floor(f"{label} step", paths)
        compare_plain_step(f"{label} step", paths)
        if not audio:
            step_counts = paths["counts"]
        model = paths["kernel"]["model"]
        del paths, fp32
        model.zero_grad(set_to_none=True)
        opt = adamw_steps(fb, fa, label, model, lambda m, run=run: run(m, bf16), VAT_STEPS - 1, want_step)
        state[label] = (model, opt, run)
        sync()

    log(f"  the wrappers on ViT-B/16 @224 (phase 4's configuration), bs={B_CHECK}")
    chain = {name: DEPTH * LAUNCHES_PER_LAYER.get(name, 0) for name in fb.LAUNCHES}
    fp32 = vit_b(dev, torch.float32).eval()
    model = copy.deepcopy(fp32).to(bf16)
    img = torch.randn(B_CHECK, 3, 224, 224, generator=torch.Generator(device=dev).manual_seed(SEED + 247), device=dev)
    tr = model.transformer
    wrapper = AcceptVideoWrapper(model, add_time_pos_emb=True, dim_emb=1000, time_seq_len=8, device=dev, dtype=bf16,
                                 generator=torch.Generator(device=dev).manual_seed(SEED))
    with torch.inference_mode():
        rec = Recorder(model)
        reset_all(fb, fa)
        preds, attns = rec(img.to(bf16))
        sync()
        expect_launches(fb, fa, {}, "Recorder(ViT-B/16): recording takes the composite")
        if attns.shape != (B_CHECK, DEPTH, HEADS, N, N):
            fail(f"Recorder: attns {tuple(attns.shape)}")
        # the plain bf16 path: the chain of twins, and each layer's map from its input
        x = model.embed(img.to(bf16))
        maps = []
        for i in range(DEPTH):
            ws, kws = tr.layer_weights(i, bf16)
            h = torch.nn.functional.layer_norm(x, (DIM,), ws[2], ws[3], 1e-5)
            q, k, _ = torch.nn.functional.linear(h, ws[0]).view(B_CHECK, N, 3, HEADS, DH).permute(2, 0, 3, 1, 4)
            maps.append(torch.softmax((torch.matmul(q, k.transpose(-1, -2)) * DH**-0.5).float(), -1).to(bf16))
            x = fb.layer_reference(x, *ws, heads=HEADS, dim_head=DH, **kws)
        plain_preds = model.mlp_head(tr.norm(x)[:, 0])
        preds32, attns32 = Recorder(fp32)(img)
        e_ap, e_af = rel_l2(attns, torch.stack(maps, dim=1)), rel_l2(attns, attns32)
        e_pp, e_pf = rel_l2(preds, plain_preds), rel_l2(preds, preds32)
        ok = (e_ap <= RECORDER_VS_PLAIN and e_af <= RECORDER_VS_FP32 and e_pp <= LOGITS_VS_PLAIN_BF16
              and e_pf <= LOGITS_VS_FP32)
        log(f"  Recorder: attns {tuple(attns.shape)} rel L2 vs the plain chain's maps {e_ap:.4e} (bound "
            f"{RECORDER_VS_PLAIN}), vs fp32 {e_af:.4e} (bound {RECORDER_VS_FP32}); preds vs plain bf16 {e_pp:.4e} "
            f"(bound {LOGITS_VS_PLAIN_BF16}), vs fp32 {e_pf:.4e} (bound {LOGITS_VS_FP32}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("Recorder: the maps or preds disagree with the plain path or fp32")
        del maps, attns, attns32
        reset_all(fb, fa)
        rec.eject()(img.to(bf16))
        sync()
        expect_launches(fb, fa, chain, f"ViT-B/16 after eject ({DEPTH} x 7 launches)")

        seen = []
        handle = tr.register_forward_hook(lambda m, a, out: seen.append(out))
        reset_all(fb, fa)
        _, emb = Extractor(model)(img.to(bf16))
        sync()
        handle.remove()
        expect_launches(fb, fa, chain, f"Extractor(ViT-B/16) ({DEPTH} x 7 launches)")
        same = torch.equal(emb, seen[0])
        log(f"  Extractor: embeddings {tuple(emb.shape)} bitwise the transformer's output of the call: {same}")
        if not same:
            fail("Extractor: the embeddings are not the transformer's output")

        video = torch.randn(2, 3, 8, 224, 224, generator=torch.Generator(device=dev).manual_seed(SEED + 347),
                            device=dev).to(bf16)
        reset_all(fb, fa)
        out = wrapper(video)
        sync()
        expect_launches(fb, fa, chain, f"AcceptVideoWrapper(ViT-B/16): 16 frames in one call ({DEPTH} x 7 launches)")
        with plain_layers():
            plain = wrapper(video)
        e = rel_l2(out, plain)
        log(f"  AcceptVideoWrapper: out {tuple(out.shape)}, rel L2 vs plain bf16 {e:.4e} (bound "
            f"{LOGITS_VS_PLAIN_BF16})")
        if out.shape != (2, 8, 1000) or not e <= LOGITS_VS_PLAIN_BF16:
            fail("AcceptVideoWrapper disagrees with the plain path")
    del fp32, model, wrapper
    sync()
    return step_counts, state


def time_vla(fa, dev, smi, siglip, vat):
    """Phase 48: SigLIPVAT at (3, 2), bs=8: ms a batch served and ms/step
    trained with peak memory, kernel and plain paths in turns (K P P K), the
    busy share of one profiled step; each flash kernel and the short kernel
    at phase 45's shapes against its twin, its bound and the library call;
    VAT_B's and VAAT_B's ms/step.  Returns the kernels-line records."""
    from vit_pytorch_tpu_torch.ops import short_attention as sa

    log(f"[48 VLA timing] {smi}")
    model, opt, x, actions = siglip["model"], siglip["opt"], siglip["x"], siglip["actions"]

    def plain(fn):
        def run():
            with plain_attention():
                fn()
        return run

    model.eval()
    with torch.inference_mode():
        serve = lambda: model(x)
        k1, p1, p2, k2 = (host_ms(f, 5) for f in (serve, plain(serve), plain(serve), serve))
    log(f"  SigLIPVAT serving at bs={SIGLIP_BS}, (3, 2): kernel path {(k1 + k2) / 2:.3f} ms/batch, plain bf16 path "
        f"{(p1 + p2) / 2:.3f} ms/batch; turns ms kernel {k1:.3f} plain {p1:.3f} plain {p2:.3f} kernel {k2:.3f}")
    model.train()

    def step():
        opt.zero_grad(set_to_none=True)
        model(x, actions=actions).backward()
        opt.step()

    (k1, km1), (p1, pm1), (p2, pm2), (k2, km2) = (train_step_ms(dev, f) for f in (step, plain(step), plain(step), step))
    log(f"  SigLIPVAT training at bs={SIGLIP_BS}: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path "
        f"{(p1 + p2) / 2:.3f} ms/step; turns ms kernel {k1:.3f} plain {p1:.3f} plain {p2:.3f} kernel {k2:.3f}; peak "
        f"device memory kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
    busy = profiled_busy(step)
    log("  one profiled SigLIPVAT step: the profiler saw no device time (busy share not measured)" if busy is None
        else f"  one profiled SigLIPVAT step: device busy {busy[0]:.4f} of the window ({busy[2]:.3f} ms), device "
             f"kernel time {busy[1]:.3f} ms; host ops by self CPU time: {busy[3]}")
    opt.zero_grad(set_to_none=True)
    for label, (vmodel, vopt, run) in vat.items():
        def vstep(vmodel=vmodel, vopt=vopt, run=run):
            vopt.zero_grad(set_to_none=True)
            run(vmodel, torch.bfloat16).backward()
            vopt.step()

        (k1, km1), (p1, pm1), (p2, pm2), (k2, km2) = (train_step_ms(dev, f)
                                                      for f in (vstep, plain(vstep), plain(vstep), vstep))
        log(f"  {label} training at bs={VAT_BS}: kernel path {(k1 + k2) / 2:.3f} ms/step, plain bf16 path "
            f"{(p1 + p2) / 2:.3f} ms/step; turns ms kernel {k1:.3f} plain {p1:.3f} plain {p2:.3f} kernel {k2:.3f}; "
            f"peak device memory kernel {max(km1, km2):.2f} GiB, plain {max(pm1, pm2):.2f} GiB")
        vopt.zero_grad(set_to_none=True)
    siglip.clear()
    vat.clear()
    sync()

    per_kernel = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 48)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = DH**-0.5
    log("  each flash launch at phase 45's shapes against its twin (the backward twin computes dq, dk and dv at "
        "once), its bound and its library call (SDPA; the backward: one aten call for dq, dk and dv), all device "
        "time by torch.profiler (device_ms), in turns (plain, kernel, kernel, plain):")

    def turns(kern, twin):
        p1, k1, k2, p2 = (device_ms(f) for f in (twin, kern, kern, twin))
        return (k1 + k2) / 2, (p1 + p2) / 2

    with torch.inference_mode():
        for label, b, n, m in VLA_FLASH:
            q, k, v = vla_qkv(gen, dev, b, n, m)
            do = torch.randn(b, VLA_HEADS, n, DH, generator=gen, device=dev).to(torch.bfloat16)
            o, lse = fa.flash_fwd(q, k, v, scale=scale)
            delta = (do.float() * o.float()).sum(-1)
            qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
            bwd_lib, bwd_what = flash_backend_bwd_ms(qc, kc, vc, doc, 10, timer=device_ms)
            times = {
                "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale=scale),
                              lambda: fa.flash_fwd_reference(q, k, v, scale=scale), device_ms(lambda: sdpa(q, k, v))),
                "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, scale=scale),
                                 lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, scale=scale), bwd_lib),
                "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale),
                                  lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, scale=scale), bwd_lib),
            }
            for name, (kern, twin, lib_ms) in times.items():
                km, pm = turns(kern, twin)
                w = pair_work(name, b, n, m, n * m, heads=VLA_HEADS)
                bound, by = bound_ms(w)
                log(f"  {name} @ {label} ({b} x {VLA_HEADS} x {n} x {m}): kernel {km:.4f} ms, plain {pm:.4f} ms, bound "
                    f"{bound:.4f} ms ({by}), library {lib_ms:.4f} ms ({'SDPA' if name == 'flash_fwd' else bwd_what})")
                if label in VLA_ENTRIES:
                    record(per_kernel, f"{name} @ {label}", km, pm, w, lib_ms)
        for label, b, n, m in VLA_SHORT:
            q, k, v = vla_qkv(gen, dev, b, n, m)
            km, pm = turns(lambda: sa.short_fwd(q, k, v, scale=scale),
                           lambda: sa.short_attention_reference(q, k, v, scale=scale))
            lib_ms = device_ms(lambda: sdpa(q, k, v))
            w = pair_work("short_attention", b, n, m, n * m, heads=VLA_HEADS)
            bound, by = bound_ms(w)
            log(f"  short_attention @ {label} ({b} x {VLA_HEADS} x {n} x {m}): kernel {km:.4f} ms, plain {pm:.4f} ms, "
                f"bound {bound:.4f} ms ({by}), library {lib_ms:.4f} ms (SDPA)")
            if label == VLA_ENTRIES[0]:
                record(per_kernel, f"short_attention @ {label}", km, pm, w, lib_ms)
    sync()
    return per_kernel


# -- the simple-ViT family (phase 49): the eleven models of ROADMAP item 9's
# first family, served at config 2's width (SIMPLE: 256/32, dim 1024, depth 6,
# 16 heads, bs=256, 64 tokens); the 1-D model at 256 steps of patch 16 (16
# tokens, 8 heads: inner 512 != dim), the 3-D ones at ViViT's clip (16 frames
# of 128 x 128, tubelets 2 x 16 x 16: 512 tokens, the wide attention
# kernels' block), each with random weights from SEED
FAMILY_1D = dict(seq_len=256, patch_size=16, num_classes=1000, dim=1024, depth=6, heads=8, mlp_dim=2048)
FAMILY_3D = dict(image_size=128, image_patch_size=16, frames=16, frame_patch_size=2, num_classes=1000, dim=1024,
                 depth=6, heads=8, mlp_dim=2048)
FAMILY_3D_BS = 16
FAMILY_STREAMS = 4  # hyper-connections' residual streams (and its 4 register tokens: 68 tokens)
FAMILY_PATCH_DROPOUT = 0.5  # 32 of 64 tokens in training
SIMPLE_2D = {k: v for k, v in SIMPLE.items()}
# name: (module, class, constructor, input shape past the batch, batch, tokens served, fuses)
FAMILY = {
    "simple_vit_1d": ("simple_vit_1d", "SimpleViT", FAMILY_1D, (3, 256), SIMPLE_BS, 16, True),
    "simple_vit_3d": ("simple_vit_3d", "SimpleViT", FAMILY_3D, (3, 16, 128, 128), FAMILY_3D_BS, 512, True),
    "simple_vit_with_patch_dropout": ("simple_vit_with_patch_dropout", "SimpleViT",
                                      {**SIMPLE_2D, "patch_dropout": FAMILY_PATCH_DROPOUT}, (3, 256, 256), SIMPLE_BS,
                                      64, True),
    "simple_vit_with_fft": ("simple_vit_with_fft", "SimpleViT", {**SIMPLE_2D, "freq_patch_size": 32},
                            (3, 256, 256), SIMPLE_BS, 128, True),
    "simple_flash_attn_vit": ("simple_flash_attn_vit", "SimpleViT", SIMPLE_2D, (3, 256, 256), SIMPLE_BS, 64, True),
    "simple_flash_attn_vit_3d": ("simple_flash_attn_vit_3d", "SimpleViT", FAMILY_3D, (3, 16, 128, 128),
                                 FAMILY_3D_BS, 512, True),
    "simple_vit_orthog_residual_update": ("simple_vit_orthog_residual_update", "SimpleViT", SIMPLE_2D,
                                          (3, 256, 256), SIMPLE_BS, 64, True),
    "simple_vit_with_hyper_connections": ("simple_vit_with_hyper_connections", "SimpleViT",
                                          {**SIMPLE_2D, "num_residual_streams": FAMILY_STREAMS}, (3, 256, 256),
                                          SIMPLE_BS, 68, True),
    "simple_vit_with_value_residual": ("simple_vit_with_value_residual", "SimpleViT", SIMPLE_2D, (3, 256, 256),
                                       SIMPLE_BS, 64, False),
    "simple_vit_with_specialized_cls": ("simple_vit_with_specialized_cls", "SimpleViT", SIMPLE_2D, (3, 256, 256),
                                        SIMPLE_BS, 65, False),
    "simple_vit_attn_residual": ("simple_vit_attn_residual", "SimpleViTAttnResidual", SIMPLE_2D, (3, 256, 256),
                                 SIMPLE_BS, 64, False),
}
FAMILY_TRAINED = ("simple_vit_1d", "simple_vit_with_patch_dropout", "simple_vit_orthog_residual_update",
                  "simple_vit_with_hyper_connections")
FAMILY_TRAIN_STEPS = 3
# The first step's gradients against fp32: SIMPLE_TRAIN_VS_FP32 for every
# parameter but the hyper-connections' mixing parameters (static and dynamic
# alpha and beta), whose bf16 gradients are sums over every token of
# products that cancel and move with any rounding (phase 49 reads them at
# 2.83e-2 to 6.73e-2 from fp32 on the kernel and plain bf16 paths; NVIDIA
# H100 80GB HBM3, 700.00 W): each of them is held to fp32 on its own at
# HYPER_MIXING_VS_FP32, and the run reads three witnesses on the same draw
# beside it: the same step in f64 (is fp32 the answer?), the kernel path's
# step again (does it repeat?), and three batches with 1e-3 relative noise
# through the kernel, plain bf16 and fp32 paths (how far each bf16 path's
# distance from fp32 moves around this draw).
HYPER_MIXING = re.compile(r"\.(static_alpha|static_beta|dynamic_alpha_fn|dynamic_alpha_scale|dynamic_beta_fn|"
                          r"dynamic_beta_scale)$")
HYPER_MIXING_VS_FP32 = 1e-1
HYPER_NOISE, HYPER_NOISE_DRAWS = 1e-3, 3
# a Transformer with a qkv bias at ViT-B widths, each layer's Attention
# with the logits' scale QKV_SCALE: one layer without the final norm (its 13
# gradients: dx and 12 operands), and the stack's 6 layers.  Its gradients
# against an f32 copy on the composite: each within QKV_VS_FP32_REL_L2, and
# a control (the f32 gradients with one of the B_CHECK samples' cotangent
# zeroed, as a reduction that skips a sample's rows would give) outside it.
QKV_SCALE = 0.1  # dim_head**-0.5 is 0.125
QKV_STACK_DEPTH = 6
QKV_VS_FP32_REL_L2 = 3e-2
FAMILY_ENTRIES = ("attention_rows @ SimpleViT-1D", "attention_bwd_rows @ SimpleViT-1D",
                  "attention_rows @ SimpleViT-FFT", "gemm_bf16[qkv+bias] @ Transformer")


def family_model(name, dev, dtype, **kw):
    """One model of the family at its phase-49 configuration, random
    weights from SEED, initialised in f32 and cast as the JAX bench casts
    its params."""
    import importlib

    module, cls, cfg, *_ = FAMILY[name]
    model_cls = getattr(importlib.import_module(f"vit_pytorch_tpu_torch.models.{module}"), cls)
    return model_cls(**cfg, **kw, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).to(dtype)


def family_depth(name):
    return FAMILY[name][2]["depth"]


def family_want(name, per_layer, runs=1):
    """The exact launch counts of ``runs`` calls: ``per_layer`` a layer
    where the model fuses, nothing anywhere else."""
    fuses = FAMILY[name][-1]
    return {k: family_depth(name) * v * runs for k, v in per_layer.items()} if fuses else {}


def serve_family(fb, fa, name, dev, gen):
    """Serve one batch of the model: exact launch counters, outputs against
    the plain bf16 path (the block Function on its twins) and fp32, the
    time of a batch.  Returns the launch counts."""
    _, _, cfg, shape, bs, tokens, fuses = FAMILY[name]
    fp32 = family_model(name, dev, torch.float32).eval()
    model = copy.deepcopy(fp32).to(torch.bfloat16).eval()
    x = torch.randn(bs, *shape, generator=gen, device=dev)
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        reset_all(fb, fa)
        out = model(xb)
        sync()
        log(f"  {name}: bs={bs}, {tokens} tokens, {'the attention-block kernels' if fuses else 'no kernel'}")
        counts = expect_launches(fb, fa, family_want(name, BLOCK_FWD_LAUNCHES), f"{name} serving")
        if out.shape != (bs, cfg["num_classes"]) or not bool(torch.isfinite(out).all()):
            fail(f"{name}: outputs {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
        reset_all(fb, fa)
        with plain_layers():
            plain = model(xb)
        want = fp32(x)
        sync()
        if any(all_launches(fb, fa).values()):
            fail(f"{name}: the plain and fp32 paths launched kernels")
        e_plain, e_fp32, floor = rel_l2(out, plain), rel_l2(out, want), rel_l2(plain, want)
        ms = host_ms(lambda: model(xb), iters=3)
    ok = e_plain <= SIMPLE_LOGITS_VS_PLAIN and e_fp32 <= SIMPLE_LOGITS_VS_FP32
    log(f"    logits rel L2 vs plain bf16 {e_plain:.4e} (bound {SIMPLE_LOGITS_VS_PLAIN}), vs fp32 {e_fp32:.4e} (bound "
        f"{SIMPLE_LOGITS_VS_FP32}; plain bf16 vs fp32 {floor:.4e}) {'ok' if ok else 'FAILED'}; {ms:.3f} ms a batch")
    if not ok:
        fail(f"{name} served outputs disagree with the plain path or fp32")
    del model, fp32
    return counts


def train_family(fb, fa, name, dev, gen):
    """FAMILY_TRAIN_STEPS Adam steps through make_train_step on one batch,
    each with a generator seeded alike (patch dropout keeps the same tokens
    on every path): loss finite and falling, exact launch counters, the first
    step's loss and gradients against the plain bf16 path and fp32.  Returns
    the launch counts of the steps."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16
    _, _, cfg, shape, *_ = FAMILY[name]
    fp32 = family_model(name, dev, torch.float32)
    model = copy.deepcopy(fp32).to(bf16)
    initial = copy.deepcopy(model)
    names = [n for n, _ in model.named_parameters()]
    mixing = [i for i, n in enumerate(names) if HYPER_MIXING.search(n)]
    fp32_initial = copy.deepcopy(fp32) if mixing else None  # the witnesses' start
    images = torch.randn(B_TRAIN, *shape, generator=gen, device=dev)
    labels = torch.randint(0, cfg["num_classes"], (B_TRAIN,), generator=gen, device=dev)
    seeded = lambda: torch.Generator(device=dev).manual_seed(SEED)
    state, step = create_train_state(model), make_train_step(model)
    reset_all(fb, fa)
    losses = []
    for i in range(FAMILY_TRAIN_STEPS):
        losses.append(step(state, images.to(bf16), labels, seeded())["loss"].item())
        if i == 0:
            grads = grad_vector(model)
            t0 = time.perf_counter()
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / (FAMILY_TRAIN_STEPS - 1)
    log(f"  {name}: bs={B_TRAIN}, losses {[f'{v:.6f}' for v in losses]}, {ms:.3f} ms/step (steps 2-"
        f"{FAMILY_TRAIN_STEPS}, host clock)")
    counts = expect_launches(fb, fa, family_want(name, BLOCK_TRAIN_LAUNCHES, FAMILY_TRAIN_STEPS), f"{name} training")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{name} training loss is not finite or does not fall on the repeated batch")
    plain = copy.deepcopy(initial)
    reset_all(fb, fa)
    with plain_layers():
        loss_plain = make_train_step(plain)(create_train_state(plain), images.to(bf16), labels, seeded())["loss"].item()
    sync()
    if any(all_launches(fb, fa).values()):
        fail(f"{name}: the plain path launched kernels")
    loss_fp32 = make_train_step(fp32)(create_train_state(fp32), images, labels, seeded())["loss"].item()
    plain_grads, fp32_grads = grad_vector(plain), grad_vector(fp32)
    compare_grads(f"{name} first step vs plain bf16", grads, plain_grads, losses[0], loss_plain, SIMPLE_TRAIN_VS_PLAIN,
                  names)
    rest = [i for i in range(len(names)) if i not in set(mixing)]
    pick = lambda seq, idx: [seq[i] for i in idx]
    compare_grads(f"{name} first step vs fp32" + (", outside the mixing parameters" if mixing else ""),
                  pick(grads, rest), pick(fp32_grads, rest), losses[0], loss_fp32, SIMPLE_TRAIN_VS_FP32,
                  pick(names, rest))
    if mixing:
        check_mixing(name, names, mixing, dict(kernel=grads, plain=plain_grads, fp32=fp32_grads), initial,
                     fp32_initial, images, labels, seeded)
    del model, plain, fp32, fp32_initial, initial, state, step
    return counts


def check_mixing(name, names, mixing, grads, initial, fp32_initial, images, labels, seeded):
    """The hyper-connections' mixing parameters: each one's first-step
    gradient on the kernel and the plain bf16 paths against fp32 within
    HYPER_MIXING_VS_FP32, and every parameter's within the all-gradients
    bound; beside them the witnesses on this draw, each at the mixing
    parameters' worst: the same step in f64 (the composite keeps its f32
    logits, ops/attention.py), the kernel path's step once more, and
    HYPER_NOISE_DRAWS batches with HYPER_NOISE relative noise, each through
    the kernel, plain bf16 and fp32 paths (the spread of both bf16 paths'
    distance from fp32 around this draw)."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    bf16 = torch.bfloat16

    def step(model, x, plain=False):
        model = copy.deepcopy(model)
        with plain_layers() if plain else contextlib.nullcontext():
            make_train_step(model)(create_train_state(model), x, labels, seeded())
        return grad_vector(model)

    rel = lambda a, b, i: ((a[i] - b[i]).norm() / b[i].norm().clamp_min(1e-30)).item()
    worst = lambda a, b: max((rel(a, b, i), names[i]) for i in mixing)
    (e_k, n_k), (e_p, n_p) = worst(grads["kernel"], grads["fp32"]), worst(grads["plain"], grads["fp32"])
    total = grads_rel_l2(grads["kernel"], grads["fp32"])
    ok = e_k <= HYPER_MIXING_VS_FP32 and e_p <= HYPER_MIXING_VS_FP32 and total <= SIMPLE_TRAIN_VS_FP32["grads"]
    log(f"  {name} first step vs fp32, the mixing parameters' worst: kernel {n_k} {e_k:.4e}, plain bf16 {n_p} "
        f"{e_p:.4e} (bound {HYPER_MIXING_VS_FP32} each); every parameter: grads rel L2 {total:.4e} (bound "
        f"{SIMPLE_TRAIN_VS_FP32['grads']}) {'ok' if ok else 'FAILED'}")
    f64 = step(copy.deepcopy(fp32_initial).double(), images.double())
    again = step(initial, images.to(bf16))
    readings = [("fp32 vs f64", grads["fp32"], f64), ("kernel vs f64", grads["kernel"], f64),
                ("plain vs f64", grads["plain"], f64), ("kernel again vs kernel", again, grads["kernel"])]
    noise = torch.Generator(device=images.device).manual_seed(SEED + 1)
    for i in range(HYPER_NOISE_DRAWS):
        noisy = images * (1 + HYPER_NOISE * torch.randn(images.shape, generator=noise, device=images.device))
        want = step(fp32_initial, noisy)
        readings += [(f"noisy batch {i}: kernel vs fp32", step(initial, noisy.to(bf16)), want),
                     ("plain vs fp32", step(initial, noisy.to(bf16), plain=True), want)]
    sync()
    log("    witnesses, the mixing parameters' worst: " + "; ".join(
        "{} {} {:.4e}".format(label, *reversed(worst(a, b))) for label, a, b in readings))
    if not ok:
        fail(f"training: {name} first step vs fp32 out of bounds")


def qkv_bias_transformer(dev, gen, depth, **kw):
    """A bf16 ``Transformer`` at ViT-B widths with a qkv bias, each layer's
    ``Attention`` built with the logits' scale QKV_SCALE (the JAX
    ``Transformer`` has no scale: the block route takes the Attention's, the
    whole-layer and stack routes take it as their ops' ``scale=``, see
    :func:`scaled_layers`), every parameter drawn from ``gen`` (Linear
    weights N(0, 1/fan_in), every bias and LayerNorm shift N(0, 0.1^2),
    LayerNorm scales 1 + N(0, 0.1^2)): no bias is zero, so a dropped one
    shows."""
    from vit_pytorch_tpu_torch.nn.blocks import Attention, Transformer

    model = Transformer(DIM, depth, HEADS, DH, MLP, qkv_bias=True, device=dev, **kw)
    for i, layer in enumerate(model.layers):
        layer[0] = Attention(DIM, heads=HEADS, dim_head=DH, dropout=model.dropout, qkv_bias=True, scale=QKV_SCALE,
                             sow_index=i, device=dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=gen, device=dev)
            if name.endswith("weight") and p.dim() == 2:
                p.copy_(z * p.shape[1] ** -0.5)
            else:
                p.copy_((1.0 if name.endswith("norm.weight") or ".net.0.weight" in name else 0.0) + 0.1 * z)
    return model.to(torch.bfloat16)


def scaled_layers(model, x, *, stack=False):
    """``model``'s layers (no final norm) on the whole-layer route with each
    layer's Attention scale: ``fused_transformer_layer`` a layer (the
    twins' under :func:`plain_layers`) or one ``fused_transformer_stack`` of
    them all, each fed the model's ``layer_weights`` / ``layer_tuple``."""
    from vit_pytorch_tpu_torch.nn import blocks
    from vit_pytorch_tpu_torch.ops.fused_block import LN_EPS, fused_transformer_stack

    kw = dict(heads=HEADS, dim_head=DH, scale=model.layers[0][0].scale, eps=LN_EPS)
    if stack:
        return fused_transformer_stack(x, [model.layer_tuple(i, x.dtype) for i in range(len(model.layers))], **kw)
    for i in range(len(model.layers)):
        weights, biases = model.layer_weights(i, x.dtype)
        x = blocks.fused_transformer_layer(x, *weights, **kw, **biases)
    return x


def transformer_grads(model, x, g, plain=False, run=None):
    """Output and the gradients of x and of every parameter, for ``g``;
    ``run(model, x)`` (default ``model(x)``) on ``plain``: the layers on the
    twins."""
    model.zero_grad(set_to_none=True)
    leaf = x.detach().clone().requires_grad_()
    with plain_layers() if plain else contextlib.nullcontext():
        out = model(leaf) if run is None else run(model, leaf)
    out.backward(g)
    return out.detach(), [leaf.grad] + [p.grad for _, p in model.named_parameters()]


def f32_composite(model):
    """An f32 copy of ``model`` on the plain composite (``flash=False``),
    the reference of its bf16 routes."""
    ref = copy.deepcopy(model).float()
    ref.flash = False
    for attn, _ in ref.layers:
        attn.flash = False
    return ref


def check_qkv_bias_transformer(fb, fa, dev, gen):
    """A Transformer with a qkv bias at ViT-B widths (b=8, n=197), each
    layer's Attention scale QKV_SCALE: the model's own forward on the
    whole-layer kernels (7 launches, the qkv site's bias in its epilogue)
    against the twins; one layer through ``fused_transformer_layer`` with
    that scale and its backward (13 launches), the output and its 13
    gradients (db_qkv among them) against the same op on the twins and, each
    within QKV_VS_FP32_REL_L2, against an f32 copy on the composite (the
    control outside that bound); the attention-block kernels with dropout
    0.1 in training (the block's 11 launches, the Attention's scale) against
    the same module on the twins (the same masks); 6 layers' one
    ``fused_transformer_stack`` launch with that scale bitwise the 42-launch
    chain, and the chain within 6 layers' bounds of the twins.  Returns the
    qkv site's launches in the model's forward."""
    log(f"  Transformer(dim {DIM}, heads {HEADS}, mlp {MLP}, qkv_bias=True), Attention scale {QKV_SCALE}, "
        f"b={B_CHECK} n={N}")
    x, g = (torch.randn(B_CHECK, N, DIM, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    model = qkv_bias_transformer(dev, gen, 1, final_norm=False).eval()
    labels = ("x", *(name for name, _ in model.named_parameters()))
    reset_all(fb, fa)
    with torch.no_grad():
        out = model(x)
    sync()
    expect_launches(fb, fa, LAUNCHES_PER_LAYER, "the qkv-bias Transformer's whole-layer forward")
    qkv_launches = fb.GEMM_LAUNCHES["qkv"]
    with torch.no_grad(), plain_layers():
        want = model(x)
    compare("qkv-bias Transformer (out)", out, want, LAYER_ATOL, LAYER_RTOL)
    reset_all(fb, fa)
    out, grads = transformer_grads(model, x, g, run=scaled_layers)
    sync()
    expect_launches(fb, fa, TRAIN_LAUNCHES_PER_LAYER, f"the qkv-bias layer at scale {QKV_SCALE} with its backward")
    want, want_grads = transformer_grads(model, x, g, plain=True, run=scaled_layers)
    compare("qkv-bias layer (out)", out, want, LAYER_ATOL, LAYER_RTOL)
    for label, a, b in zip(labels, grads, want_grads):
        compare(f"qkv-bias layer grad d{label}", a, b, None, KERNEL_RTOL, LAYER_GRAD_REL_L2,
                atol_frac=LAYER_GRAD_ATOL_FRAC)
    ref = f32_composite(model)
    ref_out, ref_grads = transformer_grads(ref, x.float(), g.float())
    control = g.float().clone()
    control[0] = 0
    _, control_grads = transformer_grads(ref, x.float(), control)
    sync()
    del ref
    rows = [("out", out, want, ref_out, ref_out)] + list(zip(labels, grads, want_grads, ref_grads, control_grads))
    ok = True
    log(f"  the qkv-bias layer against its f32 copy (rel L2; bound {QKV_VS_FP32_REL_L2}, the control outside it):")
    for label, got, twin, ref_t, ctrl in rows:
        e_k, e_t = rel_l2(got, ref_t), rel_l2(twin, ref_t)
        e_c = None if label == "out" else rel_l2(ctrl, ref_t)
        good = e_k <= QKV_VS_FP32_REL_L2 and e_t <= QKV_VS_FP32_REL_L2 and (e_c is None or e_c > QKV_VS_FP32_REL_L2)
        ok &= good
        log(f"    {'' if label == 'out' else 'd'}{label}: kernels {e_k:.4e}, twins {e_t:.4e}"
            + ("" if e_c is None else f", control {e_c:.4e}") + f" {'ok' if good else 'FAILED'}")
    if not ok:
        fail("the qkv-bias layer disagrees with its f32 copy, or its control passes")
    model = qkv_bias_transformer(dev, gen, 1, final_norm=False, dropout=RATE).train()
    runs = []
    for plain in (False, True):
        torch.manual_seed(DROP_SEED)  # the block's seed (CPU) and the FF's masks (the card)
        reset_all(fb, fa)
        runs.append(transformer_grads(model, x, g, plain))
        sync()
        if not plain:
            expect_launches(fb, fa, DROPOUT_LAUNCHES_PER_LAYER, "the qkv-bias Transformer's block at dropout 0.1")
    # the layer's output and gradients (the block, then the plain FF on its
    # output): the whole layer's bounds, as above
    (out, grads), (want, want_grads) = runs
    compare("qkv-bias block, dropout (out)", out, want, LAYER_ATOL, LAYER_RTOL)
    for label, a, b in zip(labels, grads, want_grads):
        compare(f"qkv-bias block grad d{label}", a, b, None, KERNEL_RTOL, LAYER_GRAD_REL_L2,
                atol_frac=LAYER_GRAD_ATOL_FRAC)
    model = qkv_bias_transformer(dev, gen, QKV_STACK_DEPTH, final_norm=False).eval()
    with torch.inference_mode():
        with env_switch({"VIT_TPU_STACK_LAYERS": str(QKV_STACK_DEPTH)}, STACK_KEYS):
            reset_all(fb, fa)
            model_stacked = model(x)
            sync()
            expect_launches(fb, fa, {"stack_layers": 1}, "the qkv-bias Transformer under VIT_TPU_STACK_LAYERS=6")
        with env_switch({}, STACK_KEYS):
            model_chain = model(x)
        reset_all(fb, fa)
        stacked = scaled_layers(model, x, stack=True)
        sync()
        expect_launches(fb, fa, {"stack_layers": 1}, f"the qkv-bias stack of {QKV_STACK_DEPTH} layers at scale "
                        f"{QKV_SCALE}")
        chain = scaled_layers(model, x)
        with plain_layers():
            twins = scaled_layers(model, x)
    sync()
    if not torch.equal(model_stacked, model_chain) or not torch.equal(stacked, chain):
        fail("the qkv-bias Transformer's stack is not bitwise its chain")
    log(f"  the stack of {QKV_STACK_DEPTH} layers bitwise the chain of {7 * QKV_STACK_DEPTH} launches, from the "
        f"model's forward and at scale {QKV_SCALE}: ok")
    compare("qkv-bias chain of 6 vs twins", chain, twins, QKV_STACK_DEPTH * LAYER_ATOL, LAYER_RTOL,
            QKV_STACK_DEPTH * KERNEL_REL_L2)
    del model
    return qkv_launches


def check_strided_block(fb, dev, gen):
    """The attention-block Function on a strided x (one stream of a (b, n,
    5, d) mix, as the hyper-connections model hands it), forward and
    backward, against the same call on its contiguous copy: bit for bit."""
    inner = SIMPLE["heads"] * DH
    d, n = SIMPLE["dim"], SIMPLE_N + REGISTER_TOKENS
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    w = (rnd(3 * inner, d, scale=d**-0.5), rnd(d, inner, scale=inner**-0.5), 1 + rnd(d, scale=0.1), rnd(d, scale=0.1))
    strided = rnd(SIMPLE_BS // 8, n, FAMILY_STREAMS + 1, d)[..., 0, :]
    g = rnd(SIMPLE_BS // 8, n, d)
    if strided.is_contiguous():
        fail("the strided check's x is contiguous")
    outs = []
    for x in (strided, strided.contiguous()):
        with torch.no_grad():
            served = fb.fused_attention_block(x, None, *w, heads=SIMPLE["heads"], dim_head=DH)
        leaf = x.detach().requires_grad_()
        out = fb.fused_attention_block(leaf, leaf, *w, heads=SIMPLE["heads"], dim_head=DH)
        (dx,) = torch.autograd.grad(out, [leaf], g)
        outs.append((served, out.detach(), dx))
    sync()
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        fail("the attention block on a strided x differs from its contiguous copy")
    log(f"  the attention block on a strided x ({tuple(strided.shape)}, strides {strided.stride()}), served and "
        f"with its backward: bitwise its contiguous copy")


def check_family(fb, fa, dev, gen):
    """Phase 49: the eleven models served and four of them trained, the
    qkv-bias Transformer, the strided block.  Returns the launch counts by
    model (serving, training) and the qkv site's launches in the
    Transformer's whole-layer forward."""
    log(f"[49 simple-ViT family] config 2's width {SIMPLE_2D}, bs={SIMPLE_BS}; 1-D {FAMILY_1D}; 3-D {FAMILY_3D} at "
        f"bs={FAMILY_3D_BS}; bf16, random weights (seed {SEED})")
    served = {name: serve_family(fb, fa, name, dev, gen) for name in FAMILY}
    trained = {name: train_family(fb, fa, name, dev, gen) for name in FAMILY_TRAINED}
    check_strided_block(fb, dev, gen)
    return served, trained, check_qkv_bias_transformer(fb, fa, dev, gen)


def time_family(fb, dev, gen, smi):
    """Phase 49's new kernel shapes, each against its twin (the error the
    kernels line reports) and by device time against its twin in turns, its
    bound and its library call: attention_rows and attention_bwd_rows at
    the 1-D model's (256, 16 tokens, 8 heads), attention_rows at the FFT
    model's (256, 128 tokens, 16 heads), gemm_bf16's qkv site with its bias
    at the Transformer check's (1,576 x 2,304 x 768).  The FFT shape's 268
    MB of operands outlast the 50 MB L2 only in part between repeated
    launches, so it is timed with L2 flushed before each call
    (:func:`flushed_event_ms`: kernel, twin and SDPA alike), its warm
    profiler times logged beside.  Returns the records and the errors."""
    F_ = torch.nn.functional
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)
    per_kernel, errs = {}, {}
    log(f"  the new shapes, {smi}:")
    with torch.inference_mode():
        for label, b, n, heads in (("SimpleViT-1D", SIMPLE_BS, 16, FAMILY_1D["heads"]),
                                   ("SimpleViT-FFT", SIMPLE_BS, 128, SIMPLE["heads"])):
            akw = dict(heads=heads, dim_head=DH, scale=DH**-0.5)
            qkv = rnd(b, n, 3 * heads * DH)
            q, k, v = qkv.view(b, n, 3, heads, DH).permute(2, 0, 3, 1, 4)
            name = f"attention_rows @ {label}"
            errs[name] = compare(name, fb.attention_rows(qkv, **akw), fb.attention_rows_reference(qkv, **akw),
                                 ATTN_ATOL, ATTN_RTOL)
            kern, twin, sdpa = (lambda: fb.attention_rows(qkv, **akw), lambda: fb.attention_rows_reference(qkv, **akw),
                                lambda: F_.scaled_dot_product_attention(q, k, v))
            if label == "SimpleViT-FFT":
                warm = [device_ms(f) for f in (kern, sdpa)]
                p1, k1, k2, p2 = (flushed_event_ms(f) for f in (twin, kern, kern, twin))
                lib_ms = flushed_event_ms(sdpa)
                log(f"  {name}, L2 flushed before each call: kernel {k1:.4f} / {k2:.4f} ms, twin {p1:.4f} / {p2:.4f} "
                    f"ms, SDPA {lib_ms:.4f} ms; warm (the profiler, repeated calls): kernel {warm[0]:.4f} ms, SDPA "
                    f"{warm[1]:.4f} ms")
                record(per_kernel, name, (k1 + k2) / 2, (p1 + p2) / 2, attention_work(b, n, heads), library_ms=lib_ms)
                continue
            sites = [(name, kern, twin, attention_work(b, n, heads), device_ms(sdpa))]
            if label == "SimpleViT-1D":
                dm = rnd(b, n, heads * DH)
                name = f"attention_bwd_rows @ {label}"
                errs[name] = check_attention_bwd(fb, "attention_bwd_rows", qkv, dm, akw, label)
                sites.append((name, lambda: fb.attention_bwd_rows(qkv, dm, **akw),
                              lambda: fb.attention_bwd_rows_reference(qkv, dm, **akw),
                              attention_work(b, n, heads, backward=True), None))
            for name, kern, twin, wk, lib_ms in sites:
                p1, k1, k2, p2 = (device_ms(f) for f in (twin, kern, kern, twin))
                record(per_kernel, name, (k1 + k2) / 2, (p1 + p2) / 2, wk, library_ms=lib_ms)
        rows, inner = B_CHECK * N, HEADS * DH
        h, w_qkv, b_qkv = rnd(B_CHECK, N, DIM), rnd(3 * inner, DIM, scale=DIM**-0.5), rnd(3 * inner, scale=0.1)
        name = "gemm_bf16[qkv+bias] @ Transformer"
        errs[name] = compare(name, fb.gemm_bf16(h, w_qkv, "qkv", bias=b_qkv),
                             fb.gemm_bf16_reference(h, w_qkv, "qkv", bias=b_qkv), KERNEL_ATOL, KERNEL_RTOL)
        kern, twin = (lambda: fb.gemm_bf16(h, w_qkv, "qkv", bias=b_qkv),
                      lambda: fb.gemm_bf16_reference(h, w_qkv, "qkv", bias=b_qkv))
        p1, k1, k2, p2 = (device_ms(f) for f in (twin, kern, kern, twin))
        record(per_kernel, name, (k1 + k2) / 2, (p1 + p2) / 2, gemm_work(rows, 3 * inner, DIM, bias=True),
               library_ms=device_ms(lambda: F_.linear(h, w_qkv, b_qkv)))
    for name, t in per_kernel.items():
        bound, by = bound_ms(t["work"])
        log(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by})"
            + ("" if t["library_ms"] is None else f", library call {t['library_ms']:.4f} ms"))
    sync()
    return per_kernel, errs


# -- ROADMAP item 9's families 1 and 2 and ssl/distill.py (phases 50-52):
# thirteen models served one batch at full width (bf16, random weights from
# SEED) and six of them trained 3 steps at dropout 0.1 (make_train_step with
# a generator seeded alike on every path; the distillation a plain Adam loop
# seeded alike), each with exact launch counters, outputs against the plain
# bf16 path (every kernel swapped for its twin) and fp32, the first step's
# loss and gradients against the plain path with the same masks; then the
# new kernel shapes against their twins, timed.
#   - config 1's width (CONFIG1 at dropout 0.1, bs=64, 65 tokens): DeepViT,
#     CaiT (depth 12, cls_depth 2, layer dropout 0.05), ParallelViT (2
#     branches), the efficient shell around the port's Transformer, and the
#     distillation: DistillableViT (66 tokens with its token) in a
#     DistillWrapper(temperature=3, alpha=0.5) with a frozen config-1 ViT;
#   - ViT-1D at phase 49's 1-D shape (17 tokens with the cls token, 8 heads:
#     inner 512 != dim 1024); ViT-3D at ViViT's clip (513 tokens: the
#     whole layer on the wide attention kernels; JAX takes the composite);
#   - ViT-ND, -rotary and -PoPE on a 4-D input of 8 x 16 x 32 x 64 in
#     2 x 4 x 4 x 8 patches: 1,024 patches (ViT-ND 1,025 tokens with its cls
#     token: flash_fwd with a 1-row tail tile; the rotary exactly 1,024: the
#     short kernel serving, the flash [dropout] kernels training; PoPE's
#     128-wide q and k refused by both gates: the composite), dim 512, bs=16;
#   - T2T-ViT at 224 x 224 (dim 512, depth 5, heads 8, mlp 512: the trunk's
#     197 tokens on the whole layer; the one-head stems on the composite);
#   - CCT (cct_14's widths at 224 x 448: 392 tokens, the composite) and
#     CCT-3D (the same at 224 x 224 x 8 frames: 1,568 tokens, the flash
#     kernels, with their dropout in training), bs=16 for the video and ND
#     models, 8 in their training.
ZOO2_BS, ZOO2_VIDEO_BS, ZOO2_TRAIN_BS, ZOO2_VIDEO_TRAIN_BS = 64, 16, 32, 8
CONFIG1_DROP = {**CONFIG1, "dropout": RATE, "emb_dropout": RATE}
ZOO2_ND = dict(ndim=4, input_shape=(8, 16, 32, 64), patch_size=(2, 4, 4, 8), num_classes=1000, dim=512, depth=6,
               heads=8, mlp_dim=2048, dropout=RATE)
ZOO2_ND_SHAPE = (3, 8, 16, 32, 64)
ZOO2_T2T = dict(image_size=224, num_classes=1000, dim=512, depth=5, heads=8, mlp_dim=512, dropout=RATE,
                emb_dropout=RATE)
ZOO2_CCT = dict(embedding_dim=384, n_conv_layers=2, kernel_size=7, stride=2, padding=3, pooling_kernel_size=3,
                pooling_stride=2, pooling_padding=1, num_layers=14, num_heads=6, mlp_ratio=3.0, num_classes=1000)
ZOO2_CCT_3D = dict(img_size=224, num_frames=8, frame_kernel_size=3, **ZOO2_CCT)
ZOO2_STEPS = 3
DISTILL = dict(temperature=3.0, alpha=0.5)
# name: (module, class, constructor, input shape past the batch, serving bs, training bs or None)
ZOO2 = {
    "vit_1d": ("vit_1d", "ViT", {**FAMILY_1D, "dropout": RATE, "emb_dropout": RATE}, (3, 256), ZOO2_BS, ZOO2_TRAIN_BS),
    "vit_3d": ("vit_3d", "ViT", FAMILY_3D, (3, 16, 128, 128), ZOO2_VIDEO_BS, None),
    "vit_nd": ("vit_nd", "ViTND", ZOO2_ND, ZOO2_ND_SHAPE, ZOO2_VIDEO_BS, None),
    "vit_nd_rotary": ("vit_nd_rotary", "ViTND", ZOO2_ND, ZOO2_ND_SHAPE, ZOO2_VIDEO_BS, ZOO2_VIDEO_TRAIN_BS),
    "vit_nd_pope": ("vit_nd_pope", "ViTND", ZOO2_ND, ZOO2_ND_SHAPE, ZOO2_VIDEO_BS, None),
    "deepvit": ("deepvit", "DeepViT", CONFIG1_DROP, (3, 256, 256), ZOO2_BS, None),
    "cait": ("cait", "CaiT", {**CONFIG1_DROP, "depth": 12, "cls_depth": 2, "layer_dropout": 0.05}, (3, 256, 256),
             ZOO2_BS, None),
    "parallel_vit": ("parallel_vit", "ViT", {**CONFIG1_DROP, "num_parallel_branches": 2}, (3, 256, 256), ZOO2_BS,
                     ZOO2_TRAIN_BS),
    "efficient": ("efficient", "ViT", None, (3, 256, 256), ZOO2_BS, None),
    "t2t": ("t2t", "T2TViT", ZOO2_T2T, (3, 224, 224), ZOO2_BS, ZOO2_TRAIN_BS),
    "cct": ("cct", "CCT", {**ZOO2_CCT, "img_size": (224, 448)}, (3, 224, 448), ZOO2_BS, None),
    "cct_3d": ("cct_3d", "CCT", ZOO2_CCT_3D, (3, 8, 224, 224), ZOO2_VIDEO_BS, ZOO2_VIDEO_TRAIN_BS),
    "distillable_vit": ("distill", "DistillableViT", CONFIG1_DROP, (3, 256, 256), ZOO2_BS, None),
}
ZOO2_TRAINED = ("vit_1d", "vit_nd_rotary", "parallel_vit", "t2t", "cct_3d")  # and the DistillWrapper


def per_layer(counts, layers, steps=1):
    return {k: v * layers * steps for k, v in counts.items()}


def add_counts(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


FLASH_DROPOUT_STEP = {name: 1 for name in FLASH_DROPOUT}
# the launches predicted for one served batch (PERF.md, §6)
ZOO2_SERVED = {
    "vit_1d": per_layer(LAUNCHES_PER_LAYER, 6),
    "vit_3d": per_layer(LAUNCHES_PER_LAYER, 6),
    "vit_nd": {"flash_fwd": 6},
    "vit_nd_rotary": {"short_attention": 6},
    "vit_nd_pope": {},
    "deepvit": {},
    "cait": {},
    "parallel_vit": per_layer(BLOCK_FWD_LAUNCHES, 6 * 2),
    "efficient": per_layer(LAUNCHES_PER_LAYER, 6),
    "t2t": per_layer(LAUNCHES_PER_LAYER, 5),
    "cct": {},
    "cct_3d": {"flash_fwd": 14},
    "distillable_vit": per_layer(LAUNCHES_PER_LAYER, 6),
}
# ... and for ZOO2_STEPS training steps
ZOO2_TRAIN = {
    "vit_1d": per_layer(DROPOUT_LAUNCHES_PER_LAYER, 6, ZOO2_STEPS),
    "vit_nd_rotary": per_layer(FLASH_DROPOUT_STEP, 6, ZOO2_STEPS),
    "parallel_vit": per_layer(DROPOUT_LAUNCHES_PER_LAYER, 6 * 2, ZOO2_STEPS),
    "t2t": per_layer(DROPOUT_LAUNCHES_PER_LAYER, 5, ZOO2_STEPS),
    "cct_3d": per_layer(FLASH_DROPOUT_STEP, 14, ZOO2_STEPS),
    # the student's attention blocks at dropout 0.1 and the frozen teacher's whole layers, a step
    "distill": add_counts(per_layer(DROPOUT_LAUNCHES_PER_LAYER, 6, ZOO2_STEPS),
                          per_layer(LAUNCHES_PER_LAYER, 6, ZOO2_STEPS)),
}
# the new kernel shapes: (label, b, heads, n) of the attention kernels
ZOO2_FLASH = (("ViT-ND", ZOO2_VIDEO_BS, 8, 1025), ("CCT-3D", ZOO2_VIDEO_BS, 6, 1568))
ZOO2_SHORT = ("ViT-ND-rotary", ZOO2_VIDEO_BS, 8, 1024)
ZOO2_FLASH_DROPOUT = ("CCT-3D", ZOO2_VIDEO_TRAIN_BS, 6, 1568)
# the chain's: (label, b, n, dim, heads, mlp)
ZOO2_CHAIN = (("T2T trunk", ZOO2_BS, 197, 512, 8, 512), ("ViT-1D", ZOO2_BS, 17, 1024, 8, 2048))


def zoo2_model(name, dev, dtype):
    """One model at its phase-50 configuration, random weights from SEED,
    initialised in f32 and cast as the JAX benches cast their params."""
    import importlib

    from vit_pytorch_tpu_torch.models.vit import init_modules_like_jax
    from vit_pytorch_tpu_torch.nn.blocks import Transformer

    module, cls, cfg, *_ = ZOO2[name]
    package = "ssl" if module == "distill" else "models"
    model_cls = getattr(importlib.import_module(f"vit_pytorch_tpu_torch.{package}.{module}"), cls)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if name == "efficient":
        c = CONFIG1_DROP
        transformer = Transformer(c["dim"], c["depth"], c["heads"], DH, c["mlp_dim"], RATE, device=dev)
        with torch.no_grad():
            init_modules_like_jax(transformer, gen)
        cfg = dict(image_size=c["image_size"], patch_size=c["patch_size"], num_classes=c["num_classes"], dim=c["dim"],
                   transformer=transformer)
    return model_cls(**cfg, device=dev, generator=gen).to(dtype)


def zoo2_call(name, model, x, token=None):
    if name == "distillable_vit":
        return model(x, distill_token=token)[0]
    return model(x)


def serve_batch(fb, fa, name, fp32, x, want, call=lambda model, x: model(x), classes=1000, noise_floor=False):
    """Serve one batch ``x`` (fp32) with ``fp32``'s bf16 copy through
    ``call(model, x)``: exact launch counters ``want``, (b, ``classes``) finite
    outputs against the plain bf16 path and ``fp32``, the host time of a
    batch.  ``noise_floor``: the fp32 bound is the larger of
    SIMPLE_LOGITS_VS_FP32 and ZOO3_NOISE_RATIO x the bf16 path's distance from
    itself on the batch with ZOO3_INPUT_NOISE relative noise (for a model
    whose logits move that far with its input, measured in the same run).
    Returns the launch counts, the gemm_bf16 launches by site and the ms."""
    model = copy.deepcopy(fp32).to(torch.bfloat16).eval()
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        reset_all(fb, fa)
        out = call(model, xb)
        sync()
        log(f"  {name}: bs={x.shape[0]}, input {tuple(x.shape[1:])}")
        counts = expect_launches(fb, fa, want, f"{name} serving")
        sites = {f"gemm_bf16[{s}]": v for s, v in fb.GEMM_LAUNCHES.items() if v}
        if out.shape != (x.shape[0], classes) or not bool(torch.isfinite(out).all()):
            fail(f"{name}: outputs {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
        reset_all(fb, fa)
        with plain_layers(), plain_attention():
            plain = call(model, xb)
        ref = call(fp32, x)
        sync()
        if any(all_launches(fb, fa).values()):
            fail(f"{name}: the plain and fp32 paths launched kernels: {all_launches(fb, fa)}")
        e_plain, e_fp32, floor = rel_l2(out, plain), rel_l2(out, ref), rel_l2(plain, ref)
        bound, witness = SIMPLE_LOGITS_VS_FP32, ""
        if noise_floor:
            noise = torch.randn(x.shape, generator=torch.Generator(device=x.device).manual_seed(SEED + 55),
                                device=x.device)
            moved = rel_l2(call(model, (x * (1 + ZOO3_INPUT_NOISE * noise)).to(torch.bfloat16)), out)
            bound = max(bound, ZOO3_NOISE_RATIO * moved)
            witness = f": the larger of {SIMPLE_LOGITS_VS_FP32} and {ZOO3_NOISE_RATIO} x {moved:.4e}, the bf16 " \
                      f"path's distance from itself on the {ZOO3_INPUT_NOISE}-noisy batch"
        ms = host_ms(lambda: call(model, xb), iters=3)
    ok = e_plain <= SIMPLE_LOGITS_VS_PLAIN and e_fp32 <= bound
    log(f"    logits rel L2 vs plain bf16 {e_plain:.4e} (bound {SIMPLE_LOGITS_VS_PLAIN}), vs fp32 {e_fp32:.4e} (bound "
        f"{bound:.4e}{witness}; plain bf16 vs fp32 {floor:.4e}) {'ok' if ok else 'FAILED'}; {ms:.3f} ms a batch "
        f"(host clock)")
    if not ok:
        fail(f"{name} served outputs disagree with the plain path or fp32")
    del model
    return counts, sites, ms


def serve_zoo2(fb, fa, name, dev, gen):
    """Serve one batch of ``name`` at its phase-50 configuration
    (:func:`serve_batch`)."""
    _, _, _, shape, bs, _ = ZOO2[name]
    fp32 = zoo2_model(name, dev, torch.float32).eval()
    x = torch.randn(bs, *shape, generator=gen, device=dev)
    token = torch.randn(1, fp32.dim, generator=gen, device=dev) if name == "distillable_vit" else None
    return serve_batch(fb, fa, name, fp32, x, ZOO2_SERVED[name], lambda model, x: zoo2_call(name, model, x, token))


# CCT's sequence pool: its bias's gradient is exactly zero (the softmax over
# the tokens does not move with a shift of every logit) and its weight's a
# sum over 1,568 tokens of terms that cancel to ~2e-4 of the head's
# gradient norm, so in bf16 both paths read them 1.4x-3.7e3x their norm
# from fp32 with the same masks, and the plain path moves as far on a
# batch with 1e-3 relative noise (NVIDIA H100 80GB HBM3, 700.00 W;
# chip_seq_pool_grads.py).  They are held to the plain path within ZOO2_NOISE_RATIO of
# that witness, measured in the same run, and every other parameter to
# SIMPLE_TRAIN_VS_PLAIN.
SEQ_POOL = re.compile(r"\.attention_pool\.")
ZOO2_NOISE_RATIO, ZOO2_INPUT_NOISE = 1.5, 1e-3


def zoo2_first_step(what, step, make_model, seeded_steps, cancelling=None):
    """``seeded_steps`` steps of ``step(model, i)`` on the kernel path, then
    one on the plain path from the same initial weights with the same
    seeds: loss finite and falling, the first step's loss and gradients
    (of ``trainable(model)``'s (name, parameter) pairs) against the plain
    path (SIMPLE_TRAIN_VS_PLAIN).  Parameters whose name ``cancelling``
    matches are held instead within ZOO2_NOISE_RATIO of the plain path's
    distance from itself on a batch with ZOO2_INPUT_NOISE relative noise
    (``step(model, 0, noisy=True)``).  Returns the kernel path's launch
    counts, read after its steps."""
    from vit_pytorch_tpu_torch.ops import fused_block as fb
    from vit_pytorch_tpu_torch.ops import flash_attention as fa

    model, named = make_model()
    trainable = lambda m: [p for _, p in named(m)]
    names = [n for n, _ in named(model)]
    initial = copy.deepcopy(model)
    reset_all(fb, fa)
    losses, grads = [], None
    for i in range(seeded_steps):
        losses.append(step(model, i))
        if i == 0:
            grads = [p.grad.detach().float().clone() for p in trainable(model)]
            t0 = time.perf_counter()
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / (seeded_steps - 1)
    counts = dict(all_launches(fb, fa))
    log(f"  {what}: losses {[f'{v:.6f}' for v in losses]}, {ms:.3f} ms/step (steps 2-{seeded_steps}, host clock)")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: the loss is not finite or does not fall on the repeated batch")
    plain, noisy = initial, copy.deepcopy(initial) if cancelling else None
    reset_all(fb, fa)
    with plain_layers(), plain_attention():
        loss_plain = step(plain, 0)
        if cancelling:
            step(noisy, 0, noisy=True)
    sync()
    if any(all_launches(fb, fa).values()):
        fail(f"{what}: the plain path launched kernels")
    plain_grads = [p.grad.detach().float().clone() for p in trainable(plain)]
    held = [i for i, n in enumerate(names) if cancelling and cancelling.search(n)]
    rest = [i for i in range(len(names)) if i not in set(held)]
    pick = lambda seq, idx: [seq[i] for i in idx]
    compare_grads(f"{what} first step vs plain bf16 (the same masks)" + (", outside the sequence pool" if held else ""),
                  pick(grads, rest), pick(plain_grads, rest), losses[0], loss_plain, SIMPLE_TRAIN_VS_PLAIN,
                  pick(names, rest))
    if held:
        noisy_grads = [p.grad.detach().float().clone() for p in trainable(noisy)]
        rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        for i in held:
            e, floor = rel(grads[i], plain_grads[i]), rel(noisy_grads[i], plain_grads[i])
            ok = e <= ZOO2_NOISE_RATIO * floor and bool(torch.isfinite(grads[i]).all())
            log(f"    {names[i]} (norm {plain_grads[i].norm().item():.3e}): kernel vs plain bf16 {e:.4e}, plain vs "
                f"plain on the {ZOO2_INPUT_NOISE}-noisy batch {floor:.4e} (bound {ZOO2_NOISE_RATIO} x that) "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"{what}: {names[i]}'s first-step gradient is farther from the plain path than its noise")
    del model, plain, noisy
    return counts


def train_zoo2(fb, fa, name, dev, gen):
    """ZOO2_STEPS Adam steps through make_train_step on one batch, each with
    a generator seeded alike; exact launch counters; the first step against
    the plain path.  Returns the launch counts of the steps."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    _, _, _, shape, _, bs = ZOO2[name]
    images = torch.randn(bs, *shape, generator=gen, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, 1000, (bs,), generator=gen, device=dev)
    noisy_images = (images.float() * (1 + ZOO2_INPUT_NOISE * torch.randn(images.shape, generator=gen, device=dev))
                    ).to(torch.bfloat16)
    states = {}

    def step(model, i, noisy=False):
        if id(model) not in states:
            states[id(model)] = (create_train_state(model), make_train_step(model))
        state, run = states[id(model)]
        return run(state, noisy_images if noisy else images, labels,
                   torch.Generator(device=dev).manual_seed(SEED + i))["loss"].item()

    def make():
        return zoo2_model(name, dev, torch.bfloat16), lambda m: list(m.named_parameters())

    counts = zoo2_first_step(f"{name} at bs={bs}", step, make, ZOO2_STEPS,
                             cancelling=SEQ_POOL if name.startswith("cct") else None)
    got = {k: v for k, v in counts.items() if v}
    log(f"    launches {got} (expected {ZOO2_TRAIN[name]})")
    if counts != {k: ZOO2_TRAIN[name].get(k, 0) for k in counts}:
        fail(f"{name} training: the launch counters are not the expected ones")
    states.clear()
    return counts


def train_distill(fb, fa, dev, gen):
    """The DistillWrapper (DistillableViT student at config 1, dropout 0.1,
    a frozen config-1 ViT teacher) trained ZOO2_STEPS plain Adam steps
    through distill_forward, each seeded alike on every path; exact launch
    counters; the first step's loss and student and head gradients against
    the plain path.  Returns the launch counts."""
    from vit_pytorch_tpu_torch.models.vit import ViT
    from vit_pytorch_tpu_torch.ssl.distill import DistillWrapper, distill_forward

    images = torch.randn(ZOO2_TRAIN_BS, *ZOO2["distillable_vit"][3], generator=gen, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, 1000, (ZOO2_TRAIN_BS,), generator=gen, device=dev)
    opts = {}

    def make():
        teacher = ViT(**CONFIG1_DROP, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
        student = zoo2_model("distillable_vit", dev, torch.float32)
        wrapper = DistillWrapper(teacher=teacher.to(torch.bfloat16), student=student.to(torch.bfloat16), **DISTILL,
                                 generator=torch.Generator(device=dev).manual_seed(SEED + 2))
        return wrapper, lambda w: [(n, p) for n, p in w.named_parameters() if not n.startswith("teacher.")]

    def step(wrapper, i):
        if id(wrapper) not in opts:
            opts[id(wrapper)] = torch.optim.Adam([p for n, p in wrapper.named_parameters()
                                                  if not n.startswith("teacher.")], lr=3e-4)
        opt = opts[id(wrapper)]
        torch.manual_seed(SEED + i)
        wrapper.train()
        opt.zero_grad(set_to_none=True)
        loss = distill_forward(wrapper, images, labels)
        loss.backward()
        opt.step()
        if any(p.grad is not None for p in wrapper.teacher.parameters()):
            fail("the distillation teacher received gradients")
        return loss.item()

    counts = zoo2_first_step(f"DistillWrapper(T=3, alpha=0.5) at bs={ZOO2_TRAIN_BS}", step, make, ZOO2_STEPS)
    got = {k: v for k, v in counts.items() if v}
    log(f"    launches {got} (expected {ZOO2_TRAIN['distill']})")
    if counts != {k: ZOO2_TRAIN["distill"].get(k, 0) for k in counts}:
        fail("DistillWrapper training: the launch counters are not the expected ones")
    return counts


def check_zoo2(fb, fa, dev, gen):
    """Phases 50-51: the thirteen models served, six trained.  Returns the
    serving counts (with the gemm sites) and the training counts by
    model."""
    log(f"[50 ViT-1D/3D/ND/rotary/PoPE, DeepViT, CaiT, ParallelViT, efficient, T2T, CCT, CCT-3D, DistillableViT "
        f"served] bf16, random weights (seed {SEED}); config 1 {CONFIG1_DROP}; ND {ZOO2_ND}; T2T {ZOO2_T2T}; CCT "
        f"{ZOO2_CCT} at 224 x 448, CCT-3D at 224 x 224 x 8 frames")
    served = {name: serve_zoo2(fb, fa, name, dev, gen) for name in ZOO2}
    log(f"[51 training] {ZOO2_STEPS} steps at dropout {RATE}: {ZOO2_TRAINED} through make_train_step, the "
        f"DistillWrapper {DISTILL} through distill_forward")
    trained = {name: train_zoo2(fb, fa, name, dev, gen) for name in ZOO2_TRAINED}
    trained["distill"] = train_distill(fb, fa, dev, gen)
    return served, trained


def time_zoo2(fb, fa, dev, gen, smi):
    """Phase 52: the new kernel shapes against their twins (the errors of
    the kernels line) and by device time against the twin in turns, the
    bound and the library call: flash_fwd at ViT-ND's 1,025 tokens (a 1-row
    tail tile) and CCT-3D's 1,568 x 6 heads, short_attention at the
    rotary's 1,024, the flash [dropout] trio at CCT-3D's training shape,
    the chain's forward at T2T's trunk and ViT-1D's.  Returns the records
    and the errors."""
    from vit_pytorch_tpu_torch.ops import short_attention as sa

    log(f"[52 the new kernel shapes] {smi}")
    rn = torch.Generator(device=dev).manual_seed(SEED + 52)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = DH**-0.5
    per_kernel, errs = {}, {}

    def turns(kern, twin):
        p1, k1, k2, p2 = (device_ms(f) for f in (twin, kern, kern, twin))
        return (k1 + k2) / 2, (p1 + p2) / 2

    def qkv(b, h, n):
        return vla_qkv(rn, dev, b, n, n, heads=h)

    with torch.inference_mode():
        for label, b, h, n in ZOO2_FLASH:
            q, k, v = qkv(b, h, n)
            o, lse = fa.flash_fwd(q, k, v, scale=scale)
            o_want, lse_want = fa.flash_fwd_reference(q, k, v, scale=scale)
            name = f"flash_fwd @ {label}"
            errs[name] = max(compare(f"flash_fwd o [{label}]", o, o_want, ATTN_ATOL, ATTN_RTOL),
                             compare(f"flash_fwd lse [{label}]", lse, lse_want, FLASH_LSE_ATOL, FLASH_LSE_RTOL,
                                     F32_REL_L2))
            km, pm = turns(lambda: fa.flash_fwd(q, k, v, scale=scale), lambda: fa.flash_fwd_reference(q, k, v, scale=scale))
            record(per_kernel, name, km, pm, pair_work("flash_fwd", b, n, n, n * n, heads=h),
                   device_ms(lambda: sdpa(q, k, v)))
            del o, lse, o_want, lse_want
        label, b, h, n = ZOO2_SHORT
        q, k, v = qkv(b, h, n)
        name = f"short_attention @ {label}"
        errs[name] = compare(f"short_attention [{label}]", sa.short_fwd(q, k, v, scale=scale),
                             sa.short_attention_reference(q, k, v, scale=scale), ATTN_ATOL, ATTN_RTOL)
        km, pm = turns(lambda: sa.short_fwd(q, k, v, scale=scale),
                       lambda: sa.short_attention_reference(q, k, v, scale=scale))
        record(per_kernel, name, km, pm, pair_work("short_attention", b, n, n, n * n, heads=h),
               device_ms(lambda: sdpa(q, k, v)))

        label, b, h, n = ZOO2_FLASH_DROPOUT
        q, k, v = qkv(b, h, n)
        do = torch.randn(b, h, n, DH, generator=rn, device=dev).to(torch.bfloat16)
        dkw = dict(scale=scale, dropout_rate=RATE, seed=DROP_SEED)
        o, lse = fa.flash_fwd(q, k, v, **dkw)
        o_want, lse_want = fa.flash_fwd_reference(q, k, v, **dkw)
        errs[f"flash_fwd[dropout] @ {label}"] = max(
            compare(f"flash_fwd[dropout] o [{label}]", o, o_want, ATTN_ATOL, ATTN_RTOL),
            compare(f"flash_fwd[dropout] lse [{label}]", lse, lse_want, FLASH_LSE_ATOL, FLASH_LSE_RTOL, F32_REL_L2))
        delta = (do.float() * o.float()).sum(-1)
        dq, dk, dv = flash_bwd_twice(fa, f"{label}, dropout", q, k, v, do, lse, delta, **dkw)
        want = fa.flash_bwd_reference(q, k, v, do, lse, delta, **dkw)
        errs[f"flash_bwd_dq[dropout] @ {label}"] = compare(f"flash_bwd_dq[dropout] dq [{label}]", dq, want[0], None,
                                                          ATTN_RTOL, atol_frac=BWD_ATOL_FRAC)
        errs[f"flash_bwd_dkv[dropout] @ {label}"] = max(
            compare(f"flash_bwd_dkv[dropout] dk [{label}]", dk, want[1], None, ATTN_RTOL, atol_frac=BWD_ATOL_FRAC),
            compare(f"flash_bwd_dkv[dropout] dv [{label}]", dv, want[2], None, ATTN_RTOL, atol_frac=BWD_ATOL_FRAC))
        del dq, dk, dv, want, o_want, lse_want
        qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
        bwd_lib, bwd_what = flash_backend_bwd_ms(qc, kc, vc, doc, 10, dropout_p=RATE, timer=device_ms)
        sites = {
            "flash_fwd[dropout]": (lambda: fa.flash_fwd(q, k, v, **dkw), lambda: fa.flash_fwd_reference(q, k, v, **dkw),
                                   device_ms(lambda: sdpa(q, k, v, dropout_p=RATE))),
            "flash_bwd_dq[dropout]": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **dkw),
                                      lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **dkw), bwd_lib),
            "flash_bwd_dkv[dropout]": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **dkw),
                                       lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, **dkw), bwd_lib),
        }
        for kernel, (kern, twin, lib_ms) in sites.items():
            km, pm = turns(kern, twin)
            record(per_kernel, f"{kernel} @ {label}", km, pm, pair_work(kernel, b, n, n, n * n, dropout=True, heads=h),
                   lib_ms)
        log(f"  (the backward's library call: {bwd_what} at dropout_p {RATE})")
        del q, k, v, do, o, lse, delta
    sync()
    for label, b, n, dim, heads, mlp in ZOO2_CHAIN:
        for kernel, e in check_chain_shape(fb, lambda *s, scale=1.0: (torch.randn(*s, generator=rn, device=dev)
                                                                        * scale).to(torch.bfloat16),
                                           label, b, n, dim, heads, mlp).items():
            if kernel in CHAIN_FWD:
                errs[f"{kernel} @ {label}"] = e
        per_kernel.update(chain_entry_times(
            fb, lambda *s, scale=1.0: (torch.randn(*s, generator=rn, device=dev) * scale).to(torch.bfloat16), label, b,
            n, dim, heads, mlp, backward=False))
    for name, t in per_kernel.items():
        bound, by = bound_ms(t["work"])
        log(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by})"
            + ("" if t["library_ms"] is None else f", library call {t['library_ms']:.4f} ms"))
    sync()
    return per_kernel, errs


# -- ROADMAP item 9's family 3, the ten models without per-head bias tables
# (phases 53-54): each served one batch at bs=64 at the width of its upstream
# README example (bf16, random weights from SEED) with exact launch counters,
# logits against the plain bf16 path and fp32 and its host time; CrossViT,
# PiT, XCiT, MobileViT and CvT trained 3 AdamW steps at bs=32 through
# make_train_step with a generator seeded alike on every path: exact
# counters, the first step's loss and gradients against the plain path with
# the same masks, the BatchNorms' running statistics after the steps against
# the plain path's, ms/step and peak memory; then the new kernel shapes
# against their twins, timed.
#   - CrossViT: the README's 256^2, depth 4; the small branch 192 wide, patch
#     16 (257 tokens: the wide attention kernels), 2 layers; the large branch 384 wide,
#     patch 64 (17 tokens, inner 512: the whole layer served, the attention
#     block at dropout 0.1 trained), 3 layers; cross-attention depth 2;
#   - PiT: 224^2, patch 14 at stride 7, dim 256 doubling, depth (3, 3, 3),
#     16 heads: 962, 257 and 65 tokens, the last two stages on the
#     kernels;
#   - XCiT (depth 12, cls_depth 2, layer dropout 0.05), LocalViT, the
#     small-dataset ViT, RvT: config 1's widths and the README's patches;
#     NesT (224^2, patch 4, dim 96, heads 3, 3 levels, block repeats 2, 2,
#     8), MobileViT-XS, CvT and Twins-SVT at their constructors' defaults at
#     224^2: every attention on the composite (windows, dim_head != 64,
#     n > 208, a traced scale and a mask), as the JAX package routes them.
ZOO3_BS, ZOO3_TRAIN_BS, ZOO3_STEPS = 64, 32, 3
ZOO3_VIT = dict(num_classes=1000, dim=1024, depth=6, heads=16, mlp_dim=2048, dropout=RATE, emb_dropout=RATE)
ZOO3_CROSS = dict(image_size=256, num_classes=1000, depth=4, sm_dim=192, sm_patch_size=16, sm_enc_depth=2,
                  sm_enc_heads=8, sm_enc_mlp_dim=2048, lg_dim=384, lg_patch_size=64, lg_enc_depth=3, lg_enc_heads=8,
                  lg_enc_mlp_dim=2048, cross_attn_depth=2, cross_attn_heads=8, dropout=RATE, emb_dropout=RATE)
ZOO3_PIT = dict(image_size=224, patch_size=14, dim=256, num_classes=1000, depth=(3, 3, 3), heads=16, mlp_dim=2048,
                dropout=RATE, emb_dropout=RATE)
ZOO3_XCIT = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=12, cls_depth=2, heads=16,
                 mlp_dim=2048, dropout=RATE, emb_dropout=RATE, layer_dropout=0.05)
ZOO3_NEST = dict(image_size=224, patch_size=4, dim=96, heads=3, num_hierarchies=3, block_repeats=(2, 2, 8),
                 num_classes=1000)
ZOO3_MOBILE = dict(image_size=(256, 256), dims=(96, 120, 144),
                   channels=(16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384), num_classes=1000)
# name: (module, class, constructor, input shape past the batch)
ZOO3 = {
    "cross_vit": ("cross_vit", "CrossViT", ZOO3_CROSS, (3, 256, 256)),
    "pit": ("pit", "PiT", ZOO3_PIT, (3, 224, 224)),
    "xcit": ("xcit", "XCiT", ZOO3_XCIT, (3, 256, 256)),
    "local_vit": ("local_vit", "LocalViT", {**ZOO3_VIT, "image_size": 256, "patch_size": 16}, (3, 256, 256)),
    "vit_for_small_dataset": ("vit_for_small_dataset", "ViT", {**ZOO3_VIT, "image_size": 256, "patch_size": 16},
                              (3, 256, 256)),
    "rvt": ("rvt", "RvT", {**ZOO3_VIT, "image_size": 256, "patch_size": 32}, (3, 256, 256)),
    "nest": ("nest", "NesT", ZOO3_NEST, (3, 224, 224)),
    "mobile_vit": ("mobile_vit", "MobileViT", ZOO3_MOBILE, (3, 256, 256)),
    "cvt": ("cvt", "CvT", dict(num_classes=1000), (3, 224, 224)),
    "twins_svt": ("twins_svt", "TwinsSVT", dict(num_classes=1000), (3, 224, 224)),
}
ZOO3_TRAINED = ("cross_vit", "pit", "xcit", "mobile_vit", "cvt")
# the launches predicted for one served batch (PERF.md, §6): CrossViT's large
# branch 4 rounds x 3 layers and PiT's third stage 3 layers on the whole
# layer; since the wide attention kernels (257 tokens at dim_head 64) also
# CrossViT's small branch 4 rounds x 2 layers and PiT's second stage 3 layers
# on the whole layer and LocalViT's 6 attention blocks; nothing else
ZOO3_SERVED = {name: {} for name in ZOO3}
ZOO3_SERVED.update(cross_vit=per_layer(LAUNCHES_PER_LAYER, 4 * 3 + 4 * 2), pit=per_layer(LAUNCHES_PER_LAYER, 3 + 3),
                   local_vit=per_layer(BLOCK_FWD_LAUNCHES, 6))
# ... and for ZOO3_STEPS training steps: the same layers' attention blocks at dropout 0.1
ZOO3_TRAIN = {name: {} for name in ZOO3_TRAINED}
ZOO3_TRAIN.update(cross_vit=per_layer(DROPOUT_LAUNCHES_PER_LAYER, 4 * 3 + 4 * 2, ZOO3_STEPS),
                  pit=per_layer(DROPOUT_LAUNCHES_PER_LAYER, 3 + 3, ZOO3_STEPS))
# the new kernel shapes: (label, model, b, n, dim, heads, mlp) served and trained
ZOO3_SHAPES = (("CrossViT large", "cross_vit", 17, 384, 8, 2048), ("PiT stage 3", "pit", 65, 1024, 16, 2048))
ZOO3_DROPOUT_KERNELS = ("attention_rows[dropout]", "gemm_bf16[block_out]", "dropout_apply",
                        "attention_bwd_rows[dropout]", "gemm_f32out", "layernorm_bwd_rows")


# A model that launches no kernel (XCiT, MobileViT, CvT) is also held to
# fp32: its first-step loss within SIMPLE_TRAIN_VS_FP32, and its gradients
# all together within the larger of SIMPLE_TRAIN_VS_FP32's "grads" share and
# ZOO3_NOISE_RATIO x the bf16 path's own distance from itself on a batch
# with ZOO3_INPUT_NOISE relative noise (the bf16 noise floor, measured in
# the same run).  No single parameter is held: a train-mode BatchNorm takes
# out a per-channel shift or scale before it, so XCiT's local-patch
# BatchNorm biases, MobileViT's block-closing BatchNorm biases and CvT's
# ChanLayerNorm gains have fp32 gradients of norm 1e-10 to 2e-6 where bf16
# reads its rounding noise, and MobileViT's gradients read 1.25e-1 from
# fp32 all together, 1.96e-1 from themselves on the noisy batch (NVIDIA H100
# 80GB HBM3, 700.00 W).  The worst parameter, and those over
# SIMPLE_TRAIN_VS_FP32's "worst" share, are logged.
ZOO3_NOISE_RATIO, ZOO3_INPUT_NOISE = 1.5, 1e-2


def check_vs_fp32_witness(what, names, grads, fp32_grads, noisy_grads, loss, fp32_loss):
    """The first step of a bf16 model against fp32 (``grads``,
    ``fp32_grads``), the gradients' bound the larger of a share of fp32's
    norm and the bf16 path's distance from itself on a noisy batch
    (``noisy_grads``): see ZOO3_NOISE_RATIO."""
    d_loss = abs(loss - fp32_loss) / abs(fp32_loss)
    norm = lambda seq: math.sqrt(sum(t.norm().item() ** 2 for t in seq))
    total = grads_rel_l2(grads, fp32_grads)
    floor = norm([a - b for a, b in zip(noisy_grads, grads)]) / norm(fp32_grads)  # on fp32's scale, as total
    bound = max(SIMPLE_TRAIN_VS_FP32["grads"], ZOO3_NOISE_RATIO * floor)
    per = [((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(grads, fp32_grads)]
    worst = max(range(len(per)), key=per.__getitem__)
    over = [names[i] for i, v in enumerate(per) if v > SIMPLE_TRAIN_VS_FP32["worst"]]
    ok = (d_loss <= SIMPLE_TRAIN_VS_FP32["loss"] and total <= bound
          and all(bool(torch.isfinite(a).all()) for a in grads))
    log(f"  {what}: loss {loss:.6f} vs {fp32_loss:.6f} (rel {d_loss:.3e}, bound {SIMPLE_TRAIN_VS_FP32['loss']}); "
        f"grads rel L2 {total:.4e} (bound {bound:.4e}: the larger of {SIMPLE_TRAIN_VS_FP32['grads']} and "
        f"{ZOO3_NOISE_RATIO} x {floor:.4e}, the bf16 step's distance from itself on the {ZOO3_INPUT_NOISE}-noisy "
        f"batch); worst {names[worst]} {per[worst]:.4e} (fp32 norm {fp32_grads[worst].norm().item():.4e}); "
        f"{len(over)} of {len(per)} parameters over {SIMPLE_TRAIN_VS_FP32['worst']} of their fp32 norm, not held "
        f"{'ok' if ok else 'FAILED'}")
    log(f"    over it: {over}")
    if not ok:
        fail(f"training: {what} out of bounds")


def zoo3_model(name, dev, dtype, **kw):
    """One model at its phase-53 configuration (``kw`` overriding it),
    random weights from SEED, initialised in f32 and cast as the JAX benches
    cast their params."""
    import importlib

    module, cls, cfg, _ = ZOO3[name]
    model_cls = getattr(importlib.import_module(f"vit_pytorch_tpu_torch.models.{module}"), cls)
    return model_cls(**{**cfg, **kw}, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).to(dtype)


def serve_zoo3(fb, fa, name, dev, gen):
    """Serve one batch of ``name`` at ZOO3_BS (:func:`serve_batch`)."""
    fp32 = zoo3_model(name, dev, torch.float32).eval()
    x = torch.randn(ZOO3_BS, *ZOO3[name][3], generator=gen, device=dev)
    return serve_batch(fb, fa, name, fp32, x, ZOO3_SERVED[name])


def train_zoo3(fb, fa, name, dev, gen, table=None, want=None, make=None, choices=None, lr=3e-4, aux_loss_weight=0.0,
               after_step=None, fp32_too=False):
    """ZOO3_STEPS AdamW steps through make_train_step on one batch at
    ZOO3_TRAIN_BS, each with a generator seeded alike, on the kernel path,
    then on the plain path from the same initial weights (one step, or all
    of them for a model with BatchNorms): loss finite and falling, exact
    launch counters (none on the plain path), the first step's loss and
    gradients against the plain path, the BatchNorms' running statistics
    after the steps against the plain path's, ms/step (steps 2 to
    ZOO3_STEPS, host clock) and peak memory.  A model that launches no
    kernel runs the same code on both paths, so it is also trained from an
    fp32 copy of its initial weights, both at dropout 0 (torch's dropout
    masks depend on the dtype): the first step's gradients and the
    BatchNorms' statistics after the steps against fp32.  Returns the
    launch counts of the kernel path's steps.  ``table``, ``want`` and
    ``make`` (ZOO3, ZOO3_TRAIN and zoo3_model by default): the phase's
    models, their predicted launches and the function that makes one; the labels are drawn
    below the configuration's ``num_classes``.  ``choices``: a
    :class:`TokenChoices` around every run (ATS-ViT's; a :class:`DrawReplay`
    for the patch-dropout and decorrelation ViTs); ``lr``: AdamW's learning
    rate; ``aux_loss_weight``: make_train_step's, for a model that returns
    (logits, aux loss); ``after_step(model)``: run after each step on every
    path (nViT's normalize_weights); ``fp32_too``: the fp32 comparison also
    for a model that launches kernels (its bf16 copy at dropout 0 takes the
    kernels of that route)."""
    import functools

    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    table, want, make = table or ZOO3, want or ZOO3_TRAIN, make or zoo3_model
    shape, cfg = table[name][3], table[name][2]
    images = torch.randn(ZOO3_TRAIN_BS, *shape, generator=gen, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, cfg.get("num_classes", 1000), (ZOO3_TRAIN_BS,), generator=gen, device=dev)
    adamw = functools.partial(torch.optim.AdamW, lr=lr)

    def run(model, steps, images=images):
        state, step = create_train_state(model, adamw), make_train_step(model, aux_loss_weight=aux_loss_weight)
        reset_all(fb, fa)
        torch.cuda.reset_peak_memory_stats(dev)
        losses, grads = [], None
        with choices or contextlib.nullcontext():
            for i in range(steps):
                seeded = torch.Generator(device=dev).manual_seed(SEED + i)
                losses.append(step(state, images, labels, seeded)["loss"].item())
                if after_step is not None:
                    after_step(model)
                if i == 0:  # a layer that layer dropout skipped has no gradient: zeros
                    grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                             else p.grad.detach().float().clone() for p in model.parameters()]
                    t0 = time.perf_counter()
            sync()
        ms = (time.perf_counter() - t0) * 1e3 / (steps - 1) if steps > 1 else None
        return losses, grads, ms, torch.cuda.max_memory_allocated(dev) / 2**30, dict(all_launches(fb, fa))

    model = make(name, dev, torch.bfloat16)
    names = [n for n, _ in model.named_parameters()]
    batch_norms = any("running" in n for n, _ in model.named_buffers())
    plain = copy.deepcopy(model)
    losses, grads, ms, peak, counts = run(model, ZOO3_STEPS)
    what = f"{name} at bs={ZOO3_TRAIN_BS}"
    log(f"  {what}: losses {[f'{v:.6f}' for v in losses]} (AdamW at {lr}), {ms:.3f} ms/step (steps 2-{ZOO3_STEPS}, "
        f"host clock), peak memory {peak:.2f} GiB")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: the loss is not finite or does not fall on the repeated batch")
    got = {k: v for k, v in counts.items() if v}
    log(f"    launches {got} (expected {want[name]})")
    if counts != {k: want[name].get(k, 0) for k in counts}:
        fail(f"{name} training: the launch counters are not the expected ones")
    # the plain path: the first step, and all of them where BatchNorms keep statistics
    with plain_layers(), plain_attention():
        plain_losses, plain_grads, plain_ms, plain_peak, plain_counts = run(plain, ZOO3_STEPS if batch_norms else 1)
    if any(plain_counts.values()):
        fail(f"{what}: the plain path launched kernels: {plain_counts}")
    log(f"    plain path: losses {[f'{v:.6f}' for v in plain_losses]}"
        + ("" if plain_ms is None else f", {plain_ms:.3f} ms/step") + f", peak memory {plain_peak:.2f} GiB")
    compare_grads(f"{what} first step vs plain bf16 (the same masks)", grads, plain_grads, losses[0],
                  plain_losses[0], SIMPLE_TRAIN_VS_PLAIN, names)
    def check_stats(model, ref, against, bound):
        stats = bn_stats(model)
        e = rel_l2(stats, bn_stats(ref))
        ok = e <= bound and bool(torch.isfinite(stats).all())
        log(f"    BatchNorm running statistics after {ZOO3_STEPS} steps ({stats.numel()} values) vs {against}: "
            f"rel L2 {e:.4e} (bound {bound}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{what}: the BatchNorm statistics disagree with {against}")

    if batch_norms:
        check_stats(model, plain, "the plain path's", SIMPLE_TRAIN_VS_PLAIN["grads"])
    if not want[name] or fp32_too:
        no_dropout = {k: 0.0 for k in ("dropout", "emb_dropout", "attn_dropout", "ff_dropout") if k in cfg}
        fp32 = make(name, dev, torch.float32, **no_dropout)
        model, noisy = copy.deepcopy(fp32).to(torch.bfloat16), copy.deepcopy(fp32).to(torch.bfloat16)
        noisy_images = (images.float() * (1 + ZOO3_INPUT_NOISE * torch.randn(images.shape, generator=gen, device=dev))
                        ).to(torch.bfloat16)
        losses, grads, *_ = run(model, ZOO3_STEPS)
        fp32_losses, fp32_grads, *_ = run(fp32, ZOO3_STEPS, images.float())
        _, noisy_grads, *_ = run(noisy, 1, noisy_images)
        check_vs_fp32_witness(f"{what} first step vs fp32 (dropout 0)", names, grads, fp32_grads, noisy_grads,
                              losses[0], fp32_losses[0])
        if batch_norms:
            check_stats(model, fp32, "fp32's (dropout 0)", SIMPLE_TRAIN_VS_FP32["grads"])
        del fp32, noisy
    del model, plain
    return counts


def check_zoo3(fb, fa, dev, gen):
    """Phase 53: the ten models served, five trained.  Returns the serving
    counts (with the gemm sites and ms) and the training counts by model."""
    log(f"[53 CrossViT, PiT, XCiT, LocalViT, small-dataset ViT, RvT, NesT, MobileViT, CvT, Twins-SVT served] bf16, "
        f"random weights (seed {SEED}), bs={ZOO3_BS}; CrossViT {ZOO3_CROSS}; PiT {ZOO3_PIT}; XCiT {ZOO3_XCIT}; "
        f"LocalViT and the small-dataset ViT (patch 16) and RvT (patch 32) at 256^2, {ZOO3_VIT}; NesT {ZOO3_NEST}; "
        f"MobileViT-XS {ZOO3_MOBILE}; CvT and Twins-SVT at their defaults at 224^2")
    served = {name: serve_zoo3(fb, fa, name, dev, gen) for name in ZOO3}
    log(f"  [53 training] {ZOO3_STEPS} AdamW(3e-4) steps at bs={ZOO3_TRAIN_BS} through make_train_step: "
        f"{ZOO3_TRAINED}")
    trained = {name: train_zoo3(fb, fa, name, dev, gen) for name in ZOO3_TRAINED}
    return served, trained


def check_dropout_shape(fb, rnd, label, b, n, dim, heads, mlp):
    """The attention-block route's kernels at dropout RATE at one shape
    against their twins: attention_rows[dropout] and gemm_bf16[block_out]
    (phase 9's bounds), dropout_apply bitwise, attention_bwd_rows[dropout],
    gemm_f32out and layernorm_bwd_rows (phase 6's).  Returns {f"{kernel} @
    {label}": max_abs}."""
    akw = dict(heads=heads, dim_head=DH, scale=DH**-0.5, dropout_rate=RATE, seed=DROP_SEED)
    w, b_out = chain_weights(rnd, dim, heads, mlp)
    x, g = rnd(b, n, dim), rnd(b, n, dim)
    okw = dict(bias=b_out, residual=x, dropout_rate=RATE, seed=DROP_SEED, heads=heads)
    tag, errs = f"[{label}]", {}
    with torch.inference_mode():
        h = fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"])
        qkv = fb.gemm_bf16(h, w["w_qkv"], "qkv")
        m = fb.attention_rows(qkv, **akw)
        errs["attention_rows[dropout]"] = compare(f"attention_rows[dropout] {tag}", m,
                                                  fb.attention_rows_reference(qkv, **akw), ATTN_ATOL, ATTN_RTOL)
        errs["gemm_bf16[block_out]"] = compare(
            f"gemm_bf16[block_out] {tag}", fb.gemm_bf16(m, w["w_out"], "block_out", **okw),
            fb.gemm_bf16_reference(m, w["w_out"], "block_out", **okw), KERNEL_ATOL, KERNEL_RTOL, BLOCK_OUT_REL_L2)
        gm = fb.dropout_apply(g, DROP_SEED, heads=heads, rate=RATE)
        same = torch.equal(gm, fb.out_dropout_bwd_reference(g, DROP_SEED, heads=heads, rate=RATE))
        log(f"  dropout_apply {tag} bitwise equal to the twin: {same} {'ok' if same else 'FAILED'}")
        if not same:
            fail(f"dropout_apply {tag} disagrees with its twin")
        errs["dropout_apply"] = 0.0
        w_out_t, w_qkv_t = w["w_out"].t().contiguous(), w["w_qkv"].t().contiguous()
        dm = fb.gemm_bf16(gm, w_out_t, "cast")
        errs["attention_bwd_rows[dropout]"] = check_attention_bwd(fb, "attention_bwd_rows[dropout]", qkv, dm, akw,
                                                                  label)
        _, dqkv = fb.attention_bwd_rows(qkv, dm, **akw)
        dh = fb.gemm_f32out(dqkv, w_qkv_t)
        errs["gemm_f32out"] = compare(f"gemm_f32out [dh] {tag}", dh, fb.gemm_f32out_reference(dqkv, w_qkv_t), None,
                                      F32_RTOL, F32_REL_L2, atol_frac=F32_ATOL_FRAC)
        got = fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=g)
        want = fb.layernorm_bwd_rows_reference(x, dh, w["ln1_scale"], residual=g)
        errs["layernorm_bwd_rows"] = max(
            compare(f"layernorm_bwd_rows dx {tag}", got[0], want[0], KERNEL_ATOL, KERNEL_RTOL),
            compare(f"layernorm_bwd_rows dgamma {tag}", got[1], want[1], None, F32_RTOL, F32_REL_L2,
                    atol_frac=F32_ATOL_FRAC),
            compare(f"layernorm_bwd_rows dbeta {tag}", got[2], want[2], None, F32_RTOL, F32_REL_L2,
                    atol_frac=F32_ATOL_FRAC))
    sync()
    return {f"{k} @ {label}": v for k, v in errs.items()}


def time_zoo3(fb, dev, smi):
    """Phase 54: the chain at CrossViT's large branch (b=64 n=17, dim 384, 8
    heads: inner 512, mlp 2048) and at PiT's third stage (b=64 n=65, dim
    1024, 16 heads, mlp 2048), forward and backward against the twins and
    the forward's launches by device time (served), and the attention
    block's dropout kernels at bs=32 (trained) against the twins and by
    device time; returns the records and the errors."""
    log(f"[54 the new kernel shapes] {smi}")
    rn = torch.Generator(device=dev).manual_seed(SEED + 54)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=rn, device=dev) * scale).to(torch.bfloat16)
    per_kernel, errs = {}, {}
    for label, _, n, dim, heads, mlp in ZOO3_SHAPES:
        for kernel, e in check_chain_shape(fb, rnd, label, ZOO3_BS, n, dim, heads, mlp).items():
            if kernel in CHAIN_FWD:
                errs[f"{kernel} @ {label}"] = e
        errs.update(check_dropout_shape(fb, rnd, label, ZOO3_TRAIN_BS, n, dim, heads, mlp))
        per_kernel.update(chain_entry_times(fb, rnd, label, ZOO3_BS, n, dim, heads, mlp, backward=False))
        per_kernel.update(chain_entry_times(fb, rnd, label, ZOO3_TRAIN_BS, n, dim, heads, mlp, dropout_rate=RATE))
    for name, t in per_kernel.items():
        bound, by = bound_ms(t["work"])
        log(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by})"
            + ("" if t["library_ms"] is None else f", library call {t['library_ms']:.4f} ms"))
    sync()
    return per_kernel, errs


# -- ROADMAP item 9's family 3b and family 4 (phases 55-56): each model served
# one batch at bs=64 at the width of its upstream README example (bf16,
# random weights from SEED) with exact launch counters, logits against the
# plain bf16 path and fp32 and its host time; the patch-merger ViT, LeViT,
# ATS-ViT, CrossFormer and the learnable-memory Adapter trained 3 AdamW steps
# at bs=32 through make_train_step (train_zoo3, with a generator seeded alike
# on every path); then the attention block's kernels at the patch-merger's
# shape against their twins, timed.
#   - LeViT (224^2, dims 256/384/512, depth 4, heads 4/6/8, mlp_mult 2,
#     dropout 0.1), RegionViT (224^2, dims 64-512, depths 2/2/8/2, window
#     7), CrossFormer (224^2, the same dims and depths, global windows
#     8/4/2/1, local 7), ScalableViT (256^2, dim 64, depths 2/2/20/2, heads
#     2/4/8/16, ssa_dim_key 40/40/40/32, reduction 8/4/2/1, windows 64/32,
#     dropout 0.1) and SepViT (224^2, dim 32, dim_head 32, depths 1/2/6/2,
#     heads 1/2/4/8, window 7, dropout 0.1): every attention on the
#     composite (per-head biases on windows, dim_head 32 or 16, ScalableViT's
#     4,096-token windows refused by the flash gate at dim_key 32), as the
#     JAX package routes them;
#   - ATS-ViT, the learnable-memory ViT and its Adapter (5 memories a layer, 2
#     classes, the ViT frozen), LookViT: no kernel (a materialised map the
#     sampler or the reuse reads; a mask and split projections);
#   - the patch-merger ViT (256^2, patch 16, dim 1024, 12 layers of 8 heads,
#     mlp 2048, merged to 8 tokens after layer 6): layers 7-12 on the
#     attention-block kernels at n = 8 (one key chunk), served and, at
#     dropout 0.1, trained.
ZOO4_MEMORIES = 5
ZOO4_LEVIT = dict(image_size=224, num_classes=1000, stages=3, dim=(256, 384, 512), depth=4, heads=(4, 6, 8),
                  mlp_mult=2, dropout=RATE)
ZOO4_WINDOWS = dict(dim=(64, 128, 256, 512), depth=(2, 2, 8, 2), num_classes=1000)
ZOO4_SCALABLE = dict(num_classes=1000, dim=64, heads=(2, 4, 8, 16), depth=(2, 2, 20, 2), ssa_dim_key=(40, 40, 40, 32),
                     reduction_factor=(8, 4, 2, 1), window_size=(64, 32, None, None), dropout=RATE)
ZOO4_SEP = dict(num_classes=1000, dim=32, dim_head=32, heads=(1, 2, 4, 8), depth=(1, 2, 6, 2), window_size=7,
                dropout=RATE)
ZOO4_VIT = dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, mlp_dim=2048)
ZOO4_MERGER = dict(ZOO4_VIT, depth=12, heads=8, patch_merge_layer=6, patch_merge_num_tokens=8, dropout=RATE)
ZOO4_MEMORY = dict(ZOO4_VIT, depth=6, heads=8, dropout=RATE, emb_dropout=RATE)
# name: (module, class, constructor, input shape past the batch)
ZOO4 = {
    "levit": ("levit", "LeViT", ZOO4_LEVIT, (3, 224, 224)),
    "regionvit": ("regionvit", "RegionViT", dict(ZOO4_WINDOWS, window_size=7), (3, 224, 224)),
    "crossformer": ("crossformer", "CrossFormer", dict(ZOO4_WINDOWS, global_window_size=(8, 4, 2, 1),
                                                       local_window_size=7), (3, 224, 224)),
    "scalable_vit": ("scalable_vit", "ScalableViT", ZOO4_SCALABLE, (3, 256, 256)),
    "sep_vit": ("sep_vit", "SepViT", ZOO4_SEP, (3, 224, 224)),
    "ats_vit": ("ats_vit", "ViT", dict(ZOO4_VIT, depth=6, max_tokens_per_depth=(256, 128, 64, 32, 16, 8), heads=16,
                                       dropout=RATE, emb_dropout=RATE), (3, 256, 256)),
    "vit_with_patch_merger": ("vit_with_patch_merger", "ViT", ZOO4_MERGER, (3, 256, 256)),
    "learnable_memory_vit": ("learnable_memory_vit", "ViT", ZOO4_MEMORY, (3, 256, 256)),
    # the Adapter trains its memories and head on a frozen ViT, without dropout
    "adapter": ("learnable_memory_vit", "Adapter", dict(ZOO4_MEMORY, num_classes=2, dropout=0.0, emb_dropout=0.0),
                (3, 256, 256)),
    "look_vit": ("look_vit", "LookViT", dict(image_size=256, patch_size=32, highres_patch_size=8, dim=1024, depth=2,
                                             num_classes=1000), (3, 256, 256)),
}
ZOO4_TRAINED = ("vit_with_patch_merger", "levit", "ats_vit", "crossformer", "adapter")
# CrossFormer's logits at init read ~14 nats (the flax init's lecun-normal
# weights, no norm before its head; the JAX model's alike): AdamW's sign-like
# first steps at 3e-4 overshoot, its loss rising again by the third step
# (14.32 -> 13.91 -> 15.78 on the card, NVIDIA H100 80GB HBM3, 700.00 W); at
# 3e-5 it falls at every step (fp32, CPU, two batches)
ZOO4_LR = {"crossformer": 3e-5}
# the launches predicted for one served batch (PERF.md, §6): the patch-merger's
# layers 7-12 on the attention block and, since the wide attention kernels,
# its 256-token layers 1-6 too; nothing else
ZOO4_SERVED = {name: {} for name in ZOO4}
ZOO4_SERVED["vit_with_patch_merger"] = per_layer(BLOCK_FWD_LAUNCHES, ZOO4_MERGER["depth"])
# ... and for ZOO3_STEPS training steps: the same layers' attention blocks at dropout 0.1
ZOO4_TRAIN = {name: {} for name in ZOO4_TRAINED}
ZOO4_TRAIN["vit_with_patch_merger"] = per_layer(DROPOUT_LAUNCHES_PER_LAYER, ZOO4_MERGER["depth"], ZOO3_STEPS)
# the new kernel shape: (label, n, dim, heads, mlp), served at ZOO3_BS and trained at ZOO3_TRAIN_BS
ZOO4_SHAPE = ("patch-merger", ZOO4_MERGER["patch_merge_num_tokens"], 1024, 8, 2048)
ZOO4_FWD_KERNELS = ("layernorm_rows", "gemm_bf16[qkv]", "attention_rows")


class TokenChoices:
    """ATS-ViT's token choices, the outputs of ``models/ats_vit.py::
    unique_sorted_with_pad``: inside the first ``with`` block they are
    recorded in call order, inside every later one replayed in that order
    (cyclically), so that the plain bf16 path and the fp32 copy keep the
    tokens the kernel path kept.  The choice is an argmax (with Gumbel noise
    in training) over scores that bf16 rounding moves: where two are near a
    tie fp32 keeps another token and the logits part whole (phase 55 logs how
    many images); the choice itself is held bit for bit against the JAX
    package on the CPU (tests/test_torch_token_family.py)."""

    def __init__(self):
        self.taken = None

    def __enter__(self):
        from vit_pytorch_tpu_torch.models import ats_vit

        self.module, self.orig, self.i = ats_vit, ats_vit.unique_sorted_with_pad, 0
        if self.taken is None:
            self.taken = []
            ats_vit.unique_sorted_with_pad = self._record
        else:
            ats_vit.unique_sorted_with_pad = self._replay
        return self

    def _record(self, ids):
        out = self.orig(ids)
        self.taken.append(out)
        return out

    def _replay(self, ids):
        out = self.taken[self.i % len(self.taken)]
        self.i += 1
        if out[0].shape != ids.shape:
            fail(f"ATS-ViT: a replayed token choice of shape {tuple(out[0].shape)} for ids {tuple(ids.shape)}")
        return out

    def __exit__(self, *exc):
        self.module.unique_sorted_with_pad = self.orig


def zoo4_model(name, dev, dtype, **kw):
    """One model at its phase-55 configuration (``kw`` overriding it),
    random weights from SEED, initialised in f32 and cast as the JAX benches
    cast their params; the Adapter around a ViT of ZOO4_MEMORY, frozen."""
    import importlib

    from vit_pytorch_tpu_torch.models import learnable_memory_vit
    from vit_pytorch_tpu_torch.models.max_vit import BatchNorm

    module, cls, cfg, _ = ZOO4[name]
    cfg, gen = {**cfg, **kw}, torch.Generator(device=dev).manual_seed(SEED)
    if name == "adapter":
        vit = learnable_memory_vit.ViT(**{**cfg, "num_classes": ZOO4_MEMORY["num_classes"]}, device=dev,
                                       generator=gen)
        learnable_memory_vit.freeze_all_layers_(vit)
        return learnable_memory_vit.Adapter(vit=vit, num_memories_per_layer=ZOO4_MEMORIES,
                                            num_classes=cfg["num_classes"], generator=gen).to(dtype)
    model = getattr(importlib.import_module(f"vit_pytorch_tpu_torch.models.{module}"), cls)(**cfg, device=dev,
                                                                                             generator=gen)
    if name == "levit":
        # the init's zero output-BatchNorm scales (levit.py:124) zero every map
        # after the first downsampling (its attention has no residual, the
        # convolutions' biases start at zero): serve and train from ones
        for m in model.modules():
            if isinstance(m, BatchNorm):
                torch.nn.init.ones_(m.weight)
    return model.to(dtype)


def check_zoo4(fb, fa, dev, gen):
    """Phases 55-56's models: the ten served (the nine models and the
    Adapter), five trained.  Returns the serving counts (with the gemm sites
    and ms) and the training counts by model."""
    log(f"[55 LeViT, RegionViT, CrossFormer, ScalableViT, SepViT, ATS-ViT, patch-merger ViT, learnable-memory ViT "
        f"and its Adapter, LookViT served] bf16, random weights (seed {SEED}), bs={ZOO3_BS}; "
        + "; ".join(f"{name} {cfg} at {shape[-1]}^2" for name, (_, _, cfg, shape) in ZOO4.items()))
    served = {}
    for name in ZOO4:
        fp32 = zoo4_model(name, dev, torch.float32).eval()
        x = torch.randn(ZOO3_BS, *ZOO4[name][3], generator=gen, device=dev)
        call = lambda model, x: model(x)
        if name == "ats_vit":
            with torch.inference_mode():
                own = (copy.deepcopy(fp32).to(torch.bfloat16)(x.to(torch.bfloat16), True)[1], fp32(x, True)[1])
            parted = int((own[0] != own[1]).any(-1).sum())
            log(f"  ats_vit: {parted} of {ZOO3_BS} images keep other tokens in bf16 than in fp32 when each path "
                f"chooses its own; the plain and fp32 paths below replay the kernel path's choices")
            choices = TokenChoices()

            def call(model, x):
                with choices:
                    return model(x)
        # LeViT at these random weights moves its logits 0.39 with 1e-2 input noise (fp32, CPU)
        served[name] = serve_batch(fb, fa, name, fp32, x, ZOO4_SERVED[name], call,
                                   classes=ZOO4[name][2]["num_classes"], noise_floor=name == "levit")
        del fp32
    log(f"[56 training] {ZOO3_STEPS} AdamW(3e-4, CrossFormer 3e-5) steps at bs={ZOO3_TRAIN_BS} through "
        f"make_train_step: {ZOO4_TRAINED} (ATS-ViT sampling, the Adapter's ViT frozen)")
    trained = {name: train_zoo3(fb, fa, name, dev, gen, table=ZOO4, want=ZOO4_TRAIN, make=zoo4_model,
                                choices=TokenChoices() if name == "ats_vit" else None, lr=ZOO4_LR.get(name, 3e-4))
               for name in ZOO4_TRAINED}
    return served, trained


def time_zoo4(fb, dev, smi):
    """Phase 56's kernels: the chain at the patch-merger's merged shape (b=64
    n=8, dim 1024, 8 heads: inner 512, mlp 2048), forward and backward
    against the twins and the block's forward launches by device time
    (served), and the attention block's dropout kernels at bs=32 (trained)
    against the twins and by device time; returns the records and the
    errors."""
    log(f"[56 the patch-merger's kernel shape] {smi}")
    rn = torch.Generator(device=dev).manual_seed(SEED + 56)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=rn, device=dev) * scale).to(torch.bfloat16)
    label, n, dim, heads, mlp = ZOO4_SHAPE
    errs = {f"{k} @ {label}": e for k, e in check_chain_shape(fb, rnd, label, ZOO3_BS, n, dim, heads, mlp).items()
            if k in ZOO4_FWD_KERNELS}
    errs.update(check_dropout_shape(fb, rnd, label, ZOO3_TRAIN_BS, n, dim, heads, mlp))
    per_kernel = chain_entry_times(fb, rnd, label, ZOO3_BS, n, dim, heads, mlp, backward=False)
    per_kernel.update(chain_entry_times(fb, rnd, label, ZOO3_TRAIN_BS, n, dim, heads, mlp, dropout_rate=RATE))
    sync()
    return per_kernel, errs


# -- ROADMAP item 9's families 5 and 6 and AcceptVideoWrapper's MOSS (phases
# 57-58): each model served one batch at bs=64 (bf16, random weights from
# SEED) with exact launch counters, logits against the plain bf16 path and
# fp32 (the fp32 bound the larger of SIMPLE_LOGITS_VS_FP32 and
# ZOO3_NOISE_RATIO x the bf16 path's distance on a noisy batch: phase 53's
# and 55's rule) and its host time; the wrapper with MOSS around config 1's
# ViT on 8-frame clips; the patch-dropout ViT, the KEEL ViT, SimpleUViT, the
# decorrelation ViT and nViT trained 3 AdamW steps at bs=32 through
# make_train_step (train_zoo3: first step against the plain path and, at
# dropout 0, against fp32); then the new kernel shapes against their twins,
# timed with L2 flushed.
#   - config 1's width (256^2, patch 32, dim 1024, depth 6, 16 heads, mlp
#     2048): the patch-dropout ViT (a quarter of the 64 patches dropped in
#     training: 49 tokens with the cls token; served whole, 65: the whole
#     layer), the KEEL ViT (the attention block, no residual, a zero LN
#     bias), SimpleUViT (64 patches + 4 registers: the block at n = 68), the
#     decorrelation ViT (half the tokens sampled for its loss; the
#     composite), ViTDetPool without a mask (the block) and with a pixel mask
#     (the composite);
#   - nViT (256^2, patch 16, dim 1024, depth 6, 8 heads, mlp 2048: 256
#     tokens), JetViT (224^2, patch 16: a 14 x 14 grid of 7 x 7 windows, dim
#     1024, depth 6, 16 heads, mlp 2048, the kinds FA, WA, LA, a random
#     (FA, WA, LA), WA, LA), WWT (config 1's dim, depth, heads and mlp, slots
#     of 16 and 4), ViViT with MOSS (config 5's ViViT, MOSS's defaults,
#     causal): the composite, as the JAX package routes them;
#   - JumboViT at dim 64, 2 heads of 64, mlp_dim 4 (its patch FF 256 wide),
#     6 jumbo tokens, jumbo_ff_mult 2 (its jumbo FF 384 x 294,912), 256^2,
#     patch 32: the block at n = 70, dim 64.  Its FFs grow with the square
#     of the width, so it has no config-1 width (2 x 1024 x 2,097,152
#     weights a layer in the patch FF alone).
ZOO5_JET_LAYERS = ("FA", "WA", "LA", ("FA", "WA", "LA"), "WA", "LA")
ZOO5_JUMBO = dict(image_size=256, patch_size=32, num_classes=1000, dim=64, depth=6, heads=2, dim_head=64, mlp_dim=4,
                  jumbo_cls_k=6, jumbo_ff_mult=2)
ZOO5_WRAPPER_FRAMES, ZOO5_WRAPPER_CLIPS = 8, 8
ZOO5_PATCH_DROPOUT = 0.25
ZOO5_DECORR_WEIGHT = 0.1
# name: (module, class, constructor, input shape past the batch)
ZOO5 = {
    "vit_with_patch_dropout": ("vit_with_patch_dropout", "ViT",
                               dict(CONFIG1, patch_dropout=ZOO5_PATCH_DROPOUT, dropout=RATE), (3, 256, 256)),
    "vit_with_keel_post_ln": ("vit_with_keel_post_ln", "ViT", dict(CONFIG1, dropout=RATE), (3, 256, 256)),
    "simple_uvit": ("simple_uvit", "SimpleUViT", CONFIG1, (3, 256, 256)),
    "vit_with_decorr": ("vit_with_decorr", "ViT", dict(CONFIG1, decorr_sample_frac=0.5), (3, 256, 256)),
    "vit_detpool": ("vit_detpool", "ViTDetPool", CONFIG1, (3, 256, 256)),
    "vit_detpool_mask": ("vit_detpool", "ViTDetPool", CONFIG1, (3, 256, 256)),
    "normalized_vit": ("normalized_vit", "nViT", dict(image_size=256, patch_size=16, num_classes=1000, dim=1024,
                                                      depth=6, heads=8, mlp_dim=2048), (3, 256, 256)),
    "jet_vit": ("jet_vit", "JetViT", dict(image_size=224, patch_size=16, num_classes=1000, dim=1024, depth=6, heads=16,
                                          mlp_dim=2048, attn_layers=ZOO5_JET_LAYERS), (3, 224, 224)),
    "wwt": ("wwt", "WWT", dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6, heads=16,
                               mlp_dim=2048, num_slots=(16, 4)), (3, 256, 256)),
    "vivit_with_moss": ("vivit_with_moss", "ViViT", VIVIT, VIVIT_SHAPE),
    "jumbo_vit": ("jumbo_vit", "JumboViT", ZOO5_JUMBO, (3, 256, 256)),
    "accept_video_wrapper": (None, "AcceptVideoWrapper", dict(CONFIG1, num_classes=0),
                             (3, ZOO5_WRAPPER_FRAMES, 256, 256)),
}
ZOO5_TRAINED = ("vit_with_patch_dropout", "vit_with_keel_post_ln", "simple_uvit", "vit_with_decorr", "normalized_vit")
ZOO5_DEPTH = CONFIG1["depth"]
# the launches predicted for one served batch (PERF.md, §6): the patch-dropout
# ViT's whole layers, the wrapped ViT's whole layers (MOSS none), the
# attention blocks of the KEEL ViT, SimpleUViT, JumboViT and the mask-free
# ViTDetPool, nothing else
ZOO5_SERVED = {name: {} for name in ZOO5}
ZOO5_SERVED.update({name: per_layer(LAUNCHES_PER_LAYER, ZOO5_DEPTH)
                    for name in ("vit_with_patch_dropout", "accept_video_wrapper")})
ZOO5_SERVED.update({name: per_layer(BLOCK_FWD_LAUNCHES, ZOO5_DEPTH)
                    for name in ("vit_with_keel_post_ln", "simple_uvit", "jumbo_vit", "vit_detpool")})
# ... and for ZOO3_STEPS training steps: the attention blocks with dropout 0.1
# (patch dropout, KEEL), without (SimpleUViT), nothing else
ZOO5_TRAIN = {name: {} for name in ZOO5_TRAINED}
ZOO5_TRAIN.update({name: per_layer(DROPOUT_LAUNCHES_PER_LAYER, ZOO5_DEPTH, ZOO3_STEPS)
                   for name in ("vit_with_patch_dropout", "vit_with_keel_post_ln")})
ZOO5_TRAIN["simple_uvit"] = per_layer(BLOCK_TRAIN_LAUNCHES, ZOO5_DEPTH, ZOO3_STEPS)
# the new kernel shapes: (label, b, n, dim, heads, bias of the block's projection out)
ZOO5_BLOCKS = (("JumboViT", ZOO3_BS, 64 + 6, 64, 2, False), ("SimpleUViT", ZOO3_BS, 64 + 4, 1024, 16, False))
ZOO5_KEPT = int(64 * (1 - ZOO5_PATCH_DROPOUT)) + 1  # the patch-dropout ViT's trained tokens
BLOCK_FWD_KERNELS = ("layernorm_rows", "gemm_bf16[qkv]", "attention_rows", "gemm_bf16[block_out]")
# nViT's weights after normalize_weights: unit norm along each one's axis,
# within 1e-3 in fp32; a bf16 copy of a unit vector is within 2^-8 of unit
# norm (each element's rounding moves it by at most 2^-8 of itself, and a
# row whose mass sits in one element reads that element's rounding: 1.98e-3
# on the CPU at a tiny width)
NVIT_UNIT_NORM_TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0**-8}


class DrawReplay:
    """A random draw recorded on the first path and replayed on the others:
    ``owner.name`` (a function of a module, or a method of a class) is
    wrapped inside the first ``with`` block so that its outputs are
    recorded in call order, and inside every later one so that they are
    replayed in that order (cyclically), each checked against its call's
    arguments (the ints and shapes among them).  A replayed call still
    draws (and drops) its own values, so that every generator advances as on
    the recording path and the draws after it (the dropout masks) stay the
    same; ``differ`` counts the replayed calls whose own draw was not the
    recorded one.  The patch-dropout ViT's kept tokens
    (``nn/patch.py::PatchDropout.keep_indices``) and the decorrelation
    ViT's token scores (``models/vit_with_decorr.py::sample_scores``) are
    drawn from the step's seeded generator alike on every path; replaying
    them holds the paths to one draw by construction, as
    :class:`TokenChoices` does for ATS-ViT's choices."""

    def __init__(self, owner, name):
        self.owner, self.name, self.taken, self.differ, self.replayed = owner, name, None, 0, 0

    @staticmethod
    def _key(args):
        return tuple(tuple(a) if isinstance(a, torch.Size) else a for a in args if isinstance(a, (int, tuple)))

    def __enter__(self):
        self.orig, self.i = getattr(self.owner, self.name), 0
        if self.taken is None:
            self.taken = []

            def wrapped(*args, **kw):
                out = self.orig(*args, **kw)
                self.taken.append((self._key(args), out))
                return out
        else:
            def wrapped(*args, **kw):
                own = self.orig(*args, **kw)
                key, out = self.taken[self.i % len(self.taken)]
                self.i += 1
                if key != self._key(args):
                    fail(f"{self.name}: a replayed draw of {key} for a call with {self._key(args)}")
                self.replayed += 1
                self.differ += not torch.equal(own.to(out.device), out)
                return out
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def zoo5_model(name, dev, dtype, **kw):
    """One model at its phase-57 configuration (``kw`` overriding it),
    random weights from SEED, initialised in f32 and cast; the wrapper
    around a config-1 ViT that returns its tokens, with MOSS (its defaults,
    dim 1024) built from a dict."""
    import importlib

    from vit_pytorch_tpu_torch.models.vit import ViT
    from vit_pytorch_tpu_torch.wrappers.accept_video_wrapper import AcceptVideoWrapper

    module, cls, cfg, _ = ZOO5[name]
    cfg, gen = {**cfg, **kw}, torch.Generator(device=dev).manual_seed(SEED)
    if name == "accept_video_wrapper":
        vit = ViT(**cfg, device=dev, generator=gen)
        return AcceptVideoWrapper(vit, moss=dict(dim=cfg["dim"]), device=dev, generator=gen).to(dtype)
    model_cls = getattr(importlib.import_module(f"vit_pytorch_tpu_torch.models.{module}"), cls)
    return model_cls(**cfg, device=dev, generator=gen).to(dtype)


def object_masks(b, size, dev, gen):
    """(b, size, size) pixel masks, each one box of size/4 to size/2 a side
    at a random place."""
    lo = torch.randint(0, size // 2, (2, b, 1), generator=gen, device=dev)
    side = torch.randint(size // 4, size // 2 + 1, (2, b, 1), generator=gen, device=dev)
    pos = torch.arange(size, device=dev)
    rows = (pos >= lo[0]) & (pos < lo[0] + side[0])
    cols = (pos >= lo[1]) & (pos < lo[1] + side[1])
    return rows[:, :, None] & cols[:, None, :]


class UnitNormCheck:
    """nViT's hook after each optimizer step: normalize_weights, then every
    NormLinear weight of unit norm along its axis within
    NVIT_UNIT_NORM_TOL for its dtype; ``worst`` the largest distance from
    one by dtype."""

    def __init__(self):
        self.worst = {}

    def __call__(self, model):
        from vit_pytorch_tpu_torch.models import normalized_vit

        normalized_vit.normalize_weights(model)
        linears = [m for m in model.modules() if isinstance(m, normalized_vit.NormLinear)]
        dtype = linears[0].raw_weight.dtype
        norms = torch.cat([m.raw_weight.float().norm(dim=m.norm_dim) for m in linears])
        worst = (norms - 1).abs().max().item()
        if not worst <= NVIT_UNIT_NORM_TOL[dtype]:
            fail(f"nViT: a {dtype} weight's norm is {worst:.3e} off one after normalize_weights (bound "
                 f"{NVIT_UNIT_NORM_TOL[dtype]:.3e})")
        self.worst[dtype] = max(self.worst.get(dtype, 0.0), worst)


def check_zoo5(fb, fa, dev, gen):
    """Phase 57: the ten models (ViTDetPool with and without a mask) and the
    MOSS wrapper served; phase 58: five trained.  Returns the serving counts
    (with the gemm sites and ms) and the training counts by model."""
    from vit_pytorch_tpu_torch.models import vit_with_decorr
    from vit_pytorch_tpu_torch.nn.patch import PatchDropout

    log(f"[57 the patch-dropout, KEEL and decorrelation ViTs, SimpleUViT, ViTDetPool, nViT, JetViT, WWT, ViViT-MOSS, "
        f"JumboViT and the AcceptVideoWrapper with MOSS served] bf16, random weights (seed {SEED}), bs={ZOO3_BS} "
        f"({ZOO5_WRAPPER_CLIPS} clips of {ZOO5_WRAPPER_FRAMES} frames for the wrapper); "
        + "; ".join(f"{name} {cfg} at {shape}" for name, (_, _, cfg, shape) in ZOO5.items()))
    served = {}
    for name in ZOO5:
        fp32 = zoo5_model(name, dev, torch.float32).eval()
        bs = ZOO5_WRAPPER_CLIPS if name == "accept_video_wrapper" else ZOO3_BS
        x = torch.randn(bs, *ZOO5[name][3], generator=gen, device=dev)
        call, classes = (lambda model, x: model(x)), 1000
        if name == "vit_with_decorr":
            call = lambda model, x: model(x)[0]
        elif name == "vit_detpool_mask":
            masks = object_masks(bs, ZOO5[name][3][-1], dev, gen)
            log(f"  vit_detpool_mask: boxes keep {masks.float().mean().item():.3f} of the pixels")
            call = lambda model, x, masks=masks: model(x, masks)
        elif name == "accept_video_wrapper":
            cfg = ZOO5[name][2]
            call = lambda model, x: model(x).flatten(1)
            classes = x.shape[2] * ((cfg["image_size"] // cfg["patch_size"]) ** 2 + 1) * cfg["dim"]
        served[name] = serve_batch(fb, fa, name, fp32, x, ZOO5_SERVED[name], call, classes=classes,
                                   noise_floor=True)
        del fp32
    log(f"[58 training] {ZOO3_STEPS} AdamW(3e-4) steps at bs={ZOO3_TRAIN_BS} through make_train_step: {ZOO5_TRAINED} "
        f"(the patch-dropout and KEEL ViTs at dropout {RATE}, the decorrelation ViT's loss weighted "
        f"{ZOO5_DECORR_WEIGHT}, nViT's normalize_weights after each step); the first step also against fp32 at "
        f"dropout 0")
    extra = {
        "vit_with_patch_dropout": dict(choices=DrawReplay(PatchDropout, "keep_indices")),
        "vit_with_decorr": dict(choices=DrawReplay(vit_with_decorr, "sample_scores"),
                                aux_loss_weight=ZOO5_DECORR_WEIGHT),
        "normalized_vit": dict(after_step=UnitNormCheck()),
    }
    trained = {name: train_zoo3(fb, fa, name, dev, gen, table=ZOO5, want=ZOO5_TRAIN, make=zoo5_model, fp32_too=True,
                                **extra.get(name, {}))
               for name in ZOO5_TRAINED}
    for name, kw in extra.items():
        if "choices" in kw:
            log(f"  {name}: {kw['choices'].replayed} draws replayed on the plain and fp32 paths, {kw['choices'].differ} "
                f"of them other than the path's own draw")
    log("  nViT after each step: every NormLinear weight of unit norm within "
        + ", ".join(f"{w:.3e} in {dtype} (bound {NVIT_UNIT_NORM_TOL[dtype]:.3e})"
                    for dtype, w in extra["normalized_vit"]["after_step"].worst.items()) + " ok")
    return served, trained


def block_entry_times(fb, rnd, label, b, n, dim, heads, bias, forward=True, backward=False, sites=None):
    """The attention block's launches at one shape as a model runs them
    (dropout 0): forward layernorm_rows, gemm_bf16[qkv], attention_rows and
    gemm_bf16[block_out] bare (no residual: the models add theirs outside;
    with the projection's bias where ``bias``), backward attention_bwd_rows,
    gemm_f32out and layernorm_bwd_rows; block_out against its twin here,
    each timed against its twin in turns with L2 flushed, with its work and
    its library call (F.layer_norm, F.linear, SDPA,
    native_layer_norm_backward) or yardstick; ``sites``: only those kernels.
    Returns the records and the errors, keys ``f"{kernel} @ {label}"``."""
    inner = heads * DH
    rows = b * n
    akw = dict(heads=heads, dim_head=DH, scale=DH**-0.5)
    timer = lambda f: device_ms(f, flush=True)
    F_ = torch.nn.functional
    w, b_out = chain_weights(rnd, dim, heads, 4 * dim)
    b_out = b_out if bias else None
    x, dy = rnd(b, n, dim), rnd(b, n, dim)
    per_kernel, errs, entries = {}, {}, []
    with torch.inference_mode():
        h = fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"])
        qkv = fb.gemm_bf16(h, w["w_qkv"], "qkv")
        m = fb.attention_rows(qkv, **akw)
        q, k, v = qkv.view(b, n, 3, heads, DH).permute(2, 0, 3, 1, 4)
        okw = dict(bias=b_out, heads=heads)
        if forward:
            errs[f"gemm_bf16[block_out] @ {label}"] = compare(
                f"gemm_bf16[block_out] bare [{label}]", fb.gemm_bf16(m, w["w_out"], "block_out", **okw),
                fb.gemm_bf16_reference(m, w["w_out"], "block_out", **okw), KERNEL_ATOL, KERNEL_RTOL,
                BLOCK_OUT_REL_L2)
            entries += [
                ("layernorm_rows", lambda: fb.layernorm_rows(x, w["ln1_scale"], w["ln1_bias"]),
                 lambda: fb.layernorm_rows_reference(x, w["ln1_scale"], w["ln1_bias"]), ln_work(rows, dim),
                 lambda: timer(lambda: F_.layer_norm(x, (dim,), w["ln1_scale"], w["ln1_bias"], fb.LN_EPS)), None),
                ("gemm_bf16[qkv]", lambda: fb.gemm_bf16(h, w["w_qkv"], "qkv"),
                 lambda: fb.gemm_bf16_reference(h, w["w_qkv"], "qkv"), gemm_work(rows, 3 * inner, dim),
                 lambda: timer(lambda: F_.linear(h, w["w_qkv"])), None),
                ("attention_rows", lambda: fb.attention_rows(qkv, **akw),
                 lambda: fb.attention_rows_reference(qkv, **akw), attention_work(b, n, heads),
                 lambda: timer(lambda: F_.scaled_dot_product_attention(q, k, v)), None),
                ("gemm_bf16[block_out]", lambda: fb.gemm_bf16(m, w["w_out"], "block_out", **okw),
                 lambda: fb.gemm_bf16_reference(m, w["w_out"], "block_out", **okw),
                 gemm_work(rows, dim, inner, bias=bias), lambda: timer(lambda: F_.linear(m, w["w_out"], b_out)), None),
            ]
        if backward:
            w_out_t, w_qkv_t = w["w_out"].t().contiguous(), w["w_qkv"].t().contiguous()
            dm = fb.gemm_bf16(dy, w_out_t, "cast")
            _, dqkv = fb.attention_bwd_rows(qkv, dm, **akw)
            dh = fb.gemm_f32out(dqkv, w_qkv_t)
            aten = torch.ops.aten
            _, mean, rstd = aten.native_layer_norm(x, [dim], w["ln1_scale"], w["ln1_bias"], fb.LN_EPS)
            g16 = dh.to(x.dtype)
            with torch.inference_mode(False), torch.enable_grad():
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                go = dm.view(b, n, heads, DH).transpose(1, 2).clone()
                sdpa_ms = timer(lambda: torch.autograd.grad(F_.scaled_dot_product_attention(*leaves), leaves, go))
            entries += [
                ("attention_bwd_rows", lambda: fb.attention_bwd_rows(qkv, dm, **akw),
                 lambda: fb.attention_bwd_rows_reference(qkv, dm, **akw), attention_work(b, n, heads, backward=True),
                 None, (sdpa_ms, SDPA_FWD_BWD)),
                ("gemm_f32out", lambda: fb.gemm_f32out(dqkv, w_qkv_t), lambda: fb.gemm_f32out_reference(dqkv, w_qkv_t),
                 gemm_work(rows, dim, 3 * inner, out_bytes=4), None, (timer(lambda: F_.linear(dqkv, w_qkv_t)), None)),
                ("layernorm_bwd_rows", lambda: fb.layernorm_bwd_rows(x, dh, w["ln1_scale"], residual=dy),
                 lambda: fb.layernorm_bwd_rows_reference(x, dh, w["ln1_scale"], residual=dy),
                 ln_bwd_work(rows, dim, residual=True),
                 lambda: timer(lambda: aten.native_layer_norm_backward(g16, x, [dim], mean, rstd, w["ln1_scale"],
                                                                       w["ln1_bias"], [True, True, True])), None),
            ]
        for name, kern, twin, wk, lib, prod in entries:
            if sites is not None and name not in sites:
                continue
            lib_ms = lib() if lib is not None else None
            p1, k1, k2, p2 = (timer(f) for f in (twin, kern, kern, twin))
            km, pm = (k1 + k2) / 2, (p1 + p2) / 2
            record(per_kernel, f"{name} @ {label}", km, pm, wk, library_ms=lib_ms,
                   product_ms=None if prod is None else prod[0], product_of=None if prod is None else prod[1])
            log(f"  {name} @ {label}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bound_ms(wk)[0]:.4f} ms"
                + ("" if lib_ms is None else f", library call {lib_ms:.4f} ms")
                + ("" if prod is None else f", yardstick ({prod[1] or 'F.linear, the bare product'}) {prod[0]:.4f} ms"))
    sync()
    return per_kernel, errs


def time_zoo5(fb, dev, smi):
    """Phase 58's kernels: the chain's forward and backward against the twins
    at JumboViT's block shape (b=64 n=70, dim 64, 2 heads: K = 64 for qkv,
    one k-tile; LayerNorms of 64 columns) and at SimpleUViT's (n=68, dim
    1024, 16 heads, served at bs=64, trained at bs=32), the attention
    block's dropout kernels at the patch-dropout ViT's kept 49 tokens (bs=32,
    rate 0.1), and the bare gemm_bf16[block_out] (with its bias, no
    residual) at the KEEL ViT's (b=64 n=65); each of the paths' launches at
    those shapes timed with L2 flushed.  Returns the records and the
    errors."""
    log(f"[58 the new kernel shapes] {smi}")
    rn = torch.Generator(device=dev).manual_seed(SEED + 58)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=rn, device=dev) * scale).to(torch.bfloat16)
    per_kernel, errs = {}, {}
    jumbo_mlp = ZOO5_JUMBO["dim"] * ZOO5_JUMBO["mlp_dim"]
    for (label, b, n, dim, heads, bias), mlp in zip(ZOO5_BLOCKS, (jumbo_mlp, CONFIG1["mlp_dim"])):
        errs.update({f"{k} @ {label}": e for k, e in check_chain_shape(fb, rnd, label, b, n, dim, heads, mlp).items()
                     if k in BLOCK_FWD_KERNELS})
        times, block_errs = block_entry_times(fb, rnd, label, b, n, dim, heads, bias)
        per_kernel.update(times)
        errs.update(block_errs)
    # SimpleUViT trained at bs=32: the backward's kernels at that shape
    label, _, n, dim, heads, _ = ZOO5_BLOCKS[1]
    errs.update({f"{k} @ {label}": e for k, e in check_chain_shape(fb, rnd, label, ZOO3_TRAIN_BS, n, dim, heads,
                                                                    CONFIG1["mlp_dim"]).items() if k in CHAIN_BWD})
    per_kernel.update(block_entry_times(fb, rnd, label, ZOO3_TRAIN_BS, n, dim, heads, False, forward=False,
                                        backward=True)[0])
    errs.update(check_dropout_shape(fb, rnd, "patch-dropout kept", ZOO3_TRAIN_BS, ZOO5_KEPT, 1024, 16, 2048))
    per_kernel.update(chain_entry_times(fb, rnd, "patch-dropout kept", ZOO3_TRAIN_BS, ZOO5_KEPT, 1024, 16, 2048,
                                        dropout_rate=RATE))
    times, keel_errs = block_entry_times(fb, rnd, "KEEL", ZOO3_BS, CONFIG1_N, 1024, 16, True,
                                         sites=("gemm_bf16[block_out]",))
    per_kernel.update({k.replace("[block_out]", "[block_out, bare]"): v for k, v in times.items()})
    errs.update({k.replace("[block_out]", "[block_out, bare]"): v for k, v in keel_errs.items()})
    sync()
    return per_kernel, errs


# -- phases 59-60: checkpoints, the input pipeline, the Predictor, artifacts (ROADMAP item 11a) --------------
INFRA_IMAGES, INFRA_BATCH, INFRA_EPOCHS, INFRA_SPLIT = 192, 32, 4, 2
PREFETCH_STRESS_BATCHES, PREFETCH_STRESS_DEPTH = 50, 3
PREFETCH_BIG_BATCH = 256  # where the step is bound by the card, not by the host's launches
ARTIFACT_REQUESTS = (1, 5, 130)


def infra_data():
    """Phase 59's host set: seeded numpy images (f32) and labels."""
    rng = np.random.default_rng(SEED)
    return {"x": rng.standard_normal((INFRA_IMAGES, 3, 224, 224), dtype=np.float32),
            "y": rng.integers(0, 1000, INFRA_IMAGES)}


def infra_model(dev, seed):
    from vit_pytorch_tpu_torch import ViT

    return ViT(image_size=224, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP,
               device=dev, generator=torch.Generator(device=dev).manual_seed(seed)).to(torch.bfloat16)


def infra_run(fb, dev, data, ckpt_dir, epochs, resume):
    """Epochs of minibatches -> prefetch_to_device -> make_train_step, saved
    each epoch; with ``resume`` a new model (another seed) and optimizer
    restore the latest step first.  Exact counters every step.  Returns the
    state and the steps taken."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step
    from vit_pytorch_tpu_torch.utils.checkpoint import CheckpointManager
    from vit_pytorch_tpu_torch.utils.data import minibatches, prefetch_to_device

    state = create_train_state(infra_model(dev, SEED + 1 if resume else SEED))
    step = make_train_step(state.model)
    want = {k: DEPTH * TRAIN_LAUNCHES_PER_LAYER.get(k, 0) for k in fb.LAUNCHES}
    steps = 0
    with CheckpointManager(ckpt_dir, max_to_keep=2, async_save=True) as mgr:
        start = 0
        if resume:
            mgr.restore(state)
            start = mgr.latest_step()
        for epoch in range(start, epochs):
            feed = prefetch_to_device(minibatches(data, INFRA_BATCH, rng=np.random.default_rng((1, epoch))), depth=2,
                                      host_workers=True, device=dev)
            for batch in feed:
                fb.reset_launch_counts()
                step(state, batch["x"].to(torch.bfloat16), batch["y"])
                if dict(fb.LAUNCHES) != want:
                    fail(f"phase 59: step {state.step} launched {fb.LAUNCHES}, expected {want}")
                steps += 1
            mgr.save(epoch + 1, state)
    return state, steps, list(mgr.all_steps())  # after close: the last async save has committed


def adam_moments(state):
    return [(i, key, t) for i, moments in sorted(state.optimizer.state_dict()["state"].items())
            for key, t in sorted(moments.items())]


def check_resume(fb, dev, tmp):
    """Phase 59: returns (the uninterrupted run's state, its checkpoint
    directory)."""
    data = infra_data()
    log(f"[59 infrastructure] ViT-B/16 @224, depth {DEPTH}, bf16, dropout 0, seed {SEED}; {INFRA_IMAGES} host "
        f"images, bs={INFRA_BATCH}, minibatches -> prefetch_to_device(depth=2, host_workers=True) -> make_train_step, "
        f"CheckpointManager(max_to_keep=2, async_save=True) each epoch")
    full_dir, split_dir = os.path.join(tmp, "full"), os.path.join(tmp, "split")
    t0 = time.perf_counter()
    full, full_steps, full_kept = infra_run(fb, dev, data, full_dir, INFRA_EPOCHS, False)
    sync()
    t_full = time.perf_counter() - t0
    _, first_steps, _ = infra_run(fb, dev, data, split_dir, INFRA_SPLIT, False)
    resumed, second_steps, split_kept = infra_run(fb, dev, data, split_dir, INFRA_EPOCHS, True)
    sync()
    per_epoch = INFRA_IMAGES // INFRA_BATCH
    log(f"  {INFRA_EPOCHS} epochs uninterrupted: {full_steps} steps in {t_full:.2f} s (checkpoints included), kept "
        f"{full_kept}; split: {first_steps} + {second_steps} steps, kept {split_kept}; exact counters every step "
        f"({DEPTH} x {sum(TRAIN_LAUNCHES_PER_LAYER.values())})")
    if (full_steps, first_steps, second_steps) != (INFRA_EPOCHS * per_epoch, INFRA_SPLIT * per_epoch,
                                                   (INFRA_EPOCHS - INFRA_SPLIT) * per_epoch):
        fail("phase 59: the runs took the wrong number of steps")
    if full_kept != [INFRA_EPOCHS - 1, INFRA_EPOCHS] or split_kept != full_kept:
        fail(f"phase 59: retention kept {full_kept} / {split_kept}, expected the last 2 steps")
    if full.step != resumed.step:
        fail(f"phase 59: step {full.step} uninterrupted vs {resumed.step} resumed")
    differ = [name for (name, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values())
              if not torch.equal(a, b)]
    moments_a, moments_b = adam_moments(full), adam_moments(resumed)
    differ += [f"adam {i} {key}" for (i, key, a), (_, _, b) in zip(moments_a, moments_b) if not torch.equal(a, b)]
    log(f"  resume after {INFRA_SPLIT} of {INFRA_EPOCHS} epochs: {len(full.model.state_dict())} tensors and "
        f"{len(moments_a)} Adam state tensors, {len(differ)} not bitwise equal")
    if differ or len(moments_a) != len(moments_b):
        fail(f"phase 59: the resumed run differs from the uninterrupted one: {differ[:8]}")
    check_prefetch_stress(dev)
    time_prefetch(dev, data, INFRA_BATCH)
    rng = np.random.default_rng(SEED + 1)  # a device-bound batch: 3 steps of bs=256
    big = {"x": rng.standard_normal((3 * PREFETCH_BIG_BATCH, 3, 224, 224), dtype=np.float32),
           "y": rng.integers(0, 1000, 3 * PREFETCH_BIG_BATCH)}
    time_prefetch(dev, big, PREFETCH_BIG_BATCH)
    return full, full_dir


def check_prefetch_stress(dev):
    """50 distinct batches at depth 3, each summed on the card as soon as it
    is yielded and then dropped; every checksum must be its host batch's."""
    from vit_pytorch_tpu_torch.utils.data import prefetch_to_device

    rng = np.random.default_rng(SEED + 59)
    host = [{"x": rng.integers(0, 256, (INFRA_BATCH, 3, 224, 224), dtype=np.uint8)}  # uint8 images: exact sums
            for _ in range(PREFETCH_STRESS_BATCHES)]
    sums = [b["x"].sum() for b in prefetch_to_device(iter(host), depth=PREFETCH_STRESS_DEPTH, device=dev)]
    got = [int(v) for v in sums]
    want = [int(b["x"].sum(dtype=np.int64)) for b in host]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    log(f"  prefetch stress: {len(got)} batches of {host[0]['x'].nbytes / 2**20:.1f} MiB at depth "
        f"{PREFETCH_STRESS_DEPTH}, {len(bad)} checksums wrong")
    if len(got) != len(want) or bad:
        fail(f"phase 59: prefetched batches {bad} differ from their host batches")


def time_prefetch(dev, data, batch_size):
    """Epochs fed by a direct .to() of each batch, through
    prefetch_to_device(depth=2) and through it with host_workers=True (the
    batches gathered and staged in pinned memory on a thread), in turns
    (direct, prefetch, thread, thread, prefetch, direct), on a throwaway copy
    of the model; returns the mean ms of each feed."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step
    from vit_pytorch_tpu_torch.utils.data import minibatches, prefetch_to_device

    state = create_train_state(infra_model(dev, SEED))
    step = make_train_step(state.model)
    batches = lambda: minibatches(data, batch_size, rng=np.random.default_rng((1, 0)))  # noqa: E731
    feeds = {
        "direct": lambda: ({k: torch.as_tensor(v).to(dev) for k, v in b.items()} for b in batches()),
        "prefetch": lambda: prefetch_to_device(batches(), depth=2, device=dev),
        "thread": lambda: prefetch_to_device(batches(), depth=2, host_workers=True, device=dev),
    }

    def epoch(name):
        sync()
        t = time.perf_counter()
        for batch in feeds[name]():
            step(state, batch["x"].to(torch.bfloat16), batch["y"])
        sync()
        return (time.perf_counter() - t) * 1e3

    for name in feeds:  # warm-up
        epoch(name)
    turns = [(name, epoch(name)) for name in ("direct", "prefetch", "thread", "thread", "prefetch", "direct")]
    mean = {name: statistics.mean(ms for n, ms in turns if n == name) for name in feeds}
    log(f"  one epoch of {len(data['y']) // batch_size} steps at bs={batch_size}, ms: direct .to() "
        f"{mean['direct']:.2f}, prefetch_to_device(depth=2) {mean['prefetch']:.2f}, with host_workers "
        f"{mean['thread']:.2f} (turns " + ", ".join(f"{n} {ms:.2f}" for n, ms in turns) + ")")
    del state, step
    torch.cuda.empty_cache()
    return mean


def vit_b_flops(b):
    """ViT-B/16 @224's forward products from the widths, 2 FLOP a
    multiply-add: the patch embedding, per layer qkv, out, fc1, fc2, q.k^T
    and p.v, and the head on the cls token."""
    inner, patch_dim = HEADS * DH, 3 * 16 * 16
    layer = 2 * b * N * (DIM * 3 * inner + inner * DIM + 2 * DIM * MLP) + 2 * 2 * b * HEADS * N * N * DH
    return 2 * b * (N - 1) * patch_dim * DIM + DEPTH * layer + 2 * b * DIM * 1000


ARTIFACT_CHILD = r"""
import json, sys, torch
import vit_pytorch_tpu_torch.ops
from vit_pytorch_tpu_torch.ops import fused_block as fb
from vit_pytorch_tpu_torch.serving import load_model
art, weights, images, out = sys.argv[1:5]
fn = load_model(art)
variables = torch.load(weights, map_location="cuda", weights_only=True)
imgs = torch.load(images, map_location="cuda", weights_only=True)
logits, counts = {}, {}
for k in (1, 5, 130):
    fb.reset_launch_counts()
    logits[k] = fn(variables, imgs[:k])
    torch.cuda.synchronize()
    counts[k] = {name: v for name, v in fb.LAUNCHES.items() if v}
torch.save({k: v.cpu() for k, v in logits.items()}, out)
models = sorted(m for m in sys.modules if m.startswith(("vit_pytorch_tpu_torch.models", "vit_pytorch_tpu_torch.nn")))
print(json.dumps({"counts": counts, "model_modules": models}))
"""


def check_serving_artifacts(fb, dev, full, ckpt_dir, smi):
    """Phase 60."""
    from vit_pytorch_tpu_torch import ViT
    from vit_pytorch_tpu_torch.entry import entry
    from vit_pytorch_tpu_torch.serving import Predictor, export_model, forward_flops

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    images = {k: torch.randn(k, 3, 224, 224, generator=gen, device=dev) for k in REQUESTS}
    last = os.path.join(ckpt_dir, str(INFRA_EPOCHS))
    log(f"[60 serving and artifacts] Predictor.from_checkpoint of phase 59's step {INFRA_EPOCHS} into a ViT-B/16 "
        f"built on meta, buckets {BUCKETS}")
    skeleton = ViT(image_size=224, patch_size=16, num_classes=1000, dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP,
                   device="meta")
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(skeleton, last, torch.zeros(1, 3, 224, 224), batch_sizes=BUCKETS, device=dev)
    log(f"  from_checkpoint with aot=True: {time.perf_counter() - t0:.2f} s; compiled_buckets {pred.compiled_buckets}")
    if pred.compiled_buckets != BUCKETS:
        fail(f"phase 60: compiled_buckets {pred.compiled_buckets} after construction, expected {BUCKETS}")
    memory = Predictor(full.model, example_shape=(3, 224, 224), batch_sizes=BUCKETS, device=dev)
    runs = sum(-(-k // BUCKETS[-1]) for k in REQUESTS)
    want = {name: DEPTH * LAUNCHES_PER_LAYER.get(name, 0) * runs for name in fb.LAUNCHES}
    fb.reset_launch_counts()
    outs = {k: pred(images[k]) for k in REQUESTS}
    sync()
    counts = dict(fb.LAUNCHES)
    wants = {k: memory(images[k]) for k in REQUESTS}
    differ = [k for k in REQUESTS if not torch.equal(outs[k], wants[k])]
    log(f"  requests {REQUESTS}: {runs} bucket runs, launches { {k: v for k, v in counts.items() if v} } "
        f"(expected { {k: v for k, v in want.items() if v} }); logits bitwise the in-memory model's Predictor: "
        f"{not differ}")
    if counts != want or differ:
        fail(f"phase 60: from_checkpoint serving: counters {counts}, requests whose logits differ {differ}")

    flops_card = pred.cost_analysis(8)["flops"]
    flops_cpu = forward_flops(pred.model, (8, 3, 224, 224), bf16, device="cpu")
    log(f"  cost_analysis(8): {flops_card} FLOP on the card, {flops_cpu} on the CPU, {vit_b_flops(8)} from the "
        f"widths")
    if not flops_card == flops_cpu == vit_b_flops(8):
        fail("phase 60: cost_analysis disagrees")

    tmp = os.path.dirname(ckpt_dir)
    art, weights, imgs_path, out_path = (os.path.join(tmp, name) for name in
                                         ("vit_b.pt2", "weights.pt", "images.pt", "logits.pt"))
    t0 = time.perf_counter()
    blob = export_model(pred.model, pred.model.state_dict(), (3, 224, 224), input_dtype=bf16, path=art)
    t_export = time.perf_counter() - t0
    torch.save({k: v.cpu() for k, v in pred.model.state_dict().items()}, weights)
    batch = images[max(ARTIFACT_REQUESTS)].to(bf16)
    torch.save(batch.cpu(), imgs_path)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", ARTIFACT_CHILD, art, weights, imgs_path, out_path],
                          capture_output=True, text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    t_child = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 60: the artifact's subprocess failed: {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    got = torch.load(out_path, weights_only=True)
    per_call = {name: DEPTH * v for name, v in LAUNCHES_PER_LAYER.items()}
    errs = {}
    for k in ARTIFACT_REQUESTS:
        want_k = pred(batch[:k]).float().cpu()
        errs[k] = (rel_l2(got[k], want_k), (got[k].float() - want_k).abs().max().item())
        if child["counts"][str(k)] != per_call or errs[k][0] > LOGITS_VS_PLAIN_BF16:
            fail(f"phase 60: the artifact at {k} images: launches {child['counts'][str(k)]} (expected {per_call}), "
                 f"rel L2 {errs[k][0]:.4e} (bound {LOGITS_VS_PLAIN_BF16})")
    log(f"  export on the card: {len(blob)} bytes in {t_export:.2f} s; loaded in a subprocess ({t_child:.2f} s) that "
        f"imported {child['model_modules'] or 'no'} model modules; batches {ARTIFACT_REQUESTS}: launches "
        f"{child['counts']}; vs the Predictor rel L2 / max|d| " +
        ", ".join(f"{k}: {e[0]:.3e} / {e[1]:.3e}" for k, e in errs.items()) + f" (bound {LOGITS_VS_PLAIN_BF16})")
    if child["model_modules"]:
        fail(f"phase 60: the artifact's process imported model code: {child['model_modules']}")

    fn, args = entry()
    out = fn(*args)
    sync()
    log(f"  entry(): {tuple(out.shape)} {out.dtype} on {out.device}, finite {bool(torch.isfinite(out).all())}")
    if out.shape != (8, 1000) or out.device.type != "cuda" or not bool(torch.isfinite(out).all()):
        fail("phase 60: entry() gave a wrong output")
    time_layer_dispatch(fb, dev, smi)


MESH_STEPS = 3
MESH_CHILD = r"""
import json, os, sys, time, torch
from vit_pytorch_tpu_torch import ViT
from vit_pytorch_tpu_torch.ops import fused_block as fb
from vit_pytorch_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from vit_pytorch_tpu_torch.parallel.train import (create_train_state, make_sharded_train_step, make_train_step,
                                                  shard_train_state)
from vit_pytorch_tpu_torch.serving import Predictor, export_model, load_model
from vit_pytorch_tpu_torch.utils.data import prefetch_to_device

tmp, cfg = sys.argv[1], json.loads(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
dev, bf16 = torch.device("cuda", 0), torch.bfloat16
out = {}
t0 = time.perf_counter()
out["world"] = initialize_distributed(num_processes=1, process_id=0, backend="nccl",
                                      init_method="file://" + os.path.join(tmp, "store"))
mesh = make_mesh(1, 1)
out["backend"], out["mesh"] = torch.distributed.get_backend(), [list(mesh.shape), mesh.device_type]
out["init_s"] = time.perf_counter() - t0


def vit():
    return ViT(image_size=224, patch_size=16, num_classes=1000, dim=cfg["dim"], depth=cfg["depth"],
               heads=cfg["heads"], mlp_dim=cfg["mlp"], device=dev,
               generator=torch.Generator(device=dev).manual_seed(cfg["seed"])).to(bf16)


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


plain, sharded = vit(), vit()
state_a, step_a = create_train_state(plain), make_train_step(plain)
t0 = time.perf_counter()
state_b = shard_train_state(create_train_state(sharded), mesh, fsdp=True)
step_b = make_sharded_train_step(sharded, mesh)
out["shard_s"] = time.perf_counter() - t0
kinds = [type(p).__name__ + str(getattr(p, "placements", "")) for p in sharded.parameters()]
out["layout"] = {k: kinds.count(k) for k in sorted(set(kinds))}
g = torch.Generator().manual_seed(cfg["seed"] + 61)
host = [{"x": torch.randn(cfg["batch"], 3, 224, 224, generator=g).to(bf16),
         "y": torch.randint(0, 1000, (cfg["batch"],), generator=g)} for _ in range(cfg["steps"])]
out["steps"] = []
for i, batch in enumerate(prefetch_to_device(iter(host), mesh=mesh)):
    x = batch["x"]
    if i == 0:
        out["placed"] = [list(x.shape), str(x.placements), x.device.type, type(x).__name__]
    xa, ya = host[i]["x"].to(dev), host[i]["y"].to(dev)
    torch.cuda.synchronize()
    fb.reset_launch_counts()
    t = time.perf_counter()
    ma = step_a(state_a, xa, ya)
    torch.cuda.synchronize()
    ms_a = (time.perf_counter() - t) * 1e3
    ca = {k: v for k, v in fb.LAUNCHES.items() if v}
    fb.reset_launch_counts()
    t = time.perf_counter()
    mb = step_b(state_b, batch["x"], batch["y"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    cb = {k: v for k, v in fb.LAUNCHES.items() if v}
    out["steps"].append({"loss": [ma["loss"].item(), mb["loss"].item()],
                         "accuracy": [ma["accuracy"].item(), mb["accuracy"].item()],
                         "launches": [ca, cb], "ms": [ms_a, ms]})
names = [n for n, _ in plain.named_parameters()]
pa, pb = dict(plain.named_parameters()), dict(sharded.named_parameters())
out["params"] = len(names)
out["params_differ"] = [n for n in names if not torch.equal(pa[n], whole(pb[n]))]
out["params_max_abs"] = max((pa[n].float() - whole(pb[n]).float()).abs().max().item() for n in names)
moments = [(n, k) for n in names for k in ("exp_avg", "exp_avg_sq")]
out["moments_differ"] = [f"{n} {k}" for n, k in moments if not torch.equal(
    state_a.optimizer.state[pa[n]][k], whole(state_b.optimizer.state[pb[n]][k]))]
out["moment_placements"] = sum(getattr(state_b.optimizer.state[pb[n]][k], "placements", None)
                               == getattr(pb[n], "placements", None) for n, k in moments)
out["moments"] = len(moments)

# serving over the mesh against one device, every bucket
single = Predictor(plain, example_shape=(3, 224, 224), batch_sizes=cfg["buckets"], device=dev)
meshed = Predictor(plain, example_shape=(3, 224, 224), batch_sizes=cfg["buckets"], mesh=mesh)
out["serving"] = {}
for b in cfg["buckets"]:
    img = torch.randn(b, 3, 224, 224, generator=g).to(dev)
    fb.reset_launch_counts()
    want = single(img)
    torch.cuda.synchronize()
    c1 = {k: v for k, v in fb.LAUNCHES.items() if v}
    fb.reset_launch_counts()
    got = meshed(img)
    torch.cuda.synchronize()
    c2 = {k: v for k, v in fb.LAUNCHES.items() if v}
    out["serving"][b] = [torch.equal(got, want), list(got.shape), c1, c2]

# the mesh artifact against the one-device artifact
variables = single.model.state_dict()
t0 = time.perf_counter()
blob = export_model(single.model, variables, (3, 224, 224), input_dtype=bf16, mesh=mesh)
fn_mesh = load_model(blob, mesh=mesh)
fn_one = load_model(export_model(single.model, variables, (3, 224, 224), input_dtype=bf16))
out["export_s"] = time.perf_counter() - t0
out["artifact"] = {}
for k in (1, 5, 32):
    img = torch.randn(k, 3, 224, 224, generator=g).to(dev, bf16)
    fb.reset_launch_counts()
    got = fn_mesh(variables, img)
    torch.cuda.synchronize()
    c = {n: v for n, v in fb.LAUNCHES.items() if v}
    out["artifact"][k] = [torch.equal(got, fn_one(variables, img)), list(got.shape), c]
from vit_pytorch_tpu_torch.serving import _artifact_meta
meta = _artifact_meta(blob)
out["artifact_meta"] = {k: meta.get(k) for k in ("mesh", "devices", "batch_symbol")}
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


def check_mesh(fb, dev, tmp, smi):
    """Phase 61: the mesh (ROADMAP item 11b) on the card as a world of one,
    in a subprocess so that this process keeps no process group."""
    from vit_pytorch_tpu_torch.entry import dryrun_multichip

    cfg = {"dim": DIM, "depth": DEPTH, "heads": HEADS, "mlp": MLP, "seed": SEED, "batch": B_TRAIN,
           "steps": MESH_STEPS, "buckets": list(BUCKETS)}
    log(f"[61 mesh] a world of one on the card: initialize_distributed (NCCL, file store), make_mesh(1, 1); "
        f"ViT-B/16 @224, depth {DEPTH}, bf16, seed {SEED}: shard_train_state(fsdp=True) + "
        f"make_sharded_train_step against make_train_step from the same weights, {MESH_STEPS} steps of bs="
        f"{B_TRAIN} fed by prefetch_to_device(mesh=); Predictor(mesh=) at buckets {BUCKETS}; export_model(mesh=) "
        f"-> load_model(mesh=); dryrun_multichip(4); {smi}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", MESH_CHILD, tmp, json.dumps(cfg)], capture_output=True, text=True,
                          timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    t_child = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 61: the mesh subprocess failed: {proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {k: DEPTH * v for k, v in TRAIN_LAUNCHES_PER_LAYER.items() if v}
    log(f"  subprocess {t_child:.2f} s: world {got['world']}, {got['backend']}, mesh {got['mesh']}, process group "
        f"and mesh {got['init_s']:.2f} s, shard_train_state {got['shard_s']:.2f} s; layout {got['layout']}; "
        f"prefetched batch {got['placed']}")
    for i, st in enumerate(got["steps"]):
        log(f"  step {i + 1}: loss unsharded / sharded {st['loss'][0]!r} / {st['loss'][1]!r}, accuracy "
            f"{st['accuracy']}, launches {st['launches'][1]} (unsharded {st['launches'][0]}), host ms around the "
            f"step and a synchronize: unsharded {st['ms'][0]:.2f}, sharded {st['ms'][1]:.2f}")
        if st["launches"][0] != want or st["launches"][1] != want:
            fail(f"phase 61: step {i + 1} launched {st['launches']}, expected {want} in both")
        if st["loss"][0] != st["loss"][1] or st["accuracy"][0] != st["accuracy"][1]:
            fail(f"phase 61: step {i + 1}'s metrics differ: {st['loss']} {st['accuracy']}")
    log(f"  after step {MESH_STEPS}: {got['params']} parameters, {len(got['params_differ'])} not bitwise equal "
        f"(max |d| {got['params_max_abs']:.3e}); {got['moments']} Adam moments, {len(got['moments_differ'])} not "
        f"bitwise equal, {got['moment_placements']} with their parameter's placements")
    if got["params_differ"] or got["moments_differ"] or got["moment_placements"] != got["moments"]:
        fail(f"phase 61: the sharded run differs from the unsharded one: {got['params_differ'][:8]} "
             f"{got['moments_differ'][:8]}")
    if got["placed"] != [[B_TRAIN, 3, 224, 224], "(Shard(dim=0), Replicate())", "cuda", "DTensor"]:
        fail(f"phase 61: prefetch_to_device(mesh=) placed {got['placed']}")
    per_run = {k: DEPTH * v for k, v in LAUNCHES_PER_LAYER.items()}
    for b, (equal, shape, c1, c2) in got["serving"].items():
        if not equal or shape != [int(b), 1000] or c1 != per_run or c2 != per_run:
            fail(f"phase 61: Predictor(mesh=) at bucket {b}: bitwise {equal}, shape {shape}, launches {c2} "
                 f"(one device {c1}, expected {per_run})")
    for k, (equal, shape, c) in got["artifact"].items():
        if not equal or shape != [int(k), 1000] or c != per_run:
            fail(f"phase 61: the mesh artifact at {k} images: bitwise {equal}, shape {shape}, launches {c}")
    if got["artifact_meta"] != {"mesh": {"data": 1, "model": 1}, "devices": 1, "batch_symbol": "b"}:
        fail(f"phase 61: the mesh artifact records {got['artifact_meta']}")
    log(f"  Predictor(mesh=) bitwise the one-device Predictor at buckets {list(got['serving'])}, {per_run} a run; "
        f"export_model(mesh=) -> load_model(mesh=) ({got['export_s']:.2f} s with the one-device export) bitwise the "
        f"one-device artifact at {list(got['artifact'])} images; it records {got['artifact_meta']}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4)
    line = buf.getvalue().strip()
    log(f"  {line} ({time.perf_counter() - t0:.2f} s, 4 gloo CPU processes with no visible card)")
    if not line.startswith("dryrun_multichip ok: mesh={'data': 2, 'model': 2} loss="):
        fail(f"phase 61: dryrun_multichip(4) printed {line!r}")


# -- phase 62: the examples (ROADMAP item 11c) --------------------------------------------------------------------
EXAMPLE_STEPS = 3
DIGITS_SPLIT, DIGITS_EPOCHS = 2, 4  # the resume check: 2 + 2 epochs against 4
# Each training example's step against the same step through the plain
# twins (plain_layers, plain_flash: the same Functions with every kernel
# swapped for its plain version) from the same weights and inputs: the
# loss, all gradients together and the worst parameter.  MAE and Dino to the
# bounds of the phases that hold them against their twins (38, 41); MAE's
# loss is a bf16 scalar, so its float32 value, recomputed from the step's
# predicted pixels, is held as Dino's float32 loss is (2^-14).  NaViT's
# gradients at depth 6 are mostly bf16's own noise (phase 14 bounds them
# only at depth 2): its loss to phase 14's bound, all gradients together
# and the worst parameter to NAVIT_NOISE_RATIO times what the twins
# themselves read against an f32 copy in the same step (the floor, as
# phase 13 holds the logits), and each flash call of its first step through
# the kernels against their twins as phase 25 holds them.
EXAMPLE_VS_PLAIN = {"train_navit_packed": NAVIT_TRAIN_VS_PLAIN, "pretrain_mae": {**MAE_VS_PLAIN, "loss": 2.0**-14},
                    "pretrain_dino": SSL_VS_PLAIN}


def example_launches(name):
    """The exact launch counters of one step of a training example (module
    ``name`` of vit_pytorch_tpu_torch.examples) at its own configuration."""
    import importlib

    cfg = importlib.import_module(f"vit_pytorch_tpu_torch.examples.{name}").CONFIG
    if name == "train_navit_packed":  # every layer and the pooling: the flash trio
        return {k: cfg["depth"] + 1 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if name == "pretrain_mae":  # the encoder's and the decoder's whole layers, forward and backward
        return {k: (cfg["depth"] + cfg["decoder_depth"]) * v for k, v in TRAIN_LAUNCHES_PER_LAYER.items()}
    if name == "pretrain_dino":  # the student's two calls with gradients, the teacher's two without
        return {k: cfg["depth"] * (2 * TRAIN_LAUNCHES_PER_LAYER.get(k, 0) + 2 * LAUNCHES_PER_LAYER.get(k, 0))
                for k in set(TRAIN_LAUNCHES_PER_LAYER) | set(LAUNCHES_PER_LAYER)}
    raise KeyError(name)


def mae_loss32(mae, inputs, pred):
    """MAE's loss in float32 from the step's predicted pixels (the
    ``to_pixels`` output): the masked patches drawn as ``MAE.forward`` draws
    them from the step's mask seed."""
    img = inputs["images"]
    patches = mae.encoder.patchify(img)
    b, n, _ = patches.shape
    gen = torch.Generator(device=img.device).manual_seed(inputs["mask_seed"])
    masked = torch.rand((b, n), generator=gen, device=img.device).argsort(dim=-1)[:, : int(mae.masking_ratio * n)]
    target = torch.take_along_dim(patches, masked[..., None], dim=1)
    return (pred.float() - target.float()).square().mean(), (pred - target).square().mean()


@contextlib.contextmanager
def capture_flash_calls(calls):
    """Record each call of the attention dispatcher's flash route: q, k, v,
    its keywords, and (after the backward) the gradient its output took."""
    from vit_pytorch_tpu_torch.ops import attention

    original = attention.flash_attention

    def capturing(q, k, v, **kw):
        out = original(q, k, v, **kw)
        call = {"q": q.detach().contiguous(), "k": k.detach().contiguous(), "v": v.detach().contiguous(),
                **{key: t.detach() if torch.is_tensor(t) else t for key, t in kw.items()}}
        out.register_hook(lambda g: call.__setitem__("do", g.detach().contiguous()))
        calls.append(call)
        return out

    attention.flash_attention = capturing
    try:
        yield calls
    finally:
        attention.flash_attention = original


def check_flash_calls(fa, calls, label):
    """Each recorded flash call through the kernels against their twins on
    its own inputs, as phase 25 holds them: o and lse against the forward
    twin fed the kernels' own q^ and k^ (with gammas), dq, dk and dv against
    the backward twin, from the gradient the call's output took."""
    for i, c in enumerate(calls):
        if c.get("bias") is not None or c.get("dropout_rate", 0.0) or c.get("causal"):
            fail(f"phase 62: {label}: flash call {i} is not the plain packed case this check holds")
        q, k, v, do, gq, gk = c["q"], c["k"], c["v"], c["do"], c.get("gamma_q"), c.get("gamma_k")
        ids = [None if c.get(key) is None else c[key].to(torch.int32).contiguous()
               for key in ("q_segment_ids", "kv_segment_ids")]
        kw = dict(scale=q.shape[-1] ** -0.5 if c.get("scale") is None else float(c["scale"]),
                  q_segment_ids=ids[0], kv_segment_ids=ids[1])
        gkw = {} if gq is None else dict(gamma_q=gq, gamma_k=gk)
        tag = f"{'[qknorm]' if gkw else ''} [{label}, call {i}: q {tuple(q.shape)}, k {tuple(k.shape)}]"
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, **kw, **gkw)
            hats = kernel_order_hats(q, k, gq, gk) if gkw else (q, k)
            o_want, lse_want = fa.flash_fwd_reference(*hats, v, **kw)
            compare_or_zero(f"flash_fwd o{tag}", o, o_want, ATTN_ATOL, ATTN_RTOL)
            live = lse_want > 0.5 * fa.NEG_INF
            if not bool((lse[~live] == fa.NEG_INF).all()):
                fail(f"phase 62: flash_fwd lse{tag}: a fully masked row does not read the sentinel")
            if live.any():
                compare(f"flash_fwd lse{tag}", lse[live], lse_want[live], FLASH_LSE_ATOL, FLASH_LSE_RTOL, F32_REL_L2)
            delta = (do.float() * o.float()).sum(-1)
            got = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw, **gkw),
                   *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw, **gkw))
            want = fa.flash_bwd_reference(q, k, v, do, lse, delta, **kw, **gkw)
            for part, a, b in zip(("flash_bwd_dq dq", "flash_bwd_dkv dk", "flash_bwd_dkv dv"), got, want):
                compare_or_zero(f"{part}{tag}", a, b, None, ATTN_RTOL, atol_frac=BWD_ATOL_FRAC)
        sync()


def compare_grads_to_floor(name, got, plain, fp32, loss, loss_plain, bound, names):
    """The loss's relative difference to ``bound``; the relative L2 of all
    gradients together, and of the worst single parameter, against the
    twins at most NAVIT_NOISE_RATIO times what the twins read against f32."""
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()  # noqa: E731
    d_loss = abs(loss - loss_plain) / abs(loss_plain)
    total, floor = grads_rel_l2(got, plain), grads_rel_l2(plain, fp32)
    per, per_floor = [rel(a, b) for a, b in zip(got, plain)], [rel(b, c) for b, c in zip(plain, fp32)]
    worst, worst_floor = (max(range(len(v)), key=v.__getitem__) for v in (per, per_floor))
    ok = (d_loss <= bound and total <= NAVIT_NOISE_RATIO * floor and per[worst] <= NAVIT_NOISE_RATIO *
          per_floor[worst_floor] and all(bool(torch.isfinite(a).all()) for a in got))
    log(f"  {name}: loss {loss:.6f} vs {loss_plain:.6f} (rel {d_loss:.3e}, bound {bound}); grads rel L2 {total:.4e} "
        f"(bound {NAVIT_NOISE_RATIO} x the twins vs f32, {floor:.4e}), worst {names[worst]} {per[worst]:.4e} (bound "
        f"{NAVIT_NOISE_RATIO} x the twins' worst vs f32, {names[worst_floor]} {per_floor[worst_floor]:.4e}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"training: {name} out of bounds")


class PlainReplay:
    """Wraps a training example's module-level ``train_step`` while its
    ``main()`` runs (restored on exit).  Before each update, the step's loss
    and gradients on a copy of the model from the same weights and inputs
    through the plain twins (which must launch nothing); after it, the
    kernel path's own gradients, which the update leaves in place until the
    next step's ``zero_grad``; the two held to the example's bounds.  Each
    step is timed alone: the host clock around the example's step and a
    synchronize."""

    def __init__(self, fb, fa, ex, name):
        self.fb, self.fa, self.ex, self.name = fb, fa, ex, name
        self.bounds, self.losses, self.plain_losses, self.ms = EXAMPLE_VS_PLAIN[name], [], [], []
        self.flash_calls = []  # NaViT's first step's

    def __enter__(self):
        self.train_step = self.ex.train_step
        self.ex.train_step = self.step
        return self

    def __exit__(self, *exc):
        self.ex.train_step = self.train_step

    def step(self, model, opt, inputs):
        i = len(self.ms)
        plain = copy.deepcopy(model)
        plain.zero_grad(set_to_none=True)
        preds, hooks = {}, []
        if self.name == "pretrain_mae":
            hooks = [m.to_pixels.register_forward_hook(lambda mod, args, out, key=key: preds.__setitem__(key, out))
                     for m, key in ((model, "kernel"), (plain, "plain"))]
        navit = self.name == "train_navit_packed"
        before = dict(all_launches(self.fb, self.fa))
        with plain_layers(), plain_flash():
            plain_loss = self.ex.loss_of(plain, inputs)
            plain_loss.backward()
        if navit:  # the floor: the twins in f32 from the same weights
            fp32 = copy.deepcopy(plain).float()
            fp32.zero_grad(set_to_none=True)
            with plain_flash(admit_fp32=True):
                self.ex.loss_of(fp32, {**inputs, "packed": inputs["packed"].to(dtype=torch.float32)}).backward()
            _, fgrads = trained_grads(fp32)
            del fp32
        sync()
        if all_launches(self.fb, self.fa) != before:
            fail(f"phase 62: {self.name}'s plain copies launched a kernel at step {i}")
        with capture_flash_calls(self.flash_calls) if navit and i == 0 else contextlib.nullcontext():
            sync()
            t0 = time.perf_counter()
            loss = self.train_step(model, opt, inputs)
            sync()
            self.ms.append((time.perf_counter() - t0) * 1e3)
        for hook in hooks:
            hook.remove()
        names, grads = trained_grads(model)
        pnames, pgrads = trained_grads(plain)
        if names != pnames or not names:
            fail(f"phase 62: {self.name}: the paths differ in which parameters have gradients")
        got, want = loss.item(), plain_loss.item()
        if self.name == "pretrain_mae":
            with torch.no_grad():
                (got32, got16), (want32, _) = (mae_loss32(m, inputs, preds[key])
                                               for m, key in ((model, "kernel"), (plain, "plain")))
            log(f"  {self.name} step {i}: the bf16 loss {got!r} recomputed from the predicted pixels {got16.item()!r}, "
                f"float32 {got32.item():.9f} vs {want32.item():.9f}")
            if got16.item() != got:
                fail(f"phase 62: MAE's loss recomputed from its predicted pixels is {got16.item()!r}, not {got!r}")
            got, want = got32.item(), want32.item()
        what = f"{self.name} step {i} vs the plain twins"
        if navit:
            compare_grads_to_floor(what, grads, pgrads, fgrads, got, want, self.bounds["loss"], names)
        else:
            compare_grads(what, grads, pgrads, got, want, self.bounds, names)
        self.losses.append(got)
        self.plain_losses.append(want)
        del plain
        return loss


def check_serve_example(fb, fa, smi):
    """serve_vit.main() exactly as written; returns its row of phase 62."""
    from vit_pytorch_tpu_torch.examples import serve_vit

    log(f"  serve_vit: ViT-B/16 @224 ({serve_vit.CONFIG}), Predictor buckets {serve_vit.BUCKETS}, requests "
        f"{serve_vit.REQUESTS} x (1 + 10), then {serve_vit.OVERSIZE}; {smi}")
    buf = io.StringIO()
    reset_all(fb, fa)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve_vit.main([])
    sync()
    seconds = time.perf_counter() - t0
    for line in filter(None, buf.getvalue().strip().splitlines()):
        log(f"    | {line}")
    runs = len(serve_vit.BUCKETS) + 11 * len(serve_vit.REQUESTS) + -(-serve_vit.OVERSIZE // serve_vit.BUCKETS[-1])
    counts = expect_launches(fb, fa, {k: runs * DEPTH * v for k, v in LAUNCHES_PER_LAYER.items()},
                             f"serve_vit ({runs} bucket runs x {DEPTH} x 7)")
    p = out["predictor"]
    equal = {}
    for k, (x, y) in out["outputs"].items():
        again = p(x)
        equal[k] = bool(torch.equal(again, y)) and bool(torch.isfinite(y).all())
    log(f"  serve_vit in {seconds:.2f} s: {runs} bucket runs, {sum(counts.values())} launches "
        f"({DEPTH * sum(LAUNCHES_PER_LAYER.values())} a run); logits at {list(equal)} images bitwise the "
        f"Predictor's own calls and finite: {equal}")
    if p.compiled_buckets != BUCKETS or not all(equal.values()) or out["outputs"][300][1].shape != (300, 1000):
        fail(f"phase 62: serve_vit: buckets {p.compiled_buckets}, logits bitwise {equal}")
    p50 = {k: statistics.median(t) for k, t in out["latency_ms"].items()}
    return {"seconds": seconds, "p50_ms": p50, "oversize_ms": out["oversize_ms"], "gflop": out["gflop"]}


def check_digits_example(fb, fa, smi, tmp):
    """train_digits.main() (20 epochs) and its resume through run()."""
    from vit_pytorch_tpu_torch.examples import train_digits

    log(f"  train_digits: {train_digits.CONFIG}, the repo's copy of the UCI digits, float32, Adam 3e-4, bs=128; "
        f"{smi}")
    buf = io.StringIO()
    reset_all(fb, fa)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = train_digits.main([])
    sync()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:2] + lines[-3:]:
        log(f"    | {line}")
    expect_launches(fb, fa, {}, "train_digits (dim_head 16: the composite)")
    log(f"  train_digits in {seconds:.2f} s: {len(out['losses'])} epochs, losses {out['losses'][0]:.4f} -> "
        f"{out['losses'][-1]:.4f}, test accuracy {out['accuracy']:.4f}")
    if len(out["losses"]) != 20 or not out["accuracy"] > 0.5:
        fail(f"phase 62: train_digits learned to {out['accuracy']} in {len(out['losses'])} epochs")

    data = train_digits.load_data()
    dev = torch.device("cuda", 0)
    run = lambda epochs, directory, *resume: train_digits.run(  # noqa: E731
        train_digits.arguments().parse_args(["--epochs", str(epochs), "--checkpoint-dir", directory, *resume]),
        data, dev)["state"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        full = run(DIGITS_EPOCHS, os.path.join(tmp, "digits_full"))
        run(DIGITS_SPLIT, os.path.join(tmp, "digits_split"))
        resumed = run(DIGITS_EPOCHS, os.path.join(tmp, "digits_split"), "--resume")
    sync()
    differ = [n for (n, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values())
              if not torch.equal(a, b)]
    moments_a, moments_b = adam_moments(full), adam_moments(resumed)
    differ += [f"adam {i} {key}" for (i, key, a), (_, _, b) in zip(moments_a, moments_b) if not torch.equal(a, b)]
    log(f"  train_digits resume: {DIGITS_SPLIT} + {DIGITS_EPOCHS - DIGITS_SPLIT} epochs against {DIGITS_EPOCHS} "
        f"({time.perf_counter() - t0:.2f} s): steps {resumed.step} / {full.step}; {len(full.model.state_dict())} "
        f"tensors and {len(moments_a)} Adam state tensors, {len(differ)} not bitwise equal")
    if differ or full.step != resumed.step or len(moments_a) != len(moments_b) or not moments_a:
        fail(f"phase 62: the resumed digits run differs from the uninterrupted one: {differ[:8]}")
    return {"seconds": seconds, "accuracy": out["accuracy"], "epoch_losses": out["losses"]}


def check_training_example(fb, fa, smi, name):
    """A training example's main() for EXAMPLE_STEPS steps at its own
    configuration, each step held against the plain twins."""
    import importlib

    ex = importlib.import_module(f"vit_pytorch_tpu_torch.examples.{name}")
    per_step = example_launches(name)
    log(f"  {name}: {ex.CONFIG}, {EXAMPLE_STEPS} steps; {smi}")
    reset_all(fb, fa)
    t0 = time.perf_counter()
    with PlainReplay(fb, fa, ex, name) as replay:  # the example's own lines, then each step's comparison
        out = ex.main(["--steps", str(EXAMPLE_STEPS)])
    sync()
    seconds = time.perf_counter() - t0
    expect_launches(fb, fa, {k: EXAMPLE_STEPS * v for k, v in per_step.items()},
                    f"{name} ({EXAMPLE_STEPS} steps of {({k: v for k, v in per_step.items() if v})})")
    if name == "train_navit_packed":
        calls = replay.flash_calls
        if len(calls) != per_step["flash_fwd"] or any("do" not in c for c in calls):
            fail(f"phase 62: {len(calls)} flash calls recorded in NaViT's first step, {per_step['flash_fwd']} expected, "
                 f"{sum('do' in c for c in calls)} with their output's gradient")
        check_flash_calls(fa, calls, f"{name} step 0")
    ok = len(replay.ms) == EXAMPLE_STEPS and all(math.isfinite(v) for v in out["losses"])
    log(f"  {name} in {seconds:.2f} s (with the plain copy's steps): losses {[f'{v:.6f}' for v in out['losses']]}; "
        f"host ms a step around it and a synchronize {[f'{v:.2f}' for v in replay.ms]} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"phase 62: {name}'s losses are not finite or its steps were not all held against the plain twins")
    return {"seconds": seconds, "ms": replay.ms, "losses": out["losses"], "compared": replay.losses,
            "plain_losses": replay.plain_losses,
            "launches_per_step": {k: v for k, v in per_step.items() if v}}


DECORR_CHILD = r"""
import copy, json, sys, time, torch
from vit_pytorch_tpu_torch.examples import train_vit_decorr as ex
from vit_pytorch_tpu_torch.ops import fused_block as fb, flash_attention as fa, short_attention as sa
from vit_pytorch_tpu_torch.parallel.train import _loss_and_accuracy, cross_entropy_loss, make_sharded_train_step
from vit_pytorch_tpu_torch.utils.checkpoint import load_checkpoint

steps, path = int(sys.argv[1]), sys.argv[2]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
replay, placed, ms = [], [], []


def replayed_step(model, mesh, **kw):
    # the example's sharded step, each call first replayed on a copy of the
    # model from the same batch and a generator in the same state
    step = make_sharded_train_step(model, mesh, **kw)

    def checked(state, x, y, gen):
        placed.append([type(x).__name__, str(x.placements), x.device.type, list(x.shape)])
        again = torch.Generator()
        again.set_state(gen.get_state())
        loss, _ = _loss_and_accuracy(copy.deepcopy(model), cross_entropy_loss, kw["aux_loss_weight"])(
            x.to_local(), y.to_local(), again)
        replay.append(loss.item())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, x, y, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return metrics

    return checked


ex.make_sharded_train_step = replayed_step
for counters in (fb, fa, sa):
    counters.reset_launch_counts()
out = ex.main(["--steps", str(steps), "--checkpoint", path])
torch.cuda.synchronize()
launches = {k: v for c in (fb, fa, sa) for k, v in c.LAUNCHES.items() if v}
saved = load_checkpoint(path)["params"]
state = out["model"].state_dict()
print(json.dumps({"losses": out["losses"], "accuracies": out["accuracies"], "ms": ms, "mesh": out["mesh"],
                  "replay": replay, "placed": placed, "launches": launches, "initialized":
                  torch.distributed.is_initialized(), "device": str(next(out["model"].parameters()).device),
                  "saved_differ": [k for k in state if not torch.equal(saved[k], state[k].cpu())]}))
"""


def check_decorr_example(smi, tmp):
    """train_vit_decorr.main() in a subprocess: its world of one would
    otherwise outlive the phase in this process."""
    from vit_pytorch_tpu_torch.examples import train_vit_decorr

    log(f"  train_vit_decorr: {train_vit_decorr.CONFIG}, bs=32, Adam 3e-4, decorrelation weight 0.1, "
        f"{EXAMPLE_STEPS} steps in a subprocess (make_mesh(): an NCCL world of one); {smi}")
    path = os.path.join(tmp, "decorr_params")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DECORR_CHILD, str(EXAMPLE_STEPS), path], capture_output=True,
                          text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 62: the decorrelation subprocess failed: {proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    ok = (got["losses"] == got["replay"] and len(got["losses"]) == EXAMPLE_STEPS
          and all(math.isfinite(v) for v in got["losses"]) and not got["launches"] and not got["initialized"]
          and got["mesh"] == {"data": 1, "model": 1} and got["device"].startswith("cuda")
          and got["placed"][0] == ["DTensor", "(Shard(dim=0), Replicate())", "cuda", [32, 3, 32, 32]]
          and not got["saved_differ"])
    log(f"  train_vit_decorr in {seconds:.2f} s (process start included): mesh {got['mesh']}, batches placed "
        f"{got['placed'][0]}, params on {got['device']}; losses {got['losses']}, accuracies {got['accuracies']}; "
        f"each loss bitwise a replay of its step on a copy (no flash option: the composite) "
        f"{got['losses'] == got['replay']}; launches {got['launches'] or 'none'}; host ms a step "
        f"{[f'{v:.2f}' for v in got['ms']]}; the --checkpoint params equal the model's "
        f"{not got['saved_differ']}; process group left {got['initialized']} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"phase 62: train_vit_decorr: {got}")
    return {"seconds": seconds, "ms": got["ms"], "losses": got["losses"]}


def check_tune_train(fb, fa, smi):
    """tune_train's three modes at bs=1024, called one by one: a failure
    fails the run (the tool itself prints FAILED and goes on)."""
    from vit_pytorch_tpu_torch.tools import bench_fused_tuning as tuning

    log(f"  tune_train: ViT-B/16 @224, bs={tuning.TRAIN_BATCH}, bf16, Adam 3e-4; 1 step then the best of 3 (host "
        f"clock around the step and a synchronize); {smi}")
    want = {k: 4 * DEPTH * v for k, v in TRAIN_LAUNCHES_PER_LAYER.items()}
    rows = {}
    for name in tuning.TRAIN_MODES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_all(fb, fa)
        out = tuning.train_mode(name)
        sync()
        expect_launches(fb, fa, want, f"tune_train {name} (4 steps x {DEPTH} x 13)")
        rows[name] = {"ms": out["ms"], "img_s": out["img_s"], "loss": out["loss"].item(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"  train {name:28s} {out['ms']:8.2f} ms/step ({out['img_s']:.0f} img/s), peak memory "
            f"{rows[name]['peak_gib']:.2f} GiB, loss after 4 steps {rows[name]['loss']!r}")
        del out
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in rows.values()]
    spread = max(r["ms"] for r in rows.values()) / min(r["ms"] for r in rows.values()) - 1
    ok = all(math.isfinite(v) for v in losses) and max(abs(v - losses[0]) / abs(losses[0]) for v in losses) <= \
        TRAIN_VS_PLAIN["loss"]
    log(f"  tune_train: the three losses bitwise equal {len(set(losses)) == 1} (remat is a no-op on the whole "
        f"layer); ms/step spread {spread * 100:.2f}% {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"phase 62: tune_train's losses {losses}")
    return rows


def check_examples(fb, fa, smi):
    """Phase 62: every example's main() and tune_train on the card."""
    log(f"[62 examples] each example's main() at its own configuration, and tune_train; {smi}")
    rows = {}
    with tempfile.TemporaryDirectory(prefix="vit-torch-examples-") as tmp:
        rows["serve_vit"] = check_serve_example(fb, fa, smi)
        rows["train_digits"] = check_digits_example(fb, fa, smi, tmp)
        for name in ("train_navit_packed", "pretrain_mae", "pretrain_dino"):
            rows[name] = check_training_example(fb, fa, smi, name)
            torch.cuda.empty_cache()
        rows["train_vit_decorr"] = check_decorr_example(smi, tmp)
    rows["tune_train"] = check_tune_train(fb, fa, smi)
    log("  phase 62 rows: " + json.dumps(rows, default=float))
    return rows


# -- phase 63: the JAX width ladder on the wide attention kernels ----------------------------------------------
# ViT-H/14 and ViT-g/14 at the JAX tools' constructor arguments (tools/bench_vith.py:43-44, bench_vitg.py:35-40,
# 57) and tools/bench_d128.py's ViT-B/16 at 24 heads x 32 and 6 x 128 (:67-69), full width and depth, random
# weights from SEED: (ViT kwargs, serving batch, training batch or None).  ViT-H/14 trains at dropout 0 (the
# whole layer) and 0.1 (the attention block); ViT-g/14 is served only, as tools/bench_vitg.py runs it.
LADDER = {
    "ViT-H/14": (dict(image_size=224, patch_size=14, num_classes=1000, dim=1280, depth=32, heads=16, dim_head=80,
                      mlp_dim=5120), 64, 32),
    "ViT-g/14": (dict(image_size=224, patch_size=14, num_classes=1000, dim=1408, depth=40, heads=16, dim_head=88,
                      mlp_dim=6144), 64, None),
    "d32": (dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=24, dim_head=32,
                 mlp_dim=3072), 128, 128),
    "d128": (dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12, heads=6, dim_head=128,
                  mlp_dim=3072), 128, 128),
}
LADDER_STEPS = 3
WIDE_SOURCE = "vit_pytorch_tpu_torch/csrc/attention_wide.cuh"  # the wide attention kernels
# the wide kernels against their twins: (label, b, n, heads, dh) at the ladder's shapes, ViT-L/14's 257 tokens of
# dh 64, ViT-B/16 @384's 577 (the kernels' limit), and the edges of the 64-key chunks
LADDER_KERNEL_SHAPES = (
    ("ViT-H/14", 8, 257, 16, 80), ("ViT-g/14", 8, 257, 16, 88), ("ViT-L/14", 8, 257, 16, 64),
    ("d32", 8, 197, 24, 32), ("d128", 8, 197, 6, 128), ("ViT-B/16 @384", 4, 577, 12, 64),
    ("n=1 dh 80", 2, 1, 2, 80), ("n=63 dh 88", 2, 63, 2, 88), ("n=64 dh 128", 2, 64, 2, 128),
    ("n=65 dh 32", 2, 65, 4, 32), ("n=209 dh 64", 2, 209, 2, 64),
)
# the chain's other kernels at the ladder's widths, never run there before: (label, rows, dim, heads, dh, mlp)
LADDER_CHAIN = (("ViT-H/14", 2 * 257, 1280, 16, 80, 5120), ("ViT-g/14", 2 * 257, 1408, 16, 88, 6144))


def check_ladder_kernels(fb, rnd, dev):
    """Phase 63's kernel checks: attention_rows and attention_bwd_rows, each
    plain, [dropout], [qknorm] (gammas at SimpleViT-qk-norm's init and 1 +
    0.2 N(0, 1)) and [dropout,qknorm], against their twins at
    LADDER_KERNEL_SHAPES with phase 3's, 6's and 16's bounds; the chain's
    other kernels and the whole layer (forward and every gradient) at ViT-H's
    and ViT-g's widths.  Returns the largest max_abs of each kernel by its
    kernels-line name."""
    log(f"[63 the width ladder: kernels] {[s[0] for s in LADDER_KERNEL_SHAPES]}, bf16; dropout 0 and {RATE}")
    errs = {}
    with torch.inference_mode():
        for label, b, n, heads, dh in LADDER_KERNEL_SHAPES:
            inner = heads * dh
            erd = edge_rnd(SEED + 63 + n + dh)
            qkv, dm = erd(b, n, 3 * inner), erd(b, n, inner)
            init_g = torch.full((heads, 1, dh), dh**-0.5, dtype=torch.bfloat16, device=dev)
            random_g = (1 + erd(heads, 1, dh, scale=0.2), 1 + erd(heads, 1, dh, scale=0.2))
            cases = (("plain", dict(scale=dh**-0.5)), ("qk init", dict(scale=1.0, gamma_q=init_g, gamma_k=init_g)),
                     ("qk random", dict(scale=1.0, gamma_q=random_g[0], gamma_k=random_g[1])))
            for rate in (0.0, RATE):
                for case, ckw in cases:
                    qk = "gamma_q" in ckw
                    kw = dict(heads=heads, dim_head=dh, dropout_rate=rate, seed=DROP_SEED if rate else None, **ckw)
                    fwd, bwd = fb._variant("attention_rows", rate > 0, qk), fb._variant("attention_bwd_rows", rate > 0, qk)
                    tag = f"{label}, {case}"
                    bound = dict(atol_frac=QK_ATTN_ATOL_FRAC) if qk else {}
                    e = compare(f"{fwd} [{tag}]", fb.attention_rows(qkv, **kw), fb.attention_rows_reference(qkv, **kw),
                                None if qk else ATTN_ATOL, ATTN_RTOL, **bound)
                    eb = check_attention_bwd(fb, bwd, qkv, dm, kw, tag, *((None, QK_ATTN_ATOL_FRAC) if qk else ()))
                    errs[fwd] = max(errs.get(fwd, 0.0), e)
                    errs[bwd] = max(errs.get(bwd, 0.0), eb)
            sync()
        for label, rows, dim, heads, dh, mlp in LADDER_CHAIN:
            inner = heads * dh
            r = edge_rnd(SEED + 630 + dim)
            x, y, dy = r(rows, dim), r(rows, dim), r(rows, dim)
            lns, lnb = 1 + r(dim, scale=0.1), r(dim, scale=0.1)
            w_qkv, w_out = r(3 * inner, dim, scale=dim**-0.5), r(dim, inner, scale=inner**-0.5)
            w1, b1, w2, b2 = r(mlp, dim, scale=dim**-0.5), r(mlp, scale=0.1), r(dim, mlp, scale=mlp**-0.5), r(dim, scale=0.1)
            h = fb.layernorm_rows_reference(x, lns, lnb)
            compare(f"layernorm_rows [{label}]", fb.layernorm_rows(x, lns, lnb), h, KERNEL_ATOL, KERNEL_RTOL)
            m, a = r(rows, inner), r(rows, mlp)
            for site, inp, weight, bias, res in (("qkv", h, w_qkv, None, None), ("out", m, w_out, b2, y),
                                                  ("fc1", h, w1, b1, None), ("fc2", a, w2, b2, y),
                                                  ("cast", dy, w_out.t().contiguous(), None, None)):
                compare(f"gemm_bf16[{site}] [{label}]", fb.gemm_bf16(inp, weight, site, bias=bias, residual=res),
                        fb.gemm_bf16_reference(inp, weight, site, bias=bias, residual=res), KERNEL_ATOL, KERNEL_RTOL)
            dqkv, w_qkv_t = r(rows, 3 * inner), w_qkv.t().contiguous()
            dh_ = fb.gemm_f32out_reference(dqkv, w_qkv_t)
            compare(f"gemm_f32out [{label}]", fb.gemm_f32out(dqkv, w_qkv_t), dh_, None, F32_RTOL, F32_REL_L2,
                    atol_frac=F32_ATOL_FRAC)
            got, want = fb.layernorm_bwd_rows(x, dh_, lns, residual=dy), fb.layernorm_bwd_rows_reference(
                x, dh_, lns, residual=dy)
            compare(f"layernorm_bwd_rows dx [{label}]", got[0], want[0], KERNEL_ATOL, KERNEL_RTOL)
            for part, gp, wp in zip(("dgamma", "dbeta"), got[1:], want[1:]):
                compare(f"layernorm_bwd_rows {part} [{label}]", gp, wp, None, F32_RTOL, F32_REL_L2,
                        atol_frac=F32_ATOL_FRAC)
            sync()
    for label, rows, dim, heads, dh, mlp in LADDER_CHAIN:  # the whole layer, forward and its 13 gradients
        r = edge_rnd(SEED + 631 + dim)
        inner = heads * dh
        w = dict(w_qkv=r(3 * inner, dim, scale=dim**-0.5), w_out=r(dim, inner, scale=inner**-0.5),
                 ln1_scale=1 + r(dim, scale=0.1), ln1_bias=r(dim, scale=0.1), ln2_scale=1 + r(dim, scale=0.1),
                 ln2_bias=r(dim, scale=0.1), w1=r(mlp, dim, scale=dim**-0.5), b1=r(mlp, scale=0.1),
                 w2=r(dim, mlp, scale=mlp**-0.5), b2=r(dim, scale=0.1))
        kw = dict(b_qkv=r(3 * inner, scale=0.1), b_out=r(dim, scale=0.1))
        x, g = r(2, rows // 2, dim), r(2, rows // 2, dim)

        def grads(layer):
            leaves = [t.detach().clone().requires_grad_() for t in (x, *w.values(), *kw.values())]
            out = layer(leaves[0], *leaves[1:11], heads=heads, dim_head=dh, **dict(zip(kw, leaves[11:])))
            return out, torch.autograd.grad(out, leaves, g)

        out, gr = grads(fb.fused_transformer_layer)
        out_w, gr_w = grads(fb.layer_reference)
        compare(f"fused_transformer_layer [{label}]", out, out_w, LAYER_ATOL, LAYER_RTOL)
        for name, a, b in zip(("x", *w, *kw), gr, gr_w):
            compare(f"layer grad d{name} [{label}]", a, b, None, KERNEL_RTOL, LAYER_GRAD_REL_L2,
                    atol_frac=LAYER_GRAD_ATOL_FRAC)
        sync()
    return errs


class LayerSpy:
    """Counts the Transformer's whole-layer calls and attention-block calls
    (nn/blocks.py's names) and the dispatcher's calls (the composite and the
    flash and short routes) inside the ``with`` block."""

    def __enter__(self):
        from vit_pytorch_tpu_torch.nn import blocks

        self.blocks, self.counts = blocks, {"layer": 0, "block": 0, "dispatcher": 0}
        self.saved = blocks.fused_transformer_layer, blocks.fused_attention_block, blocks.dot_product_attention

        def spy(key, fn):
            def call(*a, **k):
                self.counts[key] += 1
                return fn(*a, **k)
            return call

        blocks.fused_transformer_layer = spy("layer", self.saved[0])
        blocks.fused_attention_block = spy("block", self.saved[1])
        blocks.dot_product_attention = spy("dispatcher", self.saved[2])
        return self

    def __exit__(self, *exc):
        self.blocks.fused_transformer_layer, self.blocks.fused_attention_block, \
            self.blocks.dot_product_attention = self.saved


def ladder_model(label, dev, dtype, **kw):
    """One ladder model at full width and depth, random weights from SEED,
    initialised in f32 and cast."""
    from vit_pytorch_tpu_torch import ViT

    cfg = {**LADDER[label][0], **kw}
    return ViT(**cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED)).to(dtype)


def serve_ladder(fb, fa, label, dev, gen):
    """A ladder model served through Predictor at its serving batch: one
    bucket run, exact launch counters (the depth's whole layers, nothing
    else), the spies' counts (every layer whole, no dispatcher call), and the
    logits against the plain twins (bf16) and the f32 model.  Returns the
    counts and the bucket's qkv for the timing."""
    from vit_pytorch_tpu_torch.serving import Predictor

    cfg, bs, _ = LADDER[label]
    depth = cfg["depth"]
    bf16 = torch.bfloat16
    fp32 = ladder_model(label, dev, torch.float32)
    log(f"[63 {label} serving] {cfg}, bs={bs}, random weights (seed {SEED}), bf16")
    size = cfg["image_size"]
    pred = Predictor(fp32, example_shape=(3, size, size), batch_sizes=(bs,), device=dev).warmup()
    images = torch.randn(bs, 3, size, size, generator=gen, device=dev)
    served, tr = pred.model, pred.model.transformer
    reset_all(fb, fa)
    with LayerSpy() as spy:
        out = pred(images)
        sync()
    counts = all_launches(fb, fa)
    want = {name: depth * LAUNCHES_PER_LAYER.get(name, 0) for name in counts}
    log(f"  launches {({k: v for k, v in counts.items() if v})} (expected {depth} layers x 7), calls {spy.counts}")
    if counts != want or spy.counts != {"layer": depth, "block": 0, "dispatcher": 0}:
        fail(f"phase 63: {label} serving did not run every layer on the whole-layer kernels")
    if out.shape != (bs, 1000) or not bool(torch.isfinite(out).all()):
        fail(f"phase 63: {label} logits {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    with torch.inference_mode():
        x = served.embed(images.to(bf16))
        for i in range(depth):
            ws, kws = tr.layer_weights(i, bf16)
            x = fb.layer_reference(x, *ws, heads=tr.heads, dim_head=tr.dim_head, **kws)
        plain = served.mlp_head(tr.norm(x)[:, 0])
        ref = fp32(images)
    e_plain, e_fp32 = rel_l2(out, plain), rel_l2(out, ref)
    ok = e_plain <= LOGITS_VS_PLAIN_BF16 and e_fp32 <= LOGITS_VS_FP32
    log(f"  logits rel L2 vs plain bf16 {e_plain:.4e} (bound {LOGITS_VS_PLAIN_BF16}), vs fp32 {e_fp32:.4e} (bound "
        f"{LOGITS_VS_FP32}; plain bf16 vs fp32 {rel_l2(plain, ref):.4e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"phase 63: {label} served logits disagree with the plain path or fp32")
    with torch.inference_mode():
        ws, _ = tr.layer_weights(0, bf16)
        qkv = fb.gemm_bf16(fb.layernorm_rows(served.embed(images.to(bf16)), ws[2], ws[3]), ws[0], "qkv")
    del pred, served, fp32
    torch.cuda.empty_cache()
    return counts, qkv


def train_ladder(fb, fa, label, dev, gen, rate):
    """A ladder model trained LADDER_STEPS AdamW steps at its training batch
    through make_train_step on one batch (dropout ``rate``): exact launch
    counters (the whole layer's 13 a layer at rate 0, the attention block's
    11 at 0.1), the spies' counts, the loss falling, the first step's loss
    and gradients against the same step on the plain twins (the same masks),
    and the step's peak memory.  Returns the counts and the peak GiB."""
    from vit_pytorch_tpu_torch.parallel.train import create_train_state, make_train_step

    cfg, _, bs = LADDER[label]
    depth = cfg["depth"]
    bf16 = torch.bfloat16
    model = ladder_model(label, dev, bf16, dropout=rate)
    initial = copy.deepcopy(model)
    names = [n for n, _ in model.named_parameters()]
    images = torch.randn(bs, 3, cfg["image_size"], cfg["image_size"], generator=gen, device=dev).to(bf16)
    labels = torch.randint(0, 1000, (bs,), generator=gen, device=dev)
    log(f"[63 {label} training] bs={bs}, dropout {rate}, {LADDER_STEPS} AdamW steps on one batch, bf16")
    state, step = create_train_state(model), make_train_step(model)
    reset_all(fb, fa)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, grads, ms = [], None, []
    with LayerSpy() as spy:
        for i in range(LADDER_STEPS):
            t0 = time.perf_counter()
            losses.append(step(state, images, labels, torch.Generator(device=dev).manual_seed(SEED + i))["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                grads = grad_vector(model)
        sync()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    counts = all_launches(fb, fa)
    per_layer_ = TRAIN_LAUNCHES_PER_LAYER if rate == 0.0 else DROPOUT_LAUNCHES_PER_LAYER
    want = {k: depth * per_layer_.get(k, 0) * LADDER_STEPS for k in counts}
    route = "layer" if rate == 0.0 else "block"
    want_calls = {"layer": 0, "block": 0, "dispatcher": 0, route: depth * LADDER_STEPS}
    log(f"  losses {[f'{v:.6f}' for v in losses]}; host ms a step {[f'{v:.1f}' for v in ms]}; peak device memory "
        f"{peak:.2f} GiB; launches {({k: v for k, v in counts.items() if v})}; calls {spy.counts}")
    if counts != want or spy.counts != want_calls:
        fail(f"phase 63: {label} training at dropout {rate} did not launch every kernel of every layer (expected "
             f"{({k: v for k, v in want.items() if v})}, calls {want_calls})")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"phase 63: {label} training loss is not finite or does not fall on the repeated batch")
    plain = copy.deepcopy(initial)
    reset_all(fb, fa)
    with plain_layers():
        loss_plain = make_train_step(plain)(create_train_state(plain), images, labels,
                                            torch.Generator(device=dev).manual_seed(SEED))["loss"].item()
    sync()
    if any(all_launches(fb, fa).values()):
        fail(f"phase 63: the plain path launched kernels: {all_launches(fb, fa)}")
    compare_grads(f"{label} first step vs plain bf16 (dropout {rate})", grads, grad_vector(plain), losses[0],
                  loss_plain, TRAIN_VS_PLAIN, names)
    del model, initial, plain, state, step
    torch.cuda.empty_cache()
    return counts, peak


def time_ladder_attention(fb, label, qkv, smi, rates=(0.0,), bwd_batch=None):
    """attention_rows at the served batch's qkv and attention_bwd_rows at
    the training batch (its first ``bwd_batch`` images, a random dm), each
    variant of ``rates``: kernel and twin in turns, SDPA beside the forward,
    SDPA forward + backward beside the backward (no one torch call gives m
    and dqkv: product_only_ms, as phase 8's), every call with L2 flushed by
    the size of the operands (no flush: the kernels at these batches move
    more than the 50 MB L2)."""
    cfg = LADDER[label][0]
    heads, dh = cfg["heads"], cfg["dim_head"]
    b, n, _ = qkv.shape
    per_kernel = {}
    with torch.inference_mode():
        for rate in rates:
            kw = dict(heads=heads, dim_head=dh, scale=dh**-0.5, dropout_rate=rate, seed=DROP_SEED if rate else None)
            name = fb._variant("attention_rows", rate > 0, False)
            km, pm = in_turns(lambda: fb.attention_rows(qkv, **kw), lambda: fb.attention_rows_reference(qkv, **kw), 10)
            lib = sdpa_ms(qkv, heads, 10, dh=dh, **({"dropout_p": rate} if rate else {}))
            record(per_kernel, f"{name} @ {label}", km, pm, attention_work(b, n, heads, dropout=rate > 0, dh=dh),
                   library_ms=lib)
            log(f"  {name} @ {label} (b={b} n={n} {heads} x {dh}): kernel {km:.4f} ms, plain {pm:.4f} ms, "
                f"SDPA {lib:.4f} ms; {smi}")
            if bwd_batch:
                q = qkv[:bwd_batch].contiguous()
                dm = torch.randn(bwd_batch, n, heads * dh, generator=torch.Generator(device=qkv.device).manual_seed(
                    SEED + 632), device=qkv.device).to(qkv.dtype)
                name = fb._variant("attention_bwd_rows", rate > 0, False)
                km, pm = in_turns(lambda: fb.attention_bwd_rows(q, dm, **kw),
                                  lambda: fb.attention_bwd_rows_reference(q, dm, **kw), 10)
                yard = sdpa_fwd_bwd_ms(q, dm, heads, 10, dh=dh, **({"dropout_p": rate} if rate else {}))
                record(per_kernel, f"{name} @ {label}", km, pm,
                       attention_work(bwd_batch, n, heads, backward=True, dropout=rate > 0, dh=dh),
                       product_ms=yard, product_of=SDPA_FWD_BWD)
                log(f"  {name} @ {label} (b={bwd_batch}): kernel {km:.4f} ms, plain {pm:.4f} ms, SDPA forward + "
                    f"backward {yard:.4f} ms; {smi}")
    return per_kernel


def check_ladder(fb, fa, rnd, dev, gen, smi):
    """Phase 63: the wide kernels against their twins, then the paths: ViT-H/14
    and ViT-g/14 served at 64, ViT-H/14 trained at 32 (dropout 0 and 0.1),
    the d32 and d128 ViT-Bs served and trained at 128, each with its
    counters zeroed just before and read just after; the attention kernels
    timed at each.  Returns (max_abs, per_kernel, launches), each by the
    kernels line's entry name."""
    errs = check_ladder_kernels(fb, rnd, dev)
    per_kernel, launches = {}, {}
    for label in LADDER:
        counts, qkv = serve_ladder(fb, fa, label, dev, gen)
        launches[f"attention_rows @ {label}"] = counts["attention_rows"]
        bs_train = LADDER[label][2]
        if bs_train:
            counts, peak = train_ladder(fb, fa, label, dev, gen, 0.0)
            launches[f"attention_bwd_rows @ {label}"] = counts["attention_bwd_rows"]
            log(f"  {label} training step's peak device memory: {peak:.2f} GiB ({smi})")
        if label == "ViT-H/14":
            counts, _ = train_ladder(fb, fa, label, dev, gen, RATE)
            for name in ("attention_rows[dropout]", "attention_bwd_rows[dropout]"):
                launches[f"{name} @ {label}"] = counts[name]
        per_kernel.update(time_ladder_attention(fb, label, qkv, smi, (0.0, RATE) if label == "ViT-H/14" else (0.0,),
                                                bs_train))
        del qkv
        torch.cuda.empty_cache()
    return {name: errs[name.split(" @ ")[0]] for name in launches}, per_kernel, launches


def time_layer_dispatch(fb, dev, smi):
    """Host us of one ViT-B/16 layer's 7 forward launches at bs=1 (n = 197),
    through the eager implementation (``fused_transformer_layer``, what
    eager calls run) against the same chain through the registered ops
    (``torch.ops.vit_torch.*``, the route a traced program takes); 500 calls
    after 20 warm-up ones, host clock stopped before the synchronize, in
    turns (eager, ops, ops, eager, three times), under inference_mode."""
    from types import SimpleNamespace

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    w, kw = layer_weights(rnd)
    x = rnd(1, N, DIM)
    vit_torch = torch.ops.vit_torch
    ops = SimpleNamespace(
        layernorm_rows=lambda t, s, b, eps: vit_torch.layernorm_rows(t, s, b, eps),
        gemm_bf16=lambda a, wt, epi, bias=None, residual=None: vit_torch.gemm_bf16(a, wt, epi, bias, residual, 0.0,
                                                                                   None, 0),
        attention_rows=lambda qkv, heads, dim_head, scale, n_keys=None: vit_torch.attention_rows(
            qkv, heads, dim_head, scale, 0.0, None, None, None, qkv.shape[1]),
    )
    args = (x, w["w_qkv"], kw["b_qkv"], w["w_out"], kw["b_out"], w["ln1_scale"], w["ln1_bias"], w["ln2_scale"],
            w["ln2_bias"], w["w1"], w["b1"], w["w2"], w["b2"], HEADS, DH, DH**-0.5, fb.LN_EPS)
    calls = {"eager": lambda: fb.fused_transformer_layer(x, w["w_qkv"], w["w_out"], w["ln1_scale"], w["ln1_bias"],
                                                         w["ln2_scale"], w["ln2_bias"], w["w1"], w["b1"], w["w2"],
                                                         w["b2"], heads=HEADS, dim_head=DH, **kw),
             "ops": lambda: fb._layer_forward(ops, *args)[0]}

    with torch.inference_mode():
        if not torch.equal(calls["eager"](), calls["ops"]()):
            fail("phase 60: the layer through the ops differs from the eager layer")

        def host_us(call):
            for _ in range(20):
                call()
            sync()
            t = time.perf_counter()
            for _ in range(500):
                call()
            us = (time.perf_counter() - t) * 1e6 / 500
            sync()
            return us

        order = ("eager", "ops", "ops", "eager") * 3
        turns = [(k, host_us(calls[k])) for k in order]
    got = {k: sorted(us for n, us in turns if n == k) for k in calls}
    eager, through_ops = statistics.median(got["eager"]), statistics.median(got["ops"])
    log(f"  one layer's 7 launches at bs=1, host us a call ({smi}), medians of 6 turns: eager {eager:.1f} (range "
        f"{got['eager'][0]:.1f}-{got['eager'][-1]:.1f}), through the registered ops {through_ops:.1f} (range "
        f"{got['ops'][0]:.1f}-{got['ops'][-1]:.1f}), {through_ops / eager - 1:+.1%}")


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
    mutant = start_padded_row_mutant()  # phase 45's, built beside the phases before it
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

    # -- 36. the chain at inner != dim and at 9, 16, 64, 65 tokens ------------------------
    errs.update(check_chain_new_shapes(fb, dev))
    phase_done("phase 36")

    # -- 37. ViViT served (both variants, a frame mask) and trained ---------------------
    vivit_counts, fsa_counts, vivit_train_counts, vivit_state = check_vivit(fb, fa, dev)
    phase_done("phase 37")

    # -- 38. MAE pretraining -----------------------------------------------------------------
    mae_counts, mae_state = check_mae(fb, fa, dev)
    phase_done("phase 38")

    # -- 39. MaxViT (and with registers) and config 1 served ---------------------------------
    config1_counts, zoo_served, zoo_inputs = check_maxvit_config1(fb, fa, dev)
    phase_done("phase 39")

    # -- 40. their timing; each chain launch at ViViT's and MAE's shapes ----------------------
    per_kernel.update(time_zoo(fb, fa, dev, smi, vivit_state, mae_state, zoo_served, zoo_inputs))
    del vivit_state, mae_state, zoo_served, zoo_inputs
    phase_done("phase 40")

    # -- 41. Dino trained at full width ----------------------------------------------------------
    dino_counts, dino_errs, ssl_state = check_dino(fb, fa, dev)
    errs.update(dino_errs)
    phase_done("phase 41")

    # -- 42. EsViT and LeJEPA ---------------------------------------------------------------------
    check_esvit_lejepa(fb, fa, dev, ssl_state)
    phase_done("phase 42")

    # -- 43. SimMIM, MPP (dropout 0 and 0.1) and MP3 --------------------------------------------------
    check_masked_trainers(fb, fa, dev, ssl_state)
    phase_done("phase 43")

    # -- 44. their timing; each chain launch at Dino's shape ---------------------------------------
    per_kernel.update(time_ssl(fb, dev, smi, ssl_state))
    del ssl_state
    phase_done("phase 44")

    # -- 45. the attention kernels at the VLA cross-attention shapes --------------------------------
    errs.update(check_vla_kernels(fb, fa, dev, mutant))
    phase_done("phase 45")

    # -- 46. SigLIPVAT at full width, served and trained ----------------------------------------------
    siglip_short_counts, siglip_state = check_siglip_vat(fb, fa, dev)
    siglip_train_counts = siglip_state.pop("step_counts")
    phase_done("phase 46")

    # -- 47. VAT_B, VAAT_B and the wrappers ---------------------------------------------------------------
    vat_train_counts, vat_state = check_vat_wrappers(fb, fa, dev)
    phase_done("phase 47")

    # -- 48. their timing; each VLA attention launch at its shape -------------------------------------------
    per_kernel.update(time_vla(fa, dev, smi, siglip_state, vat_state))
    del siglip_state, vat_state
    phase_done("phase 48")

    # -- 49. the simple-ViT family served and trained; the qkv-bias Transformer; a strided block ---------------
    family_served, family_trained, qkv_launches = check_family(fb, fa, dev, gen)
    family_times, family_errs = time_family(fb, dev, gen, smi)
    per_kernel.update(family_times)
    errs.update(family_errs)
    phase_done("phase 49")

    # -- 50-51. item 9's families 1 and 2 and the distillation served and trained ------------------------------
    zoo2_served, zoo2_trained = check_zoo2(fb, fa, dev, gen)
    phase_done("phases 50-51")

    # -- 52. their new kernel shapes against the twins, timed ---------------------------------------------------
    zoo2_times, zoo2_errs = time_zoo2(fb, fa, dev, gen, smi)
    per_kernel.update(zoo2_times)
    errs.update(zoo2_errs)
    phase_done("phase 52")

    # -- 53. item 9's family 3: ten models served, five trained -----------------------------------------------
    zoo3_served, zoo3_trained = check_zoo3(fb, fa, dev, gen)
    phase_done("phase 53")

    # -- 54. their new kernel shapes against the twins, timed ---------------------------------------------------
    zoo3_times, zoo3_errs = time_zoo3(fb, dev, smi)
    per_kernel.update(zoo3_times)
    errs.update(zoo3_errs)
    phase_done("phase 54")

    # -- 55-56. item 9's families 3b and 4: ten models served, five trained; the patch-merger's kernel shape ----
    zoo4_served, zoo4_trained = check_zoo4(fb, fa, dev, gen)
    zoo4_times, zoo4_errs = time_zoo4(fb, dev, smi)
    per_kernel.update(zoo4_times)
    errs.update(zoo4_errs)
    phase_done("phases 55-56")

    # -- 57-58. item 9's families 5 and 6 and the MOSS wrapper: served, five trained; their kernel shapes ----------
    zoo5_served, zoo5_trained = check_zoo5(fb, fa, dev, gen)
    zoo5_times, zoo5_errs = time_zoo5(fb, dev, smi)
    per_kernel.update(zoo5_times)
    errs.update(zoo5_errs)
    phase_done("phases 57-58")

    # -- 59-60. checkpoints, the input pipeline, the Predictor and artifacts (ROADMAP item 11a) --------------------
    with tempfile.TemporaryDirectory(prefix="vit-torch-smoke-") as tmp:
        full, ckpt_dir = check_resume(fb, dev, tmp)
        phase_done("phase 59")
        check_serving_artifacts(fb, dev, full, ckpt_dir, smi)
        del full
        phase_done("phase 60")
        # -- 61. the mesh (ROADMAP item 11b): a world of one on the card ---------------------------------------
        check_mesh(fb, dev, tmp, smi)
        phase_done("phase 61")

    # -- 62. the examples and tune_train (ROADMAP item 11c) ------------------------------------------------------
    check_examples(fb, fa, smi)
    phase_done("phase 62")

    # -- 63. the JAX width ladder on the wide attention kernels -------------------------------------------------------
    ladder_errs, ladder_times, ladder_launches = check_ladder(fb, fa, rnd, dev, gen, smi)
    errs.update(ladder_errs)
    per_kernel.update(ladder_times)
    phase_done("phase 63")

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
        + [entry(f"{name} @ {label}", {"attention_bwd_rows": ATTN_BWD_SOURCE, "layernorm_bwd_rows": BWD_SOURCE}.get(
                 name, SOURCE), TPU_BWD_KERNEL if name in CHAIN_BWD else TPU_KERNEL, path, counts_[name])
           for label, fwd, bwd, fwd_path, bwd_path in (
               ("ViViT spatial", vivit_counts, vivit_train_counts, "ViViT serving", "ViViT training"),
               ("MAE encoder", mae_counts, mae_counts, "MAE pretraining", "MAE pretraining"),
               (SSL_ENTRY[0], dino_counts, dino_counts, "Dino training", "Dino training"))
           for name, counts_, path in [(n_, fwd, fwd_path) for n_ in CHAIN_FWD]
           + [(n_, bwd, bwd_path) for n_ in CHAIN_BWD]]
        + [entry(f"{name} @ {label}", FLASH_SOURCE, TPU_FLASH[name], f"{label} training step", counts_[name])
           for label, counts_ in zip(VLA_ENTRIES, (siglip_train_counts, vat_train_counts)) for name in TPU_FLASH]
        + [entry(f"short_attention @ {VLA_ENTRIES[0]}", SHORT_SOURCE, TPU_SHORT, "SigLIPVAT serving at (2, 2) views x "
                 "frames (1,024 keys)", siglip_short_counts["short_attention"])]
        + [entry("attention_rows @ SimpleViT-1D", SOURCE, TPU_BLOCK_KERNEL, "SimpleViT-1D serving",
                 family_served["simple_vit_1d"]["attention_rows"]),
           entry("attention_bwd_rows @ SimpleViT-1D", ATTN_BWD_SOURCE, TPU_BWD_KERNEL, "SimpleViT-1D training",
                 family_trained["simple_vit_1d"]["attention_bwd_rows"]),
           entry("attention_rows @ SimpleViT-FFT", SOURCE, TPU_BLOCK_KERNEL, "SimpleViT-FFT serving",
                 family_served["simple_vit_with_fft"]["attention_rows"]),
           entry("gemm_bf16[qkv+bias] @ Transformer", SOURCE, TPU_KERNEL,
                 "Transformer(qkv_bias=True) forward on the whole-layer kernels", qkv_launches)]
        + [entry(f"flash_fwd @ {label}", FLASH_SOURCE, TPU_FLASH["flash_fwd"], f"{label} serving",
                 zoo2_served[key][0]["flash_fwd"]) for label, key in (("ViT-ND", "vit_nd"), ("CCT-3D", "cct_3d"))]
        + [entry("short_attention @ ViT-ND-rotary", SHORT_SOURCE, TPU_SHORT, "ViT-ND-rotary serving",
                 zoo2_served["vit_nd_rotary"][0]["short_attention"])]
        + [entry(f"{name} @ CCT-3D", FLASH_SOURCE, TPU_FLASH_DROPOUT[name], "CCT-3D training at attention dropout 0.1",
                 zoo2_trained["cct_3d"][name]) for name in FLASH_DROPOUT]
        + [entry(f"{name} @ {label}", SOURCE, TPU_KERNEL, f"{label} serving",
                 {**zoo2_served[key][0], **zoo2_served[key][1]}[name])
           for label, key in (("T2T trunk", "t2t"), ("ViT-1D", "vit_1d")) for name in CHAIN_FWD]
        + [entry(f"{name} @ {label}", SOURCE, TPU_KERNEL, f"{key} serving (phase 53)",
                 {**zoo3_served[key][0], **zoo3_served[key][1]}[name])
           for label, key, *_ in ZOO3_SHAPES for name in CHAIN_FWD]
        + [entry(f"{name} @ {label}", {"dropout_apply": DROPOUT_SOURCE, "attention_bwd_rows[dropout]": ATTN_BWD_SOURCE,
                                       "layernorm_bwd_rows": BWD_SOURCE}.get(name, SOURCE),
                 TPU_BLOCK_KERNEL if name in ("attention_rows[dropout]", "gemm_bf16[block_out]") else TPU_BWD_KERNEL,
                 f"{key} training at dropout {RATE} (phase 53)", zoo3_trained[key][name])
           for label, key, *_ in ZOO3_SHAPES for name in ZOO3_DROPOUT_KERNELS]
        + [entry(f"{name} @ {ZOO4_SHAPE[0]}", SOURCE, TPU_BLOCK_KERNEL, "vit_with_patch_merger serving (phase 55)",
                 {**zoo4_served["vit_with_patch_merger"][0], **zoo4_served["vit_with_patch_merger"][1]}[name])
           for name in ZOO4_FWD_KERNELS]
        + [entry(f"{name} @ {ZOO4_SHAPE[0]}", {"dropout_apply": DROPOUT_SOURCE,
                                               "attention_bwd_rows[dropout]": ATTN_BWD_SOURCE,
                                               "layernorm_bwd_rows": BWD_SOURCE}.get(name, SOURCE),
                 TPU_BLOCK_KERNEL if name in ("attention_rows[dropout]", "gemm_bf16[block_out]") else TPU_BWD_KERNEL,
                 f"vit_with_patch_merger training at dropout {RATE} (phase 56)",
                 zoo4_trained["vit_with_patch_merger"][name])
           for name in ZOO3_DROPOUT_KERNELS]
        + [entry(f"{name} @ {label}", SOURCE, TPU_BLOCK_KERNEL, f"{key} serving (phase 57)",
                 {**zoo5_served[key][0], **zoo5_served[key][1]}[name])
           for label, key in (("JumboViT", "jumbo_vit"), ("SimpleUViT", "simple_uvit")) for name in BLOCK_FWD_KERNELS]
        + [entry(f"{name} @ SimpleUViT", {"attention_bwd_rows": ATTN_BWD_SOURCE, "layernorm_bwd_rows": BWD_SOURCE}.get(
                 name, SOURCE), TPU_BWD_KERNEL, "simple_uvit training (phase 58)", zoo5_trained["simple_uvit"][name])
           for name in CHAIN_BWD]
        + [entry(f"{name} @ patch-dropout kept", {"dropout_apply": DROPOUT_SOURCE,
                                                  "attention_bwd_rows[dropout]": ATTN_BWD_SOURCE,
                                                  "layernorm_bwd_rows": BWD_SOURCE}.get(name, SOURCE),
                 TPU_BLOCK_KERNEL if name in ("attention_rows[dropout]", "gemm_bf16[block_out]") else TPU_BWD_KERNEL,
                 f"vit_with_patch_dropout training at dropout {RATE} (phase 58)",
                 zoo5_trained["vit_with_patch_dropout"][name])
           for name in ZOO3_DROPOUT_KERNELS]
        + [entry("gemm_bf16[block_out, bare] @ KEEL", SOURCE, TPU_BLOCK_KERNEL, "vit_with_keel_post_ln serving (phase 57)",
                 zoo5_served["vit_with_keel_post_ln"][1]["gemm_bf16[block_out]"])]
        + [entry(name, WIDE_SOURCE, TPU_BWD_KERNEL if "bwd" in name else TPU_BLOCK_KERNEL if "dropout" in name
                 else TPU_KERNEL, f"{name.split(' @ ')[1]} " + ("serving" if "bwd" not in name and "dropout" not in name
                                                               else f"training at dropout {RATE if 'dropout' in name else 0}")
                 + " (phase 63)", launches_)
           for name, launches_ in ladder_launches.items()]
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
        "mask and torch.addmm beside att+x; the entries '<kernel> @ ViViT spatial' and '<kernel> @ MAE encoder': "
        "the chain's launches at b=128 n=65 and b=256 n=16, dim 1024, 8 heads (inner 512), mlp 2048, their "
        "launches from ViViT's serving requests (forward; spatial and temporal layers) and 2 training steps "
        "(backward) and from one MAE step at the fixed permutation (encoder and decoder layers); the chain's "
        "errors at that shape in phase 36; the entries '<kernel> @ Dino': the chain's launches at b=20 n=65, dim "
        "1024, 8 heads, mlp 2048, their launches from one Dino step (the student's two calls with gradients, the "
        "teacher's two without), errors from phase 41; the entries '<flash kernel> @ SigLIPVAT' and '@ VAT_B': one "
        "launch at the VLA cross-attention's shape, 8 x 8 heads x 54 queries x 1,536 keys and 4 x 8 x 13 x 1,576, "
        "no ids, library_ms SDPA (forward) and PyTorch's flash-attention backward (one aten call for dq, dk, dv), "
        "their launches from the model's first training step (one of each a layer), errors from phase 45; "
        "'short_attention @ SigLIPVAT': 8 x 8 x 54 x 1,024, its launches from one SigLIPVAT forward at (2, 2) views "
        "x frames; the entries '@ SimpleViT-1D' and '@ SimpleViT-FFT': attention_rows (and attention_bwd_rows) at "
        "bs=256, 16 tokens of 8 heads and 128 tokens of 16 heads, by device time, their launches from one served "
        "batch (and 3 training steps) of those models in phase 49, library_ms SDPA; 'gemm_bf16[qkv+bias] @ "
        "Transformer': the qkv site with its bias at 1,576 x 2,304 x 768, library_ms F.linear with the bias, its "
        "launches from the qkv-bias Transformer's whole-layer forward; 'flash_fwd @ ViT-ND' and '@ CCT-3D': 16 x 8 "
        "heads x 1,025 (a 1-row tail tile) and 16 x 6 x 1,568, 'short_attention @ ViT-ND-rotary' 16 x 8 x 1,024, "
        "their launches from one served batch of those models in phase 50; the flash [dropout] kernels '@ CCT-3D' "
        "at 8 x 6 x 1,568, rate 0.1, launches from CCT-3D's 3 training steps in phase 51, library_ms SDPA with "
        "dropout_p and the flash-attention backward at dropout_p 0.1; the chain's forward '@ T2T trunk' (b=64 "
        "n=197, dim 512, 8 heads, mlp 512) and '@ ViT-1D' (b=64 n=17, dim 1024, 8 heads, mlp 2048), launches from "
        "one served batch, errors from phase 52; the chain's forward '@ CrossViT large' (b=64 n=17, dim 384, 8 "
        "heads: inner 512, mlp 2048) and '@ PiT stage 3' (b=64 n=65, dim 1024, 16 heads, mlp 2048), launches from "
        "one served batch of CrossViT and PiT in phase 53, errors from phase 54; the attention block's dropout "
        "kernels and the backward's gemm_f32out and layernorm_bwd_rows at the same shapes at bs=32, rate 0.1, "
        "launches from the model's 3 training steps in phase 53, library_ms SDPA with dropout_p and "
        "native_layer_norm_backward, errors from phase 54; the entries '@ patch-merger': layernorm_rows, "
        "gemm_bf16[qkv] and attention_rows at the merged shape (b=64 n=8, dim 1024, 8 heads: inner 512), launches "
        "from one served batch of the patch-merger ViT in phase 55 (layers 7-12 on the attention block), and the "
        "attention block's dropout kernels and the backward's gemm_f32out and layernorm_bwd_rows at bs=32, rate "
        "0.1 (gemm_bf16[block_out] timed with a residual operand, the model adds its residual outside), launches "
        "from its 3 training steps in phase 56, errors and times from phase 56, every call with L2 flushed; the "
        "entries '@ JumboViT' and '@ SimpleUViT': the attention block's forward launches (gemm_bf16[block_out] bare: "
        "no residual, no bias) at b=64 n=70, dim 64, 2 heads and at b=64 n=68, dim 1024, 16 heads, launches from one "
        "served batch of those models in phase 57, and SimpleUViT's backward launches at bs=32, launches from its 3 "
        "training steps in phase 58; the entries '@ patch-dropout kept': the attention block's dropout kernels and "
        "the backward's at b=32 n=49 (the 48 patches kept and the cls token), rate 0.1, launches from the "
        "patch-dropout ViT's 3 training steps in phase 58; 'gemm_bf16[block_out, bare] @ KEEL': with its bias and no "
        "residual at b=64 n=65, dim 1024, library_ms F.linear with the bias, launches from one served batch of the "
        "KEEL ViT in phase 57; errors and times from phase 58, every call with L2 flushed; the entries '@ ViT-H/14', "
        "'@ ViT-g/14', '@ d32' and '@ d128' (phase 63): the wide attention kernels (csrc/attention_wide.cuh) at those "
        "models' shapes, the forward at the served batch (64, 64, 128, 128; 257, 257, 197, 197 tokens; 16 x 80, "
        "16 x 88, 24 x 32, 6 x 128), the backward at the training batch (32, 128, 128), [dropout] at rate 0.1, "
        "library_ms SDPA (with dropout_p beside [dropout]), the backward's SDPA forward + backward as "
        "product_only_ms, launches from the model's served batch (forward) and its 3 training steps at dropout 0 "
        "(backward) or 0.1 ([dropout]), errors the largest of phase 63's checks of that variant at every shape)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
