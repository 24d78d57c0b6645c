#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: SwinIR-M 4x, HAT-M 4x,
DAT 4x, Swin2SR-M 4x and SRFormerV2 4x serving and training, SwinIR-M 4x
training on pairs degraded on the fly (Real-ESRGAN OTF), the training
form of the Swin attention half that saves P, SwinIR-M 4x GAN training
with the DUnet discriminator (swinir_m_gan.yml), and bf16 training as
the fidelity templates of SwinIR-M, HAT-M, DAT, SwinIR-L and SRFormerV2,
the GAN templates of SwinIR-M, HAT-M, DAT and SRFormerV2, the OTF
template of SwinIR-M, and Swin2SR's fidelity, GAN and OTF templates ship
it; then the conv families (SPAN-S, SPANPlus, Compact, ESRGAN) served and
trained as their templates ship, and two of the JAX bench's workloads
(esrgan_gan with hsluv and cosim; span_s from the device-memory cache);
then SRFormer and ATD (srformer, srformer_light, atd, atd_light) served
and trained as their templates ship, on #2/#7 and on #3/#8's 64-wide form
(atd's heads of 35); then DRCT (drct, drct_l, drct_xl) served and trained
as its templates ship, on #3/#8 at all three head widths (its heads of 122
and 77 on the 128-wide form) and #2/#7 (rows of 276 and 308: #7's split
rows stage).

    python3 chip_smoke.py [--seed N]     # one card

Phases, all run, each printing its lines and ending the run with exit 1 on
failure:

1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
             versions; no card is a failure.
2. build   - compile the CUDA kernels from `trainner_redux_tpu_torch/csrc`;
             a kernel that spills registers (ptxas) fails it.
3. kernels - each serving kernel against its plain PyTorch version at
             SwinIR-M shapes (B=1, 128x128 LR, C=180, 6 heads, ws 8), as the
             path calls them: K=1 unshifted and K=4 with the shift of 4 that
             fused_attn_block indexes itself; kernel, plain and library
             times (#3 by CUDA graphs: a call is shorter than its host time)
             and the card's bound; at K=4 #1's, #2's and #3's device time by
             stage (their tensor-core stages, csrc/block_fwd.cuh and
             csrc/tc_attn.cuh) and their times against the fp32 and the
             3xTF32 bounds; each and its plain version against float64.
4. path    - `trainner_redux_tpu_torch.test.run` on a seeded SwinIR-M 4x
             (.pth) and 4 seeded images (three 128x128 LR, one 100x120),
             counting kernel launches; then the same through the unfused
             branch (TRAINNER_FUSED_BLOCK=0), which runs fused_window_mhsa.
5. branches - one 128x128 image through the fused, unfused and plain
             (TRAINNER_FUSED_ATTN=0) branches, each timed (as every served
             forward: the median of 7 timed groups after 3 warm-ups, with
             the spread); the outputs must agree.
6. profile - device time by kernel of the fused-branch forward; a launch
             of a RETIRED forward kernel fails it (as in every profile).
7. train kernels - the training block's forward (#4: out, P, att, z) and
             saved-P backward (#5: dx and 13 parameter gradients) against
             their plain versions at the SwinIR-M training block (B=8, 64x64
             LR, DropPath scales holding 0 and 1/0.9), K=1 unshifted and K=4
             shifted by 4; times and the card's bound; #4's and #5's device
             time by stage (torch.profiler) and their times against the fp32
             and the 3xTF32 bounds, with the share of each (#5's window
             attention must be #10's saved-P stage); #5 also from #4's
             own P, att and z against the plain backward from the plain
             forward's; #4 at the OTF path's block (B=8, 32x32) timed.
8. train   - `trainner_redux_tpu_torch.train.run` on SwinIR-M 4x at full
             width and depth: 16 seeded 512x512 HR images, batch 8 of 64x64
             LR crops, L1, AdamW 2e-4, EMA 0.999, fp32, 6 steps
             (FP32_STEPS; 30 until PR 21) and a checkpoint, counting
             launches; the EMA checkpoint then serves
             through `test.run` with the strict load.
9. train branches - one forward and backward from equal weights and batch
             through the kernel branch and the plain branch; losses and
             gradients must agree.
10. train profile - device time by kernel of one training step.
11. hat kernels - HAT-M's kernels at its training block (B=8, 64x64 LR,
             C=180, 6 heads, 16x16 windows, hidden 360): the ws-16 window
             forward (#3) and its backward (#8: dqkv, dbias; also at ws 8,
             SwinIR's unfused branch; two runs of each bit-identical, #3
             against float64), and the MLP half's backward (#7), each
             against its plain version; times, the card's bound and, for #3
             and #8, SDPA with a float mask; #3's, #8's (ws 16, K=4) and
             #7's device time by stage and their times against both bounds.
12. hat path - `test.run` on a seeded HAT-M 4x and the 4 images, counting
             launches (36 window-MHSA and 42 MLP kernels an image).
13. hat train - `train.run` on HAT-M 4x as phase 8 (6 steps), counting
             36 + 36 window-MHSA and 42 + 42 MLP launches a step.
14. hat train branches - one forward and backward of HAT-M, and one of
             SwinIR-M's unfused branch (TRAINNER_FUSED_BLOCK=0), each through
             the kernels and the plain branch; losses and gradients must agree.
15. hat train profile - device time by kernel of one HAT-M training step.
16. dat kernels - the rect forms of #3 and #8 (`fused_rect_mhsa` and its
             backward) at DAT's training block (B=8, the 48x48 LR crop's qkv
             padded to 64x64, a 90-channel branch of 3 heads of 30): windows
             8x32 and 32x8, K=1 and K=4 with their shifts, and dat_s's 8x16
             shifted; each against its plain version and #3 against
             float64, two runs of each bit-identical; times, the card's
             bound and SDPA with a float mask; #3's device time by stage at
             each window's K=4 and #8's at 8x32 K=4, their times against
             both bounds.
17. dat path - `test.run` on a seeded DAT 4x and the 4 images, counting
             launches (36 rect-window forwards an image); one 128x128
             image's forward timed.
18. dat train - `train.run` on DAT 4x as `dat_fidelity.yml` has it (batch
             8 of 48x48 LR crops, L1 + MS-SSIM, AdamW 2e-4, EMA 0.999) in
             fp32, 6 steps, counting 36 + 36 rect launches a step; the EMA
             checkpoint then serves with the strict load.
19. dat train branches - one forward and backward of DAT 4x (48x48 LR)
             through the kernels and the plain branch; losses and gradients
             must agree.
20. dat train profile - device time by kernel of one DAT training step.
21. swin2sr kernels - the post-norm SwinV2 halves at Swin2SR-M's training
             block (B=8, 48x48 LR, C=180, 6 heads of 30, ws 8, hidden 360,
             DropPath scales holding 0 and 1/0.9), K=1 and K=4 shifted by 4:
             the cosine-attention half (#11) and its backward (#12), the MLP
             half (#13) and its backward (#14), each against its plain
             version, two runs of each bit-identical; times and the card's
             bound; #11's, #12's, #13's and #14's device time by stage at K=4
             and their times against the fp32 and the 3xTF32 bounds; #11 and
             #13 against float64 with every temperature at its largest, 100;
             #13 and #14 at
             Swin2SR-L's MLP half (C 240, hidden 480) against their plain
             versions, #14 twice bit for bit, timed and split by stage; #11
             and #13 also at B=1, 128x128 (serving).
22. swin2sr path - `test.run` on a seeded Swin2SR-M 4x and the 4 images,
             counting 36 #11 and 36 #13 launches an image; one 128x128
             forward timed through the kernel branch and the unfused branch
             (TRAINNER_FUSED_BLOCK=0), which must agree.
23. swin2sr train - `train.run` on Swin2SR-M 4x as `swin2sr_m_fidelity.yml`
             has it (batch 8 of 48x48 LR crops, L1 + MS-SSIM, AdamW 2e-4,
             EMA 0.999) in fp32, 6 steps, counting 36 launches of each of
             #11-#14 a step; the EMA checkpoint then serves with the strict
             load.
24. swin2sr train branches - one forward and backward of Swin2SR-M through
             the kernels and the unfused branch: losses and gradients
             (logit_scale and the CPB MLP included) must agree; then both
             timed.
25. swin2sr train profile - device time by kernel of one Swin2SR-M
             training step.
26. jpeg kernel - the DiffJPEG block transform (#15) against its plain
             version at the OTF path's planes (batch 8 of gt_size 128: Y
             8x36 and C 8x9 blocks, qualities across 45-95) and at 8 images
             of 512x512 (8x4096 Y blocks): max abs error, blocks near a
             rounding tie counted and left out, two runs bit-identical;
             kernel and plain device times (CUDA graphs: at the path's
             planes a call is shorter than its host time) and the bound;
             then a compression's three planes (Y, Cb, Cr) in one launch,
             bit for bit the three single-plane launches, timed against
             them, beside an empty kernel's launch floor.
27. otf degrade - one seeded batch (8 GT crops of 160x160, the dataset's
             kernels) through `_degrade` with every optics, sensor, ISP,
             editing and recompression gate open, twice from the same
             generator states: through #15 and through the plain core; the
             LQs within 1/255, the values that differ counted, both timed.
28. otf train - `train.run` on SwinIR-M 4x OTF as swinir_m_otf.yml has it
             in fp32, without the GAN and the perceptual loss (batch 8 of
             gt_size 128, queue 120, L1, AdamW 2e-4, EMA 0.999; the
             template's MS-SSIM raises at gt_size 128 in both packages),
             TRAIN_STEPS steps from 16 seeded 512x512 HR images, counting #15 (one
             launch a compression, recompressions included) and #4/#5 (36 +
             36 a step); the EMA checkpoint then serves with the strict load.
29. otf train profile - device time by kernel of one OTF step, split into
             the degradation (`feed_data`) and the optimizer step, with the
             card's idle share; both also timed without the profiler.
30. srformerv2 kernels - SRFormerV2's Swin-block kernels at its training
             block (B=8, the 48x48 LR crop padded to 72x72, C=240, 8 heads
             of 30, 12x12 windows, hidden 480, DropPath scales holding 0 and
             1/0.9): #1 on the tensor-core stages (csrc/block_fwd.cuh) and
             its recompute backward #6, K=1 and K=4 shifted by 6; #2 and #7;
             each against its plain version, #1 also against float64, #6
             and #7 bit-identical over two runs; times and the card's bound;
             #1's, #6's (K=1), #2's and #7's device time by stage and their
             times against both bounds; #1 and #2 also at B=1, 144x144 (a
             128x128 image, served).
31. srformerv2 path - `test.run` on a seeded SRFormerV2 4x and the 4
             images, counting 18 #1 and 18 #2 launches an image; one 128x128
             forward timed through the kernel branch and the plain branch
             (TRAINNER_FUSED_BLOCK=0), which must agree.
32. srformerv2 train - `train.run` on SRFormerV2 4x as
             `srformerv2_fidelity.yml` has it (L1 + MS-SSIM, AdamW 2e-4, EMA
             0.999) in fp32 at batch 8 of 48x48 LR crops (the template's 16
             halved), 6 steps, counting 18 launches of each of #1, #6, #2
             and #7 a step; the EMA checkpoint then serves with the strict
             load.
33. srformerv2 train branches - one forward and backward of SRFormerV2
             through the kernels and the plain branch: losses and gradients
             must agree; then both timed.
34. srformerv2 train profile - device time by kernel of one SRFormerV2
             training step, its launches and the card's busy share.
35. attn train - the training form of the attention half,
             `fused_attn_block_train` (#9, saving P and att; its saved-P
             backward #10), at SwinIR-M's training block (B=8, 64x64, C=180,
             6 heads of 30, 8x8 windows) and SRFormerV2's (B=8, 72x72, C=240,
             8 heads of 30, 12x12 windows), K=1 unshifted and K=4 shifted by
             half the window. First the path: one whole Swin block, that half
             then `fused_ln_mlp`, forward and backward of sum(out^2) at each
             block and K, counting launches; then #9 (z, P, att) and #10 (from
             the same P and att) against their plain versions, #10 twice bit
             for bit; the block against the same block through
             `fused_attn_block` (#1/#6) and, at 8x8, `fused_swin_block_train`
             (#4/#5); times of #9, #10, #1 and #6 and of the two blocks, the
             card's bound, and each block's peak memory; #10 also from #9's
             own P and att; at each block's last K, #9's and #10's device
             time by stage against both bounds, and at 8x8 #6's.
36. deterministic - one training step of each of SwinIR-M, HAT-M, DAT,
             Swin2SR-M and SRFormerV2 (their train phases' crops and losses)
             with `deterministic: true`, twice from one seed and batch: no op
             of the step lacks a deterministic implementation, and the two
             steps agree bit for bit.
37. gan branches - one GAN step of configs/_templates/train/SwinIR/
             swinir_m_gan.yml (fp32: batch 8 of 48x48 LR, DUnet, L1 +
             MS-SSIM + perceptual + vanilla GAN 0.1, AdamW 2e-4 for G and
             D) from equal weights and batch through the kernel branch and
             the plain branch: the logged G and D losses, D's gradients,
             each spectral norm's refreshed (u, v), and G's gradients from
             the plain branch's gradient at G's output (VGG19's kinks turn
             the branches' rounding into larger differences there; printed).
38. gan train - `train.run` of that config, 6 steps from 16 seeded
             512x512 HR images, counting #4/#5 (36 + 36 a step); every log
             finite; D's parameters and (u, v) moved; the EMA checkpoint
             serves with the strict load and net_d_<TRAIN_STEPS> loads back strictly
             into DUnet. The perceptual loss runs on the seeded random VGG19
             where no vgg19.pth is on the machine, and says so.
39. gan train profile - device time by kernel of one GAN step, split into
             the G step and the D step, with the card's busy share; of the G
             step, DUnet on the fake and the two VGG19 passes, and of one
             DUnet pass its three DySamples, each profiled alone.
40. gan deterministic - two GAN steps with `deterministic: true`, twice
             from one seed and batches: bit for bit in every log, G, D and
             each (u, v).
41. bf16 kernels - the bf16 forms of #4 and #5 at the training block (B=8,
             64x64 LR, C 180, K=1 and K=4 shifted by 4), on bf16 x and dout
             with the fp32 parameters: every output and gradient against
             its bf16 plain version (BF16_TOL of its largest, at most
             BF16_FAR_SHARE of its elements beyond one bf16 step), #5 also
             from the kernel forward's own P, att and z; kernels and plain
             versions against the float64 function of the same bf16
             inputs (the kernel's error at most F64_RATIO times the plain
             version's, plus F64_FLOOR of the largest); two runs bit for
             bit; times beside the plain versions' and the fp32 forms',
             the bf16 bound (989 TFLOP/s) and its share; device time by
             stage.
42. bf16 train - `train.run` of configs/_templates/train/SwinIR/
             swinir_m_fidelity.yml as shipped (compute_dtype bfloat16,
             batch 8 of 48x48 LR, L1 + MS-SSIM, AdamW 2e-4, EMA 0.999, its
             validation), TRAIN_STEPS steps, counting 36 + 36 bf16 #4/#5 launches a
             step and none of the fp32 forms; the validation at the end of
             training runs the fp32 twin on #1/#2 (PSNR, SSIM); the EMA
             checkpoint then serves with the strict load.
43. bf16 train profile - device time by kernel of one bf16 step, the
             bf16 #4/#5 stages summed, the card's busy share.
44. bf16 branches - one bf16 step from equal weights and batch through the
             bf16 kernels, through the bf16 plain versions of #4/#5 on the
             card, and through the fp32 kernels: the losses within
             BF16_BRANCH_LOSS_TOL, the gradients' distance from the fp32
             step (see phase_bf16_branches); then two `deterministic: true`
             bf16 steps twice, bit for bit.
45. bf16 window kernels - the bf16 forms of #3/#8 and #2/#7 on bf16
             operands (fp32 kind table and parameters) at each bf16 path's
             shapes: HAT-M's block (B=8, 48x48, C 180, 6 heads, ws 16, K=1
             and K=4), SwinIR-L's (C 240, 8 heads of 30, ws 8, K=1 and K=4),
             DAT's branches (90 channels, 3 heads; 32x8 and 8x32 at the
             crop's qkv padded to 64x64, K=4 and K=1/K=4, and dat_s's 8x16 at
             48x48) and HAT-M's MLP half (C 180, hidden 360, DropPath scales
             holding 0 and 1/0.9): each output and gradient against its bf16
             plain version (phase 41's BF16_TOL, BF16_FAR_SHARE) and, with
             it, against float64 of the same bf16 inputs (F64_RATIO,
             F64_FLOOR); two runs of each bit for bit; times beside the fp32
             forms', bf16 SDPA with a float mask (#3/#8) and the bf16 bound
             with its share; the stage splits at every K=4 shape (#8 bf16
             on csrc/attn_group_bf16.cuh: its row pass, key pass and group
             sums at n 256, its whole-window kernel and group sums at n 64
             and 128, each by name) and of the MLP half; #8 bf16's peak
             memory within its outputs and grouped scratch (no per-window
             dS); the MLP half also at SRFormerV2's C 240 / hidden 480 (B=8,
             72x72), checked and timed.
46-48. hat / dat / swinir_l bf16 train - `train.run` of hat_m_fidelity.yml,
             dat_fidelity.yml and swinir_l_fidelity.yml as shipped (bf16,
             batch 8 of 48x48 LR, L1 + MS-SSIM, AdamW 2e-4, EMA 0.999, their
             validation), TRAIN_STEPS steps each, counting a step's bf16 launches (HAT-M
             36 + 36 #3/#8 and 42 + 42 #2/#7; DAT 36 + 36 rect #3/#8;
             SwinIR-L 54 + 54 #3/#8 at ws 8 and 54 + 54 #2/#7 at C 240,
             its unfused branch's MLP halves) and none of any fp32 training
             form; every log finite; the validation through the fp32 twin
             (PSNR/SSIM); the EMA checkpoint served with the strict load.
49. hat / dat bf16 profile and branches - phases 43 and 44 for HAT-M and
             DAT: one bf16 step's device time by kernel, the bf16 forms'
             stages summed, the busy share and peak memory; one step through
             the bf16 kernels, their bf16 plain versions and the fp32
             kernels (the losses within BF16_BRANCH_LOSS_TOL, the gradients'
             L2 distance from fp32 within BF16_BRANCH_RATIO of the plain
             versions'); two deterministic bf16 steps twice, bit for bit.
             The profiled step must run #8 bf16's row and key passes and
             group sums, whose device ms it sums.

50. srformerv2 bf16 kernels - the bf16 forms of #1 and #6 (12x12
             windows, csrc/fused_block_train.cu's trr_attn_block_fwd_bf16 /
             _bwd_bf16) at SRFormerV2's training block as its template ships
             it (B=16, 72x72, C 240, 8 heads of 30), K=1 and K=4 shifted by
             6, on bf16 x and dout with fp32 parameters: against their bf16
             plain versions and float64 (phase 45's limits), two runs bit for
             bit, timed beside the fp32 forms with the bf16 bound; split by
             stage at K=1 (#1's window attention attn_group_fwd_bf16_kernel,
             over groups of windows of one kind, its products
             linear_tma_bf16_kernel, TMA-fed).
51. srformerv2 bf16 train - `train.run` of srformerv2_fidelity.yml as
             shipped (bf16, batch 16 of 48x48 LR, L1 + MS-SSIM, its
             validation), TRAIN_STEPS steps, counting 18 + 18 launches a step of
             #1/#6's bf16 forms and of #2/#7's and none of any fp32 training
             form; the fp32 twin's validation; the EMA checkpoint served;
             then one step profiled (device ms, busy share, peak memory,
             #1's and #6's window attention summed).
52. bf16 gan - `train.run` of swinir_m_gan.yml as shipped (bf16: G on
             #4/#5's bf16 forms, DUnet in bf16), TRAIN_STEPS steps with phase 38's
             checks; its step profiled into the G and D steps (phase 39's);
             then hat_m_gan.yml, dat_gan.yml and srformerv2_gan.yml as
             shipped, six steps each, a G step's bf16 launches counted and
             one step profiled into G and D.
53. otf bf16 - `train.run` of swinir_m_otf.yml as shipped with its MS-SSIM
             cut (bf16 G and DUnet, L1 + perceptual + GAN; the degradation
             in fp32 on #15), TRAIN_STEPS steps, counting #15 and 36 + 36 bf16 #4/#5
             launches a step; one step profiled into the degradation and
             the optimizer step, peak memory.

54. swin2sr bf16 kernels - the bf16 forms of #11-#14 (csrc/fused_block_v2.cu's
             trr_cos_attn_fwd_bf16 / _bwd_bf16 and trr_pn_mlp_fwd_bf16 /
             _bwd_bf16) at Swin2SR-M's training block as its template ships
             it (B=8, 48x48, C 180, 6 heads of 30, hidden 360, DropPath
             scales holding 0 and 1/0.9) and at Swin2SR-L's (C 240, 8 heads,
             hidden 480), K=1 and K=4 shifted by 4, and at Swin2SR-S's (C 60)
             K=4 for correctness, on bf16 x and dout with fp32 parameters:
             against their bf16 plain versions and float64 (phase 45's
             limits), two runs bit for bit, timed beside the fp32 forms with
             the bf16 bound; split by stage at M's and L's K=4.
55. swin2sr bf16 train - `train.run` of swin2sr_m_fidelity.yml as shipped
             (bf16, batch 8 of 48x48 LR, L1 + MS-SSIM, its validation), TRAIN_STEPS
             steps, counting 36 launches a step of each of #11-#14's bf16
             forms and none of any fp32 training form; the fp32 twin's
             validation (#11/#13); the EMA checkpoint served; then one step
             profiled (device ms, busy share, peak memory).
56. swin2sr bf16 branches - one bf16 step of Swin2SR-M through the bf16
             forms, their bf16 plain versions on the card and the fp32
             forms: the losses within BF16_BRANCH_LOSS_TOL, the gradients'
             L2 distance from fp32 within BF16_BRANCH_RATIO of the plain
             versions'; two deterministic bf16 steps twice, bit for bit.
57. swin2sr bf16 templates - six bf16 steps each of swin2sr_l_fidelity.yml,
             swin2sr_m_gan.yml and swin2sr_m_otf.yml less its MS-SSIM, as
             shipped: every log finite, each step's bf16 launches counted.

58. conv serve - `test.run` on seeded SPAN-S, SPANPlus, Compact and
             ESRGAN 4x and ESRGAN 2x (pixel-unshuffle; 2x images), full
             width and depth, on the 4 images: no hand-written kernel
             launched (cuDNN convolutions); each 128x128 forward's device
             ms (CUDA graph replay, fp32); SPAN-S's folded eval form
             against its train form, FOLD_TOL of the output's largest.
59. span_s train - `train.run` of span_s_fidelity.yml as shipped (bf16,
             batch 16 of 48x48 LR, L1 + MS-SSIM, its validation through the
             fp32 twin), TRAIN_STEPS steps; one step profiled (device ms, launches,
             busy share, peak memory); one fp32 step (TF32 off) on the card
             against the CPU's (BRANCH_LOSS_TOL, BRANCH_GRAD_TOL); two
             3-step `deterministic: true` runs bit for bit.
60. conv templates - six bf16 steps each of spanplus_fidelity.yml
             (DySample with its end convolution), compact_fidelity.yml,
             esrgan_fidelity.yml (phase 43's profile), esrgan_gan.yml
             (phase 39's G/D profile) and compact_otf.yml less its
             MS-SSIM, queue_size twice its batch (bench.py's; 120 is no
             multiple of 16), as shipped: every log finite.
61-62. conv bench - through `train.run`: bench.py's esrgan_gan (ESRGAN +
             DUnet in bf16; MS-SSIM 0.5, perceptual charbonnier 0.01, hsluv
             charbonnier 1.0, cosim 1.0, vanilla GAN 0.1; optim_d AdamW
             1e-4; no remat), six steps, hsluv's terms logged apart; its
             span_s (batch 16 of 64x64 LR, charbonnier) with `device_cache:
             true`, TRAIN_STEPS steps, beside the same run from the host loader:
             each step end to end, device ms and busy share (the last two
             steps profiled), and a count that the cache cut every batch on
             the card.

63. atd kernels - #3 and #8 at heads of 33 to 64 channels (the 64-wide
             form: rows padded to 64 channels, at n 256 rows of 32 and 8
             warps, csrc/tc_attn.cuh's HD = 64), fp32 and bf16, at atd's
             training block (B=4, 48x48, C 210, 6 heads of 35, ws 16), K=1
             and K=4, and at heads of 64 (C 384) K=4: each against its plain
             version (phase 11's and 45's limits) and float64, two runs bit
             for bit, timed beside the bound and SDPA (bf16: and the fp32
             form), split by stage at K=4 (the 64-wide kernels must launch);
             #3 at B=1, 128x128 (serving) by CUDA graphs; the 32-wide forms
             timed beside them at HAT-M's heads on the same block. #2/#7 in
             fp32 and bf16 at srformer_light's MLP half (C 60, hidden 120,
             rows 16) and srformer's (C 180, hidden 360, rows 24): against
             their plain versions, two runs bit for bit, timed.
64. srformer atd serve - `test.run` on seeded srformer, srformer_light, atd
             and atd_light 4x, full width and depth, on the 4 images: PNGs,
             PSNR/SSIM and launches (#2 once a block for SRFormer, #3 once a
             block for ATD: 36 in one atd forward, on the 64-wide form);
             each 128x128 forward's device ms (torch.profiler).
65. srformer atd train - `train.run` of srformer_fidelity.yml and
             atd_fidelity.yml as shipped (bf16; batch 16 and 4; L1 +
             MS-SSIM; their validation through the fp32 twin), six steps
             each (SIX_STEPS): ms and images/s a step, launches (36 + 36 a
             step of #2/#7's or #3/#8's bf16 forms), peak memory, PSNR/SSIM,
             the EMA checkpoint served; one step profiled (device ms, busy
             share); the share of it SRFormer's PSA and ATD's category
             attention and sort take (timed alone at the step's shapes).
66. srformer atd templates - six bf16 steps each of
             srformer_light_fidelity.yml, atd_light_fidelity.yml and
             atd_gan.yml, as shipped: every log finite, launches counted.
67. atd fp32 - `train.run` of atd in fp32 (batch 4 of 48x48, L1),
             FP32_STEPS steps, 36 + 36 launches a step of #3/#8's 64-wide
             fp32 forms; one fp32 step of atd_light (TF32 off) on the card
             against the CPU (BRANCH_LOSS_TOL, BRANCH_GRAD_TOL), each
             layer's categories compared; two 3-step `deterministic: true`
             bf16 runs of atd_light_fidelity.yml bit for bit.

68. drct kernels - #3 and #8's 128-wide form (heads of 65 to 128 channels:
             csrc/tc_attn.cuh's attn_wide_fwd_kernel, k and v streamed in
             tiles of 64 keys; #8's row pass attn_wide_bwd_rows_kernel and
             key pass attn_wide_bwd_keys_kernel), fp32 and bf16, at drct's
             swin_3 block (B=8, 48x48, C 244, 2 heads of 122, ws 16) K=1
             and K=4 and its swin_5 block (C 308, 4 heads of 77) K=4: each
             against its plain version and float64, two runs bit for bit,
             timed beside the bound and SDPA (bf16: and the fp32 form); #3
             and #8 split by stage (#8: row pass, key pass, bias table) at
             all three (the wide kernels must launch); #3 in fp32 at DRCT's
             serving shape (B=1, 128x128 LR) beside SDPA's forward; the 32-
             and 64-wide forms timed beside at swin_1's and swin_2's heads
             (30, 53) on the same block. #2
             and #7 at swin_5's MLP half (C 308, hidden 308) and swin_4's (C
             276, hidden 276), fp32 and bf16: against their plain versions,
             two runs bit for bit, timed, #7 split by stage (its split rows
             stage's ln_bwd_rows_kernel must launch).
69. drct serve - `test.run` on seeded drct (one 128x128 LR and one 100x120:
             the reflect pad), drct_l and drct_xl (one 128x128 LR each) 4x,
             full width and depth: PNGs, PSNR/SSIM, launches (#3 and #2 once
             a block: 30, 60 and 70 a forward; 2 a group of them on the
             128-wide form); each 128x128 forward's device ms, the 32-, 64-
             and 128-wide #3 kernels named in its profile.
70. drct train - `train.run` of drct_fidelity.yml as shipped (bf16, batch
             8 of 48x48 LR, L1 + MS-SSIM, its validation through the fp32
             twin), TRAIN_STEPS steps: ms and images/s a step, 30 + 30
             launches a step of #3/#8's and of #2/#7's bf16 forms (12 + 12
             on the 128-wide form, 12 of #7 on its split rows stage), peak
             memory, PSNR/SSIM, the EMA checkpoint served; one step
             profiled (device ms, busy share, the hand-written kernels
             against the rest, the 128-wide #8's and #3's device ms; the
             bf16 wide kernels and ln_bwd_rows_kernel must launch).
71. drct templates - six bf16 steps each of drct_gan.yml (DUnet in bf16),
             drct_l_fidelity.yml and drct_otf.yml less its MS-SSIM, four of
             drct_xl_fidelity.yml, as shipped: every log finite, launches
             counted, the new forms' among them; one more drct_l step
             profiled, the new forms' kernels named in it.
72. drct fp32 - one fp32 step (TF32 off, L1) of a one-group drct (embed
             180: heads of 30, 53, 122, 46, 77; rows of 180-308) on 2
             crops of 32x32 LR on the card against the same step on the CPU
             from the same weights and batch (BRANCH_LOSS_TOL relative, each
             gradient BRANCH_GRAD_TOL of its largest; a gradient below
             NEAR_NULL of its block's largest held against that), every
             fp32 form launched (the 128-wide #3/#8, #7's split rows stage);
             a LeakyReLU input that lies within KINK_TOL of its largest
             |value| from 0 takes the CPU's side, at most KINK_MAX.

Each phase prints its seconds, and the run its total. Then one JSON line
of kernel records and, last, the device JSON line.
Scratch files go to `chiprun_out/chip_smoke/` under the repo.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, TF32 on them, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

# SwinIR-M block shapes at B=1 and a 128x128 LR image (serving), and at the
# training batch: 8 crops of 64x64 LR (bench.py's SwinIR-M workload)
B, H, W, C, NH, WS, HIDDEN = 1, 128, 128, 180, 6, 8, 360
TB, TH, TW = 8, 64, 64
HD, N = C // NH, WS * WS
KERNEL_TOL = 1e-4  # unit-scale fp32 inputs; the kernels sum in another order
GRAD_TOL = 1e-4  # of each gradient tensor's largest magnitude
PATH_TOL = 1e-3  # [0, 1] outputs of 36 blocks, kernel vs plain branches
BRANCH_LOSS_TOL = 1e-4  # relative, one training loss, kernel vs plain branch
BRANCH_GRAD_TOL = 1e-3  # of each gradient tensor's largest, after 36 blocks back
# a ReLU / LeakyReLU input element that the branches put on two sides of the
# kink lies within this share of its tensor's largest |value| in both (the
# elements seen lay within 2.64e-7), and a network has at most KINK_MAX
KINK_TOL = 1e-6
KINK_MAX = 4
# #15's outputs are spatial values in [-128, 127]; the JAX kernel test's tolerance
JPEG_TOL = 1e-3
N_IMAGES = 4
BLOCKS = 36
# the template and OTF train.run phases (30 until PR 22, cut to make room
# for phases 63-67; 12 until PR 25, cut to keep the run under 1,100 s on a
# slow host)
TRAIN_STEPS = 8
# the fp32 train.run phases 8, 13, 18, 23, 32, 38 and 67 (30 until PR 21, 6
# until PR 22)
FP32_STEPS = 4
TRAIN_WARMUP = 5  # steps left out of the per-step median
# the logger's print_freq in every train.run phase (10 until PR 25, when no
# run reached step 10 any more): each run, the shortest of FP32_STEPS, logs
# through MessageLogger on the card, outside the profiled windows
PRINT_FREQ = 4

# HAT-M's block: the same widths, 16x16 windows (n = 256), 42 MLP halves
HWS = 16
HN = HWS * HWS
HAT_BLOCKS = 36  # HABs: window attention
HAT_MLPS = 42  # HABs and OCABs: MLP halves

# DAT 4x: 18 spatial blocks of two rect-window branches, each a 90-channel
# half of 3 heads of 30; its training crop (dat_fidelity.yml) is 48x48 LR,
# whose qkv each spatial block pads to 64x64
DAT_RECT = 36  # rect-window attentions a forward
DC, DNH = 90, 3
DHD = DC // DNH
DAT_LQ = 48
# (h_sp, w_sp) -> the shift of a shifted block: dat's two orientations and
# dat_s's first
DAT_WINDOWS = {(8, 32): (4, 16), (32, 8): (16, 4), (8, 16): (4, 8)}

# Swin2SR-M 4x: 36 post-norm blocks at SwinIR-M's widths; its training crop
# (swin2sr_m_fidelity.yml) is 48x48 LR, with L1 + MS-SSIM
SWIN2SR_BLOCKS = 36
S2_LQ = 48
S2_LOSSES = ("l1loss", "mssimloss")

# SRFormerV2 4x: 6 layers of 4 PSA and 3 Swin blocks at embed 240, 8 heads;
# the Swin blocks' 12x12 windows (n 144), hidden 480. Its training crop
# (srformerv2_fidelity.yml) is 48x48 LR, which the network pads to 72x72
# (a multiple of its windows 36 and 12); a 128x128 image runs at 144x144.
SRF_SWIN = 18  # Swin blocks a forward: one #1 and one #2 each
SC, SNH, SWS, SHIDDEN = 240, 8, 12, 480
SRF_WIDTHS = (SC, SNH, SWS, SHIDDEN)
SHD, SN = SC // SNH, SWS * SWS
SRF_LQ, SRF_PAD, SRF_SERVE = 48, 72, 144

REPLACES = {
    "fused_attn_block": "trainner_redux_tpu/ops/pallas/fused_block.py:693",
    "fused_ln_mlp": "trainner_redux_tpu/ops/pallas/fused_block.py:388",
    "fused_window_mhsa": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_swin_block_train": "trainner_redux_tpu/ops/pallas/fused_block.py:1374",
    "fused_swin_block_train_backward": "trainner_redux_tpu/ops/pallas/fused_block.py:1441",
    "fused_window_mhsa_ws16": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_window_mhsa_backward": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_ln_mlp_backward": "trainner_redux_tpu/ops/pallas/fused_block.py:415",
    "fused_rect_mhsa": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_rect_mhsa_backward": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_cos_attn_block": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:338",
    "fused_cos_attn_block_backward": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:373",
    "fused_postnorm_mlp": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:529",
    "fused_postnorm_mlp_backward": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:556",
    "jpeg_block_transform": "trainner_redux_tpu/ops/pallas/jpeg_kernel.py:62",
    "fused_attn_block_ws12": "trainner_redux_tpu/ops/pallas/fused_block.py:693",
    "fused_attn_block_backward": "trainner_redux_tpu/ops/pallas/fused_block.py:729",
    "fused_ln_mlp_c240": "trainner_redux_tpu/ops/pallas/fused_block.py:388",
    "fused_ln_mlp_backward_c240": "trainner_redux_tpu/ops/pallas/fused_block.py:415",
    "fused_attn_block_train": "trainner_redux_tpu/ops/pallas/fused_block.py:977",
    "fused_attn_block_train_backward": "trainner_redux_tpu/ops/pallas/fused_block.py:1036",
    "fused_attn_block_train_ws12": "trainner_redux_tpu/ops/pallas/fused_block.py:977",
    "fused_attn_block_train_backward_ws12": "trainner_redux_tpu/ops/pallas/fused_block.py:1036",
    "fused_swin_block_train_bf16": "trainner_redux_tpu/ops/pallas/fused_block.py:1374",
    "fused_swin_block_train_backward_bf16": "trainner_redux_tpu/ops/pallas/fused_block.py:1441",
    "fused_window_mhsa_bf16": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_window_mhsa_backward_bf16": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_window_mhsa_bf16_ws8": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_window_mhsa_backward_bf16_ws8": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_rect_mhsa_bf16": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_rect_mhsa_backward_bf16": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_ln_mlp_bf16": "trainner_redux_tpu/ops/pallas/fused_block.py:388",
    "fused_ln_mlp_backward_bf16": "trainner_redux_tpu/ops/pallas/fused_block.py:415",
    "fused_attn_block_bf16": "trainner_redux_tpu/ops/pallas/fused_block.py:693",
    "fused_attn_block_backward_bf16": "trainner_redux_tpu/ops/pallas/fused_block.py:729",
    "fused_cos_attn_block_bf16": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:338",
    "fused_cos_attn_block_backward_bf16": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:373",
    "fused_postnorm_mlp_bf16": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:529",
    "fused_postnorm_mlp_backward_bf16": "trainner_redux_tpu/ops/pallas/fused_block_v2.py:556",
    "fused_window_mhsa_hd64": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_window_mhsa_backward_hd64": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_window_mhsa_bf16_hd64": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_window_mhsa_backward_bf16_hd64": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_window_mhsa_hd128": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_window_mhsa_backward_hd128": "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_window_mhsa_bf16_hd128": "trainner_redux_tpu/ops/pallas/window_attention.py:337",
    "fused_window_mhsa_backward_bf16_hd128":
        "trainner_redux_tpu/ops/pallas/window_attention.py:371",
    "fused_ln_mlp_backward_c320": "trainner_redux_tpu/ops/pallas/fused_block.py:415",
    "fused_ln_mlp_backward_bf16_c320": "trainner_redux_tpu/ops/pallas/fused_block.py:415",
}
SOURCES = {
    "fused_attn_block": "trainner_redux_tpu_torch/csrc/fused_block.cu",
    "fused_ln_mlp": "trainner_redux_tpu_torch/csrc/fused_block.cu",
    "fused_window_mhsa": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_swin_block_train": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_swin_block_train_backward": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_window_mhsa_ws16": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_backward": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_ln_mlp_backward": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_rect_mhsa": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_rect_mhsa_backward": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_cos_attn_block": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_cos_attn_block_backward": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_postnorm_mlp": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_postnorm_mlp_backward": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "jpeg_block_transform": "trainner_redux_tpu_torch/csrc/jpeg_block.cu",
    "fused_attn_block_ws12": "trainner_redux_tpu_torch/csrc/attn_block_staged.cu",
    "fused_attn_block_backward": "trainner_redux_tpu_torch/csrc/attn_block_staged.cu",
    "fused_ln_mlp_c240": "trainner_redux_tpu_torch/csrc/fused_block.cu",
    "fused_ln_mlp_backward_c240": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_attn_block_train": "trainner_redux_tpu_torch/csrc/attn_block_staged.cu",
    "fused_attn_block_train_backward": "trainner_redux_tpu_torch/csrc/attn_block_staged.cu",
    "fused_attn_block_train_ws12": "trainner_redux_tpu_torch/csrc/attn_block_staged.cu",
    "fused_attn_block_train_backward_ws12": "trainner_redux_tpu_torch/csrc/attn_block_staged.cu",
    "fused_swin_block_train_bf16": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_swin_block_train_backward_bf16": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_window_mhsa_bf16": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_backward_bf16": "trainner_redux_tpu_torch/csrc/attn_group_bf16.cuh",
    "fused_window_mhsa_bf16_ws8": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_backward_bf16_ws8": "trainner_redux_tpu_torch/csrc/attn_group_bf16.cuh",
    "fused_rect_mhsa_bf16": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_rect_mhsa_backward_bf16": "trainner_redux_tpu_torch/csrc/attn_group_bf16.cuh",
    "fused_ln_mlp_bf16": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_ln_mlp_backward_bf16": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_attn_block_bf16": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_attn_block_backward_bf16": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_cos_attn_block_bf16": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_cos_attn_block_backward_bf16": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_postnorm_mlp_bf16": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_postnorm_mlp_backward_bf16": "trainner_redux_tpu_torch/csrc/fused_block_v2.cu",
    "fused_window_mhsa_hd64": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_backward_hd64": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_bf16_hd64": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_backward_bf16_hd64": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_hd128": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_backward_hd128": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_bf16_hd128": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_window_mhsa_backward_bf16_hd128": "trainner_redux_tpu_torch/csrc/window_attention.cu",
    "fused_ln_mlp_backward_c320": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
    "fused_ln_mlp_backward_bf16_c320": "trainner_redux_tpu_torch/csrc/fused_block_train.cu",
}
# the kernel records of the JSON line; "fused_window_mhsa_ws16" is the
# window wrapper's 16x16 kernel, counted by that wrapper in HAT's runs, and
# the "_ws12" / "_c240" records are #1, #2 and #7 at SRFormerV2's Swin
# blocks, counted by their wrappers in SRFormerV2's runs; the
# "fused_attn_block_train*" records are #9 and #10 at SwinIR-M's block (8x8)
# and SRFormerV2's ("_ws12"), counted in phase 35's runs of each; the
# "_bf16" records are #4 and #5's bf16 forms, counted in the bf16 training
# run of swinir_m_fidelity.yml (phase 42), and those of #3/#8 and #2/#7,
# counted in the bf16 runs of hat_m_fidelity.yml (ws 16, the MLP halves),
# dat_fidelity.yml (rect) and swinir_l_fidelity.yml ("_ws8": 8x8 at C 240;
# phases 46-48); #1/#6's bf16 forms ("fused_attn_block_bf16" and its
# backward, 12x12) in the bf16 run of srformerv2_fidelity.yml (phase 51);
# #11-#14's bf16 forms in the bf16 run of swin2sr_m_fidelity.yml (phase 55);
# the "_hd64" records are #3/#8's 64-wide form (heads of 33 to 64 channels,
# atd's 35), counted by the window wrappers in atd's runs: fp32 #3 in its
# serving (phase 64), fp32 #8 in its fp32 train.run (phase 67), the bf16
# forms in atd_fidelity.yml's run (phase 65); the "_hd128" records are
# #3/#8's 128-wide form (heads of 65 to 128, drct's 122 and 77) and the
# "_c320" ones #7 on its split rows stage (rows of 257-320, drct's 276 and
# 308), counted by the wrappers' form counts (`read_form_counts`): fp32 #3 in
# drct's serving (phase 69), fp32 #8 and #7 in the one-group drct's fp32
# step on the card (phase 72), the bf16 forms in drct_fidelity.yml's run
# (phase 70)
KERNELS = tuple(SOURCES)
SERVING = ("fused_attn_block", "fused_ln_mlp", "fused_window_mhsa")
# operands of the training block, in fused_swin_block_train's order
TRAIN_OPS = ("x", "g", "be", "wq", "bq", "wp", "bp", "bias", "g2", "be2", "w1", "b1", "w2",
             "b2")


@contextmanager
def fused_env(env: dict):
    """TRAINNER_FUSED_BLOCK and TRAINNER_FUSED_ATTN as `env` sets them (unset
    otherwise) for the body, restored after."""
    saved = {k: os.environ.pop(k, None) for k in ("TRAINNER_FUSED_BLOCK", "TRAINNER_FUSED_ATTN")}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def say(msg: str) -> None:
    """Print a result line, and keep it in chip_smoke/summary.txt (the
    entry points' own logs fill the console around it)."""
    print(msg, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / "summary.txt", "a") as f:
        f.write(msg + "\n")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{info['kind']} x{info['count']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return info


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from trainner_redux_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    try:
        cuda_build.build_all()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"kernel build: {e}")
    rep = cuda_build.build_report
    say(f"[build] {time.perf_counter() - t0:.1f} s, built {rep['built']} in {rep['dir']}")
    OUT.mkdir(parents=True, exist_ok=True)
    spills, reports = [], 0
    with open(OUT / "ptxas.txt", "w") as f:
        for name, log in rep["logs"].items():
            f.write(f"== {name}\n{log}\n")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"[build] {name}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    reports += 1
                    if int(m.group(1)) or int(m.group(2)):
                        spills.append(f"{name}: {line.strip()}")
    say(f"[build] {reports} ptxas reports, {len(spills)} with spills")
    if not reports:
        fail("no ptxas report: the build kept no register counts")
    if spills:
        fail("a kernel spills registers: " + "; ".join(spills))


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Device time of one `fn` call: `iters` calls captured in a CUDA graph,
    replayed `replays` times between CUDA events. For a call too short for
    `time_ms`, which then measures how fast the host launches it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def serving_ms(fn, groups: int = 7, calls: int = 2, warmup: int = 3) -> tuple[float, float, float]:
    """Time a call of `fn` (one whole forward) by CUDA events: `warmup`
    calls, then `groups` timed groups of `calls` calls each. Returns the
    median group's time a call and the least and largest group's: one
    timed loop varied 10-40% between runs."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), min(times), max(times)


def spread(t: tuple[float, float, float]) -> str:
    """`serving_ms`'s result as a line prints it."""
    return f"{t[0]:.3f} ms (median of 7 groups of 2 calls; {t[1]:.3f}-{t[2]:.3f})"


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """The least time (ms) of `flops` operations at `peak` (fp32 outside the
    tensor cores unless said) and `nbytes` at 3.35 TB/s, and which bounds."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def stage_of(kernel: str) -> str:
    """The stage of a staged kernel that a kernel (by its profiler name)
    runs: the training backwards #5 and #7 (csrc/fused_block_train.cu), #6
    and #10 (csrc/attn_block_staged.cu), #8 (csrc/window_attention.cu), #12
    and #14 (csrc/fused_block_v2.cu), the pre-LN block forwards #1 and #9
    at 8x8 and 12x12, #2 and #4 (csrc/block_fwd.cuh), and #3; their
    per-token kernels are csrc/tc_rows.cuh's, the window attention of #3,
    #6, #8 and the forwards csrc/tc_attn.cuh's; #11 and #13 (csrc/fused_block_v2.cu) run
    the same kernels. rows_kernel's epilogue mode is its second template
    argument: 0 stores A W^T (datt), 1 adds a residual (#12's and #14's dx),
    2 takes the LayerNorm backward. linear_kernel's is its third: 0 and 1
    are x W + b and its gelu, 2 the forwards' proj and fc2 with the
    residual, x + s (A W + b). ln_rows_kernel's second is true in the
    post-norm forwards' row pass, x + s LN(rows). The bf16 forms of #4 and
    #5 (csrc/tc_rows_bf16.cuh, csrc/tc_attn.cuh, csrc/fused_block_train.cu)
    run the same stages under `_bf16_` names, their epilogue mode the second
    template argument of linear_bf16_kernel and rows_bf16_kernel (1 in #12's
    and #14's bf16 dx); #11's and #13's bf16 post-norm row pass is
    postnorm_rows_bf16_kernel. #3/#8's 128-wide form (heads of 65-128) is
    attn_wide_fwd_kernel, and #8's attn_wide_bwd_rows_kernel (the row
    pass) and attn_wide_bwd_keys_kernel (the key pass), in both types;
    #7's split rows stage (rows of 257-320) stores dy on rows_kernel's (or
    rows_bf16_kernel's) mode 0, then ln_bwd_rows_kernel takes the LN
    backward. The bf16 forms of #5, #6, #7, #12 and #14 take their weight
    gradients on csrc/wgrad_bf16.cuh's stage: wg_bf16_kernel (the products;
    B's column sums where B is the bias sums' source), wg_colsum_kernel
    (every other source's bias sums: "bias sums"), wg_sum_kernel (the
    partial sums in order); #6's bf16 window attention is
    attn_group_bwd_bf16_kernel (csrc/attn_group_bf16.cuh), its dbias the
    groups' sums added by dbias_group_sum_kernel; #8's bf16 form at heads of
    up to 32 (csrc/attn_group_bf16.cuh) attn_window_bwd_bf16_kernel at n 64
    and 128 and, at n 256, attn_group_rows_bf16_kernel (its row pass) and
    attn_group_keys_bf16_kernel (its key pass), with the same group sums;
    #1's bf16 window attention attn_group_fwd_bf16_kernel and its qkv and
    proj linear_tma_bf16_kernel (csrc/linear_tma_bf16.cuh, its epilogue
    mode the template argument)."""
    for part, stage in (("postnorm_rows_bf16_kernel", "post-norm rows"),
                        ("attn_wide_fwd_kernel", "window attention forward"),
                        ("attn_wide_bwd_rows_kernel", "row pass"),
                        ("attn_wide_bwd_keys_kernel", "key pass"),
                        ("ln_bwd_rows_kernel", "dy and the LN backward"),
                        ("ln_rows_bf16_kernel", "LN rows"),
                        ("mlp_hidden_bf16_kernel", "fc1 and dh"),
                        ("attn_rows_fwd_bf16_kernel", "window attention forward"),
                        ("attn_rows_bwd_bf16_kernel", "window attention"),
                        ("attn_rows_bwd_recompute_bf16_kernel", "window attention"),
                        ("attn_group_bwd_bf16_kernel", "window attention"),
                        ("attn_window_bwd_bf16_kernel", "window attention"),
                        ("attn_group_rows_bf16_kernel", "row pass"),
                        ("attn_group_keys_bf16_kernel", "key pass"),
                        ("attn_group_fwd_bf16_kernel", "window attention forward"),
                        ("dbias_group_sum_kernel", "bias table"),
                        ("wg_bf16_kernel", "weight gradients"),
                        ("wg_colsum_kernel", "bias sums"), ("wg_sum_kernel", "partial sums")):
        if part in kernel:
            return stage
    if "linear_tma_bf16_kernel<" in kernel:  # #1 bf16's products: its epilogue mode
        mode = kernel.split("linear_tma_bf16_kernel<", 1)[1].split(">", 1)[0].strip()
        return "x + s (A W + b)" if mode == "2" else "x W + b"
    for part, modes in (("linear_bf16_kernel<", {"2": "x + s (A W + b)"}),
                        ("rows_bf16_kernel<", {"0": "datt", "1": "dx = dout + A W^T",
                                               "2": "dy and the LN backward"})):
        if part in kernel:
            mode = kernel.split(part, 1)[1].split(">", 1)[0].split(",")[1].strip()
            return modes.get(mode, "x W + b")
    if "ln_rows_kernel<" in kernel and "postnorm_ln_rows_kernel" not in kernel:
        args = kernel.split("ln_rows_kernel<", 1)[1].split(">", 1)[0].split(",")
        if args[-1].strip() == "true":
            return "post-norm rows"
    for part, stage in (("postnorm_ln_rows_kernel", "post-norm LN backward"),
                        ("ln_rows_kernel", "LN rows"), ("mlp_hidden_kernel", "fc1 and dh"),
                        ("attn_rows_fwd_tc_kernel", "window attention forward"),
                        ("attn_rows_bwd_tc_kernel", "window attention"),
                        ("cos_attn_bwd_tc_kernel", "window attention"),
                        ("atb_kernel", "weight gradients"), ("sum_rows_kernel", "partial sums"),
                        ("dbias", "bias table")):
        if part in kernel:
            return stage
    if "linear_kernel<" in kernel:
        mode = kernel.split("linear_kernel<", 1)[1].split(">", 1)[0].split(",")[2].strip()
        return "x + s (A W + b)" if mode == "2" else "x W + b"
    if "rows_kernel<" in kernel:
        mode = kernel.split("rows_kernel<", 1)[1].split(">", 1)[0].split(",")[-1].strip()
        return {"0": "datt", "1": "dx = dout + A W^T"}.get(mode, "dy and the LN backward")
    return kernel[:60]


# launches a call of each stage (the entry points of csrc/fused_block_train.cu,
# csrc/attn_block_staged.cu, csrc/window_attention.cu and
# csrc/fused_block_v2.cu); "x W + b" is qkv (and #12's proj; #14's hg and
# m), the partial sums those of the weight gradients and the LayerNorm (and
# #12's dscale), the bias table two passes (one where a window kind's table
# alone fills the card: HAT-M's ws 16)
STAGES_5 = {"LN rows": 2, "fc1 and dh": 1, "dy and the LN backward": 2, "datt": 1,
            "x W + b": 1, "window attention": 1, "weight gradients": 4, "partial sums": 6,
            "bias table": 2}
STAGES_7 = {"LN rows": 1, "fc1 and dh": 1, "dy and the LN backward": 1, "weight gradients": 2,
            "partial sums": 3}
# #7 at rows of 257-320 channels: its split rows stage's two dy products
# (rows_kernel's store mode, which `stage_of` calls "datt") and the LN rows
STAGES_7_SPLIT = {"LN rows": 1, "fc1 and dh": 1, "datt": 2, "dy and the LN backward": 1,
                  "weight gradients": 2, "partial sums": 3}
STAGES_6 = {"LN rows": 1, "x W + b": 1, "datt": 1, "window attention": 1,
            "dy and the LN backward": 1, "weight gradients": 2, "partial sums": 3,
            "bias table": 2}
STAGES_12 = {"x W + b": 2, "window attention forward": 1, "post-norm LN backward": 1, "datt": 1,
             "window attention": 1, "dx = dout + A W^T": 1, "weight gradients": 2,
             "partial sums": 4, "bias table": 2}
STAGES_8 = {"window attention": 1, "bias table": 1}  # HAT-M's ws 16


def stages_8_wide(b: int, nwin: int, nh: int, n: int = 256) -> dict[str, int]:
    """The 128-wide #8's stages a call: its row pass, its key pass and the
    bias table, which takes one pass where fewer than two groups of 16
    windows are there or a window kind's table alone fills the card
    (common.cuh's launch_dbias), else two."""
    one = b * nwin // 16 < 2 or nh * n * n >= 1 << 18
    return {"row pass": 1, "key pass": 1, "bias table": 1 if one else 2}
STAGES_8_RECT = {"window attention": 1, "bias table": 2}  # DAT's 8x32, 3 heads
# #8's bf16 form at heads of up to 32 (csrc/attn_group_bf16.cuh): its row
# pass, key pass and group sums at n 256, its whole-window kernel and group
# sums at n 64 and 128, and those kernels by name
STAGES_8_PASSES = {"row pass": 1, "key pass": 1, "bias table": 1}
STAGES_8_WHOLE = {"window attention": 1, "bias table": 1}
GROUP_BWD_256 = ("attn_group_rows_bf16_kernel", "attn_group_keys_bf16_kernel",
                 "dbias_group_sum_kernel")
GROUP_BWD_WHOLE = ("attn_window_bwd_bf16_kernel", "dbias_group_sum_kernel")
STAGES_14 = {"x W + b": 2, "post-norm LN backward": 1, "fc1 and dh": 1, "dx = dout + A W^T": 1,
             "weight gradients": 2, "partial sums": 3}
# the bf16 forms: their weight gradients' bias sums of a source other than
# B (s2 dout, dh, s1 dz; s dout; dproj; dm, dh) on wg_colsum_kernel, and
# #6's dbias one sum over the window attention's groups
STAGES_5_BF16 = {**STAGES_5, "bias sums": 3}
STAGES_6_BF16 = {**STAGES_6, "bias sums": 1, "bias table": 1}
STAGES_7_BF16 = {**STAGES_7, "bias sums": 2}
STAGES_7_SPLIT_BF16 = {**STAGES_7_SPLIT, "bias sums": 2}
STAGES_12_BF16 = {**STAGES_12, "bias sums": 1}
STAGES_14_BF16 = {**STAGES_14, "bias sums": 2}
# the kernels of the bf16 weight gradients (csrc/wgrad_bf16.cuh)
WG_BF16 = ("wg_bf16_kernel", "wg_colsum_kernel", "wg_sum_kernel")
# the pre-LN forwards (csrc/block_fwd.cuh): #1 and #9 at 8x8 and 12x12 (LN1,
# qkv, the window attention, proj + residual), #2 (LN2, fc1 + gelu, fc2 +
# residual) and #4 (both halves); #3, the window attention alone
STAGES_1 = {"LN rows": 1, "x W + b": 1, "window attention forward": 1, "x + s (A W + b)": 1}
STAGES_2 = {"LN rows": 1, "x W + b": 1, "x + s (A W + b)": 1}
STAGES_4 = {"LN rows": 2, "x W + b": 2, "window attention forward": 1, "x + s (A W + b)": 2}
STAGES_3 = {"window attention forward": 1}
# the post-norm forwards (csrc/fused_block_v2.cu): #11 (qkv, the cosine
# window attention, proj, the post-norm rows) and #13 (fc1 + gelu, fc2, the
# post-norm rows)
STAGES_11 = {"x W + b": 2, "window attention forward": 1, "post-norm rows": 1}
STAGES_13 = {"x W + b": 2, "post-norm rows": 1}
# the FMA kernels that the tensor-core stages replaced (the forwards, #10's
# saved-P window attention, #15's block transform, #5's window attention):
# a profile or stage split that launches one fails
RETIRED = ("trr::attn_block_fwd_kernel", "trr::ln_mlp_fwd_kernel", "trr::ln_qkv_kernel",
           "trr::attn_rows_fwd_kernel", "trr::proj_residual_kernel",
           "trr::window_mhsa_fwd_kernel", "trr::window_mhsa_rows_fwd_kernel",
           "trr::cos_attn_fwd_kernel", "trr::cos_attn_rows_kernel", "trr::pn_mlp_fwd_kernel",
           "trr::attn_rows_bwd_saved_kernel", "trr::jpeg_block_kernel",
           "trr::block_bwd_attn_kernel")
SERVING_STAGES = {"fused_attn_block": STAGES_1, "fused_ln_mlp": STAGES_2,
                  "fused_window_mhsa": STAGES_3}
# the window attention forward's kernel at each window of n tokens (its plan
# <n, rows, key parts, cosine, row width>), which #3 and the forwards' stage
# splits must show; the cosine form (#11, #12) at 8x8 windows; the 64-wide
# rows of #3 at n 256 (heads of 33 to 64 channels); the post-norm row pass
ATTN_FWD = {n: f"attn_rows_fwd_tc_kernel<{n}, {rb}, {ks}, false, 32>"
            for n, rb, ks in ((64, 64, 2), (128, 32, 4), (144, 48, 2), (256, 64, 4))}
COS_ATTN_FWD = "attn_rows_fwd_tc_kernel<64, 64, 2, true, 32>"
ATTN_FWD_64 = "attn_rows_fwd_tc_kernel<256, 32, 4, false, 64>"
ATTN_BWD_64 = "attn_rows_bwd_tc_kernel<256, 32, 4, false, false, 64>"
# #3/#8's 128-wide form at n 256 (heads of 65-128), fp32 and bf16: #3's
# kernel (<n, rows, keys a tile, type>), #8's row pass (<n, rows, key parts,
# type>) and key pass (<n, keys, rows, key parts, type>); and #7's split
# rows stage's LN rows
ATTN_FWD_128 = "attn_wide_fwd_kernel<256, 64, 64, float>"
ATTN_BWD_128 = ("attn_wide_bwd_rows_kernel<256, 64, 2, float>",
                "attn_wide_bwd_keys_kernel<256, 64, 32, 4, float>")
ATTN_FWD_128_BF = "attn_wide_fwd_kernel<256, 64, 64, __nv_bfloat16>"
ATTN_BWD_128_BF = ("attn_wide_bwd_rows_kernel<256, 64, 2, __nv_bfloat16>",
                   "attn_wide_bwd_keys_kernel<256, 64, 32, 4, __nv_bfloat16>")
LN_BWD_ROWS = "ln_bwd_rows_kernel<float"
LN_BWD_ROWS_BF = "ln_bwd_rows_kernel<__nv_bfloat16"
# #10's window attention: the saved-P form of the tensor-core backward
# (<n, rows, key parts, att, saved, row width>) at 8x8 and 12x12 windows
SAVED_BWD = {n: f"attn_rows_bwd_tc_kernel<{n}, {rb}, {ks}, false, true, 32>"
             for n, rb, ks in ((64, 64, 2), (144, 48, 2))}
POSTNORM_ROWS = "ln_rows_kernel<true, true>"
LN_LINEAR = ("ln_rows_kernel", "linear_kernel")
SERVING_KERNELS = {"fused_attn_block": (*LN_LINEAR, ATTN_FWD[N]), "fused_ln_mlp": LN_LINEAR,
                   "fused_window_mhsa": (ATTN_FWD[N],)}


def stage_split(tag: str, name: str, fn, flops: float, nb: float, ms: float,
                per_call: dict[str, int], calls: int = 3, kernels: tuple[str, ...] = (),
                bf16: bool = False) -> None:
    """Device time by stage of one call of a staged kernel (the training
    backwards #5, #6, #7, #8, #10, #12 and #14; the forwards #1 and #9 at
    8x8 and 12x12, #2, #3 and #4), and the call's time `ms` against both
    bounds: fp32 on the FMA units (67 TFLOP/s) and 3xTF32 on the tensor
    cores (3 x operations at 495 TFLOP/s). A stage's time is its launches'
    mean device time (torch.profiler over `calls` calls; the table goes to
    chip_smoke/stages.txt) times its `per_call` launches: the profiler may
    keep only some of a session's launches, and of a short session none of
    a stage (then, while a stage has fewer profiled launches than the
    session's calls, it profiles again, four times the calls up to 48,
    four times at most, and adds the sessions' launches up). Fails unless a profiled
    kernel's name holds each of `kernels`, and if a RETIRED kernel
    launched. `bf16`, a bf16 form: its time against the bf16 bound (989
    TFLOP/s on the tensor cores, 3.35 TB/s) instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen: dict[str, list] = {}
    names: set[str] = set()
    profiled = 0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        profiled += calls
        events = device_events(prof)
        check_retired(tag, events)
        for e in events:
            names.add(e.key)
            rec = seen.setdefault(stage_of(e.key), [0.0, 0])
            rec[0] += e.self_device_time_total / 1e3
            rec[1] += e.count
        if all(seen.get(st, (0, 0))[1] >= calls for st in per_call):
            break
        calls = min(4 * calls, 48)
    stages = {st: (t / n * per_call.get(st, 0), n) for st, (t, n) in seen.items() if n}
    total = sum(t for t, _ in stages.values())
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / "stages.txt", "a") as f:
        f.write(f"== [{tag}] {name}\n"
                + prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=20))
    for stage, (t, n) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        say(f"[{tag}] {name} stage {stage}: {t:.4f} ms a call ({per_call.get(stage, 0)} "
            f"launches; {n} profiled over {profiled} calls), {100 * t / max(total, 1e-9):.1f}% "
            f"of the stages' {total:.4f} ms")
    for k in kernels:
        if not any(k in key for key in names):
            fail(f"[{tag}] {name}: no profiled kernel is {k}")
    if kernels:
        say(f"[{tag}] {name} launched " + ", ".join(kernels))
    if bf16:
        bms, by = bound(flops, nb, PEAK_BF16)
        say(f"[{tag}] {name}: kernel {ms:.4f} ms; bf16 bound {bms:.4f} ms ({by}; "
            f"{100 * bms / ms:.1f}% of the kernel's time)")
        return
    fp32 = max(flops / PEAK_FP32, nb / PEAK_BYTES) * 1e3
    tc = max(3 * flops / PEAK_TF32, nb / PEAK_BYTES) * 1e3
    say(f"[{tag}] {name}: kernel {ms:.4f} ms; fp32 bound {fp32:.4f} ms ({100 * fp32 / ms:.1f}% "
        f"of the kernel's time), 3xTF32 bound {tc:.4f} ms ({100 * tc / ms:.1f}%)")


def block_inputs(gen, kinds: int, device, shape=(B, H, W), widths=(C, NH, WS, HIDDEN)):
    """Seeded unit-scale inputs of one pre-LN Swin block: SwinIR-M's
    (C, heads, window, hidden) unless `widths` gives others, at B=1,
    128x128 unless `shape` gives (B, H, W); a shifted block's (K=4) masks
    at a shift of half the window."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    c, nh, ws, hidden = widths

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    b, h, w = shape
    x = randn(b, h, w, c)
    p = {
        "g": 1.0 + randn(c, scale=0.1), "be": randn(c, scale=0.1),
        "wq": randn(c, 3 * c, scale=c**-0.5), "bq": randn(3 * c, scale=0.1),
        "wp": randn(c, c, scale=c**-0.5), "bp": randn(c, scale=0.1),
        "w1": randn(c, hidden, scale=c**-0.5), "b1": randn(hidden, scale=0.1),
        "w2": randn(hidden, c, scale=hidden**-0.5), "b2": randn(c, scale=0.1),
        "s": torch.ones(b, device=device),
    }
    rel = randn(nh, ws * ws, ws * ws, scale=0.5)
    if kinds == 4:
        masks = torch.from_numpy(shift_mask_kinds(ws, ws // 2)).to(device)
        bias = (rel[None] + masks[:, None]).contiguous()
    else:
        bias = rel[None].contiguous()
    qkv = randn(b, h, w, 3 * c)
    p["g2"], p["be2"] = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
    return x, p, bias, qkv


def window_mhsa_f64(qkv, bias, nh: int, hd: int, wr: int, wc: int):
    """#3's function (window MHSA with the kind table, wr x wc windows) in
    float64: the yardstick of the kernels' and the plain versions'
    accuracy."""
    import torch

    b, h, w, _ = qkv.shape
    q, k, v, mask = sdpa_windows(qkv.double(), bias.double(), wr, wc, bias.shape[0], nh, hd)
    p = torch.softmax(q @ k.transpose(-1, -2) * hd**-0.5 + mask, dim=-1)
    return from_windows(p @ v, b, h, w, wr, wc, nh, hd)


def f64_line(tag: str, what: str, got, want, exact) -> None:
    """Print the kernel's and the plain version's largest errors against
    the float64 result `exact`."""
    say(f"[{tag}] {what} against float64: kernel "
        f"{(got.double() - exact).abs().max().item():.3g}, plain "
        f"{(want.double() - exact).abs().max().item():.3g} of {exact.abs().max().item():.3g}")


def block_half_f64(name: str, x, p: dict, bias, shift: int, nh: int = NH, ws: int = WS):
    """#1's (fused_attn_block, nh heads, ws x ws windows) or #2's
    (fused_ln_mlp) function in float64, the window attention's included,
    on the inputs of `block_inputs`: the yardstick of the kernel's and of
    the plain version's accuracy."""
    import torch
    import torch.nn.functional as F

    d = {k: v.double() for k, v in p.items()}
    b, h, w, c = x.shape
    s = d["s"].repeat_interleave(h * w)[:, None]
    xr = torch.roll(x.double(), (-shift, -shift), (1, 2))
    t = xr.reshape(-1, c)
    y = F.layer_norm(t, (c,), d["g"], d["be"], 1e-5)
    if name == "fused_ln_mlp":
        out = t + s * (F.gelu(y @ d["w1"] + d["b1"]) @ d["w2"] + d["b2"])
    else:
        qkv = (y @ d["wq"] + d["bq"]).reshape(b, h, w, 3 * c)
        att = window_mhsa_f64(qkv, bias, nh, c // nh, ws, ws)
        out = t + s * (att.reshape(-1, c) @ d["wp"] + d["bp"])
    return torch.roll(out.reshape(x.shape), (shift, shift), (1, 2))


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    T = B * H * W
    res: dict[str, dict] = {}
    for kinds in (1, 4):
        x, p, bias, qkv = block_inputs(gen, kinds, dev)
        # SwinBlock passes the K=4 table together with the shift of ws/2
        shift = WS // 2 if kinds == 4 else 0
        cases = {
            "fused_attn_block": (
                lambda: fb.fused_attn_block(x, p["g"], p["be"], p["wq"], p["bq"], p["wp"],
                                            p["bp"], bias, p["s"], NH, HD, WS, shift=shift),
                lambda: fb.fused_attn_block_reference(x, p["g"], p["be"], p["wq"], p["bq"],
                                                      p["wp"], p["bp"], bias, p["s"], NH, HD,
                                                      WS, shift=shift),
                None,
                2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C,
                nbytes(x, x, p["g"], p["be"], p["wq"], p["bq"], p["wp"], p["bp"], bias, p["s"]),
            ),
            "fused_ln_mlp": (
                lambda: fb.fused_ln_mlp(x, p["g"], p["be"], p["w1"], p["b1"], p["w2"], p["b2"],
                                        p["s"], WS),
                lambda: fb.fused_ln_mlp_reference(x, p["g"], p["be"], p["w1"], p["b1"],
                                                  p["w2"], p["b2"], p["s"], WS),
                None,
                4 * T * C * HIDDEN,
                nbytes(x, x, p["g"], p["be"], p["w1"], p["b1"], p["w2"], p["b2"], p["s"]),
            ),
        }
        # the library yardstick: one SDPA call on windows already partitioned
        # into (B*nW, nh, n, hd), with the per-window bias as a float mask
        nw = (H // WS) * (W // WS)
        win = qkv.reshape(B, H // WS, WS, W // WS, WS, 3, NH, HD)
        win = win.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B * nw, NH, N, HD).contiguous()
        mask = bias[wa.window_kinds(H // WS, W // WS, kinds, dev)].repeat(B, 1, 1, 1)
        cases["fused_window_mhsa"] = (
            lambda: wa.fused_window_mhsa(qkv, bias, NH, HD, WS),
            lambda: wa.fused_window_mhsa_reference(qkv, bias, NH, HD, WS),
            lambda: F.scaled_dot_product_attention(win[0], win[1], win[2], attn_mask=mask),
            4 * T * N * C,
            nbytes(qkv, bias) + T * C * 4,
        )
        for name, (kern, plain, lib, flops, nb) in cases.items():
            try:
                got = kern()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - report and fail the phase
                fail(f"{name} K={kinds}: {e}")
            want = plain()
            err = (got - want).abs().max().item()
            if lib is not None:
                lib_out = lib()  # (B*nW, nh, n, hd) -> NHWC, to check the yardstick
                lib_out = lib_out.reshape(B, H // WS, W // WS, NH, WS, WS, HD)
                lib_out = lib_out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, H, W, C)
                lib_err = (lib_out - want).abs().max().item()
                if lib_err > KERNEL_TOL:
                    fail(f"{name} K={kinds}: the SDPA yardstick differs by {lib_err:.3g}")
            ok = bool(err <= KERNEL_TOL) and bool(torch.isfinite(got).all())
            ms, plain_ms = time_ms(kern), time_ms(plain)
            note = ""
            if name == "fused_window_mhsa":  # a call shorter than its host time: CUDA graphs
                note = f" (back-to-back calls {ms:.4f} ms)"
                ms = graph_ms(kern)
            lib_ms = time_ms(lib) if lib is not None else None
            bms, by = bound(flops, nb)
            say(f"[kernels] {name} K={kinds}: max_abs_err {err:.3g} (tol {KERNEL_TOL}) "
                f"kernel {ms:.4f} ms{note} plain {plain_ms:.4f} ms "
                f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
                f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB)")
            if not ok:
                fail(f"{name} K={kinds} disagrees with its plain version: {err:.3g}")
            # each against float64, on the tensor-core stages
            exact = (window_mhsa_f64(qkv, bias, NH, HD, WS, WS) if name == "fused_window_mhsa"
                     else block_half_f64(name, x, p, bias,
                                         shift if name == "fused_attn_block" else 0))
            f64_line("kernels", f"{name} K={kinds}", got, want, exact)
            rec = res.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # the times reported in the JSON line are the shifted (K=4) calls'
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)
            if kinds == 4 and name in SERVING_STAGES:
                stage_split("kernels", f"{name} K=4", kern, flops, nb, ms, SERVING_STAGES[name],
                            kernels=SERVING_KERNELS[name])
    return res


# ---------------------------------------------------------------------------
# 4. path
# ---------------------------------------------------------------------------


def _wrappers() -> dict:
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2
    from trainner_redux_tpu_torch.ops import jpeg_kernel as jk
    from trainner_redux_tpu_torch.ops import window_attention as wa

    return {
        "fused_attn_block": fb.fused_attn_block,
        "fused_attn_block_backward": fb.fused_attn_block_backward,
        "fused_attn_block_train": fb.fused_attn_block_train,
        "fused_attn_block_train_backward": fb.fused_attn_block_train_backward,
        "fused_ln_mlp": fb.fused_ln_mlp,
        "fused_window_mhsa": wa.fused_window_mhsa,
        "fused_swin_block_train": fb.fused_swin_block_train,
        "fused_swin_block_train_backward": fb.fused_swin_block_train_backward,
        "fused_swin_block_train_bf16": fb.fused_swin_block_train_bf16,
        "fused_swin_block_train_backward_bf16": fb.fused_swin_block_train_backward_bf16,
        "fused_window_mhsa_bf16": wa.fused_window_mhsa_bf16,
        "fused_window_mhsa_backward_bf16": wa.fused_window_mhsa_backward_bf16,
        "fused_rect_mhsa_bf16": wa.fused_rect_mhsa_bf16,
        "fused_rect_mhsa_backward_bf16": wa.fused_rect_mhsa_backward_bf16,
        "fused_ln_mlp_bf16": fb.fused_ln_mlp_bf16,
        "fused_ln_mlp_backward_bf16": fb.fused_ln_mlp_backward_bf16,
        "fused_attn_block_bf16": fb.fused_attn_block_bf16,
        "fused_attn_block_backward_bf16": fb.fused_attn_block_backward_bf16,
        "fused_window_mhsa_backward": wa.fused_window_mhsa_backward,
        "fused_ln_mlp_backward": fb.fused_ln_mlp_backward,
        "fused_rect_mhsa": wa.fused_rect_mhsa,
        "fused_rect_mhsa_backward": wa.fused_rect_mhsa_backward,
        "fused_cos_attn_block": v2.fused_cos_attn_block,
        "fused_cos_attn_block_backward": v2.fused_cos_attn_block_backward,
        "fused_postnorm_mlp": v2.fused_postnorm_mlp,
        "fused_postnorm_mlp_backward": v2.fused_postnorm_mlp_backward,
        "fused_cos_attn_block_bf16": v2.fused_cos_attn_block_bf16,
        "fused_cos_attn_block_backward_bf16": v2.fused_cos_attn_block_backward_bf16,
        "fused_postnorm_mlp_bf16": v2.fused_postnorm_mlp_bf16,
        "fused_postnorm_mlp_backward_bf16": v2.fused_postnorm_mlp_backward_bf16,
        "jpeg_block_transform": jk.jpeg_block_transform,
    }


def check_counts(what: str, counts: dict[str, int], want: dict[str, int]) -> None:
    """The wrappers in `want` launched that many times, every other none."""
    if {k: v for k, v in counts.items() if v or k in want} != want:
        fail(f"{what} launches {counts}, expected {want} and no others")


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        for form in FORM_COUNTERS:
            if hasattr(fn, form):
                setattr(fn, form, 0)


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


# the wrappers' counts of one form apart (each added to where the wrapper
# counts that form's launch): #3/#8's 128-wide form, #7 on rows of 257-320
FORM_COUNTERS = {"launches_hd128": "_hd128", "launches_c320": "_c320"}


def read_form_counts() -> dict[str, int]:
    """`name` + suffix -> that form's launches, for the wrappers that count
    one (fused_window_mhsa_hd128, fused_ln_mlp_backward_bf16_c320, ...)."""
    return {name + suffix: getattr(fn, form) for name, fn in _wrappers().items()
            for form, suffix in FORM_COUNTERS.items() if hasattr(fn, form)}


def make_dataset(root: Path, seed: int,
                 sizes=((128, 128),) * 3 + ((100, 120),), scale: int = 4) -> tuple[Path, Path]:
    """Seeded smooth HR images and their `scale` x `scale` box-average LR,
    as PNGs; one image for each LR (height, width) of `sizes`."""
    import numpy as np

    from trainner_redux_tpu_torch.utils.img_util import imwrite

    rng = np.random.default_rng(seed)
    hr_dir, lr_dir = root / "hr", root / "lr"
    hr_dir.mkdir(parents=True, exist_ok=True)
    lr_dir.mkdir(parents=True, exist_ok=True)
    for i, (lh, lw) in enumerate(sizes):
        hh, hw = scale * lh, scale * lw
        yy, xx = np.mgrid[0:hh, 0:hw] / 64.0
        img = np.zeros((hh, hw, 3))
        for _ in range(6):
            fy, fx, ph = rng.uniform(0.2, 2.0), rng.uniform(0.2, 2.0), rng.uniform(0, 6.3)
            img += rng.uniform(0.05, 0.2, 3) * np.sin(fy * yy + fx * xx + ph)[..., None]
        img += 0.02 * rng.standard_normal(img.shape)
        hr = np.clip(img + 0.5, 0, 1)
        hr8 = (hr * 255).round().astype(np.uint8)
        lr = hr8.astype(np.float64).reshape(lh, scale, lw, scale, 3).mean(axis=(1, 3))
        imwrite(hr8, str(hr_dir / f"img{i}.png"))
        imwrite((lr / 255.0).astype(np.float32), str(lr_dir / f"img{i}.png"))
    return hr_dir, lr_dir


def smoke_options(name: str, weights: Path, hr_dir: Path, lr_dir: Path, seed: int,
                  network: str = "swinir_m", scale: int = 4):
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    metric = {"crop_border": 4, "test_y_channel": True}
    raw = {
        "name": name,
        "scale": scale,
        "num_gpu": 1,
        "manual_seed": seed,
        "network_g": {"type": network},
        "path": {"pretrain_network_g": str(weights), "strict_load_g": True},
        "datasets": {
            "test_1": {
                "name": "smoke", "type": "PairedImageDataset",
                "dataroot_gt": str(hr_dir), "dataroot_lq": str(lr_dir),
                "io_backend": {"type": "disk"},
            }
        },
        "val": {
            "val_enabled": True, "save_img": True, "pbar": False, "metrics_enabled": True,
            "metrics": {
                "psnr": {"type": "calculate_psnr", **metric},
                "ssim": {"type": "calculate_ssim", **metric},
            },
        },
    }
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=False)


def serve(name: str, weights: Path, hr_dir: Path, lr_dir: Path, seed: int, env: dict,
          network: str = "swinir_m", scale: int = 4, images: int = N_IMAGES) -> dict:
    """One run of the serving entry point with kernel counts read around it
    (`images` LR images in `lr_dir`; the new forms' counts under "forms")."""
    import math

    import torch

    from trainner_redux_tpu_torch import test as port_test

    opt = smoke_options(name, weights, hr_dir, lr_dir, seed, network, scale)
    with fused_env(env):
        t0 = time.perf_counter()
        reset_counts()
        model = port_test.run(opt)
        torch.cuda.synchronize()
        counts = read_counts()
        forms = read_form_counts()
        secs = time.perf_counter() - t0
    pngs = sorted((Path(opt.path.visualization) / "smoke").glob("*.png"))
    metrics = getattr(model, "metric_results", {})
    say(f"[path] {name} {env or ''}: {secs:.2f} s, {len(pngs)} PNGs, "
        f"psnr {metrics.get('psnr', float('nan')):.4f} "
        f"ssim {metrics.get('ssim', float('nan')):.4f}, "
        f"launches {counts}")
    if len(pngs) != images:
        fail(f"{name}: {len(pngs)} PNGs written, expected {images}")
    if not all(math.isfinite(metrics.get(k, float("nan"))) for k in ("psnr", "ssim")):
        fail(f"{name}: PSNR/SSIM not logged or not finite: {metrics}")
    return {"counts": counts, "metrics": metrics, "forms": forms}


def check_serving_counts(what: str, c: dict[str, int]) -> None:
    want = BLOCKS * N_IMAGES
    check_counts(what, c, {"fused_attn_block": want, "fused_ln_mlp": want})


def phase_path(seed: int) -> dict[str, int]:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    OUT.mkdir(parents=True, exist_ok=True)
    net = build_network({"type": "swinir_m", "scale": 4})
    net.init_weights(torch.Generator().manual_seed(seed))
    weights = OUT / "swinir_m_x4_seeded.pth"
    torch.save(net.state_dict(), weights)
    hr_dir, lr_dir = make_dataset(OUT / "data", seed)

    fused = serve("swinir_m_x4_fused", weights, hr_dir, lr_dir, seed, {})
    c = fused["counts"]
    check_serving_counts("fused path", c)
    want = BLOCKS * N_IMAGES
    unfused = serve("swinir_m_x4_unfused", weights, hr_dir, lr_dir, seed,
                    {"TRAINNER_FUSED_BLOCK": "0"})
    u = unfused["counts"]
    check_counts("unfused path", u, {"fused_window_mhsa": want})
    for k in ("psnr", "ssim"):
        d = abs(fused["metrics"][k] - unfused["metrics"][k])
        if d > 1e-3:
            fail(f"{k} differs by {d:.3g} between the fused and unfused paths")
    weights.unlink()  # 48 MB: chiprun_out/ comes back only under 64 MiB
    return {**c, "fused_window_mhsa": u["fused_window_mhsa"]}


# ---------------------------------------------------------------------------
# 5. branches
# ---------------------------------------------------------------------------


def phase_branches(seed: int) -> None:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "swinir_m", "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().eval()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    outs = {}
    for branch, env in (
        ("fused", {}), ("unfused", {"TRAINNER_FUSED_BLOCK": "0"}),
        ("plain", {"TRAINNER_FUSED_ATTN": "0"}),
    ):
        with fused_env(env), torch.inference_mode():
            outs[branch] = net(x)
            fwd_ms = serving_ms(lambda: net(x))
        if outs[branch].shape != (1, 3, 512, 512) or not torch.isfinite(outs[branch]).all():
            fail(f"branch {branch}: bad output {tuple(outs[branch].shape)}")
        say(f"[branches] {branch}: SwinIR-M 4x forward of one 128x128 image {spread(fwd_ms)}")
    for branch in ("fused", "unfused"):
        d = (outs[branch] - outs["plain"]).abs().max().item()
        say(f"[branches] {branch} vs plain: max_abs_diff {d:.3g} (tol {PATH_TOL})")
        if d > PATH_TOL:
            fail(f"branch {branch} differs from the plain branch by {d:.3g}")


# ---------------------------------------------------------------------------
# 6. profile
# ---------------------------------------------------------------------------


def device_events(prof) -> list:
    """The profile's device kernels and copies by name. The device-side
    spans of `record_function` ranges (`Optimizer.step#AdamW.step`) are left
    out: they lie over the kernels they enclose, and would count them twice."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def check_retired(tag: str, events) -> None:
    """Fail if a profile launched one of the RETIRED FMA kernels."""
    for e in events:
        if any(k in e.key for k in RETIRED):
            fail(f"[{tag}] {e.key[:90]} was launched: a retired FMA kernel (the tensor-core "
                 "stages replaced it)")


def phase_profile(seed: int) -> None:
    """Device time by kernel over two fused-branch forwards of one 128x128
    image (torch.profiler, CUPTI); the table goes to chip_smoke/profile.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "swinir_m", "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().eval()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                net(x)
            torch.cuda.synchronize()
    events = device_events(prof)
    check_retired("profile", events)
    total = sum(e.self_device_time_total for e in events)
    if total == 0:
        say("[profile] the profiler recorded no device time")
        return
    OUT.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    (OUT / "profile.txt").write_text(table)
    say(f"[profile] device time per forward {total / 2e3:.3f} ms over "
        f"{sum(e.count for e in events) // 2} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        say(f"[profile]   {e.self_device_time_total / 2e3:8.3f} ms  {e.count // 2:4d}x  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# 7. train kernels
# ---------------------------------------------------------------------------


def train_flops(tokens: int) -> tuple[float, float]:
    """Operations of one block's forward (#4) and saved-P backward (#5).
    Forward: qkv, S and P v, proj, fc1 and fc2. Backward: the MLP side
    recomputes fc1 and takes dw2, dh, dw1, dy2 (5 products of T x C x
    hidden); the attention side recomputes qkv and takes datt, dwp, dwq, dy
    (11 products of T x C x C) and dv, dP, dq, dk (4 of T x n x C)."""
    t = tokens
    fwd = 2 * t * C * 3 * C + 4 * t * N * C + 2 * t * C * C + 4 * t * C * HIDDEN
    bwd = 10 * t * C * HIDDEN + 22 * t * C * C + 8 * t * N * C
    return fwd, bwd


def phase_train_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    T = TB * TH * TW
    keep = 1.0 / 0.9  # DropPath at rate 0.1: a sample keeps 1/0.9 or drops to 0
    s1 = torch.full((TB,), keep, device=dev)
    s1[1] = 0.0
    s2 = torch.full((TB,), keep, device=dev)
    s2[4] = 0.0
    fwd_flops, bwd_flops = train_flops(T)
    res: dict[str, dict] = {}
    for kinds in (1, 4):
        shift = WS // 2 if kinds == 4 else 0
        x, p, bias, _ = block_inputs(gen, kinds, dev, shape=(TB, TH, TW))
        ops = [x if k == "x" else bias if k == "bias" else p[k] for k in TRAIN_OPS]
        meta = (NH, HD, WS, 1e-5, shift)
        saved = [t for k, t in zip(TRAIN_OPS, ops) if k != "bias"]
        dout = torch.randn(TB, TH, TW, C, generator=gen).to(dev)

        def fwd():
            return fb._swin_block_train_fwd_cuda(*ops, s1, s2, *meta)

        def fwd_plain():
            return fb.fused_swin_block_train_reference(*ops, s1, s2, *meta)

        try:
            got = fwd()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"fused_swin_block_train K={kinds}: {e}")
        want = fwd_plain()
        errs = {name: (g - w).abs().max().item() for name, g, w in
                zip(("out", "P", "att", "z"), got, want)}
        fwd_err = max(errs.values())
        if not fwd_err <= KERNEL_TOL or not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"fused_swin_block_train K={kinds} disagrees with its plain version: {errs}")

        def bwd():
            return fb.fused_swin_block_train_backward(*saved, s1, s2, *want[1:], dout, kinds,
                                                      *meta)

        def bwd_plain():
            return fb.fused_swin_block_train_bwd_reference(*saved, s1, s2, *want[1:], dout,
                                                           kinds, *meta)

        try:
            grads = bwd()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"fused_swin_block_train_backward K={kinds}: {e}")
        names = ("dx", "dg1", "dbe1", "dwq", "dbq", "dwp", "dbp", "dbias", "dg2", "dbe2", "dw1",
                 "db1", "dw2", "db2")
        plain_grads = bwd_plain()
        bwd_err, worst = check_grads("fused_swin_block_train_backward", f"K={kinds}", grads,
                                     plain_grads, names)
        # #5 as the path runs it: from the kernel forward's P, att and z, held
        # against the plain backward from the plain forward's
        _, chained = check_grads("fused_swin_block_train_backward",
                                 f"K={kinds} from the kernel's P, att, z",
                                 fb.fused_swin_block_train_backward(*saved, s1, s2, *got[1:], dout,
                                                                    kinds, *meta),
                                 plain_grads, names)
        say(f"[train kernels] fused_swin_block_train_backward K={kinds} from the kernel "
            f"forward's P, att, z: within {chained:.3g} of each gradient's max")
        fwd_bytes = nbytes(*ops, s1, s2, *got)
        bwd_bytes = nbytes(*saved, s1, s2, *want[1:], dout, *grads)
        cases = {
            "fused_swin_block_train": (fwd, fwd_plain, fwd_err, fwd_flops, fwd_bytes, ""),
            "fused_swin_block_train_backward": (
                bwd, bwd_plain, bwd_err, bwd_flops, bwd_bytes,
                f", largest error {worst:.3g} of its tensor's max |g|"),
        }
        for name, (kern, plain_fn, err, flops, nb, note) in cases.items():
            ms, plain_ms = time_ms(kern, iters=10, warmup=2), time_ms(plain_fn, iters=5, warmup=1)
            bms, by = bound(flops, nb)
            say(f"[train kernels] {name} K={kinds} shift {shift}: max_abs_err {err:.3g}{note} "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library n/a "
                f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB)")
            rec = res.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # the times reported in the JSON line are the shifted (K=4) calls'
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by)
        stage_split("train kernels", f"fused_swin_block_train K={kinds}", fwd, fwd_flops,
                    fwd_bytes, res["fused_swin_block_train"]["ms"], STAGES_4)
        stage_split("train kernels", f"fused_swin_block_train_backward K={kinds}", bwd,
                    bwd_flops, bwd_bytes, res["fused_swin_block_train_backward"]["ms"], STAGES_5,
                    kernels=(SAVED_BWD[N], "linear_kernel"))

    # #4 at the OTF path's block: 8 LR crops of 32x32, 8,192 tokens (64 token
    # tiles on 132 SMs)
    x, p, bias, _ = block_inputs(gen, 4, dev, shape=(TB, OTF_GT // 4, OTF_GT // 4))
    ops = [x if k == "x" else bias if k == "bias" else p[k] for k in TRAIN_OPS]
    meta = (NH, HD, WS, 1e-5, WS // 2)
    got = fb._swin_block_train_fwd_cuda(*ops, s1, s2, *meta)
    want = fb.fused_swin_block_train_reference(*ops, s1, s2, *meta)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not err <= KERNEL_TOL:
        fail(f"fused_swin_block_train at B=8, 32x32 disagrees with its plain version: {err:.3g}")
    flops = train_flops(TB * (OTF_GT // 4) ** 2)[0]
    bms, by = bound(flops, nbytes(*ops, s1, s2, *got))
    ms = time_ms(lambda: fb._swin_block_train_fwd_cuda(*ops, s1, s2, *meta), iters=10, warmup=2)
    say(f"[train kernels] fused_swin_block_train at B=8, 32x32 (OTF) K=4: max_abs_err {err:.3g} "
        f"kernel {ms:.4f} ms bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP)")
    return res


# ---------------------------------------------------------------------------
# 8. train (and 13. hat train)
# ---------------------------------------------------------------------------


def train_options(name: str, hr_dir: Path, lr_dir: Path, seed: int, network: str = "swinir_m",
                  lq: int = TH, losses: tuple[str, ...] = ("l1loss",), steps: int = TRAIN_STEPS,
                  **extra):
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    raw = {
        "name": name, "scale": 4, "num_gpu": 1, "manual_seed": seed,
        "compute_dtype": "float32",
        "network_g": {"type": network},
        "path": {},
        "datasets": {"train": {
            "name": "smoke_train", "type": "PairedImageDataset",
            "dataroot_gt": str(hr_dir), "dataroot_lq": str(lr_dir),
            "io_backend": {"type": "disk"}, "lq_size": lq, "batch_size_per_gpu": TB,
            "num_worker_per_gpu": 4,
        }},
        "train": {
            "total_iter": steps, "ema_decay": 0.999,
            "optim_g": {"type": "AdamW", "lr": 2e-4, "betas": [0.9, 0.99]},
            "losses": [{"type": t, "loss_weight": 1.0} for t in losses],
        },
        "logger": {"print_freq": PRINT_FREQ, "save_checkpoint_freq": 1000,
                   "use_tb_logger": False},
        **extra,
    }
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=True)


def phase_train(seed: int, network: str = "swinir_m", label: str = "SwinIR-M",
                tag: str = "train", per_step: dict[str, int] | None = None,
                serve_want: dict[str, int] | None = None, lq: int = TH,
                losses: tuple[str, ...] = ("l1loss",), opt=None,
                more_launches=None, check=None, batch_size: int = TB,
                steps: int = TRAIN_STEPS) -> dict[str, int]:
    """The training entry point on `network` (batch `batch_size` of lq x lq
    LR crops, the pair `losses`, `steps` steps; `opt`, when given, are the
    run's options, at that batch and step count); returns
    the launch counts of its run, which must be `per_step` times the steps
    and what `more_launches()` returns after the run. With `check`, every
    step's logs must be finite, and `check(model, opt)` runs before the
    checkpoints are removed."""
    import math
    import statistics

    import torch

    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.models.sr_model import SRModel

    if per_step is None:
        per_step = {"fused_swin_block_train": BLOCKS, "fused_swin_block_train_backward": BLOCKS}
    if serve_want is None:
        serve_want = {"fused_attn_block": BLOCKS * N_IMAGES, "fused_ln_mlp": BLOCKS * N_IMAGES}
    if opt is None:
        hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
        opt = train_options(f"{network}_x4_train", hr_dir, lr_dir, seed, network, lq, losses,
                            steps)
    ends, totals = [], []
    original = SRModel.optimize_parameters

    bad_logs = []

    def timed(self, current_iter):
        original(self, current_iter)
        totals.append(float(self.log_dict["l_g_total"]))  # waits for the step
        ends.append(time.perf_counter())
        if check is not None:
            bad_logs.extend(f"{k} at step {current_iter}" for k, v in self.log_dict.items()
                            if not math.isfinite(float(v)))

    SRModel.optimize_parameters = timed
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_counts()
        model = port_train.run(opt)
        torch.cuda.synchronize()
        counts = read_counts()
        secs = time.perf_counter() - t0
    finally:
        SRModel.optimize_parameters = original
    peak = torch.cuda.max_memory_allocated()
    ran = len(ends)
    warm = min(TRAIN_WARMUP, steps - 3)  # a short run keeps two intervals
    per = [b - a for a, b in zip(ends[warm:], ends[warm + 1:])]
    med = statistics.median(per)
    q = statistics.quantiles(per, n=4)
    say(f"[{tag}] {label} 4x, batch {batch_size} of {lq}x{lq} LR, {' + '.join(losses)}, "
        f"{ran} steps in {secs:.2f} s "
        f"(model build and data included): median {med * 1e3:.2f} ms per step "
        f"(quartiles {q[0] * 1e3:.2f} / {q[2] * 1e3:.2f} ms, steps {warm + 1}-{ran}), "
        f"{batch_size / med:.2f} images/s, max_memory_allocated {peak / 2**30:.2f} GiB")
    say(f"[{tag}] l_g_total per step: first {totals[0]:.5f}, last {totals[-1]:.5f}; "
        f"launches {counts}")
    if ran != steps or model.step != steps:
        fail(f"{tag} ran {ran} steps (model step {model.step}), expected {steps}")
    if not all(math.isfinite(v) for v in totals):
        fail(f"a training loss is not finite: {totals}")
    if bad_logs:
        fail(f"{tag}: logs not finite: {bad_logs[:8]}")
    want = {k: v * steps for k, v in per_step.items()}
    want.update(more_launches() if more_launches else {})
    check_counts(f"{tag} ({label})", counts, want)
    ema = Path(opt.path.models) / f"net_g_ema_{steps}.safetensors"
    if not ema.exists():
        fail(f"no EMA checkpoint at {ema}")
    state = Path(opt.path.training_states) / f"{steps}.state"
    if not (state.exists() and Path(f"{state}.meta.json").exists()):
        fail(f"no training state at {state}")
    eval_hr, eval_lr = make_dataset(OUT / "data", seed)
    served = serve(f"{network}_x4_trained", ema, eval_hr, eval_lr, seed, {}, network)
    check_counts(f"serving the trained {label} checkpoint", served["counts"], serve_want)
    if check is not None:
        check(model, opt)
    # checkpoints, states and the 512x512 PNGs: too large to bring back
    shutil.rmtree(opt.path.models)
    shutil.rmtree(opt.path.training_states)
    shutil.rmtree(OUT / "train_data", ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# 9. train branches
# ---------------------------------------------------------------------------


class KinkPins:
    """The kernel branch takes the plain branch's side at a ReLU's or
    LeakyReLU's kink (see `train_branches`): `hooks(branch, net)` records
    each kink module's inputs in the plain branch, in call order, and pins
    the kernel branch's outputs to the plain branch's sides; an element on
    the other side must lie within KINK_TOL of its tensor's largest |value|
    in both, and `check` fails past KINK_MAX of them."""

    def __init__(self, label: str) -> None:
        self.label = label
        self.plain_inputs: dict[int, list] = {}
        self.pinned, self.share = 0, 0.0

    def _record(self, i, mod, inp):
        self.plain_inputs.setdefault(i, []).append(inp[0].detach())

    def _pin(self, i, mod, inp, out):
        import torch

        x, xp = inp[0], self.plain_inputs[i].pop(0)
        side = xp > 0
        moved = side != (x > 0)
        if bool(moved.any()):
            share = max((x.detach()[moved].abs().max() / x.detach().abs().max()).item(),
                        (xp[moved].abs().max() / xp.abs().max()).item())
            if not share <= KINK_TOL:
                fail(f"{self.label}: a {type(mod).__name__} input differs in sign between the "
                     f"branches at {share:.3g} of its largest |value| (tol {KINK_TOL})")
            self.pinned += int(moved.sum())
            self.share = max(self.share, share)
        slope = mod.negative_slope if isinstance(mod, torch.nn.LeakyReLU) else 0.0
        return torch.where(side, x, x * slope)

    def hooks(self, branch: str, net) -> list:
        import torch

        kinks = [mod for mod in net.modules()
                 if isinstance(mod, (torch.nn.ReLU, torch.nn.LeakyReLU))]
        return [mod.register_forward_pre_hook(functools.partial(self._record, i))
                if branch == "plain" else mod.register_forward_hook(functools.partial(self._pin, i))
                for i, mod in enumerate(kinks)]

    def check(self) -> None:
        if self.pinned > KINK_MAX:
            fail(f"{self.label}: {self.pinned} ReLU / LeakyReLU input elements differ in sign "
                 f"between the branches (at most {KINK_MAX})")

    def said(self) -> str:
        return (f"{self.pinned} ReLU / LeakyReLU input elements on the other side of the kink "
                f"in the kernel branch (at most {KINK_MAX}), within {self.share:.3g} of their "
                f"tensor's max (tol {KINK_TOL}), took the plain branch's side")


def train_branches(seed: int, network: str, label: str, kernel_env: dict,
                   expect: dict[str, int], tag: str, lq: int = TH,
                   zero_grad: tuple[str, ...] = ()) -> None:
    """One forward and backward of `network` in train mode (DropPath on, from
    equal generators) on batch 8 of lq x lq LR through the plain branch
    (TRAINNER_FUSED_ATTN=0) and the kernel branch (`kernel_env`); the kernel
    branch launches `expect`. Parameters named in `zero_grad` (a true
    gradient of 0) are held against their block's largest gradient.

    A ReLU's or LeakyReLU's gradient jumps at 0, so an input element that
    lies within rounding of 0 can take the two sides in the two branches
    and move every gradient behind it by far more than the kernels' error
    (one such element of SRFormerV2's upsampler, 3.9e-8 from the kink,
    moved a bias table's gradient by 1.5e-3 of its largest). The kernel
    branch takes the plain branch's side at each such element: each must
    lie within KINK_TOL of its tensor's largest |value| in both branches,
    and there may be at most KINK_MAX of them; their count is printed."""
    import copy

    import torch

    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.models.sr_model import fp32_math

    net = build_network({"type": network, "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().train()
    nets = {"kernel": net, "plain": copy.deepcopy(net)}
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(TB, 3, lq, lq, generator=gen).cuda()
    gt = torch.rand(TB, 3, 4 * lq, 4 * lq, generator=gen).cuda()
    losses, grads, counts = {}, {}, {}
    pins = KinkPins(label)

    for branch, env in (("plain", {"TRAINNER_FUSED_ATTN": "0"}), ("kernel", kernel_env)):
        m = nets[branch]
        if hasattr(m, "set_dropout_generator"):  # SRFormerV2 has no DropPath
            m.set_dropout_generator(torch.Generator(device="cuda").manual_seed(seed))
        hooks = pins.hooks(branch, m)
        with fused_env(env), fp32_math():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reset_counts()
            loss = (m(x) - gt).abs().mean()
            loss.backward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts[branch] = read_counts()
        for h in hooks:
            h.remove()
        losses[branch] = loss.item()
        # a parameter the step does not reach (DAT's BatchNorm statistics in
        # train mode) has a zero gradient, as SRModel hands it to AdamW
        grads[branch] = {k: torch.zeros_like(p) if p.grad is None else p.grad
                         for k, p in m.named_parameters()}
        say(f"[{tag}] {label} {branch} {env or ''}: loss {losses[branch]:.6f}, forward and "
            f"backward {secs * 1e3:.1f} ms (first call), launches {counts[branch]}")
    pins.check()
    check_counts(f"{label} kernel branch", counts["kernel"], expect)
    check_counts(f"{label} plain branch", counts["plain"], {})
    rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    if not rel <= BRANCH_LOSS_TOL:
        fail(f"{label}: training loss differs by {rel:.3g} (relative) between the branches")

    def block_of(name: str) -> str:
        """`layers.i.residual_group.blocks.j` of a block parameter, else the name."""
        head, sep, tail = name.partition(".blocks.")
        return head + sep + tail.split(".")[0] if sep else name

    block_max: dict[str, float] = {}
    for k, g in grads["plain"].items():
        block_max[block_of(k)] = max(block_max.get(block_of(k), 0.0), g.abs().max().item())
    worst = (0.0, "")
    for k, w in grads["plain"].items():
        g = grads["kernel"][k]
        ref = w.abs().max().item()
        if ref == 0 or k.endswith(zero_grad):  # a zero true gradient
            ref = block_max[block_of(k)]
        err = (g - w).abs().max().item()
        worst = max(worst, (err / ref, k))
        if not err <= BRANCH_GRAD_TOL * ref:
            fail(f"{label}: gradient of {k} differs by {err:.3g} between the branches "
                 f"(ref {ref:.3g})")
    say(f"[{tag}] {label}: loss rel diff {rel:.3g} (tol {BRANCH_LOSS_TOL}); largest gradient "
        f"diff {worst[0]:.3g} of its tensor's max, at {worst[1]} (tol {BRANCH_GRAD_TOL}); "
        f"{pins.said()}")


def phase_train_branches(seed: int) -> None:
    train_branches(seed, "swinir_m", "SwinIR-M", {},
                   {"fused_swin_block_train": BLOCKS, "fused_swin_block_train_backward": BLOCKS},
                   "train branches")


# ---------------------------------------------------------------------------
# 10. train profile
# ---------------------------------------------------------------------------


def phase_train_profile(seed: int, network: str = "swinir_m", tag: str = "train profile",
                        file: str = "profile_train.txt", lq: int = TH,
                        losses: tuple[str, ...] = ("l1loss",)) -> None:
    """Device time by kernel of one training step of `network` (batch 8 of
    lq x lq), after two warm-up steps; the table goes to chip_smoke/`file`.
    The card's busy share is that device time over the host time of a step
    without the profiler (the mean of three)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch.models import build_model

    opt = train_options(f"{network}_x4_profile", OUT, OUT, seed, network, lq, losses)
    model = build_model(opt, device="cuda")
    rng = np.random.default_rng(seed)
    batch = {"lq": rng.integers(0, 256, (TB, lq, lq, 3), dtype=np.uint8),
             "gt": rng.integers(0, 256, (TB, 4 * lq, 4 * lq, 3), dtype=np.uint8)}
    for i in range(2):
        model.feed_data(batch)
        model.optimize_parameters(i + 1)
    torch.cuda.synchronize()
    model.feed_data(batch)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.optimize_parameters(3)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = device_events(prof)
    check_retired(tag, events)
    total = sum(e.self_device_time_total for e in events)
    if total == 0:
        say(f"[{tag}] the profiler recorded no device time")
        return
    OUT.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50)
    (OUT / file).write_text(table)
    t0 = time.perf_counter()
    for i in range(3):
        model.feed_data(batch)
        model.optimize_parameters(4 + i)
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / 3
    say(f"[{tag}] device time per step {total / 1e3:.3f} ms over "
        f"{sum(e.count for e in events)} kernel launches; step wall time under the "
        f"profiler {wall * 1e3:.1f} ms, without it {step * 1e3:.1f} ms (the card busy "
        f"{total / 1e6 / step:.1%} of it)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        say(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# 11. hat kernels
# ---------------------------------------------------------------------------


def window_inputs(gen, kinds: int, ws: int, device):
    """Seeded unit-scale qkv, kind table and output gradient of one window
    attention at the training block (B=8, 64x64, C=180, 6 heads)."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    n = ws * ws
    qkv = torch.randn(TB, TH, TW, 3 * C, generator=gen).to(device)
    rel = (torch.randn(NH, n, n, generator=gen) * 0.5).to(device)
    if kinds == 4:
        rel = rel[None] + torch.from_numpy(shift_mask_kinds(ws, ws // 2)).to(device)[:, None]
    else:
        rel = rel[None]
    dout = torch.randn(TB, TH, TW, C, generator=gen).to(device)
    return qkv, rel.contiguous(), dout


def sdpa_windows(qkv, bias, wr: int, wc: int, kinds: int, nh: int = NH, hd: int = HD):
    """(q, k, v, mask) of the wr x wc windows as SDPA takes them:
    (B*nW, nh, n, hd) each, the per-window bias as a float mask
    (B*nW, nh, n, n)."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    b, h, w, _ = qkv.shape
    win = qkv.reshape(b, h // wr, wr, w // wc, wc, 3, nh, hd)
    win = win.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, nh, wr * wc, hd).contiguous()
    mask = bias[wa.window_kinds(h // wr, w // wc, kinds, qkv.device)].repeat(b, 1, 1, 1)
    return win[0], win[1], win[2], mask


def from_windows(t, b: int, h: int, w: int, wr: int, wc: int, nh: int = NH, hd: int = HD):
    """(B*nW, nh, n, hd) -> (B, H, W, nh*hd)."""
    t = t.reshape(b, h // wr, w // wc, nh, wr, wc, hd)
    return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, nh * hd)


def check_grads(name: str, label: str, grads, plain, parts) -> tuple[float, float]:
    """Each gradient within GRAD_TOL of its plain version's largest
    magnitude; returns the largest error and the largest relative one."""
    err, worst = 0.0, 0.0
    for part, g, w in zip(parts, grads, plain):
        e, top = (g - w).abs().max().item(), w.abs().max().item()
        err, worst = max(err, e), max(worst, e / top)
        if g.shape != w.shape or not e <= GRAD_TOL * top:
            fail(f"{name} {label}: {part} differs by {e:.3g} (max |g| {top:.3g})")
    return err, worst


def record_kernel(res: dict, tag: str, name: str, label: str, kern, plain, lib, flops: float,
                  nb: float, err: float, note: str = "", timer=None) -> None:
    """Time a checked kernel, its plain version and its library call (with
    `timer`, when given, for the first two), print them with the card's
    bound, and keep them in `res[name]` (the last call recorded under a
    name is the one the JSON line reports)."""
    ms = timer(kern) if timer else time_ms(kern, iters=10, warmup=2)
    plain_ms = timer(plain) if timer else time_ms(plain, iters=5, warmup=1)
    lib_ms = time_ms(lib, iters=10, warmup=2) if lib is not None else None
    bms, by = bound(flops, nb)
    say(f"[{tag}] {name} {label}: max_abs_err {err:.3g}{note} kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
        f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB)")
    rec = res.setdefault(name, {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)


def window_attention_cases(tag: str, name: str, label: str, ops, inputs, wr: int, wc: int,
                           kinds: int, nh: int, hd: int) -> dict:
    """Run one window-attention wrapper pair on the card (`ops`: forward,
    its plain version, backward, its plain version; `inputs`: qkv, the kind
    table, the output gradient), check the forward and the SDPA yardstick
    within KERNEL_TOL of the plain forward, both gradients within GRAD_TOL
    of their largest and two backward runs bit-identical; return the timed
    cases, name -> (kernel, plain, library, operations, bytes, error, note)."""
    import torch
    import torch.nn.functional as F

    fwd, fwd_plain, bwd, bwd_plain = ops
    qkv, bias, dout = inputs
    b, h, w, _ = qkv.shape
    n, tokens = wr * wc, b * h * w
    q, k, v, mask = sdpa_windows(qkv, bias, wr, wc, kinds, nh, hd)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    gwin = dout.reshape(b, h // wr, wr, w // wc, wc, nh, hd)
    gwin = gwin.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, nh, n, hd).contiguous()

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        return torch.autograd.grad(out, (qg, kg, vg), gwin)

    try:
        with torch.no_grad():
            got = fwd()
        grads = bwd()
        again = bwd()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"{name} {label}: {e}")
    want = fwd_plain()
    fwd_err = (got - want).abs().max().item()
    lib_err = (from_windows(lib_fwd(), b, h, w, wr, wc, nh, hd) - want).abs().max().item()
    if not fwd_err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
        fail(f"{name} {label} disagrees with its plain version: {fwd_err:.3g}")
    if lib_err > KERNEL_TOL:
        fail(f"{name} {label}: the SDPA yardstick differs by {lib_err:.3g}")
    bwd_err, worst = check_grads(f"{name}_backward", label, grads, bwd_plain(), ("dqkv", "dbias"))
    if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
        fail(f"{name}_backward {label}: two runs differ")
    with torch.no_grad():
        if not torch.equal(got, fwd()):
            fail(f"{name} {label}: two runs differ")
    say(f"[{tag}] {label}: forward max_abs_err {fwd_err:.3g}, backward {bwd_err:.3g} "
        f"({worst:.3g} of its tensor's max |g|), two runs of each bit-identical")
    f64_line(tag, f"{name} {label}", got, want, window_mhsa_f64(qkv, bias, nh, hd, wr, wc))
    c = nh * hd
    return {
        name: (fwd, fwd_plain, lib_fwd, 4 * tokens * n * c, nbytes(qkv, bias, got), fwd_err, ""),
        f"{name}_backward": (bwd, bwd_plain, lib_fwd_bwd, 10 * tokens * n * c,
                             nbytes(qkv, bias, dout, *grads), bwd_err,
                             f", largest error {worst:.3g} of its tensor's max |g|"),
    }


def phase_hat_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    T = TB * TH * TW
    res: dict[str, dict] = {}
    # the JSON line reports the last case of each name: ws 16, shifted (K=4)
    for ws, kinds in ((8, 4), (16, 1), (16, 4)):
        qkv, bias, dout = inputs = window_inputs(gen, kinds, ws, dev)
        ops = (lambda: wa.fused_window_mhsa(qkv, bias, NH, HD, ws),
               lambda: wa.fused_window_mhsa_reference(qkv, bias, NH, HD, ws),
               lambda: wa.fused_window_mhsa_backward(qkv, bias, dout, NH, HD, ws),
               lambda: wa.fused_window_mhsa_bwd_reference(qkv, bias, dout, NH, HD, ws))
        cases = window_attention_cases("hat kernels", "fused_window_mhsa", f"ws {ws} K={kinds}",
                                       ops, inputs, ws, ws, kinds, NH, HD)
        if ws == 8:
            continue  # SwinIR's unfused branch: checked here, timed at ws 16 only
        for name, (kern, plain, lib, flops, nb, err, note) in cases.items():
            name = "fused_window_mhsa_ws16" if name == "fused_window_mhsa" else name
            record_kernel(res, "hat kernels", name, f"K={kinds}", kern, plain, lib, flops, nb,
                          err, note)
        if kinds == 4:  # #3 and #8 as the JSON line has them
            _, _, _, flops, nb, _, _ = cases["fused_window_mhsa"]
            stage_split("hat kernels", "fused_window_mhsa ws 16 K=4", ops[0], flops, nb,
                        res["fused_window_mhsa_ws16"]["ms"], STAGES_3, kernels=(ATTN_FWD[HN],))
            _, _, _, flops, nb, _, _ = cases["fused_window_mhsa_backward"]
            stage_split("hat kernels", "fused_window_mhsa_backward ws 16 K=4", ops[2], flops, nb,
                        res["fused_window_mhsa_backward"]["ms"], STAGES_8)

    # the MLP half's backward (#7), DropPath scales holding 0 and 1/0.9
    x, p, _, _ = block_inputs(gen, 1, dev, shape=(TB, TH, TW))
    s = torch.full((TB,), 1.0 / 0.9, device=dev)
    s[3] = 0.0
    params = [p[k] for k in ("g", "be", "w1", "b1", "w2", "b2")]
    dout = torch.randn(TB, TH, TW, C, generator=gen).to(dev)

    def mlp_bwd():
        return fb.fused_ln_mlp_backward(x, *params, s, dout, HWS)

    def mlp_bwd_plain():
        return fb.fused_ln_mlp_bwd_reference(x, *params, s, dout, HWS)

    def mlp_fwd():
        with torch.no_grad():
            return fb.fused_ln_mlp(x, *params, s, HWS)

    try:
        out = mlp_fwd()
        grads = mlp_bwd()
        again = mlp_bwd()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"fused_ln_mlp / fused_ln_mlp_backward at 16-row strips: {e}")
    # the forward (#2) at HAT's training block, as HAB and OCAB call it
    fwd_err = (out - fb.fused_ln_mlp_reference(x, *params, s, HWS)).abs().max().item()
    if not fwd_err <= KERNEL_TOL or not bool(torch.isfinite(out).all()):
        fail(f"fused_ln_mlp at 16-row strips disagrees with its plain version: {fwd_err:.3g}")
    say(f"[hat kernels] fused_ln_mlp at HAT-M's training block: max_abs_err {fwd_err:.3g} "
        f"(tol {KERNEL_TOL}) kernel {time_ms(mlp_fwd, iters=10, warmup=2):.4f} ms")
    err, worst = check_grads("fused_ln_mlp_backward", "at 16-row strips", grads, mlp_bwd_plain(),
                             ("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2"))
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        fail("fused_ln_mlp_backward: two runs differ")
    record_kernel(res, "hat kernels", "fused_ln_mlp_backward", "K=1", mlp_bwd, mlp_bwd_plain,
                  None, 10 * T * C * HIDDEN, nbytes(x, *params, s, dout, *grads), err,
                  f", largest error {worst:.3g} of its tensor's max |g|, two runs bit-identical")
    stage_split("hat kernels", "fused_ln_mlp_backward", mlp_bwd, 10 * T * C * HIDDEN,
                nbytes(x, *params, s, dout, *grads), res["fused_ln_mlp_backward"]["ms"],
                STAGES_7)
    return res


# ---------------------------------------------------------------------------
# 12. hat path
# ---------------------------------------------------------------------------


def hat_serving_counts() -> dict[str, int]:
    return {"fused_window_mhsa": HAT_BLOCKS * N_IMAGES, "fused_ln_mlp": HAT_MLPS * N_IMAGES}


def phase_hat_path(seed: int) -> None:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "hat_m", "scale": 4})
    net.init_weights(torch.Generator().manual_seed(seed))
    weights = OUT / "hat_m_x4_seeded.pth"
    torch.save(net.state_dict(), weights)
    hr_dir, lr_dir = make_dataset(OUT / "data", seed)
    served = serve("hat_m_x4", weights, hr_dir, lr_dir, seed, {}, "hat_m")
    check_counts("HAT-M serving path", served["counts"], hat_serving_counts())
    weights.unlink()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    net = net.cuda().eval()
    with torch.inference_mode():
        out = net(x)
        fwd_ms = serving_ms(lambda: net(x))
    if out.shape != (1, 3, 512, 512) or not torch.isfinite(out).all():
        fail(f"HAT-M forward: bad output {tuple(out.shape)}")
    say(f"[hat path] HAT-M 4x forward of one 128x128 image {spread(fwd_ms)}")


# ---------------------------------------------------------------------------
# 16. dat kernels
# ---------------------------------------------------------------------------


def rect_inputs(gen, window: tuple[int, int], kinds: int, device):
    """Seeded unit-scale qkv, kind table and output gradient of one DAT
    branch at the training block (B=8, qkv padded to 64x64, 3 heads of 30)."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import rect_shift_mask_kinds

    n = window[0] * window[1]
    qkv = torch.randn(TB, TH, TW, 3 * DC, generator=gen).to(device)
    rel = (torch.randn(DNH, n, n, generator=gen) * 0.5).to(device)
    if kinds == 4:
        masks = rect_shift_mask_kinds(*window, *DAT_WINDOWS[window])
        rel = rel[None] + torch.from_numpy(masks).to(device)[:, None]
    else:
        rel = rel[None]
    dout = torch.randn(TB, TH, TW, DC, generator=gen).to(device)
    return qkv, rel.contiguous(), dout


def phase_dat_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    res: dict[str, dict] = {}
    # the JSON line reports the last case: DAT's first branch of a shifted block
    for (wr, wc), kinds in (((32, 8), 1), ((32, 8), 4), ((8, 16), 4), ((8, 32), 1),
                            ((8, 32), 4)):
        qkv, bias, dout = inputs = rect_inputs(gen, (wr, wc), kinds, dev)
        ops = (lambda: wa.fused_rect_mhsa(qkv, bias, DNH, DHD, wr, wc),
               lambda: wa.fused_rect_mhsa_reference(qkv, bias, DNH, DHD, wr, wc),
               lambda: wa.fused_rect_mhsa_backward(qkv, bias, dout, DNH, DHD, wr, wc),
               lambda: wa.fused_rect_mhsa_bwd_reference(qkv, bias, dout, DNH, DHD, wr, wc))
        label = f"{wr}x{wc} K={kinds}"
        cases = window_attention_cases("dat kernels", "fused_rect_mhsa", label, ops, inputs,
                                       wr, wc, kinds, DNH, DHD)
        for name, (kern, plain, lib, flops, nb, err, note) in cases.items():
            record_kernel(res, "dat kernels", name, label, kern, plain, lib, flops, nb, err, note)
        if kinds == 4:  # #3 at each window
            _, _, _, flops, nb, _, _ = cases["fused_rect_mhsa"]
            stage_split("dat kernels", f"fused_rect_mhsa {label}", ops[0], flops, nb,
                        res["fused_rect_mhsa"]["ms"], STAGES_3, kernels=(ATTN_FWD[wr * wc],))
    # #8's rect form as the JSON line has it: 8x32, K=4
    _, _, _, flops, nb, _, _ = cases["fused_rect_mhsa_backward"]
    stage_split("dat kernels", "fused_rect_mhsa_backward 8x32 K=4", ops[2], flops, nb,
                res["fused_rect_mhsa_backward"]["ms"], STAGES_8_RECT)
    return res


# ---------------------------------------------------------------------------
# 17. dat path
# ---------------------------------------------------------------------------


def dat_serving_counts() -> dict[str, int]:
    return {"fused_rect_mhsa": DAT_RECT * N_IMAGES}


def phase_dat_path(seed: int) -> None:
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": "dat", "scale": 4})
    net.init_weights(torch.Generator().manual_seed(seed))
    weights = OUT / "dat_x4_seeded.pth"
    torch.save(net.state_dict(), weights)
    hr_dir, lr_dir = make_dataset(OUT / "data", seed)
    served = serve("dat_x4", weights, hr_dir, lr_dir, seed, {}, "dat")
    check_counts("DAT serving path", served["counts"], dat_serving_counts())
    weights.unlink()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    net = net.cuda().eval()
    with torch.inference_mode():
        out = net(x)
        fwd_ms = serving_ms(lambda: net(x))
    if out.shape != (1, 3, 512, 512) or not torch.isfinite(out).all():
        fail(f"DAT forward: bad output {tuple(out.shape)}")
    say(f"[dat path] DAT 4x forward of one 128x128 image {spread(fwd_ms)}")


# ---------------------------------------------------------------------------
# 21. swin2sr kernels
# ---------------------------------------------------------------------------


def v2_flops(tokens: int, c: int = C, hidden: int = HIDDEN) -> dict[str, float]:
    """Operations of the post-norm halves at 8x8 windows (Swin2SR-M's widths
    unless said). #11: qkv, cos and P v, proj. #12 recomputes them and takes
    datt, dwp, dv, dP, dq^, dk^, dwq and dx (24 T C^2 + 12 T n C in all).
    #13: fc1 and fc2. #14 recomputes both and takes dhg, dx, dw2 and dw1."""
    t = tokens
    return {
        "fused_cos_attn_block": 8 * t * c * c + 4 * t * N * c,
        "fused_cos_attn_block_backward": 24 * t * c * c + 12 * t * N * c,
        "fused_postnorm_mlp": 4 * t * c * hidden,
        "fused_postnorm_mlp_backward": 12 * t * c * hidden,
    }


def v2_inputs(gen, kinds: int, device, shape, widths=(C, NH, WS, HIDDEN)):
    """Seeded unit-scale operands of one Swin2SR block (Swin2SR-M's unless
    `widths` gives others): `block_inputs`' weights, temperatures
    exp(min(logit, log 100)) between 1 and 100, and a kind table of 16 *
    sigmoid values (plus the shift masks at K=4)."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    nh = widths[1]
    x, p, _, _ = block_inputs(gen, 1, device, shape, widths)
    p["scale"] = torch.exp(torch.rand(nh, generator=gen) * 4.6).to(device)
    bias = (16.0 * torch.sigmoid(torch.randn(nh, N, N, generator=gen))).to(device)[None]
    if kinds == 4:
        bias = bias + torch.from_numpy(shift_mask_kinds(WS, WS // 2)).to(device)[:, None]
    return x, p, bias.contiguous()


def postnorm_half_f64(name: str, x, p: dict, bias, s, shift: int, nh: int = NH):
    """#11's (fused_cos_attn_block, nh heads) or #13's (fused_postnorm_mlp)
    function in float64, on the operands of `v2_inputs` and DropPath scales
    s: the yardstick of the kernel's and of the plain version's accuracy
    (differentiable in float64 leaves)."""
    import torch
    import torch.nn.functional as F

    d = {k: v.double() for k, v in p.items()}
    b, h, w, c = x.shape
    t = torch.roll(x.double(), (-shift, -shift), (1, 2)).reshape(-1, c)
    if name == "fused_postnorm_mlp":
        m = F.gelu(t @ d["w1"] + d["b1"]) @ d["w2"] + d["b2"]
        g, be = d["g2"], d["be2"]
    else:
        qkv = (t @ d["wq"] + d["bq"]).reshape(b, h, w, 3 * c)
        q, k, v, mask = sdpa_windows(qkv, bias.double(), WS, WS, bias.shape[0], nh, c // nh)
        q, k = F.normalize(q, dim=-1, eps=1e-12), F.normalize(k, dim=-1, eps=1e-12)
        pw = torch.softmax(q @ k.transpose(-1, -2) * d["scale"][:, None, None] + mask, dim=-1)
        m = from_windows(pw @ v, b, h, w, WS, WS, nh, c // nh).reshape(-1, c) @ d["wp"] + d["bp"]
        g, be = d["g"], d["be"]
    out = t + s.double().repeat_interleave(h * w)[:, None] * F.layer_norm(m, (c,), g, be, 1e-5)
    return torch.roll(out.reshape(x.shape), (shift, shift), (1, 2))


def phase_swin2sr_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    res: dict[str, dict] = {}
    s = torch.full((TB,), 1.0 / 0.9, device=dev)  # DropPath at rate 0.1: keep or drop
    s[2] = 0.0
    flops = v2_flops(TB * S2_LQ * S2_LQ)
    cos_parts = ("dx", "dwq", "dbq", "dscale", "dwp", "dbp", "dg", "dbe", "dbias")
    mlp_parts = ("dx", "dw1", "db1", "dw2", "db2", "dg", "dbe")
    # the JSON line reports the last case of each name: shifted (K=4)
    for kinds in (1, 4):
        shift = WS // 2 if kinds == 4 else 0
        x, p, bias = v2_inputs(gen, kinds, dev, (TB, S2_LQ, S2_LQ))
        dout = torch.randn(x.shape, generator=gen).to(dev)
        cos = (x, p["wq"], p["bq"], p["scale"], p["wp"], p["bp"], p["g"], p["be"], bias)
        mlp = (x, p["w1"], p["b1"], p["w2"], p["b2"], p["g2"], p["be2"])
        meta = (NH, HD, WS, 1e-5, shift)
        cases = (
            ("fused_cos_attn_block", cos_parts, cos,
             lambda: v2.fused_cos_attn_block(*cos, s, *meta),
             lambda: v2.fused_cos_attn_block_reference(*cos, s, *meta),
             lambda: v2.fused_cos_attn_block_backward(*cos, s, dout, *meta),
             lambda: v2.fused_cos_attn_block_bwd_reference(*cos, s, dout, *meta)),
            ("fused_postnorm_mlp", mlp_parts, mlp,
             lambda: v2.fused_postnorm_mlp(*mlp, s, WS),
             lambda: v2.fused_postnorm_mlp_reference(*mlp, s, WS),
             lambda: v2.fused_postnorm_mlp_backward(*mlp, s, dout, WS),
             lambda: v2.fused_postnorm_mlp_bwd_reference(*mlp, s, dout, WS)),
        )
        label = f"K={kinds} shift {shift}"
        for name, parts, operands, fwd, fwd_plain, bwd, bwd_plain in cases:
            try:
                got, got_again = fwd(), fwd()
                grads = bwd()
                again = bwd()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - report and fail the phase
                fail(f"{name} {label}: {e}")
            fwd_err = (got - fwd_plain()).abs().max().item()
            if not fwd_err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
                fail(f"{name} {label} disagrees with its plain version: {fwd_err:.3g}")
            if not torch.equal(got, got_again):
                fail(f"{name} {label}: two runs differ")
            bwd_err, worst = check_grads(f"{name}_backward", label, grads, bwd_plain(), parts)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                fail(f"{name}_backward {label}: two runs differ")
            record_kernel(res, "swin2sr kernels", name, label, fwd, fwd_plain, None, flops[name],
                          nbytes(*operands, s, got), fwd_err)
            record_kernel(res, "swin2sr kernels", f"{name}_backward", label, bwd, bwd_plain, None,
                          flops[f"{name}_backward"], nbytes(*operands, s, dout, *grads), bwd_err,
                          f", largest error {worst:.3g} of its tensor's max |g|, two runs "
                          "bit-identical")
            if kinds == 4:  # #11-#14 as the JSON line has them
                stage_split("swin2sr kernels", f"{name} K=4", fwd, flops[name],
                            nbytes(*operands, s, got), res[name]["ms"],
                            STAGES_11 if name == "fused_cos_attn_block" else STAGES_13,
                            kernels=("linear_kernel", POSTNORM_ROWS)
                            + ((COS_ATTN_FWD,) if name == "fused_cos_attn_block" else ()))
                stage_split("swin2sr kernels", f"{name}_backward K=4", bwd,
                            flops[f"{name}_backward"], nbytes(*operands, s, dout, *grads),
                            res[f"{name}_backward"]["ms"],
                            STAGES_12 if name == "fused_cos_attn_block" else STAGES_14)

    # #11 and #13 against float64 where the cosine attention's error grows
    # most: every head's temperature at its largest, 100 (the last K=4
    # operands)
    p["scale"] = torch.full_like(p["scale"], 100.0)
    cos = (x, p["wq"], p["bq"], p["scale"], p["wp"], p["bp"], p["g"], p["be"], bias)
    for name, got, want in (
        ("fused_cos_attn_block", v2.fused_cos_attn_block(*cos, s, *meta),
         v2.fused_cos_attn_block_reference(*cos, s, *meta)),
        ("fused_postnorm_mlp", v2.fused_postnorm_mlp(*mlp, s, WS),
         v2.fused_postnorm_mlp_reference(*mlp, s, WS)),
    ):
        err = (got - want).abs().max().item()
        if not err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
            fail(f"{name} K=4, temperatures 100, disagrees with its plain version: {err:.3g}")
        f64_line("swin2sr kernels", f"{name} K=4, temperatures 100", got, want,
                 postnorm_half_f64(name, x, p, bias, s, shift if name == "fused_cos_attn_block"
                                   else 0))

    # #13 and #14 at Swin2SR-L's MLP half (C 240, hidden 480), which #14 now
    # trains on the tensor-core engine
    lc, lhidden = SC, SHIDDEN
    x, p, _, _ = block_inputs(gen, 1, dev, (TB, S2_LQ, S2_LQ), (lc, SNH, WS, lhidden))
    mlp = (x, p["w1"], p["b1"], p["w2"], p["b2"], p["g2"], p["be2"])
    dout = torch.randn(x.shape, generator=gen).to(dev)
    label = f"C {lc} hidden {lhidden}"
    try:
        with torch.no_grad():
            got = v2.fused_postnorm_mlp(*mlp, s, WS)
        grads = v2.fused_postnorm_mlp_backward(*mlp, s, dout, WS)
        again = v2.fused_postnorm_mlp_backward(*mlp, s, dout, WS)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"fused_postnorm_mlp {label}: {e}")
    fwd_err = (got - v2.fused_postnorm_mlp_reference(*mlp, s, WS)).abs().max().item()
    if not fwd_err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
        fail(f"fused_postnorm_mlp {label} disagrees with its plain version: {fwd_err:.3g}")

    def l_fwd():
        return v2.fused_postnorm_mlp(*mlp, s, WS)

    f_flops, f_nb = 4 * TB * S2_LQ * S2_LQ * lc * lhidden, nbytes(*mlp, s, got)
    f_ms = time_ms(l_fwd, iters=10, warmup=2)
    say(f"[swin2sr kernels] fused_postnorm_mlp {label}: kernel {f_ms:.4f} ms plain "
        f"{time_ms(lambda: v2.fused_postnorm_mlp_reference(*mlp, s, WS), iters=5, warmup=1):.4f}"
        " ms")
    stage_split("swin2sr kernels", f"fused_postnorm_mlp {label}", l_fwd, f_flops, f_nb, f_ms,
                STAGES_13)

    def l_bwd():
        return v2.fused_postnorm_mlp_backward(*mlp, s, dout, WS)

    def l_bwd_plain():
        return v2.fused_postnorm_mlp_bwd_reference(*mlp, s, dout, WS)

    err, worst = check_grads("fused_postnorm_mlp_backward", label, grads, l_bwd_plain(),
                             mlp_parts)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        fail(f"fused_postnorm_mlp_backward {label}: two runs differ")
    l_flops = 12 * TB * S2_LQ * S2_LQ * lc * lhidden
    l_nb = nbytes(*mlp, s, dout, *grads)
    ms, plain_ms = time_ms(l_bwd, iters=10, warmup=2), time_ms(l_bwd_plain, iters=5, warmup=1)
    bms, by = bound(l_flops, l_nb)
    say(f"[swin2sr kernels] fused_postnorm_mlp {label}: forward max_abs_err {fwd_err:.3g}; "
        f"fused_postnorm_mlp_backward {label}: max_abs_err {err:.3g}, largest error "
        f"{worst:.3g} of its tensor's max |g|, two runs bit-identical, kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms bound {bms:.4f} ms ({by}; {l_flops / 1e9:.3f} GFLOP, "
        f"{l_nb / 1e6:.2f} MB)")
    stage_split("swin2sr kernels", f"fused_postnorm_mlp_backward {label}", l_bwd, l_flops, l_nb,
                ms, STAGES_14)

    # the serving shapes: B=1, one 128x128 image, shifted
    x, p, bias = v2_inputs(gen, 4, dev, (B, H, W))
    s1 = torch.ones(B, device=dev)
    cos = (x, p["wq"], p["bq"], p["scale"], p["wp"], p["bp"], p["g"], p["be"], bias)
    mlp = (x, p["w1"], p["b1"], p["w2"], p["b2"], p["g2"], p["be2"])
    flops = v2_flops(B * H * W)
    for name, operands, kern, plain in (
        ("fused_cos_attn_block", cos,
         lambda: v2.fused_cos_attn_block(*cos, s1, NH, HD, WS, shift=WS // 2),
         lambda: v2.fused_cos_attn_block_reference(*cos, s1, NH, HD, WS, shift=WS // 2)),
        ("fused_postnorm_mlp", mlp, lambda: v2.fused_postnorm_mlp(*mlp, s1, WS),
         lambda: v2.fused_postnorm_mlp_reference(*mlp, s1, WS)),
    ):
        got = kern()
        err = (got - plain()).abs().max().item()
        if not err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
            fail(f"{name} at B=1, 128x128 disagrees with its plain version: {err:.3g}")
        bms, by = bound(flops[name], nbytes(*operands, s1, got))
        say(f"[swin2sr kernels] {name} at B=1, 128x128 (serving) K=4: max_abs_err {err:.3g} "
            f"kernel {time_ms(kern):.4f} ms ({graph_ms(kern):.4f} by CUDA graphs) plain "
            f"{time_ms(plain):.4f} ms bound {bms:.4f} ms ({by}; {flops[name] / 1e9:.3f} GFLOP)")
    return res


# ---------------------------------------------------------------------------
# 22. swin2sr path (and 31. srformerv2 path)
# ---------------------------------------------------------------------------


def swin2sr_serving_counts() -> dict[str, int]:
    return {"fused_cos_attn_block": SWIN2SR_BLOCKS * N_IMAGES,
            "fused_postnorm_mlp": SWIN2SR_BLOCKS * N_IMAGES}


def phase_branch_path(seed: int, network: str, label: str, tag: str,
                      serve_want: dict[str, int], forward_want: dict[str, int],
                      second: str) -> None:
    """`test.run` on a seeded `network` 4x and the 4 images (its kernels
    launching `serve_want`), then one 128x128 forward timed through the
    kernel branch (launching `forward_want`) and through the branch
    TRAINNER_FUSED_BLOCK=0 selects (`second`), which must agree."""
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    net = build_network({"type": network, "scale": 4})
    net.init_weights(torch.Generator().manual_seed(seed))
    weights = OUT / f"{network}_x4_seeded.pth"
    torch.save(net.state_dict(), weights)
    hr_dir, lr_dir = make_dataset(OUT / "data", seed)
    served = serve(f"{network}_x4", weights, hr_dir, lr_dir, seed, {}, network)
    check_counts(f"{label} serving path", served["counts"], serve_want)
    weights.unlink()
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    net = net.cuda().eval()
    outs = {}
    for branch, env, want in (("kernel", {}, forward_want),
                              (second, {"TRAINNER_FUSED_BLOCK": "0"}, {})):
        with fused_env(env), torch.inference_mode():
            reset_counts()
            outs[branch] = net(x)
            check_counts(f"{label} {branch} branch forward", read_counts(), want)
            fwd_ms = serving_ms(lambda: net(x))
        if outs[branch].shape != (1, 3, 512, 512) or not torch.isfinite(outs[branch]).all():
            fail(f"{label} {branch} forward: bad output {tuple(outs[branch].shape)}")
        say(f"[{tag}] {label} 4x {branch} branch {env or ''}: forward of one 128x128 "
            f"image {spread(fwd_ms)}")
    d = (outs["kernel"] - outs[second]).abs().max().item()
    say(f"[{tag}] kernel vs {second} branch: max_abs_diff {d:.3g} (tol {PATH_TOL})")
    if d > PATH_TOL:
        fail(f"{label}: the kernel and {second} branches differ by {d:.3g}")


# ---------------------------------------------------------------------------
# 24. swin2sr train branches (and 33. srformerv2 train branches)
# ---------------------------------------------------------------------------


def phase_timed_train_branches(seed: int, network: str, label: str, tag: str,
                               per_step: dict[str, int], lq: int, second: str) -> None:
    """The kernel branch against the plain one for one training forward and
    backward of `network` (the check), then the kernel branch and the
    branch TRAINNER_FUSED_BLOCK=0 selects (`second`) timed from equal
    weights."""
    import torch

    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.models.sr_model import fp32_math

    train_branches(seed, network, label, {}, per_step, tag, lq)
    net = build_network({"type": network, "scale": 4})
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().train()
    if hasattr(net, "set_dropout_generator"):
        net.set_dropout_generator(torch.Generator(device="cuda").manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(TB, 3, lq, lq, generator=gen).cuda()
    gt = torch.rand(TB, 3, 4 * lq, 4 * lq, generator=gen).cuda()

    def step():
        net.zero_grad(set_to_none=True)
        (net(x) - gt).abs().mean().backward()

    for branch, env in (("kernel", {}), (second, {"TRAINNER_FUSED_BLOCK": "0"})):
        with fused_env(env), fp32_math():
            ms = time_ms(step, iters=5, warmup=2)
        say(f"[{tag}] {label} {branch} branch {env or ''}: forward and backward of batch "
            f"{TB} of {lq}x{lq} {ms:.2f} ms")


# ---------------------------------------------------------------------------
# 26. jpeg kernel
# ---------------------------------------------------------------------------


def jpeg_planes(seed: int, b: int, size: int, device) -> dict[str, tuple]:
    """The level-shifted 8x8 blocks of the Y ("Y"), Cb ("C") and Cr ("Cr")
    planes of `b` seeded smooth size x size images, and their tables at
    qualities across 45-95, as DiffJPEG hands them to kernel #15."""
    import torch

    from trainner_redux_tpu_torch.utils import diffjpeg as dj

    gen = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(size) / 16.0, torch.arange(size) / 16.0, indexing="ij")
    img = torch.full((b, size, size, 3), 0.5)
    for _ in range(6):
        f = torch.rand(b, 1, 1, 3, generator=gen) * 1.8 + 0.2
        ph = torch.rand(b, 1, 1, 3, generator=gen) * 6.3
        img += 0.12 * torch.sin(f * (yy + 0.7 * xx)[None, ..., None] + ph)
    img = (img + 0.03 * torch.randn(img.shape, generator=gen)).clamp(0, 1).to(device)
    factor = dj.quality_to_factor(torch.linspace(45, 95, b)).to(device)[:, None]
    ycc = dj._rgb_to_ycbcr(img * 255.0)
    cb, cr = (ycc[..., i].reshape(b, size // 2, 2, size // 2, 2).mean(dim=(2, 4))
              for i in (1, 2))
    out = {}
    for plane, x, table in (("Y", ycc[..., 0], dj.Y_TABLE), ("C", cb, dj.C_TABLE),
                            ("Cr", cr, dj.C_TABLE)):
        qt = torch.clamp(torch.from_numpy(table.reshape(-1)).to(device)[None] * factor, 1.0, 255.0)
        out[plane] = (dj._to_blocks(x - 128.0).contiguous(), qt.contiguous())
    return out


def phase_jpeg_kernel() -> dict:
    """#15 against its plain version at the OTF path's planes (batch 8 of
    gt_size 128: the 40x40 LQ padded to 48x48, 36 Y and 9 C blocks an
    image) and at 8 images of 512x512 (4096 Y blocks an image). Blocks with
    a coefficient within 1e-4 of a rounding tie are counted and left out of
    the comparison. Then the path's three planes in one launch
    (`jpeg_block_transform_planes`, DiffJPEG's call) against three
    single-plane launches, and an empty kernel's launch, all by CUDA
    graphs."""
    import torch

    from trainner_redux_tpu_torch.ops import jpeg_kernel as jk

    dev = torch.device("cuda")
    res: dict[str, dict] = {}
    big, path = jpeg_planes(512, TB, 512, dev), jpeg_planes(48, TB, 48, dev)
    # the JSON line reports the last call recorded: the path's Y plane
    cases = [("Y", *big["Y"]), ("C", *path["C"]), ("Y", *path["Y"])]
    for plane, blocks, qt in cases:
        label = f"{plane} {TB}x{blocks.shape[1]} blocks"
        n = blocks.shape[1]
        try:
            got = jk.jpeg_block_transform(blocks, qt)
            again = jk.jpeg_block_transform(blocks, qt)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"jpeg_block_transform {label}: {e}")
        want = jk.jpeg_block_transform_reference(blocks, qt)
        tied = jk.ties(blocks, qt)
        clear = ~tied.any(dim=-1)
        err = (got - want)[clear].abs().max().item()
        if not (err <= JPEG_TOL and torch.equal(got, again) and bool(torch.isfinite(got).all())):
            fail(f"jpeg_block_transform {label}: max_abs_err {err:.3g} (tol {JPEG_TOL}), "
                 f"bit-identical {torch.equal(got, again)}")
        flops = TB * n * (4 * 64 * 64 + 6 * 64)  # two 64x64 products and the quantisation
        events_ms = time_ms(lambda: jk.jpeg_block_transform(blocks, qt))
        note = (f", {int(tied.sum())} coefficients within 1e-4 of a tie "
                f"({int((~clear).sum())} of {TB * n} blocks left out), two runs bit-identical; "
                f"back-to-back calls {events_ms:.4f} ms each (CUDA events); times below from "
                f"CUDA graphs")
        record_kernel(res, "jpeg kernel", "jpeg_block_transform", label,
                      lambda: jk.jpeg_block_transform(blocks, qt),
                      lambda: jk.jpeg_block_transform_reference(blocks, qt), None, flops,
                      nbytes(blocks, qt, got), err, note, timer=graph_ms)

    # a compression's three planes, as DiffJPEG launches them
    planes = [path[k] for k in ("Y", "C", "Cr")]
    try:
        got = jk.jpeg_block_transform_planes(planes)
        again = jk.jpeg_block_transform_planes(planes)
        single = [jk.jpeg_block_transform(*pl) for pl in planes]
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"jpeg_block_transform_planes: {e}")
    for name, out, out2, one, (blocks, qt) in zip(("Y", "Cb", "Cr"), got, again, single, planes):
        clear = ~jk.ties(blocks, qt).any(dim=-1)
        err = (out - jk.jpeg_block_transform_reference(blocks, qt))[clear].abs().max().item()
        if not (err <= JPEG_TOL and torch.equal(out, out2) and torch.equal(out, one)):
            fail(f"jpeg_block_transform_planes {name}: max_abs_err {err:.3g} (tol {JPEG_TOL}), "
                 f"two runs bit-identical {torch.equal(out, out2)}, the single-plane launch's "
                 f"output {torch.equal(out, one)}")
    three_ms = graph_ms(lambda: jk.jpeg_block_transform_planes(planes))
    singles_ms = graph_ms(lambda: [jk.jpeg_block_transform(*pl) for pl in planes])
    floor_ms = graph_ms(lambda: jk.empty_launch(dev))
    blocks = sum(pl[0].shape[0] * pl[0].shape[1] for pl in planes)
    bms, by = bound(blocks * (4 * 64 * 64 + 6 * 64), nbytes(*(t for pl in planes for t in pl))
                    + nbytes(*got))
    say(f"[jpeg kernel] a compression's three planes (Y {TB}x{planes[0][0].shape[1]}, Cb and Cr "
        f"{TB}x{planes[1][0].shape[1]} blocks) in one launch: {three_ms:.4f} ms; as three "
        f"single-plane launches {singles_ms:.4f} ms; an empty kernel's launch {floor_ms:.4f} ms "
        f"(the launch floor; CUDA graphs, each of the three); bound {bms:.4f} ms ({by}); each "
        "plane bit for bit its single launch, within tolerance of the plain version, two runs "
        "bit-identical")
    return res


# ---------------------------------------------------------------------------
# 27. otf degrade
# ---------------------------------------------------------------------------

# what configs/_templates/train/SwinIR/swinir_m_otf.yml sets beyond the
# network, the GAN and the perceptual loss
OTF_TEMPLATE = {"blur_prob": 0.8, "gaussian_noise_prob": 0.5, "noise_range": [1, 20],
                "jpeg_prob": 1.0, "compression_jpeg_range": [45, 95], "recompression_prob": 0.3}
OTF_GT = 128  # gt_size: LQ crops of 32x32
OTF_QUEUE = 120
# the template's L1 + MS-SSIM less MS-SSIM, which needs 161-pixel sides
# (gt_size 128 raises in both packages)
OTF_LOSSES = ("l1loss",)
# every optics, sensor, ISP, editing and recompression gate open
OTF_ALL_ON = {
    "lens_distort_prob": 1.0, "chromatic_aberration_prob": 1.0, "motion_blur_prob": 1.0,
    "blur_prob": 1.0, "demosaic_prob": 1.0, "sensor_noise_prob": 1.0,
    "rolling_shutter_prob": 1.0, "gaussian_noise_prob": 1.0, "noise_range": [1, 20],
    "exposure_prob": 1.0, "color_temp_prob": 1.0, "oversharpen_prob": 1.0,
    "aliasing_prob": 1.0, "recompression_prob": 1.0, "editing_prob": 1.0,
    "editing_exposure_prob": 1.0, "editing_oversharpen_prob": 1.0,
}


def otf_options(name: str, hr_dir: Path, seed: int, **degrade):
    """SwinIR-M 4x OTF training as swinir_m_otf.yml has it, in fp32 and
    without network_d, perceptualloss and ganloss, on `hr_dir`."""
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    raw = {
        "name": name, "scale": 4, "num_gpu": 1, "manual_seed": seed,
        "compute_dtype": "float32", "network_g": {"type": "swinir_m"}, "path": {},
        "high_order_degradation": True, "queue_size": OTF_QUEUE, **degrade,
        "datasets": {"train": {
            "name": "smoke_otf", "type": "realesrgandataset", "dataroot_gt": str(hr_dir),
            "io_backend": {"type": "disk"}, "gt_size": OTF_GT, "batch_size_per_gpu": TB,
            "num_worker_per_gpu": 8, "accum_iter": 1,
        }},
        "train": {
            "total_iter": TRAIN_STEPS, "ema_decay": 0.999, "warmup_iter": -1,
            "grad_clip": False,
            "optim_g": {"type": "AdamW", "lr": 2e-4, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [250000, 400000, 450000, 475000],
                          "gamma": 0.5},
            "losses": [{"type": t, "loss_weight": 1.0} for t in OTF_LOSSES],
        },
        "logger": {"print_freq": PRINT_FREQ, "save_checkpoint_freq": 1000,
                   "use_tb_logger": False},
    }
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=True)


def otf_batch(opt, seed: int, n: int = TB) -> dict:
    """n samples of the OTF dataset (uint8 GT of gt_size + 32 and the three
    kernels), stacked, on the card."""
    import numpy as np
    import torch

    from trainner_redux_tpu_torch.data import build_dataset

    ds = build_dataset(opt.datasets["train"], seed=seed)
    return {k: torch.from_numpy(np.stack([ds[i][k] for i in range(n)])).cuda()
            for k in ("gt", "kernel1", "kernel2", "sinc_kernel")}


@contextmanager
def plain_jpeg_core():
    """DiffJPEG's block transform (its three-plane entry, which DiffJPEG
    calls) through its plain version, plane by plane, for the body."""
    from trainner_redux_tpu_torch.ops import jpeg_kernel as jk

    kernel = jk.jpeg_block_transform_planes
    jk.jpeg_block_transform_planes = lambda planes: [
        jk.jpeg_block_transform_reference(blocks, qtabs) for blocks, qtabs in planes]
    try:
        yield
    finally:
        jk.jpeg_block_transform_planes = kernel


def phase_otf_degrade(seed: int, hr_dir: Path) -> None:
    """One seeded batch through `_degrade` with every gate open, twice from
    the same generator states: through #15 and through the plain core."""
    import torch

    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.models.sr_model import fp32_math

    opt = otf_options("otf_degrade", hr_dir, seed, **OTF_ALL_ON)
    model = build_model(opt, device="cuda")
    batch = otf_batch(opt, seed)
    states = (model.host_generator.get_state(), model.device_generator.get_state())
    outs, times = {}, {}

    def degrade():
        with torch.no_grad(), fp32_math():
            return model._degrade(*batch.values())

    for core in ("kernel", "plain"):
        model.host_generator.set_state(states[0])
        model.device_generator.set_state(states[1])
        reset_counts()
        with plain_jpeg_core() if core == "plain" else nullcontext():
            outs[core] = degrade()
        torch.cuda.synchronize()
        launches = read_counts()["jpeg_block_transform"]
        want = 2 if core == "kernel" else 0  # compressed twice, 3 planes a launch
        if launches != want:
            fail(f"otf degrade {core} core: {launches} launches of #15, expected {want}")
    # the host clock of this machine wanders: time in turns, kernel, plain,
    # plain, kernel, 10 runs a turn, from the same generator states
    for core in ("kernel", "plain", "plain", "kernel"):
        model.host_generator.set_state(states[0])
        model.device_generator.set_state(states[1])
        with plain_jpeg_core() if core == "plain" else nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                degrade()
            torch.cuda.synchronize()
        times.setdefault(core, []).append((time.perf_counter() - t0) / 10 * 1e3)
    (gt_k, lq_k), (gt_p, lq_p) = outs["kernel"], outs["plain"]
    if lq_k.shape != (TB, OTF_GT // 4, OTF_GT // 4, 3) or not torch.equal(gt_k, gt_p):
        fail(f"otf degrade: lq {tuple(lq_k.shape)}, GT crops equal {torch.equal(gt_k, gt_p)}")
    d = (lq_k - lq_p).abs()
    say(f"[otf degrade] batch {TB} of {OTF_GT + 32}x{OTF_GT + 32} GT, every gate open: LQ "
        f"{tuple(lq_k.shape)}, #15 vs plain core max_abs_diff {d.max().item():.3g} "
        f"(tol {1 / 255:.3g}), {int((d > 1e-6).sum())} of {d.numel()} values differ; "
        f"_degrade through #15 {' / '.join(f'{t:.2f}' for t in times['kernel'])} ms, through "
        f"the plain core {' / '.join(f'{t:.2f}' for t in times['plain'])} ms (host clock, "
        f"turns of 10 runs: kernel, plain, plain, kernel)")
    if d.max().item() > 1 / 255 + 1e-6:
        fail(f"otf degrade: the #15 and plain-core LQs differ by {d.max().item():.3g}")


# ---------------------------------------------------------------------------
# 28. otf train
# ---------------------------------------------------------------------------


def phase_otf_train(seed: int, hr_dir: Path) -> dict[str, int]:
    """`train.run` on SwinIR-M 4x OTF: TRAIN_STEPS steps, counting #15 (one launch
    a compression, its three planes together: one a step and one for each
    recompression drawn) and #4/#5 (36 + 36 a step)."""
    from trainner_redux_tpu_torch.models.realesrgan_model import RealESRGANModel

    compressions = []
    original = RealESRGANModel._compress

    def counted(self, x, fmt):
        compressions.append(fmt)
        return original(self, x, fmt)

    RealESRGANModel._compress = counted
    try:
        counts = phase_train(
            seed, "swinir_m", "SwinIR-M OTF", "otf train", lq=OTF_GT // 4, losses=OTF_LOSSES,
            opt=otf_options("swinir_m_x4_otf", hr_dir, seed, **OTF_TEMPLATE),
            more_launches=lambda: {"jpeg_block_transform": len(compressions)})
    finally:
        RealESRGANModel._compress = original
    say(f"[otf train] {len(compressions) - TRAIN_STEPS} recompressions drawn in "
        f"{TRAIN_STEPS} steps (p 0.3); #15 launches {counts['jpeg_block_transform']}")
    return counts


# ---------------------------------------------------------------------------
# 29. otf train profile
# ---------------------------------------------------------------------------


def phase_otf_profile(seed: int, hr_dir: Path, opt=None, tag: str = "otf profile") -> None:
    """Device time by kernel of one OTF step (`opt`, else phase 28's run),
    split into the degradation (`feed_data`: degrade and pool) and the
    optimizer step; both timed again without the profiler, and the card's
    idle share against that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch.models import build_model

    opt = opt or otf_options("swinir_m_x4_otf_profile", hr_dir, seed, **OTF_TEMPLATE)
    stem = "otf" if tag == "otf profile" else tag.replace(" ", "_")
    model = build_model(opt, device="cuda")
    batch = otf_batch(opt, seed)
    for i in range(3):
        model.feed_data(batch)
        model.optimize_parameters(i + 1)
    torch.cuda.synchronize()
    parts = {}
    for part, fn in (("degrade", lambda: model.feed_data(batch)),
                     ("step", lambda: model.optimize_parameters(4))):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = device_events(prof)
        check_retired(tag, events)
        parts[part] = (sum(e.self_device_time_total for e in events) / 1e3, wall * 1e3, events,
                       prof)
    if parts["degrade"][0] == 0:
        say(f"[{tag}] the profiler recorded no device time")
        return
    timed = {}
    for part, fn in (("degrade", lambda: model.feed_data(batch)),
                     ("step", lambda: model.optimize_parameters(5))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        timed[part] = (time.perf_counter() - t0) / 5 * 1e3
    device = sum(p[0] for p in parts.values())
    wall = sum(timed.values())
    say(f"[{tag}] one OTF step (batch {TB}, gt {OTF_GT}): device {device:.3f} ms "
        f"(profiler) against {wall:.2f} ms on the host clock without the profiler (5 runs "
        f"each): the card idle {1 - device / wall:.1%}. feed_data (degrade and pool) "
        f"{parts['degrade'][0]:.3f} device ms, {timed['degrade']:.2f} ms host clock "
        f"({parts['degrade'][0] / device:.1%} of the device time); optimize_parameters "
        f"{parts['step'][0]:.3f} device ms, {timed['step']:.2f} ms host clock (under the "
        f"profiler {parts['degrade'][1]:.1f} and {parts['step'][1]:.1f} ms)")
    for part, (_, _, events, prof) in parts.items():
        (OUT / f"profile_{stem}_{part}.txt").write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50))
        say(f"[{tag}] {part}: {sum(e.count for e in events)} kernel launches")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            say(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  "
                f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# 30. srformerv2 kernels
# ---------------------------------------------------------------------------


def srf_flops(tokens: int) -> dict[str, float]:
    """Operations of SRFormerV2's Swin-block kernels at 12x12 windows. #1:
    qkv, S and P v, proj (8 T C^2 + 4 T n C). #6 recomputes qkv, S and P v
    and takes datt, dwp, dv, dP, dq, dk, dwq and dy (22 T C^2 + 12 T n C).
    #2: fc1 and fc2. #7 recomputes fc1 and takes dw2, dh, dw1, dy."""
    t = tokens
    return {
        "fused_attn_block_ws12": 8 * t * SC * SC + 4 * t * SN * SC,
        "fused_attn_block_backward": 22 * t * SC * SC + 12 * t * SN * SC,
        "fused_ln_mlp_c240": 4 * t * SC * SHIDDEN,
        "fused_ln_mlp_backward_c240": 10 * t * SC * SHIDDEN,
    }


def phase_srformerv2_kernels() -> dict:
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    res: dict[str, dict] = {}
    s = torch.full((TB,), 1.0 / 0.9, device=dev)  # DropPath at rate 0.1: keep or drop
    s[5] = 0.0
    flops = srf_flops(TB * SRF_PAD * SRF_PAD)
    attn_parts = ("dx", "dg", "dbe", "dwq", "dbq", "dwp", "dbp", "dbias")
    mlp_parts = ("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2")
    # the JSON line reports the last case of each name: K=1, the path's
    for kinds in (4, 1):
        shift = SWS // 2 if kinds == 4 else 0
        x, p, bias, _ = block_inputs(gen, kinds, dev, (TB, SRF_PAD, SRF_PAD), SRF_WIDTHS)
        dout = torch.randn(x.shape, generator=gen).to(dev)
        attn = (x, p["g"], p["be"], p["wq"], p["bq"], p["wp"], p["bp"], bias)
        mlp = (x, p["g"], p["be"], p["w1"], p["b1"], p["w2"], p["b2"])
        meta = (SNH, SHD, SWS, 1e-5, shift)

        def attn_fwd():
            with torch.no_grad():
                return fb.fused_attn_block(*attn, s, *meta[:4], shift=shift)

        def mlp_fwd():
            with torch.no_grad():
                return fb.fused_ln_mlp(*mlp, s, SWS)

        cases = (
            ("fused_attn_block_ws12", "fused_attn_block_backward", attn_parts, attn, attn_fwd,
             lambda: fb.fused_attn_block_reference(*attn, s, *meta),
             lambda: fb.fused_attn_block_backward(*attn, s, dout, *meta),
             lambda: fb.fused_attn_block_bwd_reference(*attn, s, dout, *meta)),
            ("fused_ln_mlp_c240", "fused_ln_mlp_backward_c240", mlp_parts, mlp, mlp_fwd,
             lambda: fb.fused_ln_mlp_reference(*mlp, s, SWS),
             lambda: fb.fused_ln_mlp_backward(*mlp, s, dout, SWS),
             lambda: fb.fused_ln_mlp_bwd_reference(*mlp, s, dout, SWS)),
        )
        label = f"K={kinds} shift {shift}"
        for name, bname, parts, operands, fwd, fwd_plain, bwd, bwd_plain in cases:
            if name == "fused_ln_mlp_c240" and kinds == 4:
                continue  # per-token: no window kinds
            try:
                got = fwd()
                grads = bwd()
                again = bwd()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - report and fail the phase
                fail(f"{name} {label}: {e}")
            fwd_err = (got - fwd_plain()).abs().max().item()
            if not fwd_err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
                fail(f"{name} {label} disagrees with its plain version: {fwd_err:.3g}")
            bwd_err, worst = check_grads(bname, label, grads, bwd_plain(), parts)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                fail(f"{bname} {label}: two runs differ")
            record_kernel(res, "srformerv2 kernels", name, label, fwd, fwd_plain, None,
                          flops[name], nbytes(*operands, s, got), fwd_err)
            record_kernel(res, "srformerv2 kernels", bname, label, bwd, bwd_plain, None,
                          flops[bname], nbytes(*operands, s, dout, *grads), bwd_err,
                          f", largest error {worst:.3g} of its tensor's max |g|, two runs "
                          "bit-identical")
            if name == "fused_attn_block_ws12":  # #1 at 12x12 against float64, split by stage
                exact = block_half_f64("fused_attn_block", x, {**p, "s": s}, bias, shift, SNH, SWS)
                f64_line("srformerv2 kernels", f"{name} {label}", got, fwd_plain(), exact)
                if kinds == 1:
                    stage_split("srformerv2 kernels", f"{name} K=1", fwd, flops[name],
                                nbytes(*operands, s, got), res[name]["ms"], STAGES_1,
                                kernels=(*LN_LINEAR, ATTN_FWD[SN]))
            if bname == "fused_ln_mlp_backward_c240":
                stage_split("srformerv2 kernels", name, fwd, flops[name],
                            nbytes(*operands, s, got), res[name]["ms"], STAGES_2)
                stage_split("srformerv2 kernels", bname, bwd, flops[bname],
                            nbytes(*operands, s, dout, *grads), res[bname]["ms"], STAGES_7)
            elif kinds == 1:  # #6 at the path's own K
                stage_split("srformerv2 kernels", f"{bname} K=1", bwd, flops[bname],
                            nbytes(*operands, s, dout, *grads), res[bname]["ms"], STAGES_6)

    # the serving shapes: B=1, one 128x128 image padded to 144x144
    x, p, bias, _ = block_inputs(gen, 1, dev, (B, SRF_SERVE, SRF_SERVE), SRF_WIDTHS)
    s1 = torch.ones(B, device=dev)
    attn = (x, p["g"], p["be"], p["wq"], p["bq"], p["wp"], p["bp"], bias)
    mlp = (x, p["g"], p["be"], p["w1"], p["b1"], p["w2"], p["b2"])
    flops = srf_flops(B * SRF_SERVE * SRF_SERVE)
    with torch.no_grad():
        for name, operands, kern, plain in (
            ("fused_attn_block_ws12", attn, lambda: fb.fused_attn_block(*attn, s1, SNH, SHD, SWS),
             lambda: fb.fused_attn_block_reference(*attn, s1, SNH, SHD, SWS)),
            ("fused_ln_mlp_c240", mlp, lambda: fb.fused_ln_mlp(*mlp, s1, SWS),
             lambda: fb.fused_ln_mlp_reference(*mlp, s1, SWS)),
        ):
            got = kern()
            err = (got - plain()).abs().max().item()
            if not err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
                fail(f"{name} at B=1, 144x144 disagrees with its plain version: {err:.3g}")
            bms, by = bound(flops[name], nbytes(*operands, s1, got))
            say(f"[srformerv2 kernels] {name} at B=1, 144x144 (serving) K=1: max_abs_err "
                f"{err:.3g} kernel {time_ms(kern):.4f} ms plain {time_ms(plain):.4f} ms "
                f"bound {bms:.4f} ms ({by}; {flops[name] / 1e9:.3f} GFLOP)")
    return res


def srformerv2_serving_counts() -> dict[str, int]:
    return {"fused_attn_block": SRF_SWIN * N_IMAGES, "fused_ln_mlp": SRF_SWIN * N_IMAGES}


# ---------------------------------------------------------------------------
# 35. attn train
# ---------------------------------------------------------------------------


def attn_train_flops(tokens: int, c: int, n: int) -> tuple[float, float]:
    """Operations of #9 and #10. #9: qkv, S and P v, proj (8 T C^2 + 4 T n
    C), as #1. #10 recomputes qkv only and takes datt, dwp, dwq and dy (22 T
    C^2 with the recompute) and dv, dP, dq, dk from the saved P (8 T n C)."""
    return 8 * tokens * c * c + 4 * tokens * n * c, 22 * tokens * c * c + 8 * tokens * n * c


# label, record suffix, (B, H, W), (C, heads, window, hidden), K in order (the
# JSON line reports the last: the path's own K of each model's timed cases)
ATTN_TRAIN_BLOCKS = (
    ("SwinIR-M block", "", (TB, TH, TW), (C, NH, WS, HIDDEN), (1, 4)),
    ("SRFormerV2 block", "_ws12", (TB, SRF_PAD, SRF_PAD), SRF_WIDTHS, (4, 1)),
)


def swin_block_loss(attn_fn, ops, s1, s2, meta):
    """One pre-LN Swin block, the attention half by `attn_fn` (the two
    attention-half ops, or the whole training block when attn_fn is None)
    then `fused_ln_mlp`: sum(out^2) and its gradients in the 14 operands."""
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    ops = [t.detach().requires_grad_() for t in ops]
    nh, hd, ws, eps, shift = meta
    if attn_fn is None:
        out = fb.fused_swin_block_train(*ops, s1, s2, *meta)
    else:
        z = attn_fn(*ops[:8], s1, nh, hd, ws, eps, shift=shift)
        out = fb.fused_ln_mlp(z, *ops[8:], s2, ws, eps)
    return out.detach(), torch.autograd.grad(out.square().sum(), ops)


def phase_attn_train() -> tuple[dict, dict]:
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    keep = 1.0 / 0.9  # DropPath at rate 0.1: a sample keeps 1/0.9 or drops to 0
    s1 = torch.full((TB,), keep, device=dev)
    s1[1] = 0.0
    s2 = torch.full((TB,), keep, device=dev)
    s2[4] = 0.0
    res: dict[str, dict] = {}
    launches: dict[str, int] = {}
    grad_names = ("dx", "dg", "dbe", "dwq", "dbq", "dwp", "dbp", "dbias")
    block_names = ("out", *TRAIN_OPS)
    for label, suffix, shape, widths, kind_order in ATTN_TRAIN_BLOCKS:
        c, nh, ws, _ = widths
        hd, n = c // nh, ws * ws
        cases = []
        for kinds in kind_order:
            x, p, bias, _ = block_inputs(gen, kinds, dev, shape, widths)
            ops = [x if k == "x" else bias if k == "bias" else p[k] for k in TRAIN_OPS]
            dout = torch.randn(x.shape, generator=gen).to(dev)
            cases.append((kinds, ws // 2 if kinds == 4 else 0, ops, dout))

        # the path: the whole block through #9/#10 and #2/#7, at each K
        reset_counts()
        try:
            saved = [swin_block_loss(fb.fused_attn_block_train, ops, s1, s2,
                                     (nh, hd, ws, 1e-5, shift)) for _, shift, ops, _ in cases]
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"fused_attn_block_train {label}: {e}")
        counts = read_counts()
        k = len(cases)
        check_counts(f"[attn train] {label}", counts, {
            "fused_attn_block_train": k, "fused_attn_block_train_backward": k,
            "fused_ln_mlp": k, "fused_ln_mlp_backward": k})
        fname, bname = "fused_attn_block_train" + suffix, "fused_attn_block_train_backward" + suffix
        launches[fname] = counts["fused_attn_block_train"]
        launches[bname] = counts["fused_attn_block_train_backward"]
        say(f"[attn train] {label}: launches {counts['fused_attn_block_train']} of #9, "
            f"{counts['fused_attn_block_train_backward']} of #10 over {k} blocks forward and "
            "backward")

        fwd_flops, bwd_flops = attn_train_flops(shape[0] * shape[1] * shape[2], c, n)
        for (kinds, shift, ops, dout), (out, grads) in zip(cases, saved):
            case = f"{label} K={kinds} shift {shift}"
            meta = (nh, hd, ws, 1e-5, shift)
            attn = ops[:7]

            def fwd():
                return fb._attn_block_train_fwd_cuda(*attn, ops[7], s1, *meta)

            def fwd_plain():
                return fb.fused_attn_block_train_reference(*attn, ops[7], s1, *meta)

            try:
                got = fwd()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - report and fail the phase
                fail(f"{fname} {case}: {e}")
            want = fwd_plain()
            errs = {name: (g - w).abs().max().item()
                    for name, g, w in zip(("z", "P", "att"), got, want)}
            fwd_err = max(errs.values())
            if not fwd_err <= KERNEL_TOL or not all(bool(torch.isfinite(g).all()) for g in got):
                fail(f"{fname} {case} disagrees with its plain version: {errs}")

            def bwd():
                return fb.fused_attn_block_train_backward(*attn, s1, want[1], want[2], dout, kinds,
                                                          *meta)

            def bwd_plain():
                return fb.fused_attn_block_train_bwd_reference(*attn, s1, want[1], want[2], dout,
                                                               kinds, *meta)

            try:
                bgrads = bwd()
                again = bwd()
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 - report and fail the phase
                fail(f"{bname} {case}: {e}")
            plain_grads = bwd_plain()
            bwd_err, worst = check_grads(bname, case, bgrads, plain_grads, grad_names)
            if not all(torch.equal(a, b_) for a, b_ in zip(bgrads, again)):
                fail(f"{bname} {case}: two runs differ")
            # #10 as the path runs it: from the kernel forward's P and att
            _, chained = check_grads(
                bname, f"{case} from the kernel's P, att",
                fb.fused_attn_block_train_backward(*attn, s1, got[1], got[2], dout, kinds, *meta),
                plain_grads, grad_names)
            say(f"[attn train] {bname} {case} from the kernel forward's P, att: within "
                f"{chained:.3g} of each gradient's max")
            record_kernel(res, "attn train", fname, case, fwd, fwd_plain, None, fwd_flops,
                          nbytes(*ops[:8], s1, *got), fwd_err)
            record_kernel(res, "attn train", bname, case, bwd, bwd_plain, None, bwd_flops,
                          nbytes(*attn, s1, want[1], want[2], dout, *bgrads), bwd_err,
                          f", largest error {worst:.3g} of its tensor's max |g|, two runs "
                          "bit-identical")

            # the recompute pair (#1 and #6) on the same inputs, timed beside
            def rec_fwd():
                with torch.no_grad():
                    return fb.fused_attn_block(*ops[:8], s1, nh, hd, ws, 1e-5, shift=shift)

            def rec_bwd():
                return fb.fused_attn_block_backward(*ops[:8], s1, dout, *meta)

            f_ms, b_ms = res[fname]["ms"], res[bname]["ms"]
            rf_ms, rb_ms = time_ms(rec_fwd, iters=10, warmup=2), time_ms(rec_bwd, iters=10,
                                                                         warmup=2)
            if kinds == kind_order[-1]:  # #10 (#6's stages), #9, and #6 at 8x8 (phase 30: 12x12)
                stage_split("attn train", f"{bname} {case}", bwd, bwd_flops,
                            nbytes(*attn, s1, want[1], want[2], dout, *bgrads), b_ms, STAGES_6,
                            kernels=(SAVED_BWD[n],))
                stage_split("attn train", f"{fname} {case}", fwd, fwd_flops,
                            nbytes(*ops[:8], s1, *got), f_ms, STAGES_1,
                            kernels=(*LN_LINEAR, ATTN_FWD[n]))
                if ws == WS:
                    t = shape[0] * shape[1] * shape[2]
                    stage_split("attn train", f"fused_attn_block_backward {case}", rec_bwd,
                                22 * t * c * c + 12 * t * n * c,
                                nbytes(*ops[:8], s1, dout, *bgrads), rb_ms, STAGES_6)
            say(f"[attn train] {case}: saved-P pair #9 {f_ms:.4f} + #10 {b_ms:.4f} = "
                f"{f_ms + b_ms:.4f} ms; recompute pair #1 {rf_ms:.4f} + #6 {rb_ms:.4f} = "
                f"{rf_ms + rb_ms:.4f} ms; P {got[1].numel() * 4 / 1e6:.1f} MB")

            # the whole block: saved-P against recompute (and #4/#5 at 8x8)
            others = {"#1/#6": fb.fused_attn_block}
            if ws == WS:
                others["#4/#5"] = None
            for other, fn in others.items():
                o_out, o_grads = swin_block_loss(fn, ops, s1, s2, meta)
                worst = 0.0
                for name, a, b_ in zip(block_names, (out, *grads), (o_out, *o_grads)):
                    e, top = (a - b_).abs().max().item(), b_.abs().max().item()
                    worst = max(worst, e / top)
                    if not e <= GRAD_TOL * top:
                        fail(f"[attn train] {case}: the block through #9/#10 and through {other} "
                             f"differ in {name} by {e:.3g} (max {top:.3g})")
                say(f"[attn train] {case}: the block through #9/#10 against {other}: out and 14 "
                    f"gradients within {worst:.3g} of each tensor's max")
            peaks, times = {}, {}
            for other, fn in {"#9/#10": fb.fused_attn_block_train, **others}.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                swin_block_loss(fn, ops, s1, s2, meta)
                torch.cuda.synchronize()
                peaks[other] = (torch.cuda.max_memory_allocated() - base) / 2**20
                times[other] = time_ms(lambda fn=fn: swin_block_loss(fn, ops, s1, s2, meta),
                                       iters=5, warmup=1)
            say(f"[attn train] {case}: the block forward and backward through "
                + ", ".join(f"{k} {times[k]:.4f} ms (peak {peaks[k]:.1f} MiB above the inputs)"
                            for k in times))
    return res, launches


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 36. deterministic
# ---------------------------------------------------------------------------

# (network, LR crop, pair losses) of each family's training step, as its
# train phase runs it
DET_FAMILIES = (("swinir_m", TH, ("l1loss",)), ("hat_m", TH, ("l1loss",)),
                ("dat", DAT_LQ, ("l1loss", "mssimloss")), ("swin2sr_m", S2_LQ, S2_LOSSES),
                ("srformerv2", SRF_LQ, S2_LOSSES))


def phase_deterministic(seed: int) -> None:
    """One training step of each family with `deterministic: true` (torch's
    deterministic algorithms, cuDNN's deterministic convolutions, cuBLAS's
    fixed workspace), twice from the same seed and batch: every op of the
    step has a deterministic implementation (torch raises where one has
    none), and the two steps agree bit for bit, in the loss and in every
    parameter after AdamW."""
    import numpy as np
    import torch

    from trainner_redux_tpu_torch.models import build_model

    for network, lq, losses in DET_FAMILIES:
        opt = train_options(f"{network}_x4_deterministic", OUT, OUT, seed, network, lq, losses,
                            deterministic=True)
        rng = np.random.default_rng(seed)
        batch = {"lq": rng.integers(0, 256, (TB, lq, lq, 3), dtype=np.uint8),
                 "gt": rng.integers(0, 256, (TB, 4 * lq, 4 * lq, 3), dtype=np.uint8)}
        runs = []
        for _ in range(2):
            model = build_model(opt, device="cuda")
            model.feed_data(batch)
            t0 = time.perf_counter()
            try:
                model.optimize_parameters(1)
                torch.cuda.synchronize()
            except RuntimeError as e:
                fail(f"{network} with deterministic: true: {e}")
            secs = time.perf_counter() - t0
            runs.append((model.log_dict["l_g_total"].item(),
                         [p.detach().clone() for p in model.net_g.parameters()]))
            del model
            torch.cuda.empty_cache()
        (loss_a, params_a), (loss_b, params_b) = runs
        if loss_a != loss_b or not all(torch.equal(a, b) for a, b in zip(params_a, params_b)):
            fail(f"{network} with deterministic: true: two steps differ (loss {loss_a!r} "
                 f"against {loss_b!r})")
        say(f"[deterministic] {network}: one step under deterministic algorithms in "
            f"{secs * 1e3:.1f} ms (second build), loss {loss_a:.6f}; two steps bit-identical "
            f"in the loss and all {len(params_a)} parameters")


# ---------------------------------------------------------------------------
# 37-40. GAN training (swinir_m_gan.yml)
# ---------------------------------------------------------------------------

GAN_TEMPLATE = ROOT / "configs" / "_templates" / "train" / "SwinIR" / "swinir_m_gan.yml"
GAN_LQ = 48  # the template's lq_size: 192x192 GT
GAN_LOSSES = ("l1loss", "mssimloss", "perceptualloss", "ganloss")
GAN_DATA = OUT / "gan_data"


def gan_options(name: str, hr_dir: Path, lr_dir: Path, seed: int,
                template: Path = GAN_TEMPLATE, as_shipped: bool = False,
                steps: int = TRAIN_STEPS, **extra):
    """`template`, configs/_templates/train/SwinIR/swinir_m_gan.yml unless
    said (SwinIR-M 4x, batch 8 of 48x48 LR crops, network_d dunet, L1 +
    MS-SSIM + perceptual + vanilla GAN 0.1, AdamW 2e-4 for G and D, EMA
    0.999, its MultiStepLR, bf16), in fp32 (phases 37-40) or `as_shipped`
    (bf16, phase 52), on `hr_dir` / `lr_dir`, `steps` steps, without
    validation."""
    import yaml

    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    raw = yaml.safe_load(template.read_text())
    raw.update(name=name, manual_seed=seed, num_gpu=1, path={})
    if not as_shipped:
        raw["compute_dtype"] = "float32"
    raw["datasets"] = {"train": {**raw["datasets"]["train"], "dataroot_gt": str(hr_dir),
                                 "dataroot_lq": str(lr_dir), "io_backend": {"type": "disk"},
                                 "num_worker_per_gpu": 4}}
    raw["train"]["total_iter"] = steps
    raw["val"]["val_enabled"] = False
    raw["logger"] = {"print_freq": PRINT_FREQ, "save_checkpoint_freq": 1000,
                     "use_tb_logger": False}
    raw.update(extra)
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=True)


def gan_vgg_line(tag: str | None) -> None:
    """Let the perceptual loss run: torchvision's vgg19.pth from
    TRAINNER_WEIGHTS_DIR where one is there, else the seeded random init,
    allowed here (TRAINNER_ALLOW_RANDOM_VGG=1); with a `tag`, say which."""
    wdir = os.environ.get("TRAINNER_WEIGHTS_DIR")
    if wdir and (Path(wdir) / "vgg19.pth").exists():
        if tag:
            say(f"[{tag}] VGG19: torchvision's weights from {wdir}/vgg19.pth")
        return
    os.environ["TRAINNER_ALLOW_RANDOM_VGG"] = "1"
    if tag:
            say(f"[{tag}] VGG19: no vgg19.pth on this machine: the perceptual loss runs on the "
            "seeded random He-normal init (TRAINNER_ALLOW_RANDOM_VGG=1), the JAX package's "
            "numbers; its features are not meaningful, its cost is the real one")


def gan_batch(seed: int, n: int = TB, lq: int = GAN_LQ) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"lq": rng.integers(0, 256, (n, lq, lq, 3), dtype=np.uint8),
            "gt": rng.integers(0, 256, (n, 4 * lq, 4 * lq, 3), dtype=np.uint8)}


def gan_train_kernels() -> dict[str, int]:
    return {"fused_swin_block_train": BLOCKS, "fused_swin_block_train_backward": BLOCKS}


def phase_gan_branches(seed: int) -> None:
    """One GAN step of the template's run from equal weights (G and D from
    one seed) and batch through the kernel branch and the plain branch
    (TRAINNER_FUSED_ATTN=0): every logged loss within BRANCH_LOSS_TOL
    (D's mean outputs within it of the larger), D's gradients within
    BRANCH_GRAD_TOL of each tensor's largest, and every spectral norm's
    (u, v), refreshed from D's equal weights of before the step, within
    1e-6. G's gradients are held to BRANCH_GRAD_TOL from one upstream
    gradient: the kernel branch's backward takes the plain branch's
    gradient of the losses at G's output, because VGG19's ReLUs and max
    pools turn the branches' rounding-level different outputs into
    differences at their kinks far above the kernels' error (how far, the
    phase prints); G's own ReLU / LeakyReLU kinks are pinned as in
    `train_branches`."""
    import torch

    from trainner_redux_tpu_torch.archs.arch_util import spectral_norms
    from trainner_redux_tpu_torch.models import build_model

    gan_vgg_line("gan branches")
    opt = gan_options("swinir_m_x4_gan_branches", OUT, OUT, seed)
    batch = gan_batch(seed)
    pins = KinkPins("gan branches")
    upstream = {}
    runs = {}

    def at_output(branch, grad):
        upstream[branch] = grad.detach().clone()
        return upstream["plain"] if branch == "kernel" else None

    def hook_output(branch, module, args, out):
        out.register_hook(functools.partial(at_output, branch))

    for branch, env in (("plain", {"TRAINNER_FUSED_ATTN": "0"}), ("kernel", {})):
        with fused_env(env):
            model = build_model(opt, device="cuda")
            hooks = pins.hooks(branch, model.net_g)
            hooks.append(model.net_g.register_forward_hook(
                functools.partial(hook_output, branch)))
            model.feed_data(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reset_counts()
            model.optimize_parameters(1)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            for h in hooks:
                h.remove()
        logs = {k: float(v) for k, v in model.log_dict.items()}
        runs[branch] = (logs,
                        {k: p.grad.clone() for k, p in model.net_g.named_parameters()},
                        {k: p.grad.clone() for k, p in model.net_d.named_parameters()},
                        [torch.cat([sn._u, sn._v]) for _, sn in spectral_norms(model.net_d)])
        say(f"[gan branches] {branch} {env or ''}: one GAN step {secs * 1e3:.1f} ms (first "
            f"call), l_g_total {logs['l_g_total']:.6f}, l_d_real {logs['l_d_real']:.6f}, "
            f"l_d_fake {logs['l_d_fake']:.6f}, launches {counts}")
        check_counts(f"gan branches ({branch})", counts,
                     gan_train_kernels() if branch == "kernel" else {})
        del model
        torch.cuda.empty_cache()
    pins.check()
    (lk, gk, dk, uvk), (lp, gp, dp, uvp) = runs["kernel"], runs["plain"]
    out_scale = max(abs(lp["out_d_real"]), abs(lp["out_d_fake"]))
    worst_loss = (0.0, "")
    for k, w in lp.items():
        if k.startswith("lr_") or k == "grad_norm_g":
            continue
        ref = out_scale if k.startswith("out_d") else abs(w)
        rel = abs(lk[k] - w) / ref
        worst_loss = max(worst_loss, (rel, k))
        if not rel <= BRANCH_LOSS_TOL:
            fail(f"gan branches: {k} differs by {rel:.3g} (relative) between the branches")
    worst = (0.0, "")
    for name, kern, plain in (("G", gk, gp), ("D", dk, dp)):
        for k, w in plain.items():
            ref = w.abs().max().item()
            err = (kern[k] - w).abs().max().item()
            share = err / ref if ref else err
            worst = max(worst, (share, f"{name} {k}"))
            if not share <= BRANCH_GRAD_TOL:
                fail(f"gan branches: {name} gradient of {k} differs by {err:.3g} between the "
                     f"branches (ref {ref:.3g})")
    uv = max((a - b).abs().max().item() for a, b in zip(uvk, uvp))
    if not uv <= 1e-6:
        fail(f"gan branches: a spectral norm's (u, v) differs by {uv:.3g} between the branches")
    up = (upstream["kernel"] - upstream["plain"]).abs().max() / upstream["plain"].abs().max()
    say(f"[gan branches] largest loss diff {worst_loss[0]:.3g} (relative, {worst_loss[1]}; tol "
        f"{BRANCH_LOSS_TOL}); largest gradient diff {worst[0]:.3g} of its tensor's max, at "
        f"{worst[1]} (tol {BRANCH_GRAD_TOL}); (u, v) of {len(uvk)} spectral norms within "
        f"{uv:.3g} (tol 1e-6); each branch's own gradient of the losses at G's output differs "
        f"by {up.item():.3g} of its largest (the kernel branch's backward took the plain "
        f"one's); {pins.said()}")


def phase_gan_train(seed: int, as_shipped: bool = False, tag: str = "gan train",
                    per_step: dict[str, int] | None = None,
                    steps: int = TRAIN_STEPS) -> dict[str, int]:
    """`train.run` of swinir_m_gan.yml (fp32, or `as_shipped` in bf16),
    `steps` steps from 16 seeded 512x512 HR images, counting #4/#5 (36 + 36 a step,
    or `per_step`); every log finite; D's parameters and every (u, v) moved
    from D's seeded init; the EMA checkpoint serves with the strict load,
    and net_d_<iter> loads back strictly into DUnet."""
    import torch

    from trainner_redux_tpu_torch.archs import build_network_cast

    gan_vgg_line(tag)
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    opt = gan_options("swinir_m_x4_gan" + ("_bf16" if as_shipped else ""), hr_dir, lr_dir, seed,
                      as_shipped=as_shipped, steps=steps)
    dtype = torch.bfloat16 if as_shipped else torch.float32

    def build_network(o):
        return build_network_cast(o, dtype)

    start = build_network(dict(opt.network_d)).init_weights(
        torch.Generator().manual_seed(seed + 1)).state_dict()

    def check(model, opt):
        if type(model.net_d).__name__ != "DUnet":
            fail(f"{tag}: network_d is {type(model.net_d).__name__}, expected DUnet")
        if model.net_d.compute_dtype != dtype or model.net_g.compute_dtype != dtype:
            fail(f"{tag}: G and D compute in {model.net_g.compute_dtype} and "
                 f"{model.net_d.compute_dtype}, expected {dtype}")
        now = model.net_d.state_dict()
        still = [k for k, v in now.items() if not k.endswith("init_pos")
                 and torch.equal(v.cpu(), start[k])]
        if still:
            fail(f"{tag}: D did not move in {steps} steps: {still[:6]}")
        path = Path(opt.path.resume_models) / f"net_d_{steps}.safetensors"
        if not path.exists():
            fail(f"{tag}: no {path.name} under resume_models")
        fresh = build_network(dict(opt.network_d))
        model.load_network(fresh, str(path), strict=True)  # raises on any key or shape
        same = all(torch.equal(fresh.state_dict()[k], v.cpu()) for k, v in now.items())
        if not same:
            fail(f"{tag}: {path.name} does not load back to the trained D")
        log = model.get_current_log()
        say(f"[{tag}] D moved in all {len(now) - 3} parameters and (u, v) buffers; "
            f"{path.name} loads back strictly into DUnet; last step: "
            + ", ".join(f"{k} {v:.5f}" for k, v in log.items())
            + f"; lr_g, lr_d {model.get_current_learning_rate()}")

    label = "SwinIR-M GAN" + (" bf16 (swinir_m_gan.yml)" if as_shipped else "")
    return phase_train(seed, "swinir_m", label, tag, per_step=per_step, lq=GAN_LQ,
                       losses=GAN_LOSSES, opt=opt, check=check, steps=steps)


def phase_gan_profile(seed: int, template: Path = GAN_TEMPLATE, as_shipped: bool = False,
                      tag: str = "gan profile", per_step: dict[str, int] | None = None,
                      detail: bool = True) -> None:
    """Device time by kernel of one GAN step of `template` (fp32, or
    `as_shipped`), split into the G step (its forward, losses, backward,
    AdamW and EMA; D's step held back) and the D step (D on the GT and on
    the fake, forward and backward, AdamW, the spectral refresh) on that G
    step's own output; with `per_step`, the G step's launches of the
    hand-written kernels must be those; with `detail`, of the G step, DUnet
    on the fake (forward and backward to the image) and the perceptual
    loss's two VGG19 passes each profiled alone on the step's inputs, and of
    one DUnet pass its three DySample upsamplers. The card's busy share is
    the device time over the host time of a whole step without the profiler
    (the mean of three); peak memory over the six steps. The logs of the
    warm-up steps and the last timed step must be finite."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch.archs.arch_util import DySample
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.models.sr_model import step_math

    def device_ms(fn, file: str | None = None):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        check_retired(tag, events)
        if file:
            (OUT / file).write_text(
                prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50))
        return sum(e.self_device_time_total for e in events) / 1e3, events

    gan_vgg_line(None)
    stem = template.stem + ("_bf16" if as_shipped else "")
    opt = gan_options(f"{stem}_profile", OUT, OUT, seed, template=template,
                      as_shipped=as_shipped)
    model = build_model(opt, device="cuda")
    batch_size = opt.datasets["train"].batch_size_per_gpu
    batch = gan_batch(seed, batch_size)
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        model.feed_data(batch)
        model.optimize_parameters(i + 1)
        check_finite_logs(tag, model, i + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        model.feed_data(batch)
        model.optimize_parameters(3 + i)
    torch.cuda.synchronize()
    step_host = (time.perf_counter() - t0) / 3 * 1e3
    check_finite_logs(tag, model, 5)

    d_step = model._discriminator_step
    held = {}
    model._discriminator_step = lambda *args: held.setdefault("args", args)
    model.feed_data(batch)
    reset_counts()
    g_ms, g_events = device_ms(lambda: model.optimize_parameters(6),
                               f"profile_{stem}_g_step.txt")
    if per_step is not None:
        check_counts(f"{tag} G step", read_counts(), per_step)
    del model._discriminator_step  # the class's again

    def run_d_step():
        with step_math(model.opt):
            d_step(*held["args"])

    d_ms, d_events = device_ms(run_d_step, f"profile_{stem}_d_step.txt")
    peak = torch.cuda.max_memory_allocated()
    if g_ms == 0:
        fail(f"[{tag}] the profiler recorded no device time")
    total = g_ms + d_ms
    launches = sum(e.count for e in g_events) + sum(e.count for e in d_events)
    lq = opt.datasets["train"].lq_size
    say(f"[{tag}] one GAN step of {template.name}{' as shipped' if as_shipped else ' in fp32'} "
        f"(batch {batch_size}, {lq}x{lq} LR, {4 * lq}x{4 * lq} GT): device {total:.3f} ms over "
        f"{launches} kernel launches = G step {g_ms:.3f} + D step {d_ms:.3f}; host clock "
        f"{step_host:.1f} ms a step without the profiler (mean of 3): the card busy "
        f"{total / step_host:.1%}; max_memory_allocated {peak / 2**30:.2f} GiB")
    for part, events in (("G step", g_events), ("D step", d_events)):
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            say(f"[{tag}]   {part} {e.self_device_time_total / 1e3:8.3f} ms  "
                f"{e.count:4d}x  {e.key[:80]}")
    if not detail:
        return

    fake, gt = held["args"][0], held["args"][1]
    net_d, gan = model.net_d.train().requires_grad_(False), model.gan_losses[0]
    percep = next(loss for key, loss in model.losses if key == "l_g_perceptual")

    def dunet_on_fake():
        with step_math(model.opt):
            x = fake.clone().requires_grad_(True)
            (abs(gan.loss_weight) * gan(net_d(x), True, is_disc=False)).backward()

    def vgg_passes():
        with step_math(model.opt):
            x = fake.clone().requires_grad_(True)
            percep(x, gt).backward()

    inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, a: inputs.append((m, a[0].detach())))
             for m in net_d.modules() if isinstance(m, DySample)]
    with torch.no_grad():
        net_d(fake)
    for h in hooks:
        h.remove()

    def dysamples():
        with step_math(model.opt):
            for m, x in inputs:
                x = x.clone().requires_grad_(True)
                m(x).square().mean().backward()

    dunet_ms, _ = device_ms(dunet_on_fake)
    vgg_ms, _ = device_ms(vgg_passes)
    dys_ms, dys_events = device_ms(dysamples, f"profile_{stem}_dysample.txt")
    say(f"[{tag}] of the G step, profiled alone on its inputs: DUnet on the fake, "
        f"forward and backward to the image, {dunet_ms:.3f} ms; the perceptual loss's two "
        f"VGG19 passes (the output's with its backward, the GT's without) {vgg_ms:.3f} ms; "
        f"the three DySamples of one DUnet pass, forward and backward, {dys_ms:.3f} ms over "
        f"{sum(e.count for e in dys_events)} launches")


def phase_gan_deterministic(seed: int) -> None:
    """Two GAN steps of the template's run with `deterministic: true`,
    twice from one seed and batches: every op has a deterministic
    implementation, and the two runs agree bit for bit in every log, G's
    parameters, D's parameters and every (u, v)."""
    import torch

    from trainner_redux_tpu_torch.models import build_model

    gan_vgg_line(None)
    opt = gan_options("swinir_m_x4_gan_deterministic", OUT, OUT, seed, deterministic=True)
    batches = [gan_batch(seed + i) for i in range(2)]
    runs = []
    for _ in range(2):
        model = build_model(opt, device="cuda")
        t0 = time.perf_counter()
        try:
            for i, batch in enumerate(batches):
                model.feed_data(batch)
                model.optimize_parameters(i + 1)
            torch.cuda.synchronize()
        except RuntimeError as e:
            fail(f"GAN step with deterministic: true: {e}")
        secs = time.perf_counter() - t0
        runs.append(({k: v.item() for k, v in model.log_dict.items()},
                     [p.detach().clone() for p in model.net_g.parameters()],
                     {k: v.clone() for k, v in model.net_d.state_dict().items()}))
        del model
        torch.cuda.empty_cache()
    (la, ga, da), (lb, gb, db) = runs
    if la != lb or not all(torch.equal(a, b) for a, b in zip(ga, gb)) or \
            not all(torch.equal(da[k], db[k]) for k in da):
        fail(f"GAN steps with deterministic: true differ between two runs (logs {la} against "
             f"{lb})")
    say(f"[gan deterministic] two GAN steps under deterministic algorithms in {secs * 1e3:.1f} "
        f"ms (second build), l_g_total {la['l_g_total']:.6f}, l_d_real {la['l_d_real']:.6f}; "
        f"two runs bit-identical in {len(la)} logs, {len(ga)} G parameters and {len(da)} D "
        f"tensors (parameters and each spectral norm's u and v)")


# ---------------------------------------------------------------------------
# 41-44. bf16 training (swinir_m_fidelity.yml as shipped)
# ---------------------------------------------------------------------------

# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16 = 989e12
FIDELITY_TEMPLATE = ROOT / "configs" / "_templates" / "train" / "SwinIR" / "swinir_m_fidelity.yml"
FID_LQ = 48  # the template's lq_size: 192x192 GT
FID_LOSSES = ("l1loss", "mssimloss")
# bf16 kernel against its bf16 plain version: both round to bf16 (8 bits,
# 2^-8 = 3.9e-3 of a value) at the same points, summing in other orders, so
# a value at a rounding tie rounds one way in one and the other way in the
# other: each tensor within BF16_TOL (some 2.5 bf16 steps) of its largest,
# and at most BF16_FAR_SHARE of its elements beyond one bf16 step of it
BF16_TOL = 1e-2
BF16_STEP = 2.0**-8
BF16_FAR_SHARE = 1e-3
# against the float64 function of the same bf16-rounded inputs, the kernel's
# error at most F64_RATIO times the plain version's, plus F64_FLOOR of the
# tensor's largest (what fp32 sums over 32,768 tokens in another order
# move: db2 sums s2 dout exactly in both, and nothing else moves it)
F64_RATIO = 1.5
F64_FLOOR = 1e-5
# one bf16 step's loss, kernels against plain versions (relative): the mean
# of 884,736 output pixels, a few of which round apart by a bf16 step
BF16_BRANCH_LOSS_TOL = 1e-3
# the bf16 step's gradients, kernels against plain versions, each against
# the fp32 step: two bf16 computations of one function, each as far from
# fp32 as bf16's rounding puts it (see phase_bf16_branches)
BF16_BRANCH_RATIO = 1.5  # L2 over every parameter
BF16_TENSOR_RATIO = 3.0  # one tensor's largest difference
BF16_TRAIN_STEP = {"fused_swin_block_train_bf16": BLOCKS,
                   "fused_swin_block_train_backward_bf16": BLOCKS}
BF16_GRAD_NAMES = ("dx", "dg1", "dbe1", "dwq", "dbq", "dwp", "dbp", "dbias", "dg2", "dbe2", "dw1",
                   "db1", "dw2", "db2")


def swin_block_f64(ops, s1, s2, shift: int):
    """#4's function in float64 on float64 leaves `ops` (TRAIN_OPS order),
    the window attention's P included, for autograd: (out, P, att, z), laid
    out as the kernels lay them out; no rounding anywhere."""
    import torch
    import torch.nn.functional as F

    x, g1, be1, wq, bq, wp, bp, bias, g2, be2, w1, b1, w2, b2 = ops
    b, h, w, c = x.shape
    xr = torch.roll(x, (-shift, -shift), (1, 2))
    t = xr.reshape(-1, c)
    qkv = (F.layer_norm(t, (c,), g1, be1, 1e-5) @ wq + bq).reshape(b, h, w, 3 * c)
    q, k, v, mask = sdpa_windows(qkv, bias, WS, WS, bias.shape[0])
    P = torch.softmax(q @ k.transpose(-1, -2) * HD**-0.5 + mask, dim=-1)
    att = from_windows(P @ v, b, h, w, WS, WS)
    rows = h * w
    z = t + s1.double().repeat_interleave(rows)[:, None] * (att.reshape(-1, c) @ wp + bp)
    mlp = F.gelu(F.layer_norm(z, (c,), g2, be2, 1e-5) @ w1 + b1) @ w2 + b2
    out = z + s2.double().repeat_interleave(rows)[:, None] * mlp

    def unroll(u):
        return torch.roll(u.reshape(b, h, w, c), (shift, shift), (1, 2))

    return (unroll(out), P.reshape(b, h // WS, w // WS, NH, N, N), unroll(att.reshape(-1, c)),
            unroll(z))


def check_bf16(tag: str, what: str, got, want, hold_max: bool = True) -> tuple[float, float]:
    """A bf16 form's output or gradient against its bf16 plain version:
    within BF16_TOL of the tensor's largest, at most BF16_FAR_SHARE of the
    elements beyond one bf16 step of it; returns the largest error and that
    over the tensor's largest. Without `hold_max` the largest is printed and
    only the share held (see phase 54)."""
    g, w = got.float(), want.float()
    top = w.abs().max().item()
    err = (g - w).abs()
    rel, far = err.max().item() / top, (err > BF16_STEP * top).float().mean().item()
    if not hold_max and rel > BF16_TOL:
        say(f"[{tag}] {what}: {rel:.3g} of its largest (printed, not held), {far:.3g} of the "
            f"elements beyond one bf16 step (tol {BF16_FAR_SHARE})")
    held = rel if hold_max else 0.0
    if got.dtype != want.dtype or not (held <= BF16_TOL and far <= BF16_FAR_SHARE):
        fail(f"[{tag}] {what}: {rel:.3g} of its largest (tol {BF16_TOL}), {far:.3g} of the "
             f"elements beyond one bf16 step (tol {BF16_FAR_SHARE}); dtypes {got.dtype}, "
             f"{want.dtype}")
    return err.max().item(), rel


def phase_bf16_kernels() -> dict:
    """41. The bf16 forms of #4 and #5 at the bf16 path's block (B=8, 64x64
    LR, C 180, 6 heads of 30, hidden 360, DropPath scales holding 0 and
    1/0.9), K=1 and K=4 shifted by 4, on bf16 x and dout with the fp32
    parameters: each output and gradient against its bf16 plain version
    (`check_bf16`), #5 from the plain forward's P, att and z and, as the path
    runs it, from the kernel forward's own; kernel and plain version against
    the float64 function of the same bf16-rounded inputs (autograd for the
    gradients; `F64_RATIO`, `F64_FLOOR`); two runs of each bit for bit; ms a
    call beside the plain versions' and the fp32 forms' from the same call,
    the bf16 bound (989 TFLOP/s, 3.35 TB/s) and its share; at K=4 the device
    time by stage."""
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(41)
    keep = 1.0 / 0.9
    s1 = torch.full((TB,), keep, device=dev)
    s1[1] = 0.0
    s2 = torch.full((TB,), keep, device=dev)
    s2[4] = 0.0
    fwd_flops, bwd_flops = train_flops(TB * TH * TW)
    res: dict[str, dict] = {}
    for kinds in (1, 4):
        shift = WS // 2 if kinds == 4 else 0
        x32, p, bias, _ = block_inputs(gen, kinds, dev, shape=(TB, TH, TW))
        ops32 = [x32 if k == "x" else bias if k == "bias" else p[k] for k in TRAIN_OPS]
        ops = [ops32[0].bfloat16()] + ops32[1:]
        dout = torch.randn(TB, TH, TW, C, generator=gen).to(dev).bfloat16()
        meta = (NH, HD, WS, 1e-5, shift)
        saved = [t for k, t in zip(TRAIN_OPS, ops) if k != "bias"]
        label = f"K={kinds}"

        def fwd():
            return fb.fused_swin_block_train_bf16(*ops, s1, s2, *meta)

        def fwd_plain():
            return fb.fused_swin_block_train_bf16_reference(*ops, s1, s2, *meta)

        try:
            got = fwd()
            again = fwd()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"fused_swin_block_train_bf16 {label}: {e}")
        want = fwd_plain()
        fwd_err = {n: check_bf16("bf16 kernels", f"#4 bf16 {label} {n}", g, w)
                   for n, g, w in zip(("out", "P", "att", "z"), got, want)}
        fwd_rel = {n: e[1] for n, e in fwd_err.items()}
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"fused_swin_block_train_bf16 {label}: two runs differ")

        def bwd():
            return fb.fused_swin_block_train_backward_bf16(*saved, s1, s2, *want[1:], dout, kinds,
                                                           *meta)

        def bwd_plain():
            return fb.fused_swin_block_train_bwd_bf16_reference(*saved, s1, s2, *want[1:], dout,
                                                                kinds, *meta)

        try:
            grads, grads2 = bwd(), bwd()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"fused_swin_block_train_backward_bf16 {label}: {e}")
        plain_grads = bwd_plain()
        bwd_err = {n: check_bf16("bf16 kernels", f"#5 bf16 {label} {n}", g, w)
                   for n, g, w in zip(BF16_GRAD_NAMES, grads, plain_grads)}
        bwd_rel = {n: e[1] for n, e in bwd_err.items()}
        if not all(torch.equal(a, b) for a, b in zip(grads, grads2)):
            fail(f"fused_swin_block_train_backward_bf16 {label}: two runs differ")
        # as the path runs it: from the kernel forward's own P, att and z
        path_grads = fb.fused_swin_block_train_backward_bf16(*saved, s1, s2, *got[1:], dout,
                                                             kinds, *meta)
        path_rel = max(check_bf16("bf16 kernels", f"#5 bf16 {label} {n} from the kernel's P",
                                  g, w)[1] for n, g, w in zip(BF16_GRAD_NAMES, path_grads,
                                                             plain_grads))
        say(f"[bf16 kernels] {label}: #4 within {max(fwd_rel.values()):.3g} of each output's "
            f"largest ({', '.join(f'{k} {v:.3g}' for k, v in fwd_rel.items())}); #5 within "
            f"{max(bwd_rel.values()):.3g} of each gradient's ({max(bwd_rel, key=bwd_rel.get)}), "
            f"{path_rel:.3g} from the kernel forward's P, att, z; two runs of each bit for bit")

        # the float64 yardstick: the same bf16-rounded inputs, no rounding after
        leaves = [t.detach().double().requires_grad_() for t in
                  ([ops[0]] + [fb._bf(t) if k in ("wq", "wp", "w1", "w2") else t
                               for k, t in zip(TRAIN_OPS[1:], ops[1:])])]
        exact = swin_block_f64(leaves, s1, s2, shift)
        # the gradients in TRAIN_OPS order, which is #5's
        exact_g = torch.autograd.grad(exact[0], leaves, dout.double())
        pairs = [(f"#4 {n}", g, w, e) for n, g, w, e in
                 zip(("out", "P", "att", "z"), got, want, exact)]
        pairs += [(f"#5 {n}", g, w, e) for n, g, w, e in
                  zip(BF16_GRAD_NAMES, path_grads, plain_grads, exact_g)]
        worst = (0.0, "")
        for what, g, w, e in pairs:
            e = e.detach()
            top = e.abs().max().item()
            ke = (g.double() - e).abs().max().item()
            pe = (w.double() - e).abs().max().item()
            worst = max(worst, (ke / max(pe, 1e-30), what))
            if not ke <= F64_RATIO * pe + F64_FLOOR * top:
                fail(f"[bf16 kernels] {label} {what} against float64: kernel {ke:.3g}, plain "
                     f"{pe:.3g} of {top:.3g} (the kernel may be at most {F64_RATIO}x the plain "
                     f"version's + {F64_FLOOR} of the largest)")
            say(f"[bf16 kernels] {label} {what} against float64: kernel {ke:.3g}, plain "
                f"{pe:.3g} of {top:.3g}")
        say(f"[bf16 kernels] {label}: against float64 the kernels' error is at most "
            f"{worst[0]:.3f}x the plain versions' ({worst[1]})")

        fwd_bytes = nbytes(*ops, s1, s2, *got)
        bwd_bytes = nbytes(*saved, s1, s2, *want[1:], dout, *grads)
        saved32 = [t for k, t in zip(TRAIN_OPS, ops32) if k != "bias"]
        want32 = fb.fused_swin_block_train_reference(*ops32, s1, s2, *meta)
        dout32 = dout.float()
        cases = {
            "fused_swin_block_train_bf16": (
                fwd, fwd_plain, lambda: fb._swin_block_train_fwd_cuda(*ops32, s1, s2, *meta),
                max(e[0] for e in fwd_err.values()), max(fwd_rel.values()), fwd_flops,
                fwd_bytes),
            "fused_swin_block_train_backward_bf16": (
                bwd, bwd_plain, lambda: fb.fused_swin_block_train_backward(
                    *saved32, s1, s2, *want32[1:], dout32, kinds, *meta),
                max(e[0] for e in bwd_err.values()), max(bwd_rel.values()), bwd_flops,
                bwd_bytes),
        }
        for name, (kern, plain_fn, fp32_fn, err, rel, flops, nb) in cases.items():
            ms, fp32_ms = time_ms(kern, iters=10, warmup=2), time_ms(fp32_fn, iters=10, warmup=2)
            plain_ms = time_ms(plain_fn, iters=5, warmup=1)
            bms, by = bound(flops, nb, PEAK_BF16)
            say(f"[bf16 kernels] {name} {label} shift {shift}: max_abs_err {err:.3g} ({rel:.3g} of "
                f"its tensor's largest), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, fp32 form {fp32_ms:.4f} ms; bf16 "
                f"bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB), "
                f"{100 * bms / ms:.1f}% of the kernel's time")
            rec = res.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by)
        stage_split("bf16 kernels", f"fused_swin_block_train_bf16 {label}", fwd, fwd_flops,
                    fwd_bytes, res["fused_swin_block_train_bf16"]["ms"], STAGES_4,
                    kernels=("attn_rows_fwd_bf16_kernel", "linear_bf16_kernel"), bf16=True)
        stage_split("bf16 kernels", f"fused_swin_block_train_backward_bf16 {label}", bwd,
                    bwd_flops, bwd_bytes, res["fused_swin_block_train_backward_bf16"]["ms"],
                    STAGES_5_BF16, kernels=("attn_rows_bwd_bf16_kernel", *WG_BF16),
                    bf16=True)
    return res


def fidelity_options(name: str, hr_dir: Path, lr_dir: Path, seed: int, val_dirs=None,
                     template: Path = FIDELITY_TEMPLATE, **extra):
    """`template` (configs/_templates/train/SwinIR/swinir_m_fidelity.yml unless
    said: compute_dtype bfloat16, SwinIR-M 4x, batch 8 of 48x48 LR crops, L1
    + MS-SSIM, AdamW 2e-4, EMA 0.999, its MultiStepLR; its TensorBoard
    logger writes under chiprun_out/chip_smoke/tb_logger) as shipped, on
    `hr_dir` / `lr_dir`, TRAIN_STEPS steps; with `val_dirs` (HR, LR) its
    validation (PSNR and SSIM, the fp32
    twin) runs as the template sets it: at the end of training, its
    val_freq not reached in TRAIN_STEPS steps; else none."""
    import yaml

    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    raw = yaml.safe_load(template.read_text())
    raw.update(name=name, manual_seed=seed, num_gpu=1, path={})
    train = {**raw["datasets"]["train"], "dataroot_gt": str(hr_dir), "dataroot_lq": str(lr_dir),
             "io_backend": {"type": "disk"}, "num_worker_per_gpu": 4}
    raw["datasets"] = {"train": train}
    if val_dirs:
        raw["datasets"]["val"] = {"name": "val dataset", "type": "pairedimagedataset",
                                  "dataroot_gt": str(val_dirs[0]), "dataroot_lq": str(val_dirs[1]),
                                  "io_backend": {"type": "disk"}}
    else:
        raw["val"]["val_enabled"] = False
    raw["train"]["total_iter"] = TRAIN_STEPS
    raw["logger"].update(print_freq=PRINT_FREQ, save_checkpoint_freq=1000)
    raw.update(extra)
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=True)


def phase_bf16_train(seed: int) -> dict[str, int]:
    """42. `train.run` of swinir_m_fidelity.yml as shipped: 30 bf16 steps
    from 16 seeded 512x512 HR images, 36 + 36 launches of the bf16 #4/#5 a
    step and none of any fp32 training kernel; every log finite; the
    validation after step 30 runs the fp32 twin (the EMA network in fp32,
    on #1/#2: 36 + 36 launches an image) and logs PSNR/SSIM; the EMA
    checkpoint then serves with the strict load."""
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    val_hr, val_lr = make_dataset(OUT / "data", seed)
    opt = fidelity_options("swinir_m_x4_fidelity_bf16", hr_dir, lr_dir, seed, (val_hr, val_lr))
    return phase_train(seed, "swinir_m", "SwinIR-M bf16 (swinir_m_fidelity.yml)", "bf16 train",
                       per_step=BF16_TRAIN_STEP, lq=FID_LQ, losses=FID_LOSSES, opt=opt,
                       more_launches=lambda: {"fused_attn_block": BLOCKS * N_IMAGES,
                                              "fused_ln_mlp": BLOCKS * N_IMAGES},
                       check=bf16_train_check("bf16 train"))


def bf16_train_check(tag: str):
    """A bf16 training run's check for `phase_train`: the model and network
    compute in bf16, every parameter is fp32, and the validation at the end
    (the fp32 twin) logged a finite PSNR and SSIM."""
    import math

    import torch

    def check(model, opt):
        if model.compute_dtype != torch.bfloat16 or model.net_g.compute_dtype != torch.bfloat16:
            fail(f"{tag}: the model computes in {model.compute_dtype}")
        if any(p.dtype != torch.float32 for p in model.net_g.parameters()):
            fail(f"{tag}: a parameter is not fp32")
        metrics = getattr(model, "metric_results", {})
        if not all(math.isfinite(metrics.get(k, float("nan"))) for k in ("psnr", "ssim")):
            fail(f"{tag}: validation logged no finite PSNR/SSIM: {metrics}")
        say(f"[{tag}] validation after step {model.step} through the fp32 twin: psnr "
            f"{metrics['psnr']:.4f} ssim {metrics['ssim']:.4f}")

    return check


def check_finite_logs(tag: str, model, step: int) -> None:
    """Every log of `model`'s last step is finite."""
    import math

    bad = [k for k, v in model.log_dict.items() if not math.isfinite(float(v))]
    if bad:
        fail(f"[{tag}] logs not finite at step {step}: {bad}")


def phase_bf16_profile(seed: int, template: Path = FIDELITY_TEMPLATE,
                       name: str = "swinir_m_x4_bf16_profile",
                       per_step: dict[str, int] = BF16_TRAIN_STEP, tag: str = "bf16 train profile",
                       file: str = "profile_bf16_train.txt", batch_size: int = TB,
                       kernels: tuple[str, ...] = (),
                       sums: dict[str, tuple[str, ...]] | None = None) -> None:
    """43 (and 49, 51). Device time by kernel of one bf16 step of
    `template`'s run (after two warm-up steps; `batch_size` 48x48 LR crops),
    its busy share and launches (`per_step` and no others), the bf16 forms'
    stages summed, the hand-written kernels' time against the rest, and each
    of `sums`' labels with the time of the kernels whose names hold one of
    its names; the table to chip_smoke/`file`. The logs of the warm-up,
    profiled and last steps must be finite; a profiled kernel's name must
    hold each of `kernels`."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch.models import build_model

    opt = fidelity_options(name, OUT, OUT, seed, template=template)
    model = build_model(opt, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)
    batch = {"lq": rng.integers(0, 256, (batch_size, FID_LQ, FID_LQ, 3), dtype=np.uint8),
             "gt": rng.integers(0, 256, (batch_size, 4 * FID_LQ, 4 * FID_LQ, 3),
                                dtype=np.uint8)}
    for i in range(2):
        model.feed_data(batch)
        model.optimize_parameters(i + 1)
        check_finite_logs(tag, model, i + 1)
    torch.cuda.synchronize()
    reset_counts()
    model.feed_data(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.optimize_parameters(3)
        torch.cuda.synchronize()
    check_finite_logs(tag, model, 3)
    check_counts(f"{tag} step", read_counts(), per_step)
    events = device_events(prof)
    check_retired(tag, events)
    total = sum(e.self_device_time_total for e in events)
    if total == 0:
        fail(f"[{tag}] the profiler recorded no device time")
    peak = torch.cuda.max_memory_allocated()
    (OUT / file).write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    t0 = time.perf_counter()
    for i in range(3):
        model.feed_data(batch)
        model.optimize_parameters(4 + i)
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / 3
    check_finite_logs(tag, model, 6)
    check_profiled(tag, "the step", events, kernels)
    by_stage: dict[str, float] = {}
    for e in events:
        bf = "bf16" in e.key or "bfloat16" in e.key
        st = stage_of(e.key) if "trr::" in e.key and bf else "other"
        by_stage[st] = by_stage.get(st, 0.0) + e.self_device_time_total / 1e3
    own = sum(e.self_device_time_total for e in events if "trr::" in e.key) / 1e3
    say(f"[{tag}] the hand-written kernels {own:.3f} ms of the step's device time, the rest "
        f"{total / 1e3 - own:.3f} ms")
    for label, parts in (sums or {}).items():
        mine = [e for e in events if any(p in e.key for p in parts)]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        say(f"[{tag}] {label}: {ms:.3f} device ms a step over {sum(e.count for e in mine)} "
            f"launches, {100 * ms / (total / 1e3):.1f}% of the step's")
    say(f"[{tag}] device time per step {total / 1e3:.3f} ms over "
        f"{sum(e.count for e in events)} kernel launches; step {step * 1e3:.1f} ms without the "
        f"profiler (the card busy {total / 1e6 / step:.1%} of it); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; the bf16 forms' stages: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by_stage.items(), key=lambda kv: -kv[1])))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        say(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  "
            f"{e.key[:90]}")
    return total / 1e3, step * 1e3


class _PlainBf16Block:
    """`fused_swin_block_train` with the bf16 plain versions on the card, for
    the branch check: an autograd Function whose forward and backward are
    `fused_swin_block_train_bf16_reference` and its backward's."""

    def __init__(self, fb):
        import torch

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, *rest):
                params, meta = rest[:15], rest[15:]
                out, P, att, z = fb.fused_swin_block_train_bf16_reference(x, *params, *meta)
                ctx.save_for_backward(x, *params, P, att, z)
                ctx.meta = meta
                return out

            @staticmethod
            def backward(ctx, dout):
                x, *params, P, att, z = ctx.saved_tensors
                ops = [x] + [t for i, t in enumerate(params[:13]) if i != 6] + params[13:]
                grads = fb.fused_swin_block_train_bwd_bf16_reference(
                    *ops, P, att, z, dout, params[6].shape[0], *ctx.meta)
                return (*grads, None, None, *([None] * len(ctx.meta)))

        self.fn = Fn

    def __call__(self, x, *rest, shift=0):
        return self.fn.apply(x, *rest, shift)


@contextmanager
def bf16_plain_versions(network: str):
    """For the body, the bf16 forms that `network`'s training step runs are
    replaced by their bf16 plain versions, on the card: #4/#5's for
    SwinIR-M, #11-#14's for Swin2SR-M, #3/#8's and #2/#7's for the others."""
    from trainner_redux_tpu_torch.archs import swinir_arch
    from trainner_redux_tpu_torch.ops import fused_block as fb
    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2
    from trainner_redux_tpu_torch.ops import window_attention as wa

    if network == "swinir_m":
        patches = [(swinir_arch, "fused_swin_block_train", _PlainBf16Block(fb))]
    elif network == "swin2sr_m":
        patches = [(v2, f"{half}{part}_bf16", getattr(v2, f"{half}{ref}_bf16_reference"))
                   for half in ("fused_cos_attn_block", "fused_postnorm_mlp")
                   for part, ref in (("", ""), ("_backward", "_bwd"))]
    else:
        patches = [(mod, name, getattr(mod, ref)) for mod, name, ref in (
            (wa, "fused_window_mhsa_bf16", "fused_window_mhsa_bf16_reference"),
            (wa, "fused_window_mhsa_backward_bf16", "fused_window_mhsa_bwd_bf16_reference"),
            (wa, "fused_rect_mhsa_bf16", "fused_rect_mhsa_bf16_reference"),
            (wa, "fused_rect_mhsa_backward_bf16", "fused_rect_mhsa_bwd_bf16_reference"),
            (fb, "fused_ln_mlp_bf16", "fused_ln_mlp_bf16_reference"),
            (fb, "fused_ln_mlp_backward_bf16", "fused_ln_mlp_bwd_bf16_reference"))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_bf16_branches(seed: int, network: str = "swinir_m", label: str = "SwinIR-M",
                        template: Path = FIDELITY_TEMPLATE, tag: str = "bf16 branches",
                        kernel_step: dict[str, int] = BF16_TRAIN_STEP,
                        fp32_step: dict[str, int] | None = None,
                        tensor_check: bool = True) -> None:
    """44 (and 49, 56). One bf16 step of `template`'s network (SwinIR-M: batch 8
    of 48x48 LR, L1 + MS-SSIM) from equal weights, DropPath generators and
    batch, through the bf16 kernels (`kernel_step` launches), through their
    bf16 plain versions on the card (`bf16_plain_versions`; everything else
    the same), and, as the yardstick of bf16 itself, through the fp32
    kernels (`fp32_step`): the losses within BF16_BRANCH_LOSS_TOL of each
    other (relative). The gradients sum bf16-rounded gradients of random
    sign over every pixel through 36 blocks, so bf16 moves a first layer's
    by some 6% of its largest from fp32, and a value at a rounding tie that
    the two branches round apart moves them as far: over all parameters the
    kernel branch lies within BF16_BRANCH_RATIO of the plain branch's
    distance from the fp32 step (L2 over every gradient), and per tensor
    within BF16_TENSOR_RATIO of the plain branch's largest distance from it
    (plus BRANCH_GRAD_TOL of the tensor's largest). Without `tensor_check`
    (phase 49) the per-tensor ratio is printed and not held: HAT's
    channel-attention convolutions and DAT's position MLPs take sums of
    terms of random sign that nearly cancel (HAT's SE convolutions some
    1e-6 of their block's largest gradient), on which two bf16 computations
    differ by their terms' roundings, not by a share of the sum; the L2
    distance over every parameter holds them. Then two `deterministic:
    true` bf16 steps bit for bit."""
    import copy

    import numpy as np
    import torch

    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.models import build_model
    from trainner_redux_tpu_torch.models.sr_model import fp32_math

    fp32_step = fp32_step or {"fused_swin_block_train": BLOCKS,
                              "fused_swin_block_train_backward": BLOCKS}
    net = build_network_cast({"type": network, "scale": 4}, torch.bfloat16)
    net = net.init_weights(torch.Generator().manual_seed(seed)).cuda().train()
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(TB, 3, FID_LQ, FID_LQ, generator=gen).cuda()
    gt = torch.rand(TB, 3, 4 * FID_LQ, 4 * FID_LQ, generator=gen).cuda()
    opt = fidelity_options(f"{network}_x4_bf16_branches", OUT, OUT, seed, template=template)
    losses_fn = build_model(opt, device="cuda")._generator_losses
    results = {}
    for branch in ("kernel", "plain", "fp32"):
        m = copy.deepcopy(net)
        if branch == "fp32":
            m.compute_dtype = torch.float32
        m.set_dropout_generator(torch.Generator(device="cuda").manual_seed(seed))
        with fp32_math(), bf16_plain_versions(network) if branch == "plain" else nullcontext():
            reset_counts()
            loss = losses_fn(m(x), gt)[0]
            loss.backward()
            torch.cuda.synchronize()
            counts = read_counts()
        want = {"kernel": kernel_step, "plain": {}, "fp32": fp32_step}[branch]
        check_counts(f"{tag} {label} ({branch})", counts, want)
        # a parameter the step does not reach (DAT's BatchNorm statistics in
        # train mode) has a zero gradient, as SRModel hands it to AdamW
        results[branch] = (loss.item(), {k: torch.zeros_like(p) if p.grad is None else p.grad
                                         for k, p in m.named_parameters()})
        say(f"[{tag}] {label} {branch}: loss {loss.item():.6f}, launches {counts}")
    (lk, gk), (lp, gp), (lf, gf) = results["kernel"], results["plain"], results["fp32"]
    rel = abs(lk - lp) / abs(lp)
    if not rel <= BF16_BRANCH_LOSS_TOL:
        fail(f"{tag} {label}: loss differs by {rel:.3g} (relative) between the kernels and the "
             "plain versions")
    worst = (0.0, "")
    for k, w in gp.items():
        top = w.abs().max().item()
        diff, noise = (gk[k] - w).abs().max().item(), (w - gf[k]).abs().max().item()
        worst = max(worst, (diff / max(noise, 1e-30), k))
        if tensor_check and not diff <= BF16_TENSOR_RATIO * noise + BRANCH_GRAD_TOL * top:
            fail(f"{tag} {label}: gradient of {k} differs by {diff:.3g} between the kernels and "
                 f"the plain versions; bf16 and fp32 differ by {noise:.3g} (max {top:.3g})")

    def dist(a, b):
        return sum(((a[k] - b[k]).double() ** 2).sum().item() for k in b) ** 0.5

    dk, dp = dist(gk, gf), dist(gp, gf)
    if not dk <= BF16_BRANCH_RATIO * dp:
        fail(f"{tag} {label}: the kernels' gradients lie {dk:.4g} from the fp32 step's, the "
             f"plain versions' {dp:.4g} (L2 over every parameter)")
    say(f"[{tag}] {label} losses: kernels {lk:.6f}, plain versions {lp:.6f} (rel {rel:.3g}, tol "
        f"{BF16_BRANCH_LOSS_TOL}), fp32 {lf:.6f}; gradients' L2 distance from the fp32 step: "
        f"kernels {dk:.4g}, plain versions {dp:.4g} (ratio {dk / dp:.3f}, tol "
        f"{BF16_BRANCH_RATIO}); per tensor the kernel-plain difference at most {worst[0]:.3f} "
        f"of the plain-fp32 one ({worst[1]}; "
        f"{f'tol {BF16_TENSOR_RATIO}' if tensor_check else 'printed, not held'})")

    # two deterministic bf16 steps, bit for bit
    det = fidelity_options(f"{network}_x4_bf16_deterministic", OUT, OUT, seed, template=template,
                           deterministic=True)
    rng = np.random.default_rng(seed)
    batch = {"lq": rng.integers(0, 256, (TB, FID_LQ, FID_LQ, 3), dtype=np.uint8),
             "gt": rng.integers(0, 256, (TB, 4 * FID_LQ, 4 * FID_LQ, 3), dtype=np.uint8)}
    runs = []
    for _ in range(2):
        model = build_model(det, device="cuda")
        reset_counts()
        for i in range(2):
            model.feed_data(batch)
            try:
                model.optimize_parameters(i + 1)
            except RuntimeError as e:
                fail(f"{label} bf16 with deterministic: true: {e}")
        torch.cuda.synchronize()
        check_counts(f"{label} bf16 deterministic", read_counts(),
                     {k: 2 * v for k, v in kernel_step.items()})
        runs.append((model.log_dict["l_g_total"].item(),
                     [p.detach().clone() for p in model.net_g.parameters()]))
        del model
        torch.cuda.empty_cache()
    (la, pa), (lb, pb) = runs
    if la != lb or not all(torch.equal(a, b) for a, b in zip(pa, pb)):
        fail(f"{label} bf16 with deterministic: true: two runs differ (loss {la!r} against "
             f"{lb!r})")
    say(f"[{tag}] {label} deterministic: two bf16 steps twice, bit for bit in the loss "
        f"({la:.6f}) and all {len(pa)} parameters")


# ---------------------------------------------------------------------------
# 45-49. bf16 window attention and LN-MLP: HAT, DAT and SwinIR-L training
# ---------------------------------------------------------------------------

# SwinIR-L's blocks: C 240, 8 heads of 30, 8x8 windows (the unfused branch:
# C 240 is above the training block's 192); 54 blocks a forward
SLC, SLNH = 240, 8
SLHD = SLC // SLNH
SWINIR_L_BLOCKS = 54
TEMPLATES = ROOT / "configs" / "_templates" / "train"


def bf16_f64_check(tag: str, what: str, got, want, exact) -> float:
    """The kernel's and the plain version's errors against the float64
    result `exact` of the same bf16 inputs: the kernel's at most F64_RATIO
    times the plain version's plus F64_FLOOR of the largest; returns their
    ratio."""
    top = exact.abs().max().item()
    ke = (got.double() - exact).abs().max().item()
    pe = (want.double() - exact).abs().max().item()
    if not ke <= F64_RATIO * pe + F64_FLOOR * top:
        fail(f"[{tag}] {what} against float64: kernel {ke:.3g}, plain {pe:.3g} of {top:.3g} (the "
             f"kernel may be at most {F64_RATIO}x the plain version's + {F64_FLOOR} of the "
             "largest)")
    say(f"[{tag}] {what} against float64: kernel {ke:.3g}, plain {pe:.3g} of {top:.3g}")
    return ke / max(pe, 1e-30)


def bf16_record(res: dict, tag: str, name: str, label: str, kern, plain, fp32, lib,
                flops: float, nb: float, err: float, rel: float) -> None:
    """Time a checked bf16 form beside its plain version, its fp32 form and
    the library call; print them with the bf16 bound (989 TFLOP/s, 3.35
    TB/s) and keep them in `res[name]` (the last case of a name is the JSON
    line's)."""
    ms, fp32_ms = time_ms(kern, iters=10, warmup=2), time_ms(fp32, iters=10, warmup=2)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    lib_ms = time_ms(lib, iters=10, warmup=2) if lib is not None else None
    bms, by = bound(flops, nb, PEAK_BF16)
    say(f"[{tag}] {name} {label}: max_abs_err {err:.3g} ({rel:.3g} of its tensor's largest), "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, fp32 form {fp32_ms:.4f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms (bf16 SDPA, float mask)'}; bf16 bound "
        f"{bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB), "
        f"{100 * bms / ms:.1f}% of the kernel's time")
    rec = res.setdefault(name, {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)


def bf16_window_case(res: dict, names: tuple[str, str], label: str, shape, wr: int, wc: int,
                     kinds: int, nh: int, hd: int, shift_hw, gen, split: dict | None) -> None:
    """#3's and #8's bf16 forms at one block: bf16 qkv and dout, the fp32
    kind table (with the shift masks of `shift_hw` at K=4); each output and
    gradient against its bf16 plain version (`check_bf16`) and, with the
    plain version, against float64 of the same bf16 inputs; two runs of each
    bit for bit; timed beside the fp32 forms and bf16 SDPA with a float mask
    (forward, and forward and backward); `split`, the backward's stages a
    call: the backward's stage split, and the forward's. #8's bf16 form at
    heads of up to 32 allocates no per-window dS: the call's peak memory
    above its inputs stays within its outputs and grouped scratch (the
    groups' dbias sums, the row stats)."""
    import torch
    import torch.nn.functional as F

    from trainner_redux_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    b, h, w = shape
    c, n = nh * hd, wr * wc
    square = wr == wc
    qkv = torch.randn(b, h, w, 3 * c, generator=gen).to(dev).bfloat16()
    rel = (torch.randn(nh, n, n, generator=gen) * 0.5).to(dev)
    if kinds == 4:
        masks = wa.rect_shift_mask_kinds(wr, wc, *shift_hw)
        bias = (rel[None] + torch.from_numpy(masks).to(dev)[:, None]).contiguous()
    else:
        bias = rel[None].contiguous()
    dout = torch.randn(b, h, w, c, generator=gen).to(dev).bfloat16()
    win = (wr,) if square else (wr, wc)
    if square:
        fwd_k, fwd_p, fwd_32 = wa.fused_window_mhsa_bf16, wa.fused_window_mhsa_bf16_reference, \
            wa.fused_window_mhsa
        bwd_k, bwd_p, bwd_32 = (wa.fused_window_mhsa_backward_bf16,
                                wa.fused_window_mhsa_bwd_bf16_reference,
                                wa.fused_window_mhsa_backward)
    else:
        fwd_k, fwd_p, fwd_32 = wa.fused_rect_mhsa_bf16, wa.fused_rect_mhsa_bf16_reference, \
            wa.fused_rect_mhsa
        bwd_k, bwd_p, bwd_32 = (wa.fused_rect_mhsa_backward_bf16,
                                wa.fused_rect_mhsa_bwd_bf16_reference,
                                wa.fused_rect_mhsa_backward)
    qkv32, dout32 = qkv.float(), dout.float()
    tag = "bf16 window kernels"
    try:
        got, again = fwd_k(qkv, bias, nh, hd, *win), fwd_k(qkv, bias, nh, hd, *win)
        grads, grads2 = (bwd_k(qkv, bias, dout, nh, hd, *win),
                         bwd_k(qkv, bias, dout, nh, hd, *win))
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"{names[0]} {label}: {e}")
    if wa.window_bwd_grouped(hd, wr, wc):  # no per-window dS: the peak within the scratch
        part, stats = wa.window_bwd_scratch_floats(b, h, w, nh, kinds, wr, wc)
        own = nbytes(*grads) + 4 * (part + stats)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bwd_k(qkv, bias, dout, nh, hd, *win)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        dS = 4 * b * (h // wr) * (w // wc) * nh * n * n
        if extra > own + (1 << 21):
            fail(f"{names[1]} {label}: the call's peak {extra} bytes past its outputs and scratch "
                 f"({own})")
        say(f"[{tag}] {names[1]} {label}: peak {extra / 1e6:.1f} MB above the inputs (outputs "
            f"and grouped scratch {own / 1e6:.1f} MB; a per-window dS would be {dS / 1e6:.1f} "
            "MB)")
    want, plain_grads = fwd_p(qkv, bias, nh, hd, *win), bwd_p(qkv, bias, dout, nh, hd, *win)
    fwd_err = check_bf16(tag, f"{names[0]} {label} out", got, want)
    bwd_err = [check_bf16(tag, f"{names[1]} {label} {part}", g, p_)
               for part, g, p_ in zip(("dqkv", "dbias"), grads, plain_grads)]
    if not torch.equal(got, again) or not all(torch.equal(x, y) for x, y in zip(grads, grads2)):
        fail(f"{names[0]} {label}: two runs differ")
    if got.dtype != torch.bfloat16 or grads[0].dtype != torch.bfloat16:
        fail(f"{names[0]} {label}: out {got.dtype}, dqkv {grads[0].dtype}, expected bf16")
    # float64 of the same bf16 inputs, autograd for the gradients
    q64, b64 = qkv.double().requires_grad_(), bias.double().requires_grad_()
    exact = window_mhsa_f64(q64, b64, nh, hd, wr, wc)
    exact_g = torch.autograd.grad(exact, (q64, b64), dout.double())
    ratio = max(bf16_f64_check(tag, f"{name} {label} {part}", g, p_, e.detach())
                for name, part, g, p_, e in (
                    (names[0], "out", got, want, exact),
                    (names[1], "dqkv", grads[0], plain_grads[0], exact_g[0]),
                    (names[1], "dbias", grads[1], plain_grads[1], exact_g[1])))
    say(f"[{tag}] {label}: #3 bf16 within {fwd_err[1]:.3g} of out's largest, #8 bf16 within "
        f"{max(e[1] for e in bwd_err):.3g} of each gradient's; against float64 at most "
        f"{ratio:.3f}x the plain versions' error; two runs of each bit for bit")
    q, k, v, mask = sdpa_windows(qkv, bias, wr, wc, kinds, nh, hd)
    mask = mask.bfloat16()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    gwin = dout.reshape(b, h // wr, wr, w // wc, wc, nh, hd)
    gwin = gwin.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, nh, n, hd).contiguous()

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        return torch.autograd.grad(out, (qg, kg, vg), gwin)

    tokens = b * h * w
    fwd_flops, bwd_flops = 4 * tokens * n * c, 10 * tokens * n * c
    fwd_bytes, bwd_bytes = nbytes(qkv, bias, got), nbytes(qkv, bias, dout, *grads)
    bf16_record(res, tag, names[0], label, lambda: fwd_k(qkv, bias, nh, hd, *win),
                lambda: fwd_p(qkv, bias, nh, hd, *win),
                lambda: fwd_32(qkv32, bias, nh, hd, *win),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                fwd_flops, fwd_bytes, *fwd_err)
    bf16_record(res, tag, names[1], label, lambda: bwd_k(qkv, bias, dout, nh, hd, *win),
                lambda: bwd_p(qkv, bias, dout, nh, hd, *win),
                lambda: bwd_32(qkv32, bias, dout32, nh, hd, *win), lib_fwd_bwd,
                bwd_flops, bwd_bytes, max(e[0] for e in bwd_err), max(e[1] for e in bwd_err))
    if split is not None:
        rb, ks = wa.tc_attn_plan(n, hd)
        if wa.head_width(hd) == wa.HD_MAX:  # the 128-wide form's kernels
            kb, kr, kks = wa.TC_ATTN_KEY_PLAN_128
            fb, fk = wa.TC_ATTN_FWD_PLAN_128
            fwd_name = f"attn_wide_fwd_kernel<{n}, {fb}, {fk}, __nv_bfloat16>"
            bwd_names = (f"attn_wide_bwd_rows_kernel<{n}, {rb}, {ks}, __nv_bfloat16>",
                         f"attn_wide_bwd_keys_kernel<{n}, {kb}, {kr}, {kks}, __nv_bfloat16>")
        else:
            plan = f"{n}, {rb}, {ks}, false, {wa.head_width(hd)}"
            fwd_name = f"attn_rows_fwd_bf16_kernel<{plan}>"
            if wa.window_bwd_grouped(hd, wr, wc):  # csrc/attn_group_bf16.cuh
                bwd_names = GROUP_BWD_256 if n == wa.PASS_N else GROUP_BWD_WHOLE
            else:
                bwd_names = (f"attn_rows_bwd_recompute_bf16_kernel<{n}, {rb}, {ks}, "
                             f"{wa.head_width(hd)}>",)
        stage_split(tag, f"{names[0]} {label}", lambda: fwd_k(qkv, bias, nh, hd, *win),
                    fwd_flops, fwd_bytes, res[names[0]]["ms"], STAGES_3, kernels=(fwd_name,),
                    bf16=True)
        stage_split(tag, f"{names[1]} {label}", lambda: bwd_k(qkv, bias, dout, nh, hd, *win),
                    bwd_flops, bwd_bytes, res[names[1]]["ms"], split, kernels=bwd_names,
                    bf16=True)


def mlp_f64(x, g, be, w1, b1, w2, b2, s):
    """#2's function in float64 (for autograd): x + s fc2(gelu(fc1(LN x)))."""
    import torch.nn.functional as F

    b, h, w, c = x.shape
    t = x.reshape(-1, c)
    m = F.gelu(F.layer_norm(t, (c,), g, be, 1e-5) @ w1 + b1) @ w2 + b2
    return (t + s.double().repeat_interleave(h * w)[:, None] * m).reshape(x.shape)


def phase_bf16_window_kernels() -> dict:
    """45. The bf16 forms of #3/#8 and #2/#7 at each bf16 path's shapes (see
    the module doc): HAT-M's block, DAT's branches, SwinIR-L's block, each
    K=4 case split by stage; the MLP half at HAT-M's block with DropPath
    scales holding 0 and 1/0.9, and at SRFormerV2's C 240 / hidden 480."""
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(45)
    res: dict[str, dict] = {}
    tag = "bf16 window kernels"
    hat = (TB, FID_LQ, FID_LQ)
    # HAT-M: ws 16 (the JSON line's case: K=4, shifted by 8)
    for kinds in (1, 4):
        bf16_window_case(res, ("fused_window_mhsa_bf16", "fused_window_mhsa_backward_bf16"),
                         f"HAT-M ws 16 K={kinds}", hat, HWS, HWS, kinds, NH, HD,
                         (HWS // 2, HWS // 2), gen, STAGES_8_PASSES if kinds == 4 else None)
    # SwinIR-L: ws 8 at C 240
    for kinds in (1, 4):
        bf16_window_case(res, ("fused_window_mhsa_bf16_ws8", "fused_window_mhsa_backward_bf16_ws8"),
                         f"SwinIR-L ws 8 C 240 K={kinds}", hat, WS, WS, kinds, SLNH, SLHD,
                         (WS // 2, WS // 2), gen, STAGES_8_WHOLE if kinds == 4 else None)
    # DAT: its 90-channel branches at the crop's qkv padded to 64x64, and
    # dat_s's 8x16 at 48x48 (the JSON line's case: 8x32, K=4)
    for (wr, wc), kinds, size in (((32, 8), 4, TH), ((8, 16), 4, FID_LQ), ((8, 32), 1, TH),
                                  ((8, 32), 4, TH)):
        bf16_window_case(res, ("fused_rect_mhsa_bf16", "fused_rect_mhsa_backward_bf16"),
                         f"DAT {wr}x{wc} K={kinds}", (TB, size, size), wr, wc, kinds, DNH, DHD,
                         DAT_WINDOWS[(wr, wc)], gen,
                         None if kinds == 1 else STAGES_8_PASSES if wr * wc == 256
                         else STAGES_8_WHOLE)

    # the MLP half (#2, #7) at HAT-M's block
    x32, p, _, _ = block_inputs(gen, 1, dev, shape=hat)
    x = x32.bfloat16()
    s = torch.full((TB,), 1.0 / 0.9, device=dev)
    s[3] = 0.0
    params = [p[k] for k in ("g", "be", "w1", "b1", "w2", "b2")]
    dout = torch.randn(*hat, C, generator=gen).to(dev).bfloat16()

    def fwd():
        return fb.fused_ln_mlp_bf16(x, *params, s, HWS)

    def bwd():
        return fb.fused_ln_mlp_backward_bf16(x, *params, s, dout, HWS)

    try:
        got, again, grads, grads2 = fwd(), fwd(), bwd(), bwd()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"fused_ln_mlp_bf16 / fused_ln_mlp_backward_bf16: {e}")
    want = fb.fused_ln_mlp_bf16_reference(x, *params, s, HWS)
    plain_grads = fb.fused_ln_mlp_bwd_bf16_reference(x, *params, s, dout, HWS)
    names = ("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2")
    fwd_err = check_bf16(tag, "fused_ln_mlp_bf16 out", got, want)
    bwd_err = [check_bf16(tag, f"fused_ln_mlp_backward_bf16 {n}", g, w)
               for n, g, w in zip(names, grads, plain_grads)]
    if not torch.equal(got, again) or not all(torch.equal(a, b) for a, b in zip(grads, grads2)):
        fail("fused_ln_mlp_bf16 / fused_ln_mlp_backward_bf16: two runs differ")
    leaves = [x.double().requires_grad_()] + [
        (fb._bf(t) if k in ("w1", "w2") else t).double().requires_grad_()
        for k, t in zip(("g", "be", "w1", "b1", "w2", "b2"), params)]
    exact = mlp_f64(*leaves, s)
    exact_g = torch.autograd.grad(exact, leaves, dout.double())
    ratio = max([bf16_f64_check(tag, "fused_ln_mlp_bf16 out", got, want, exact.detach())]
                + [bf16_f64_check(tag, f"fused_ln_mlp_backward_bf16 {n}", g, w, e)
                   for n, g, w, e in zip(names, grads, plain_grads, exact_g)])
    say(f"[{tag}] MLP half at HAT-M's block: #2 bf16 within {fwd_err[1]:.3g} of out's largest, "
        f"#7 bf16 within {max(e[1] for e in bwd_err):.3g} of each gradient's; against float64 at "
        f"most {ratio:.3f}x the plain versions' error; two runs of each bit for bit")
    x32c = x.float()
    dout32 = dout.float()
    T = TB * FID_LQ * FID_LQ
    fwd_bytes = nbytes(x, *params, s, got)
    bwd_bytes = nbytes(x, *params, s, dout, *grads)
    bf16_record(res, tag, "fused_ln_mlp_bf16", "HAT-M", fwd,
                lambda: fb.fused_ln_mlp_bf16_reference(x, *params, s, HWS),
                lambda: fb._ln_mlp_fwd_cuda(x32c, *params, s, HWS, 1e-5), None,
                4 * T * C * HIDDEN, fwd_bytes, *fwd_err)
    bf16_record(res, tag, "fused_ln_mlp_backward_bf16", "HAT-M", bwd,
                lambda: fb.fused_ln_mlp_bwd_bf16_reference(x, *params, s, dout, HWS),
                lambda: fb.fused_ln_mlp_backward(x32c, *params, s, dout32, HWS), None,
                10 * T * C * HIDDEN, bwd_bytes, max(e[0] for e in bwd_err),
                max(e[1] for e in bwd_err))
    stage_split(tag, "fused_ln_mlp_bf16 HAT-M", fwd, 4 * T * C * HIDDEN, fwd_bytes,
                res["fused_ln_mlp_bf16"]["ms"], STAGES_2,
                kernels=("ln_rows_bf16_kernel", "linear_bf16_kernel"), bf16=True)
    stage_split(tag, "fused_ln_mlp_backward_bf16 HAT-M", bwd, 10 * T * C * HIDDEN, bwd_bytes,
                res["fused_ln_mlp_backward_bf16"]["ms"], STAGES_7_BF16,
                kernels=("mlp_hidden_bf16_kernel", "rows_bf16_kernel", *WG_BF16),
                bf16=True)

    # the MLP half at SRFormerV2's block (C 240, hidden 480: the 256-column
    # rows tile), which no bf16 path runs yet: checked and timed
    xw32, pw, _, _ = block_inputs(gen, 1, dev, shape=(TB, SRF_PAD, SRF_PAD), widths=SRF_WIDTHS)
    xw = xw32.bfloat16()
    pws = [pw[k] for k in ("g", "be", "w1", "b1", "w2", "b2")]
    sw = torch.ones(TB, device=dev)
    doutw = torch.randn(TB, SRF_PAD, SRF_PAD, SC, generator=gen).to(dev).bfloat16()
    try:
        gw = [fb.fused_ln_mlp_bf16(xw, *pws, sw, SWS),
              *fb.fused_ln_mlp_backward_bf16(xw, *pws, sw, doutw, SWS)]
        again = [fb.fused_ln_mlp_bf16(xw, *pws, sw, SWS),
                 *fb.fused_ln_mlp_backward_bf16(xw, *pws, sw, doutw, SWS)]
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - report and fail the phase
        fail(f"fused_ln_mlp_bf16 at C 240: {e}")
    ww = [fb.fused_ln_mlp_bf16_reference(xw, *pws, sw, SWS),
          *fb.fused_ln_mlp_bwd_bf16_reference(xw, *pws, sw, doutw, SWS)]
    rel = max(check_bf16(tag, f"MLP half at C 240 {n}", g, w)[1]
              for n, g, w in zip(("out",) + names, gw, ww))
    if not all(torch.equal(a, b) for a, b in zip(gw, again)):
        fail("fused_ln_mlp_bf16 / fused_ln_mlp_backward_bf16 at C 240: two runs differ")
    tw = TB * SRF_PAD * SRF_PAD
    ms_f = time_ms(lambda: fb.fused_ln_mlp_bf16(xw, *pws, sw, SWS), iters=10, warmup=2)
    ms_b = time_ms(lambda: fb.fused_ln_mlp_backward_bf16(xw, *pws, sw, doutw, SWS), iters=10,
                   warmup=2)
    bf, _ = bound(4 * tw * SC * SHIDDEN, nbytes(xw, *pws, sw, gw[0]), PEAK_BF16)
    bb, _ = bound(10 * tw * SC * SHIDDEN, nbytes(xw, *pws, sw, doutw, *gw[1:]), PEAK_BF16)
    say(f"[{tag}] MLP half at SRFormerV2's block (B=8, 72x72, C 240, hidden 480): within "
        f"{rel:.3g} of each tensor's largest, two runs bit for bit; #2 bf16 {ms_f:.4f} ms (bound "
        f"{bf:.4f}), #7 bf16 {ms_b:.4f} ms (bound {bb:.4f})")
    return res


# the bf16 training runs of phases 46-48: template, network, label, the
# bf16 forms' launches a step, and the fp32 twin's launches an image (its
# validation and the served EMA checkpoint)
BF16_RUNS = {
    "hat": (TEMPLATES / "HAT" / "hat_m_fidelity.yml", "hat_m", "HAT-M",
            {"fused_window_mhsa_bf16": HAT_BLOCKS, "fused_window_mhsa_backward_bf16": HAT_BLOCKS,
             "fused_ln_mlp_bf16": HAT_MLPS, "fused_ln_mlp_backward_bf16": HAT_MLPS},
            {"fused_window_mhsa": HAT_BLOCKS, "fused_ln_mlp": HAT_MLPS}),
    "dat": (TEMPLATES / "DAT" / "dat_fidelity.yml", "dat", "DAT",
            {"fused_rect_mhsa_bf16": DAT_RECT, "fused_rect_mhsa_backward_bf16": DAT_RECT},
            {"fused_rect_mhsa": DAT_RECT}),
    # SwinIR-L trains on SwinBlock's unfused branch: #3/#8, and its MLP
    # halves on #2/#7 (C 240 / hidden 480)
    "swinir_l": (TEMPLATES / "SwinIR" / "swinir_l_fidelity.yml", "swinir_l", "SwinIR-L",
                 {"fused_window_mhsa_bf16": SWINIR_L_BLOCKS,
                  "fused_window_mhsa_backward_bf16": SWINIR_L_BLOCKS,
                  "fused_ln_mlp_bf16": SWINIR_L_BLOCKS,
                  "fused_ln_mlp_backward_bf16": SWINIR_L_BLOCKS},
                 {"fused_attn_block": SWINIR_L_BLOCKS, "fused_ln_mlp": SWINIR_L_BLOCKS}),
}


def phase_bf16_family_train(seed: int, family: str) -> dict[str, int]:
    """46-48. `train.run` of a family's fidelity template as shipped
    (BF16_RUNS: compute_dtype bfloat16, batch 8 of 48x48 LR, L1 + MS-SSIM,
    AdamW 2e-4, EMA 0.999, its validation), 30 bf16 steps from 16 seeded
    512x512 HR images: its bf16 forms' launches a step and none of any fp32
    training kernel; every log finite; the validation after step 30 runs
    the fp32 twin on the serving kernels and logs PSNR/SSIM; the EMA
    checkpoint then serves with the strict load."""
    template, network, label, per_step, per_image = BF16_RUNS[family]
    tag = f"{family} bf16 train"
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    val_hr, val_lr = make_dataset(OUT / "data", seed)
    opt = fidelity_options(f"{network}_x4_fidelity_bf16", hr_dir, lr_dir, seed, (val_hr, val_lr),
                           template=template)
    serving = {k: v * N_IMAGES for k, v in per_image.items()}
    return phase_train(seed, network, f"{label} bf16 ({template.name})", tag, per_step=per_step,
                       serve_want=serving, lq=FID_LQ, losses=FID_LOSSES, opt=opt,
                       more_launches=lambda: serving, check=bf16_train_check(tag))


def phase_bf16_family_profile_branches(seed: int, family: str) -> None:
    """49. For HAT-M and DAT: their bf16 step's profile (phase 43's: device
    ms by kernel, the bf16 forms' stages summed, the busy share, peak
    memory) and branches (phase 44's: the bf16 kernels, their bf16 plain
    versions and the fp32 kernels from equal weights; two deterministic
    bf16 steps twice, bit for bit)."""
    template, network, label, per_step, per_image = BF16_RUNS[family]
    phase_bf16_profile(seed, template, f"{network}_x4_bf16_profile", per_step,
                       f"{family} bf16 profile", f"profile_{family}_bf16_train.txt",
                       kernels=GROUP_BWD_256,
                       sums={"#8 bf16 (row pass, key pass, group sums)": GROUP_BWD_256})
    fp32_step = {k.removesuffix("_bf16"): v for k, v in per_step.items()}
    phase_bf16_branches(seed, network, label, template, f"{family} bf16 branches", per_step,
                        fp32_step, tensor_check=False)


# ---------------------------------------------------------------------------
# 50-53. bf16 SRFormerV2, GAN and OTF
# ---------------------------------------------------------------------------

SRF_BF16_TEMPLATE = TEMPLATES / "SRFormerV2" / "srformerv2_fidelity.yml"
SRF_BF16_B = 16  # the template's batch
SRF_BF16_STEP = {k: SRF_SWIN for k in ("fused_attn_block_bf16", "fused_attn_block_backward_bf16",
                                       "fused_ln_mlp_bf16", "fused_ln_mlp_backward_bf16")}
# phase 51's run: as BF16_RUNS's (template, network, label, a step's bf16
# launches, the fp32 twin's launches an image)
SRF_BF16_RUN = (SRF_BF16_TEMPLATE, "srformerv2", "SRFormerV2", SRF_BF16_STEP,
                {"fused_attn_block": SRF_SWIN, "fused_ln_mlp": SRF_SWIN})
# the bf16 GAN templates of phase 52 beside swinir_m_gan.yml: their bf16
# forms' launches a G step (D runs no hand-written kernel)
BF16_GANS = {
    "hat_m_gan": (TEMPLATES / "HAT" / "hat_m_gan.yml", BF16_RUNS["hat"][3]),
    "dat_gan": (TEMPLATES / "DAT" / "dat_gan.yml", BF16_RUNS["dat"][3]),
    "srformerv2_gan": (TEMPLATES / "SRFormerV2" / "srformerv2_gan.yml", SRF_BF16_STEP),
}
OTF_BF16_TEMPLATE = TEMPLATES / "SwinIR" / "swinir_m_otf.yml"


def phase_srformerv2_bf16_kernels() -> dict:
    """50. #1's and #6's bf16 forms at SRFormerV2's training block as
    srformerv2_fidelity.yml ships it (B=16, the 48x48 LR crop padded to
    72x72, C 240, 8 heads of 30, 12x12 windows; DropPath scales holding 0
    and 1/0.9), K=1 (the path's) and K=4 shifted by 6, on bf16 x and dout
    with the fp32 parameters: each output and gradient against its bf16
    plain version (`check_bf16`) and, with it, against float64 of the same
    bf16 inputs (wq and wp rounded to bf16, as the forms take them;
    `bf16_f64_check`); two runs of each bit for bit; times beside the plain
    versions' and the fp32 forms' (#1 at 12x12, #6), the bf16 bound and its
    share; at K=1 both split by stage (#1 must run its products on
    linear_tma_bf16_kernel and its window attention on
    attn_group_fwd_bf16_kernel, over groups of windows of one kind; #6's
    attn_group_bwd_bf16_kernel, the window attention over groups of windows
    that sums dbias in the block, dbias_group_sum_kernel and the bf16
    weight-gradient stage)."""
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(50)
    res: dict[str, dict] = {}
    tag = "srformerv2 bf16 kernels"
    shape = (SRF_BF16_B, SRF_PAD, SRF_PAD)
    s = torch.full((SRF_BF16_B,), 1.0 / 0.9, device=dev)
    s[5] = 0.0
    flops = srf_flops(SRF_BF16_B * SRF_PAD * SRF_PAD)
    fwd_flops, bwd_flops = flops["fused_attn_block_ws12"], flops["fused_attn_block_backward"]
    parts = ("dx", "dg", "dbe", "dwq", "dbq", "dwp", "dbp", "dbias")
    # the JSON line reports the last case of each name: K=1, the path's
    for kinds in (4, 1):
        shift = SWS // 2 if kinds == 4 else 0
        label = f"K={kinds} shift {shift}"
        x32, p, bias, _ = block_inputs(gen, kinds, dev, shape, SRF_WIDTHS)
        x = x32.bfloat16()
        dout = torch.randn(*shape, SC, generator=gen).to(dev).bfloat16()
        params = [p[k] for k in ("g", "be", "wq", "bq", "wp", "bp")]
        meta = (SNH, SHD, SWS, 1e-5, shift)

        def fwd():
            return fb.fused_attn_block_bf16(x, *params, bias, s, *meta)

        def bwd():
            return fb.fused_attn_block_backward_bf16(x, *params, bias, s, dout, *meta)

        try:
            got, again, grads, grads2 = fwd(), fwd(), bwd(), bwd()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"fused_attn_block_bf16 / _backward_bf16 {label}: {e}")
        want = fb.fused_attn_block_bf16_reference(x, *params, bias, s, *meta)
        plain_grads = fb.fused_attn_block_bwd_bf16_reference(x, *params, bias, s, dout, *meta)
        fwd_err = check_bf16(tag, f"fused_attn_block_bf16 {label} z", got, want)
        bwd_err = [check_bf16(tag, f"fused_attn_block_backward_bf16 {label} {n}", g, w)
                   for n, g, w in zip(parts, grads, plain_grads)]
        if not torch.equal(got, again) or not all(torch.equal(a, b) for a, b in zip(grads, grads2)):
            fail(f"fused_attn_block_bf16 / _backward_bf16 {label}: two runs differ")
        if got.dtype != torch.bfloat16 or grads[0].dtype != torch.bfloat16:
            fail(f"{label}: z {got.dtype}, dx {grads[0].dtype}, expected bf16")
        leaves = {k: (fb._bf(v) if k in ("wq", "wp") else v).double().requires_grad_()
                  for k, v in zip(("g", "be", "wq", "bq", "wp", "bp"), params)}
        x64, b64 = x.double().requires_grad_(), bias.double().requires_grad_()
        exact = block_half_f64("fused_attn_block", x64, {**leaves, "s": s}, b64, shift, SNH, SWS)
        exact_g = torch.autograd.grad(exact, (x64, *leaves.values(), b64), dout.double())
        ratio = max([bf16_f64_check(tag, f"fused_attn_block_bf16 {label} z", got, want,
                                    exact.detach())]
                    + [bf16_f64_check(tag, f"fused_attn_block_backward_bf16 {label} {n}", g, w, e)
                       for n, g, w, e in zip(parts, grads, plain_grads, exact_g)])
        del exact, exact_g, x64, b64, leaves
        say(f"[{tag}] {label}: #1 bf16 within {fwd_err[1]:.3g} of z's largest, #6 bf16 within "
            f"{max(e[1] for e in bwd_err):.3g} of each gradient's; against float64 at most "
            f"{ratio:.3f}x the plain versions' error; two runs of each bit for bit")
        fwd_bytes = nbytes(x, *params, bias, s, got)
        bwd_bytes = nbytes(x, *params, bias, s, dout, *grads)
        x32c, dout32 = x.float(), dout.float()
        bf16_record(res, tag, "fused_attn_block_bf16", label, fwd,
                    lambda: fb.fused_attn_block_bf16_reference(x, *params, bias, s, *meta),
                    lambda: fb._attn_block_fwd_cuda(x32c, *params, bias, s, *meta), None,
                    fwd_flops, fwd_bytes, *fwd_err)
        bf16_record(res, tag, "fused_attn_block_backward_bf16", label, bwd,
                    lambda: fb.fused_attn_block_bwd_bf16_reference(x, *params, bias, s, dout,
                                                                   *meta),
                    lambda: fb.fused_attn_block_backward(x32c, *params, bias, s, dout32, *meta),
                    None, bwd_flops, bwd_bytes, max(e[0] for e in bwd_err),
                    max(e[1] for e in bwd_err))
        if kinds == 1:
            stage_split(tag, f"fused_attn_block_bf16 {label}", fwd, fwd_flops, fwd_bytes,
                        res["fused_attn_block_bf16"]["ms"], STAGES_1,
                        kernels=("ln_rows_bf16_kernel", "linear_tma_bf16_kernel",
                                 "attn_group_fwd_bf16_kernel"), bf16=True)
            stage_split(tag, f"fused_attn_block_backward_bf16 {label}", bwd, bwd_flops, bwd_bytes,
                        res["fused_attn_block_backward_bf16"]["ms"], STAGES_6_BF16,
                        kernels=("attn_group_bwd_bf16_kernel", "dbias_group_sum_kernel",
                                 *WG_BF16, "rows_bf16_kernel"), bf16=True)
        torch.cuda.empty_cache()
    return res


def phase_srformerv2_bf16_train(seed: int) -> dict[str, int]:
    """51. `train.run` of srformerv2_fidelity.yml as shipped (bf16, batch 16
    of 48x48 LR padded to 72x72, L1 + MS-SSIM, AdamW 2e-4, EMA 0.999, its
    validation), TRAIN_STEPS steps: 18 + 18 launches a step of #1/#6's bf16 forms and
    18 + 18 of #2/#7's, none of any fp32 training form; every log finite;
    the validation through the fp32 twin (on #1/#2); the EMA checkpoint
    served with the strict load. Then one step profiled (phase 43's)."""
    template, network, label, per_step, per_image = SRF_BF16_RUN
    tag = "srformerv2 bf16 train"
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    val_hr, val_lr = make_dataset(OUT / "data", seed)
    opt = fidelity_options("srformerv2_x4_fidelity_bf16", hr_dir, lr_dir, seed,
                           (val_hr, val_lr), template=template)
    serving = {k: v * N_IMAGES for k, v in per_image.items()}
    counts = phase_train(seed, network, f"{label} bf16 ({template.name})", tag,
                         per_step=per_step, serve_want=serving, lq=FID_LQ, losses=FID_LOSSES,
                         opt=opt, more_launches=lambda: serving, check=bf16_train_check(tag),
                         batch_size=SRF_BF16_B)
    phase_bf16_profile(seed, template, "srformerv2_x4_bf16_profile", per_step,
                       "srformerv2 bf16 profile", "profile_srformerv2_bf16_train.txt",
                       batch_size=SRF_BF16_B, kernels=("attn_group_fwd_bf16_kernel",),
                       sums={"#1 bf16's window attention": ("attn_group_fwd_bf16_kernel",),
                             "#6 bf16's window attention": ("attn_group_bwd_bf16_kernel",)})
    return counts


def phase_bf16_gan(seed: int) -> None:
    """52. bf16 GAN training as the templates ship it: `train.run` of
    swinir_m_gan.yml (bf16, batch 8 of 48x48 LR, DUnet in bf16, L1 +
    MS-SSIM + perceptual + vanilla GAN 0.1), TRAIN_STEPS steps, 36 + 36 launches a
    step of #4/#5's bf16 forms and none of the fp32 forms (phase 38's checks
    on D, its (u, v) and net_d_<TRAIN_STEPS>); its step profiled, split into the G and
    D steps (phase 39's, the DUnet, VGG19 and DySample parts too); then six
    steps each of hat_m_gan.yml, dat_gan.yml and srformerv2_gan.yml as
    shipped, each G step's bf16 launches counted and one step profiled into
    G and D."""
    phase_gan_train(seed, as_shipped=True, tag="bf16 gan train", per_step=BF16_TRAIN_STEP)
    phase_gan_profile(seed, as_shipped=True, tag="bf16 gan profile", per_step=BF16_TRAIN_STEP)
    for name, (template, per_step) in BF16_GANS.items():
        phase_gan_profile(seed, template, as_shipped=True, tag=f"bf16 {name}",
                          per_step=per_step, detail=False)


def otf_bf16_options(name: str, hr_dir: Path, seed: int, template: Path = OTF_BF16_TEMPLATE,
                     **extra):
    """`template`, configs/_templates/train/SwinIR/swinir_m_otf.yml unless
    said, as shipped (bf16,
    batch 8 of gt_size 128, the template's degradation, DUnet, L1 +
    perceptual + vanilla GAN 0.1, AdamW 2e-4 for G and D, EMA 0.999) with one
    cut, its MS-SSIM (five scales need 161-pixel sides: gt_size 128 raises
    in both packages), on `hr_dir`, TRAIN_STEPS steps, without validation."""
    import yaml

    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    raw = yaml.safe_load(template.read_text())
    raw.update(name=name, manual_seed=seed, num_gpu=1, path={})
    raw["datasets"] = {"train": {**raw["datasets"]["train"], "dataroot_gt": str(hr_dir),
                                 "io_backend": {"type": "disk"}}}
    raw["train"]["losses"] = [lo for lo in raw["train"]["losses"] if lo["type"] != "mssimloss"]
    raw["train"]["total_iter"] = TRAIN_STEPS
    raw["val"]["val_enabled"] = False
    raw["logger"] = {"print_freq": PRINT_FREQ, "save_checkpoint_freq": 1000,
                     "use_tb_logger": False}
    raw.update(extra)
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=True)


def phase_otf_bf16(seed: int, hr_dir: Path) -> dict[str, int]:
    """53. `train.run` of swinir_m_otf.yml as shipped less its MS-SSIM
    (`otf_bf16_options`), TRAIN_STEPS steps: the degradation in fp32 on #15 (one
    launch a compression), the networks in bf16 (36 + 36 launches of #4/#5's
    bf16 forms a step, none of the fp32 forms); every log finite; then one
    step profiled into the degradation and the optimizer step (phase 29's),
    with peak memory."""
    import torch

    from trainner_redux_tpu_torch.models.realesrgan_model import RealESRGANModel

    gan_vgg_line("otf bf16 train")
    compressions = []
    original = RealESRGANModel._compress

    def counted(self, x, fmt):
        compressions.append(fmt)
        return original(self, x, fmt)

    def check(model, opt):
        if (model.net_g.compute_dtype, model.net_d.compute_dtype) != (torch.bfloat16,) * 2:
            fail("otf bf16 train: G and D do not compute in bf16")

    opt = otf_bf16_options("swinir_m_x4_otf_bf16", hr_dir, seed)
    RealESRGANModel._compress = counted
    try:
        counts = phase_train(
            seed, "swinir_m", "SwinIR-M OTF + GAN bf16 (swinir_m_otf.yml, MS-SSIM cut)",
            "otf bf16 train", per_step=BF16_TRAIN_STEP, lq=OTF_GT // 4,
            losses=tuple(lo["type"] for lo in opt.train.losses), opt=opt,
            more_launches=lambda: {"jpeg_block_transform": len(compressions)}, check=check)
    finally:
        RealESRGANModel._compress = original
    say(f"[otf bf16 train] {len(compressions) - TRAIN_STEPS} recompressions drawn in "
        f"{TRAIN_STEPS} steps; #15 launches {counts['jpeg_block_transform']}")
    torch.cuda.reset_peak_memory_stats()
    phase_otf_profile(seed, hr_dir, otf_bf16_options("swinir_m_x4_otf_bf16_profile", hr_dir, seed),
                      "otf bf16 profile")
    say(f"[otf bf16 profile] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB over the profile's six steps")
    return counts


# ---------------------------------------------------------------------------
# 54-57. bf16 Swin2SR: the bf16 forms of #11-#14
# ---------------------------------------------------------------------------

S2_TEMPLATES = TEMPLATES / "Swin2SR"
S2_BF16_STEP = {k: SWIN2SR_BLOCKS for k in (
    "fused_cos_attn_block_bf16", "fused_cos_attn_block_backward_bf16", "fused_postnorm_mlp_bf16",
    "fused_postnorm_mlp_backward_bf16")}
S2_FP32_STEP = {k.removesuffix("_bf16"): v for k, v in S2_BF16_STEP.items()}
# phase 55's run: as BF16_RUNS's (template, network, label, a step's bf16
# launches, the fp32 twin's launches an image)
S2_BF16_RUN = (S2_TEMPLATES / "swin2sr_m_fidelity.yml", "swin2sr_m", "Swin2SR-M", S2_BF16_STEP,
               {"fused_cos_attn_block": SWIN2SR_BLOCKS, "fused_postnorm_mlp": SWIN2SR_BLOCKS})
# phase 54's blocks: (label, (C, heads, window, hidden), the Ks, timed and
# split); None: Swin2SR-S at every temperature 10, the templates' start
S2_BF16_BLOCKS = (("Swin2SR-S", (60, 6, WS, 120), (4,), False),
                  ("Swin2SR-S", (60, 6, WS, 120), (4,), None),
                  ("Swin2SR-L", (240, 8, WS, 480), (1, 4), True),
                  ("Swin2SR-M", (C, NH, WS, HIDDEN), (1, 4), True))
S2_BF16_KERNELS = {
    "fused_cos_attn_block": (STAGES_11, ("linear_bf16_kernel", "cos_attn_rows_fwd_bf16_kernel",
                                         "postnorm_rows_bf16_kernel")),
    "fused_cos_attn_block_backward": (STAGES_12_BF16, (
        "cos_attn_rows_fwd_bf16_kernel", "postnorm_ln_rows_kernel<__nv_bfloat16>",
        "cos_attn_bwd_tc_kernel<__nv_bfloat16>", *WG_BF16, "rows_bf16_kernel")),
    "fused_postnorm_mlp": (STAGES_13, ("linear_bf16_kernel", "postnorm_rows_bf16_kernel")),
    "fused_postnorm_mlp_backward": (STAGES_14_BF16, (
        "postnorm_ln_rows_kernel<__nv_bfloat16>", "mlp_hidden_bf16_kernel", *WG_BF16,
        "rows_bf16_kernel")),
}


def phase_swin2sr_bf16_kernels() -> dict:
    """54. #11-#14's bf16 forms at Swin2SR's training blocks as the templates
    ship them (B=8, 48x48 LR, DropPath scales holding 0 and 1/0.9;
    temperatures between 1 and 100): Swin2SR-S (C 60) K=4 for correctness
    (also at every temperature 10), Swin2SR-L (C 240, 8 heads, hidden 480) and
    Swin2SR-M (C 180) K=1 and K=4 shifted by 4, on bf16 x and dout with the
    fp32 parameters: each output and gradient against its bf16 plain version
    (`check_bf16`) and, with it, against float64 of the same bf16 inputs
    (the weights rounded to bf16, as the forms take them; `bf16_f64_check`);
    two runs of each bit for bit; at L and M timed beside the plain versions
    and the fp32 forms with the bf16 bound and its share, and split by stage
    at K=4 (each stage split fails unless the form's bf16 kernels ran). The
    JSON line keeps Swin2SR-M's K=4."""
    import torch

    from trainner_redux_tpu_torch.ops import fused_block_v2 as v2
    from trainner_redux_tpu_torch.ops.window_attention import _bf

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(54)
    res: dict[str, dict] = {}
    tag = "swin2sr bf16 kernels"
    s = torch.full((TB,), 1.0 / 0.9, device=dev)
    s[2] = 0.0
    shape = (TB, S2_LQ, S2_LQ)
    halves = {
        "fused_cos_attn_block": (("x", "wq", "bq", "scale", "wp", "bp", "g", "be", "bias"),
                                 ("wq", "wp")),
        "fused_postnorm_mlp": (("x", "w1", "b1", "w2", "b2", "g2", "be2"), ("w1", "w2")),
    }
    for preset, widths, ks, timed_split in S2_BF16_BLOCKS:
        c, nh, _, hidden = widths
        flops = v2_flops(TB * S2_LQ * S2_LQ, c, hidden)
        # Swin2SR-S's rows of 10 channels at temperatures up to 100: a q^ or
        # k^ entry that the kernel and its plain version round to bf16 apart
        # (a tie, their fp32 norms summed in other orders) moves a logit by
        # up to 100 bf16 steps of cos, so single elements of #12's dx move
        # past BF16_TOL (1.7% of its largest, measured) while the share of
        # elements past one bf16 step and the float64 check hold: there the
        # largest is printed and not held; at every temperature 10, the
        # templates' start, it is held
        hold_max, temps10, timed = timed_split is not False, timed_split is None, bool(timed_split)
        for kinds in ks:
            shift = WS // 2 if kinds == 4 else 0
            label = f"{preset} K={kinds} shift {shift}"
            x32, p, bias = v2_inputs(gen, kinds, dev, shape, widths)
            if temps10:
                p["scale"] = torch.full_like(p["scale"], 10.0)
                label += ", temperatures 10"
            ops = {**p, "x": x32.bfloat16(), "bias": bias}
            dout = torch.randn(*shape, c, generator=gen).to(dev).bfloat16()
            for name, (keys, weights) in halves.items():
                args = [ops[k] for k in keys]
                meta = (nh, c // nh, WS, 1e-5, shift) if name == "fused_cos_attn_block" else (
                    WS, 1e-5)
                form, back = getattr(v2, f"{name}_bf16"), getattr(v2, f"{name}_backward_bf16")
                ref = getattr(v2, f"{name}_bf16_reference")
                bref = getattr(v2, f"{name}_bwd_bf16_reference")

                def fwd(form=form, args=args, meta=meta):
                    return form(*args, s, *meta)

                def bwd(back=back, args=args, meta=meta):
                    return back(*args, s, dout, *meta)

                try:
                    got, again, grads, grads2 = fwd(), fwd(), bwd(), bwd()
                    torch.cuda.synchronize()
                except Exception as e:  # noqa: BLE001 - report and fail the phase
                    fail(f"{name}_bf16 / _backward_bf16 {label}: {e}")
                want, plain_grads = ref(*args, s, *meta), bref(*args, s, dout, *meta)
                fwd_err = check_bf16(tag, f"{name}_bf16 {label} out", got, want, hold_max)
                bwd_err = [check_bf16(tag, f"{name}_backward_bf16 {label} d{k}", g, w, hold_max)
                           for k, g, w in zip(keys, grads, plain_grads)]
                if not torch.equal(got, again) or not all(
                        torch.equal(a, b) for a, b in zip(grads, grads2)):
                    fail(f"{name}_bf16 / _backward_bf16 {label}: two runs differ")
                if got.dtype != torch.bfloat16 or grads[0].dtype != torch.bfloat16:
                    fail(f"{name} {label}: out {got.dtype}, dx {grads[0].dtype}, expected bf16")
                leaves = {k: (_bf(ops[k]) if k in weights else ops[k]).double().requires_grad_()
                          for k in keys}
                exact = postnorm_half_f64(name, leaves["x"], leaves, leaves.get("bias"), s, shift,
                                          nh)
                exact_g = torch.autograd.grad(exact, list(leaves.values()), dout.double())
                ratio = max([bf16_f64_check(tag, f"{name}_bf16 {label} out", got, want,
                                            exact.detach())]
                            + [bf16_f64_check(tag, f"{name}_backward_bf16 {label} d{k}", g, w, e)
                               for k, g, w, e in zip(keys, grads, plain_grads, exact_g)])
                del exact, exact_g, leaves
                say(f"[{tag}] {name} {label}: bf16 forward within {fwd_err[1]:.3g} of its "
                    f"largest, backward within {max(e[1] for e in bwd_err):.3g} of each "
                    f"gradient's; against float64 at most {ratio:.3f}x the plain versions' "
                    "error; two runs of each bit for bit")
                if not timed:
                    continue
                fwd_bytes = nbytes(*args, s, got)
                bwd_bytes = nbytes(*args, s, dout, *grads)
                args32 = [args[0].float(), *args[1:]]
                bf16_record(res, tag, f"{name}_bf16", label, fwd,
                            lambda ref=ref, args=args, meta=meta: ref(*args, s, *meta),
                            lambda name=name, args32=args32, meta=meta: getattr(v2, name)(
                                *args32, s, *meta),
                            None, flops[name], fwd_bytes, *fwd_err)
                bf16_record(res, tag, f"{name}_backward_bf16", label, bwd,
                            lambda bref=bref, args=args, meta=meta: bref(*args, s, dout, *meta),
                            lambda name=name, args32=args32, meta=meta: getattr(
                                v2, f"{name}_backward")(*args32, s, dout.float(), *meta),
                            None, flops[f"{name}_backward"], bwd_bytes,
                            max(e[0] for e in bwd_err), max(e[1] for e in bwd_err))
                if kinds == 4:
                    for part, fn, nb in (("", fwd, fwd_bytes), ("_backward", bwd, bwd_bytes)):
                        stages, kernels = S2_BF16_KERNELS[f"{name}{part}"]
                        stage_split(tag, f"{name}{part}_bf16 {label}", fn, flops[f"{name}{part}"],
                                    nb, res[f"{name}{part}_bf16"]["ms"], stages, kernels=kernels,
                                    bf16=True)
            torch.cuda.empty_cache()
    return res


def phase_swin2sr_bf16_train(seed: int) -> dict[str, int]:
    """55. `train.run` of swin2sr_m_fidelity.yml as shipped (bf16, batch 8
    of 48x48 LR, L1 + MS-SSIM, AdamW 2e-4, EMA 0.999, its validation), TRAIN_STEPS
    steps: 36 launches a step of each of #11-#14's bf16 forms and none of any
    fp32 training form; every log finite; the validation through the fp32
    twin (on #11/#13); the EMA checkpoint served with the strict load. Then
    one step profiled (phase 43's: device ms, busy share, peak memory)."""
    template, network, label, per_step, per_image = S2_BF16_RUN
    tag = "swin2sr bf16 train"
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    val_hr, val_lr = make_dataset(OUT / "data", seed)
    opt = fidelity_options("swin2sr_m_x4_fidelity_bf16", hr_dir, lr_dir, seed, (val_hr, val_lr),
                           template=template)
    serving = {k: v * N_IMAGES for k, v in per_image.items()}
    counts = phase_train(seed, network, f"{label} bf16 ({template.name})", tag,
                         per_step=per_step, serve_want=serving, lq=FID_LQ, losses=FID_LOSSES,
                         opt=opt, more_launches=lambda: serving, check=bf16_train_check(tag))
    phase_bf16_profile(seed, template, "swin2sr_m_x4_bf16_profile", per_step,
                       "swin2sr bf16 profile", "profile_swin2sr_bf16_train.txt")
    return counts


def six_bf16_steps(tag: str, opt, batch, per_step: dict[str, int], steps: int = 6,
                   forms: dict[str, int] | None = None, kernels: tuple[str, ...] = ()) -> None:
    """Six (or `steps`) steps of `opt`'s model from `batch` (for OTF, raw GT
    and kernels that `feed_data` degrades): the model computes in bf16,
    every log of every step is finite, and each step launches `per_step` of
    the hand-written training kernels (OTF's #15 launches counted apart) and
    `forms` of the forms the wrappers count apart; with `kernels`, one more
    step profiled must name each of them."""
    import math

    import torch

    from trainner_redux_tpu_torch.models import build_model

    model = build_model(opt, device="cuda")
    if model.net_g.compute_dtype != torch.bfloat16:
        fail(f"[{tag}] G computes in {model.net_g.compute_dtype}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logs = []
    for i in range(steps):
        model.feed_data(batch)
        model.optimize_parameters(i + 1)
        logs.append({k: float(v) for k, v in model.log_dict.items()})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    bad = [(i + 1, k) for i, log in enumerate(logs) for k, v in log.items() if not math.isfinite(v)]
    if bad:
        fail(f"[{tag}] logs not finite at (step, key) {bad}")
    counts = read_counts()
    jpeg = counts.pop("jpeg_block_transform")
    check_counts(f"{tag} {steps} steps", counts, {k: steps * v for k, v in per_step.items()})
    if forms is not None:
        got = {k: v for k, v in read_form_counts().items() if k in forms}
        if got != {k: steps * v for k, v in forms.items()}:
            fail(f"[{tag}] the forms' launches {got}, expected {forms} a step")
    if kernels:
        from torch.profiler import ProfilerActivity, profile

        model.feed_data(batch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.optimize_parameters(steps + 1)
            torch.cuda.synchronize()
        check_profiled(tag, "a profiled step after them", device_events(prof), kernels)
    say(f"[{tag}] {steps} bf16 steps, {ms:.1f} ms a step (host clock, the model's build left "
        "out), "
        f"every log finite; l_g_total {logs[0]['l_g_total']:.5f} -> {logs[-1]['l_g_total']:.5f}; "
        f"{jpeg} #15 launches; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    torch.cuda.empty_cache()


def phase_swin2sr_bf16_templates(seed: int) -> None:
    """57. Six bf16 steps each of swin2sr_l_fidelity.yml (Swin2SR-L, C 240:
    54 launches a step of each bf16 form), swin2sr_m_gan.yml (DUnet in bf16)
    and swin2sr_m_otf.yml less its MS-SSIM (`otf_bf16_options`), as shipped:
    every log finite, the bf16 launches of each step counted."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fid = {"lq": rng.integers(0, 256, (TB, FID_LQ, FID_LQ, 3), dtype=np.uint8),
           "gt": rng.integers(0, 256, (TB, 4 * FID_LQ, 4 * FID_LQ, 3), dtype=np.uint8)}
    l_step = {k: 54 for k in S2_BF16_STEP}
    six_bf16_steps("swin2sr_l_fidelity bf16", fidelity_options(
        "swin2sr_l_x4_bf16_six", OUT, OUT, seed, template=S2_TEMPLATES / "swin2sr_l_fidelity.yml"),
        fid, l_step)
    gan_vgg_line("swin2sr_m_gan bf16")
    gan = gan_options("swin2sr_m_gan_bf16_six", OUT, OUT, seed,
                      template=S2_TEMPLATES / "swin2sr_m_gan.yml", as_shipped=True)
    six_bf16_steps("swin2sr_m_gan bf16", gan,
                   gan_batch(seed, gan.datasets["train"].batch_size_per_gpu), S2_BF16_STEP)
    hr_dir, _ = make_dataset(OUT / "otf_data", seed, ((128, 128),) * 16)
    otf = otf_bf16_options("swin2sr_m_x4_otf_bf16_six", hr_dir, seed,
                           template=S2_TEMPLATES / "swin2sr_m_otf.yml")
    six_bf16_steps("swin2sr_m_otf bf16", otf, otf_batch(otf, seed), S2_BF16_STEP)
    shutil.rmtree(OUT / "otf_data")


# ---------------------------------------------------------------------------
# 58-62. the conv families: SPAN-S, SPANPlus, Compact and ESRGAN
# ---------------------------------------------------------------------------

# phase 58's served networks: (type, label, scale)
CONV_SERVE = (("span_s", "SPAN-S", 4), ("spanplus", "SPANPlus", 4), ("compact", "Compact", 4),
              ("esrgan", "ESRGAN", 4), ("esrgan", "ESRGAN", 2))
FOLD_TOL = 1e-4  # SPAN-S's folded eval form against its train form, of the output's largest
SPAN_S_FID = TEMPLATES / "SPAN" / "span_s_fidelity.yml"
CONV_BATCH = 16  # span_s_fidelity.yml's batch
CPU_STEP_BATCH = 4  # phase 59's fp32 step on the card and on the CPU
# phase 60's fidelity templates, six bf16 steps each (ESRGAN's in its profile)
CONV_SIX = (TEMPLATES / "SPANPlus" / "spanplus_fidelity.yml",
            TEMPLATES / "Compact" / "compact_fidelity.yml")
ESRGAN_FID = TEMPLATES / "ESRGAN" / "esrgan_fidelity.yml"
ESRGAN_GAN = TEMPLATES / "ESRGAN" / "esrgan_gan.yml"
COMPACT_OTF = TEMPLATES / "Compact" / "compact_otf.yml"
BENCH_LQ = 64  # bench.py's lq for span_s and esrgan_gan
BENCH_STEPS = {"esrgan_gan": 6, "span_s": TRAIN_STEPS}
BENCH_PROFILED = 2  # the last steps of span_s's bench runs, profiled
# bench.py's esrgan_gan loss mix (:141-151) and its optim_d (:152-153)
ESRGAN_GAN_LOSSES = [
    {"type": "mssimloss", "loss_weight": 0.5},
    {"type": "perceptualloss", "criterion": "charbonnier", "loss_weight": 0.01},
    {"type": "hsluvloss", "criterion": "charbonnier", "loss_weight": 1.0},
    {"type": "cosimloss", "loss_weight": 1.0},
    {"type": "ganloss", "gan_type": "vanilla", "loss_weight": 0.1},
]
ESRGAN_GAN_OPTIM_D = {"type": "AdamW", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]}


def phase_conv_serve(seed: int) -> None:
    """58. `test.run` on seeded SPAN-S, SPANPlus, Compact and ESRGAN at 4x
    and ESRGAN at 2x (the pixel-unshuffle path; its images 2x), full width
    and depth, on the 4 images (three 128x128 LR, one 100x120): PNGs and
    finite PSNR/SSIM, no hand-written kernel launched (the convolutions are
    cuDNN's); each network's 128x128 forward timed on the device (CUDA
    graph replay, fp32, TF32 off). SPAN-S's folded eval form against its
    train form on the same weights and input (fp32, TF32 off): within
    FOLD_TOL of the output's largest."""
    import torch

    from trainner_redux_tpu_torch.archs import build_network
    from trainner_redux_tpu_torch.models.sr_model import fp32_math

    OUT.mkdir(parents=True, exist_ok=True)
    data = {4: make_dataset(OUT / "data", seed), 2: make_dataset(OUT / "data_x2", seed, scale=2)}
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    for network, label, scale in CONV_SERVE:
        net = build_network({"type": network, "scale": scale}).init_weights(
            torch.Generator().manual_seed(seed))
        weights = OUT / f"{network}_x{scale}_seeded.pth"
        torch.save(net.state_dict(), weights)
        served = serve(f"{network}_x{scale}", weights, *data[scale], seed, {}, network, scale)
        check_counts(f"{label} {scale}x serving", served["counts"], {})
        weights.unlink()
        net = net.cuda().eval()
        with torch.no_grad(), fp32_math():
            ms = graph_ms(lambda: net(x), iters=5, replays=4)
        say(f"[conv serve] {label} {scale}x: one 128x128 forward {ms:.3f} ms on the device "
            f"(CUDA graph replay, fp32, TF32 off; {type(net).__name__}, "
            f"{sum(p.numel() for p in net.parameters()):,d} parameters)")
        if network == "span_s":
            with torch.no_grad(), fp32_math():
                trained = net.train()(x)
                folded = net.eval()(x)
            err = float((trained - folded).abs().max() / folded.abs().max())
            say(f"[conv serve] SPAN-S's 20 Conv3XCs folded (eval) against their 1x1-3x3-1x1 "
                f"chains (train): max |diff| {err:.3g} of the output's largest (limit "
                f"{FOLD_TOL:g})")
            if not err <= FOLD_TOL:
                fail(f"SPAN-S's folded form is {err:.3g} off its train form")
    shutil.rmtree(OUT / "data_x2")


def phase_span_s_train(seed: int) -> None:
    """59. `train.run` of span_s_fidelity.yml as shipped (bf16, batch 16 of
    48x48 LR, L1 + MS-SSIM, AdamW 5e-4, EMA 0.999, its validation), TRAIN_STEPS
    steps from 16 seeded 512x512 HR images: no hand-written kernel launched,
    every log finite, the validation through the fp32 twin (PSNR/SSIM), the
    EMA checkpoint served with the strict load; one step profiled (device
    ms, launches, busy share, peak memory); one fp32 step (TF32 off) on the
    card against the same step on the CPU from the same weights and batch
    (4 crops): the loss within BRANCH_LOSS_TOL relative, each gradient
    within BRANCH_GRAD_TOL of its largest; two 3-step bf16 runs with
    `deterministic: true`, bit for bit."""
    import torch

    from trainner_redux_tpu_torch.models import build_model

    tag = "span_s train"
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    val_hr, val_lr = make_dataset(OUT / "data", seed)
    opt = fidelity_options("span_s_x4_fidelity_bf16", hr_dir, lr_dir, seed, (val_hr, val_lr),
                           template=SPAN_S_FID)
    phase_train(seed, "span_s", "SPAN-S bf16 (span_s_fidelity.yml)", tag, per_step={},
                serve_want={}, lq=FID_LQ, losses=FID_LOSSES, opt=opt,
                check=bf16_train_check(tag), batch_size=CONV_BATCH)
    phase_bf16_profile(seed, SPAN_S_FID, "span_s_x4_bf16_profile", {}, "span_s profile",
                       "profile_span_s_train.txt", CONV_BATCH)

    opt = fidelity_options("span_s_x4_fp32_step", OUT, OUT, seed, template=SPAN_S_FID,
                           compute_dtype="float32")
    batch = gan_batch(seed, CPU_STEP_BATCH, FID_LQ)
    steps = {}
    for device in ("cuda", "cpu"):
        model = build_model(opt, device=device)
        model.feed_data(batch)
        model.optimize_parameters(1)
        steps[device] = (float(model.log_dict["l_g_total"]),
                         {k: p.grad.detach().cpu() for k, p in model.net_g.named_parameters()})
    (loss_card, g_card), (loss_cpu, g_cpu) = steps["cuda"], steps["cpu"]
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst = max((float((g_card[k] - g).abs().max() / g.abs().max()), k) for k, g in g_cpu.items())
    say(f"[{tag}] one fp32 step (TF32 off, {CPU_STEP_BATCH} crops) on the card against the CPU: "
        f"loss {loss_card:.6f} against {loss_cpu:.6f} ({rel:.2e} relative, limit "
        f"{BRANCH_LOSS_TOL:g}); the farthest of {len(g_cpu)} gradients {worst[0]:.2e} of its "
        f"largest ({worst[1]}; limit {BRANCH_GRAD_TOL:g})")
    if not rel <= BRANCH_LOSS_TOL or not worst[0] <= BRANCH_GRAD_TOL:
        fail(f"{tag}: the card's fp32 step is off the CPU's")

    opt = fidelity_options("span_s_x4_deterministic", OUT, OUT, seed, template=SPAN_S_FID,
                           deterministic=True)
    batches = [gan_batch(seed + i, CONV_BATCH, FID_LQ) for i in range(3)]
    runs = []
    for _ in range(2):
        model = build_model(opt, device="cuda")
        for i, b in enumerate(batches):
            model.feed_data(b)
            model.optimize_parameters(i + 1)
        runs.append(([float(v) for v in model.log_dict.values()],
                     [p.detach().clone() for p in model.net_g.parameters()]))
    (logs_a, params_a), (logs_b, params_b) = runs
    if logs_a != logs_b or not all(torch.equal(a, b) for a, b in zip(params_a, params_b)):
        fail(f"{tag}: two deterministic 3-step bf16 runs differ")
    say(f"[{tag}] two 3-step bf16 runs with deterministic: true: bit for bit in all "
        f"{len(logs_a)} logs and {len(params_a)} parameters")
    del model
    torch.cuda.empty_cache()


def phase_conv_templates(seed: int) -> None:
    """60. Six bf16 steps each, as shipped, of spanplus_fidelity.yml
    (DySample with its end convolution), compact_fidelity.yml,
    esrgan_fidelity.yml (its profile's: device ms, launches, busy share),
    esrgan_gan.yml (DUnet, VGG19 at its seeded random init; its GAN
    profile's: G and D device ms apart) and compact_otf.yml with its
    MS-SSIM cut and its queue_size set to twice its batch, as bench.py's OTF
    workloads set it (:497; the default 120 is no multiple of batch 16,
    which both packages refuse; the degradation on #15): every log finite,
    no hand-written kernel launched but OTF's #15."""
    for template in CONV_SIX:
        opt = fidelity_options(f"{template.stem}_bf16_six", OUT, OUT, seed, template=template)
        train = opt.datasets["train"]
        six_bf16_steps(f"{template.stem} bf16", opt,
                       gan_batch(seed, train.batch_size_per_gpu, train.lq_size), {})
    # ESRGAN's six steps are its profile's (two warm-up, one profiled, three
    # timed), every log checked
    phase_bf16_profile(seed, ESRGAN_FID, "esrgan_x4_bf16_profile", {}, "esrgan profile",
                       "profile_esrgan_train.txt", TB)
    gan_vgg_line("esrgan_gan bf16")
    phase_gan_profile(seed, ESRGAN_GAN, as_shipped=True, tag="esrgan_gan bf16 profile",
                      per_step={}, detail=False)
    hr_dir, _ = make_dataset(OUT / "otf_data", seed, ((128, 128),) * 16)
    batch = 16  # compact_otf.yml's: its default queue_size 120 is no multiple of it
    otf = otf_bf16_options("compact_x4_otf_bf16_six", hr_dir, seed, template=COMPACT_OTF,
                           queue_size=2 * batch)
    if otf.datasets["train"].batch_size_per_gpu != batch:
        fail(f"compact_otf.yml's batch is {otf.datasets['train'].batch_size_per_gpu}, not {batch}")
    six_bf16_steps("compact_otf bf16", otf, otf_batch(otf, seed, batch), {})
    shutil.rmtree(OUT / "otf_data")


def bench_options(name: str, hr_dir: Path, lr_dir: Path, seed: int, workload: str, **ds):
    """bench.py's `workload` (span_s: batch 16, lq 64, charbonnier;
    esrgan_gan: batch 8, lq 64, ESRGAN_GAN_LOSSES with DUnet and
    ESRGAN_GAN_OPTIM_D, without remat) through the port's options: 4x, the
    JAX package's default compute dtype (bf16), AdamW 2e-4, EMA 0.999,
    BENCH_STEPS[workload] steps, no validation; `ds` adds to the train
    dataset (device_cache)."""
    from trainner_redux_tpu_torch.utils.options import resolve_options
    from trainner_redux_tpu_torch.utils.redux_options import ReduxOptions
    from trainner_redux_tpu_torch.utils.schema import decode

    gan = workload == "esrgan_gan"
    train = {"total_iter": BENCH_STEPS[workload], "ema_decay": 0.999,
             "optim_g": {"type": "AdamW", "lr": 2e-4, "betas": [0.9, 0.99]},
             "losses": ESRGAN_GAN_LOSSES if gan else [{"type": "charbonnierloss",
                                                       "loss_weight": 1.0}]}
    raw = {"name": name, "scale": 4, "num_gpu": 1, "manual_seed": seed, "path": {},
           "network_g": {"type": "esrgan" if gan else "span_s"},
           "datasets": {"train": {
               "name": "bench", "type": "PairedImageDataset", "dataroot_gt": str(hr_dir),
               "dataroot_lq": str(lr_dir), "io_backend": {"type": "disk"}, "lq_size": BENCH_LQ,
               "batch_size_per_gpu": 8 if gan else CONV_BATCH, "num_worker_per_gpu": 4, **ds}},
           "train": {**train, **({"optim_d": ESRGAN_GAN_OPTIM_D} if gan else {})},
           "logger": {"print_freq": PRINT_FREQ, "save_checkpoint_freq": 1000,
                      "use_tb_logger": False}}
    if gan:
        raw["network_d"] = {"type": "dunet"}
    return resolve_options(decode(raw, ReduxOptions), str(OUT), is_train=True)


def bench_run(opt, tag: str, label: str, profiled: int) -> dict:
    """`train.run` of `opt`, timing every step end to end (the loader or the
    device cache, `feed_data` and the step), its last `profiled` steps (if
    any) under torch.profiler: the median step of the unprofiled ones after
    the warm-up, the device ms and launches a step of the profiled ones, the
    busy share (device ms over the median step), peak memory; every log
    finite, no hand-written kernel launched. Returns the model's last logs
    and the numbers."""
    import math
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch import train as port_train
    from trainner_redux_tpu_torch.models.sr_model import SRModel

    steps = int(opt.train.total_iter)
    first = steps - profiled + 1
    ends, bad, window = [], [], {}
    original = SRModel.optimize_parameters

    def wrapped(self, current_iter):
        if current_iter == first:
            torch.cuda.synchronize()
            window["t0"] = time.perf_counter()
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].__enter__()
        original(self, current_iter)
        bad.extend(k for k, v in self.log_dict.items() if not math.isfinite(float(v)))
        ends.append(time.perf_counter())
        if profiled and current_iter == steps:
            torch.cuda.synchronize()
            window["prof"].__exit__(None, None, None)

    SRModel.optimize_parameters = wrapped
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        model = port_train.run(opt)
        counts = read_counts()
    finally:
        SRModel.optimize_parameters = original
    check_counts(tag, counts, {})
    if bad or model.step != steps:
        fail(f"[{tag}] {model.step} of {steps} steps; logs not finite: {bad[:8]}")
    warm = min(TRAIN_WARMUP, first - 3)
    per = [b - a for a, b in zip(ends[warm:first - 1], ends[warm + 1:first - 1])]
    med = statistics.median(per) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = opt.datasets["train"].batch_size_per_gpu
    device = busy = None
    line = "not profiled"
    if profiled:
        events = device_events(window["prof"])
        device = sum(e.self_device_time_total for e in events) / 1e3 / profiled
        busy = device / med
        line = (f"device {device:.3f} ms and {sum(e.count for e in events) / profiled:.0f} "
                f"launches a step (torch.profiler, steps {first}-{steps}): the card busy "
                f"{busy:.1%}")
    say(f"[{tag}] {label}: {steps} steps through train.run; median {med:.2f} ms a step end to "
        f"end (steps {warm + 1}-{first - 1}; {batch / med * 1e3:.1f} images/s); {line}; "
        f"max_memory_allocated {peak:.2f} GiB")
    shutil.rmtree(opt.path.experiments_root, ignore_errors=True)
    return {"logs": {k: float(v) for k, v in model.log_dict.items()}, "ms": med,
            "device_ms": device, "busy": busy}


def phase_conv_bench(seed: int) -> None:
    """61-62. Two of bench.py's workloads through the port's `train.run`:
    esrgan_gan (ESRGAN and DUnet in bf16, the workload's loss mix with
    hsluv and cosim, optim_d AdamW 1e-4, without remat), six steps, hsluv's
    three terms logged apart; span_s (batch 16 of 64x64 LR, charbonnier)
    with `device_cache: true`, TRAIN_STEPS steps, beside the same run from the host
    loader: each run's step end to end and busy share, and a count that
    the cached run cut every batch on the device (and built no host
    prefetcher's batches)."""
    from trainner_redux_tpu_torch.data import device_cache

    gan_vgg_line("esrgan_gan bench")
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    opt = bench_options("esrgan_gan_bench", hr_dir, lr_dir, seed, "esrgan_gan")
    res = bench_run(opt, "esrgan_gan bench", "ESRGAN + DUnet bf16, batch 8 of 64x64 LR, "
                    "bench.py's esrgan_gan losses", 0)
    parts = [f"l_g_hsluv_{k}" for k in ("hue", "saturation", "lightness")]
    missing = [k for k in (*parts, "l_g_cosim", "l_g_gan", "l_d_real") if k not in res["logs"]]
    if missing:
        fail(f"[esrgan_gan bench] not logged: {missing}")
    say("[esrgan_gan bench] last step: " + ", ".join(f"{k} {v:.5f}"
                                                    for k, v in res["logs"].items()))

    feeders = []
    real_init = device_cache.DeviceCacheFeeder.__init__

    def recorded(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        feeders.append(self)

    runs = {}
    device_cache.DeviceCacheFeeder.__init__ = recorded
    try:
        for cached in (True, False):
            source = "device cache" if cached else "host loader"
            opt = bench_options(f"span_s_bench_{'cache' if cached else 'host'}", hr_dir, lr_dir,
                                seed, "span_s", device_cache=cached)
            runs[source] = bench_run(opt, "span_s bench", f"SPAN-S bf16 from the {source}, "
                                     "batch 16 of 64x64 LR, charbonnier", BENCH_PROFILED)
    finally:
        device_cache.DeviceCacheFeeder.__init__ = real_init
    if len(feeders) != 1 or feeders[0].batches_cut != BENCH_STEPS["span_s"]:
        fail(f"[span_s bench] the cached run cut {[f.batches_cut for f in feeders]} batches on "
             f"the device, expected one cache cutting {BENCH_STEPS['span_s']}")
    cache, host = runs["device cache"], runs["host loader"]
    say(f"[span_s bench] the device cache cut all {feeders[0].batches_cut} batches on the card; "
        f"a step {cache['ms']:.2f} ms from it against {host['ms']:.2f} ms from the host loader "
        f"(x{host['ms'] / cache['ms']:.2f}); busy {cache['busy']:.1%} against {host['busy']:.1%}")
    shutil.rmtree(OUT / "train_data", ignore_errors=True)


# ---------------------------------------------------------------------------
# 63-67. SRFormer and ATD: #3/#8's 64-wide form, served and trained
# ---------------------------------------------------------------------------

# atd's window attention: C 210, 6 heads of 35 (rows padded to 64), 16x16
# windows; atd_fidelity.yml's batch of 4 48x48 LR crops
AC, ANH, AWS = 210, 6, 16
AHD = AC // ANH
ATD_B = 4
# blocks a forward: srformer 6x6 (one #2 each), srformer_light 4x6, atd 6x6
# (one #3 each), atd_light 4x6
SRF1_SERVE = (("srformer", "SRFormer", {"fused_ln_mlp": 36}),
              ("srformer_light", "SRFormer-light", {"fused_ln_mlp": 24}),
              ("atd", "ATD", {"fused_window_mhsa": 36}),
              ("atd_light", "ATD-light", {"fused_window_mhsa": 24}))
SRF1_TEMPLATES = TEMPLATES / "SRFormer"
ATD_TEMPLATES = TEMPLATES / "ATD"
SRF1_STEP = {"fused_ln_mlp_bf16": 36, "fused_ln_mlp_backward_bf16": 36}
ATD_STEP = {"fused_window_mhsa_bf16": 36, "fused_window_mhsa_backward_bf16": 36}
# phase 65's runs: template, network, label, a step's bf16 launches, the
# fp32 twin's launches an image (its validation, the served EMA checkpoint)
SRF1_ATD_RUNS = (
    (SRF1_TEMPLATES / "srformer_fidelity.yml", "srformer", "SRFormer", SRF1_STEP,
     {"fused_ln_mlp": 36}),
    (ATD_TEMPLATES / "atd_fidelity.yml", "atd", "ATD", ATD_STEP, {"fused_window_mhsa": 36}),
)
SIX_STEPS = 6  # phases 65-66's runs of the templates as shipped
# phase 67's fp32 step of atd_light on the card against the CPU: a token
# whose category (the argmax of its sim) differs between the two takes the
# CPU's where the card's sim at the CPU's category lies within this of its
# own largest (a near-tie that the two sum orders break apart)
CATEGORY_PIN_TOL = 1e-5
# ... and a gradient whose largest lies below this share of its layer's
# largest is held against the layer's largest, as `train_branches` holds
# DAT's zero-gradient biases: a gradient at the rounding floor of the sums
# behind it (at the seeded init the dictionary is small, trunc-normal 0.02,
# so in a group's last layers sim barely moves the output, and the cross
# attention's q, k and scale gradients lie 1e-5 to 1e-6 of their layer's)
NEAR_NULL = 1e-4


def hd64_inputs(gen, kinds: int, shape, c: int, nh: int, ws: int = AWS, dtype=None):
    """Seeded unit-scale qkv, kind table (K=4: the shift masks of ws / 2)
    and output gradient of a window attention of heads of c / nh channels."""
    import torch

    from trainner_redux_tpu_torch.ops.window_attention import shift_mask_kinds

    dev = torch.device("cuda")
    n = ws * ws
    qkv = torch.randn(*shape, 3 * c, generator=gen).to(dev)
    rel = (torch.randn(nh, n, n, generator=gen) * 0.5).to(dev)
    if kinds == 4:
        rel = rel[None] + torch.from_numpy(shift_mask_kinds(ws, ws // 2)).to(dev)[:, None]
    else:
        rel = rel[None]
    dout = torch.randn(*shape, c, generator=gen).to(dev)
    if dtype is not None:
        qkv, dout = qkv.to(dtype), dout.to(dtype)
    return qkv, rel.contiguous(), dout


def hd64_fp32_case(res: dict, names: tuple[str, str], label: str, shape, c: int, nh: int,
                   kinds: int, gen, split: bool, tag: str = "atd kernels",
                   kernels: tuple[str, ...] = (ATTN_FWD_64, ATTN_BWD_64),
                   bwd_stages: dict[str, int] = STAGES_8) -> None:
    """#3 and #8 in fp32 at one block (16x16 windows): `window_attention_cases`'
    checks (plain versions, SDPA, float64, two runs bit for bit), recorded
    under `names`; `split`: #8's stage split (its stages a call
    `bwd_stages`) and #3's, the form's `kernels` (#3's, then #8's; the
    64-wide ones unless said) among them."""
    from trainner_redux_tpu_torch.ops import window_attention as wa

    qkv, bias, dout = inputs = hd64_inputs(gen, kinds, shape, c, nh)
    hd = c // nh
    ops = (lambda: wa.fused_window_mhsa(qkv, bias, nh, hd, AWS),
           lambda: wa.fused_window_mhsa_reference(qkv, bias, nh, hd, AWS),
           lambda: wa.fused_window_mhsa_backward(qkv, bias, dout, nh, hd, AWS),
           lambda: wa.fused_window_mhsa_bwd_reference(qkv, bias, dout, nh, hd, AWS))
    cases = window_attention_cases(tag, "fused_window_mhsa", label, ops, inputs, AWS,
                                   AWS, kinds, nh, hd)
    for name, (kern, plain, lib, flops, nb, err, note) in cases.items():
        record_kernel(res, tag, names[name != "fused_window_mhsa"], label, kern, plain,
                      lib, flops, nb, err, note)
    if split:
        _, _, _, flops, nb, _, _ = cases["fused_window_mhsa"]
        stage_split(tag, f"{names[0]} {label}", ops[0], flops, nb, res[names[0]]["ms"],
                    STAGES_3, kernels=kernels[:1])
    if split:
        _, _, _, flops, nb, _, _ = cases["fused_window_mhsa_backward"]
        stage_split(tag, f"{names[1]} {label}", ops[2], flops, nb, res[names[1]]["ms"],
                    bwd_stages, kernels=kernels[1:])


def mlp_half_case(tag: str, label: str, shape, c: int, hidden: int, rows: int, gen) -> None:
    """#2 and #7, fp32 and bf16, at one MLP half (DropPath scales holding 0
    and 1/0.9): each against its plain version (fp32 KERNEL_TOL and
    GRAD_TOL, bf16 `check_bf16`), two runs of each bit for bit, timed."""
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    b = shape[0]
    x32, p, _, _ = block_inputs(gen, 1, dev, shape=shape, widths=(c, c // 6, rows, hidden))
    s = torch.full((b,), 1.0 / 0.9, device=dev)
    s[1] = 0.0
    params = [p[k] for k in ("g", "be", "w1", "b1", "w2", "b2")]
    dout32 = torch.randn(*shape, c, generator=gen).to(dev)
    names = ("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2")
    for dtype in ("fp32", "bf16"):
        x, dout = (x32, dout32) if dtype == "fp32" else (x32.bfloat16(), dout32.bfloat16())
        if dtype == "fp32":
            def fwd():
                with torch.no_grad():
                    return fb.fused_ln_mlp(x, *params, s, rows)

            def bwd():
                return fb.fused_ln_mlp_backward(x, *params, s, dout, rows)

            ref_f, ref_b = fb.fused_ln_mlp_reference, fb.fused_ln_mlp_bwd_reference
        else:
            def fwd():
                return fb.fused_ln_mlp_bf16(x, *params, s, rows)

            def bwd():
                return fb.fused_ln_mlp_backward_bf16(x, *params, s, dout, rows)

            ref_f, ref_b = fb.fused_ln_mlp_bf16_reference, fb.fused_ln_mlp_bwd_bf16_reference
        try:
            got, again, grads, grads2 = fwd(), fwd(), bwd(), bwd()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - report and fail the phase
            fail(f"[{tag}] #2/#7 {dtype} {label}: {e}")
        want, plain = ref_f(x, *params, s, rows), ref_b(x, *params, s, dout, rows)
        if dtype == "fp32":
            err = (got - want).abs().max().item()
            if not err <= KERNEL_TOL or not bool(torch.isfinite(got).all()):
                fail(f"[{tag}] #2 {label}: {err:.3g} off its plain version")
            gerr, worst = check_grads("fused_ln_mlp_backward", label, grads, plain, names)
        else:
            err = check_bf16(tag, f"#2 bf16 {label} out", got, want)[1]
            worst = max(check_bf16(tag, f"#7 bf16 {label} {n}", g, w)[1]
                        for n, g, w in zip(names, grads, plain))
        if not torch.equal(got, again) or not all(torch.equal(a, b_)
                                                  for a, b_ in zip(grads, grads2)):
            fail(f"[{tag}] #2/#7 {dtype} {label}: two runs differ")
        tokens = b * shape[1] * shape[2]
        bound_f, _ = bound(4 * tokens * c * hidden, nbytes(x, *params, s, got),
                           PEAK_FP32 if dtype == "fp32" else PEAK_BF16)
        bound_b, _ = bound(10 * tokens * c * hidden, nbytes(x, *params, s, dout, *grads),
                           PEAK_FP32 if dtype == "fp32" else PEAK_BF16)
        ms_f, ms_b = time_ms(fwd, iters=10, warmup=2), time_ms(bwd, iters=10, warmup=2)
        say(f"[{tag}] #2/#7 {dtype} at {label} (B={b}, {shape[1]}x{shape[2]}, C {c}, hidden "
            f"{hidden}, rows {rows}): out within {err:.3g}, gradients within {worst:.3g} of "
            f"their largest, two runs bit for bit; #2 {ms_f:.4f} ms (bound {bound_f:.4f}), #7 "
            f"{ms_b:.4f} ms (bound {bound_b:.4f})")


def phase_atd_kernels() -> dict:
    """63. #3 and #8 at heads of 33 to 64 channels (the 64-wide form), fp32
    and bf16, at atd's training block (B=4, 48x48, C 210, 6 heads of 35, ws
    16), K=1 and K=4 (the JSON line's case), and at heads of 64 (C 384, 6
    heads) at K=4; #3 at B=1, 128x128 (serving); each against its plain
    version and float64, two runs bit for bit, timed beside the bound, SDPA
    and (bf16) the fp32 form; split by stage at K=4. The 32-wide form timed
    beside it at HAT-M's heads (C 180, 6 heads of 30) at the same block.
    #2 and #7 at srformer_light's MLP half (C 60, hidden 120, rows 16) and
    srformer's (C 180, hidden 360, rows 24), fp32 and bf16."""
    import torch

    from trainner_redux_tpu_torch.ops import window_attention as wa

    gen = torch.Generator().manual_seed(63)
    res: dict[str, dict] = {}
    other: dict[str, dict] = {}  # cases timed but not the JSON line's
    atd = (ATD_B, FID_LQ, FID_LQ)
    names = ("fused_window_mhsa_hd64", "fused_window_mhsa_backward_hd64")
    bf_names = ("fused_window_mhsa_bf16_hd64", "fused_window_mhsa_backward_bf16_hd64")
    for kinds in (1, 4):
        hd64_fp32_case(res, names, f"ATD ws 16 K={kinds}", atd, AC, ANH, kinds, gen, kinds == 4)
        bf16_window_case(res, bf_names, f"ATD ws 16 K={kinds}", atd, AWS, AWS, kinds, ANH, AHD,
                         (AWS // 2, AWS // 2), gen, STAGES_8 if kinds == 4 else None)
    hd64_fp32_case(other, names, "heads of 64 (C 384) K=4", atd, 384, 6, 4, gen, False)
    bf16_window_case(other, bf_names, "heads of 64 (C 384) K=4", atd, AWS, AWS, 4, 6, 64,
                     (AWS // 2, AWS // 2), gen, None)
    # serving: #3 at one 128x128 image, K=4
    qkv, bias, _ = hd64_inputs(gen, 4, (1, 128, 128), AC, ANH)
    with torch.no_grad():
        got = wa.fused_window_mhsa(qkv, bias, ANH, AHD, AWS)
    err = (got - wa.fused_window_mhsa_reference(qkv, bias, ANH, AHD, AWS)).abs().max().item()
    if not err <= KERNEL_TOL:
        fail(f"[atd kernels] #3 at B=1 128x128: {err:.3g} off its plain version")
    with torch.no_grad():
        ms = graph_ms(lambda: wa.fused_window_mhsa(qkv, bias, ANH, AHD, AWS))
    bms, by = bound(4 * 128 * 128 * 256 * AC, nbytes(qkv, bias, got))
    say(f"[atd kernels] #3 64-wide at B=1, 128x128 (serving, K=4): max_abs_err {err:.3g}, "
        f"{ms:.4f} ms (CUDA graphs), bound {bms:.4f} ms ({by}; {100 * bms / ms:.1f}%)")
    # the 32-wide form at HAT-M's heads, the same block: its time beside
    times = {}
    for label, c, nh in (("32-wide, HAT-M's heads of 30", C, NH), ("64-wide, ATD's 35", AC, ANH)):
        for dtype in (None, torch.bfloat16):
            q, t, d = hd64_inputs(gen, 4, atd, c, nh, dtype=dtype)
            hd = c // nh
            with torch.no_grad():
                f = time_ms(lambda: wa.fused_window_mhsa(q, t, nh, hd, AWS), iters=10, warmup=2)
            bwd = wa.fused_window_mhsa_backward(q, t, d, nh, hd, AWS)
            del bwd
            b_ = time_ms(lambda: wa.fused_window_mhsa_backward(q, t, d, nh, hd, AWS), iters=10,
                         warmup=2)
            times[(label, dtype)] = (f, b_)
            say(f"[atd kernels] {label} (B=4, 48x48, K=4) {'bf16' if dtype else 'fp32'}: #3 "
                f"{f:.4f} ms, #8 {b_:.4f} ms")
    mlp_half_case("atd kernels", "srformer_light's MLP half", (16, FID_LQ, FID_LQ), 60, 120, 16,
                  gen)
    mlp_half_case("atd kernels", "srformer's MLP half", (16, FID_LQ, FID_LQ), 180, 360, 24, gen)
    torch.cuda.empty_cache()
    return res


def forward_device_ms(net, x, calls: int = 2, tag: str = "srformer atd serve",
                      kernels: tuple[str, ...] = ()) -> tuple[float, int]:
    """(device ms, kernel launches) of one forward of `net` on x
    (torch.profiler over `calls` forwards after one warm-up; a forward that
    copies from the host, as PSA's and the plain branch's masks do, cannot be
    captured in a CUDA graph); fails unless a profiled kernel's name holds
    each of `kernels`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                net(x)
            torch.cuda.synchronize()
    events = device_events(prof)
    check_retired(tag, events)
    total = sum(e.self_device_time_total for e in events)
    if total == 0:
        fail(f"[{tag}] the profiler recorded no device time")
    check_profiled(tag, "one forward", events, kernels)
    return total / 1e3 / calls, sum(e.count for e in events) // calls


def check_profiled(tag: str, what: str, events, kernels: tuple[str, ...]) -> None:
    """Fail unless a profiled kernel's name holds each of `kernels`."""
    missing = [k for k in kernels if not any(k in e.key for e in events)]
    if missing:
        fail(f"[{tag}] {what}: no profiled kernel is {', '.join(missing)}")
    if kernels:
        say(f"[{tag}] {what} launched " + ", ".join(kernels))


def phase_srformer_atd_serve(seed: int) -> dict[str, int]:
    """64. `test.run` on seeded srformer, srformer_light, atd and atd_light
    at 4x, full width and depth, on the 4 images (three 128x128 LR, one
    100x120: the reflect pad): PNGs and finite PSNR/SSIM, and their kernels'
    launches (#2 once a block for SRFormer, #3 once a block for ATD: 36 in
    one atd forward, on the 64-wide form); each 128x128 forward's device ms.
    Returns atd's serving counts."""
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    hr_dir, lr_dir = make_dataset(OUT / "data", seed)
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    atd_counts: dict[str, int] = {}
    for network, label, per_image in SRF1_SERVE:
        net = build_network({"type": network, "scale": 4}).init_weights(
            torch.Generator().manual_seed(seed))
        weights = OUT / f"{network}_x4_seeded.pth"
        torch.save(net.state_dict(), weights)
        served = serve(f"{network}_x4", weights, hr_dir, lr_dir, seed, {}, network)
        check_counts(f"{label} serving", served["counts"],
                     {k: v * N_IMAGES for k, v in per_image.items()})
        if network == "atd":
            atd_counts = served["counts"]
        weights.unlink()
        net = net.cuda().eval()
        reset_counts()
        with torch.inference_mode():
            out = net(x)
        torch.cuda.synchronize()
        check_counts(f"{label} one 128x128 forward", read_counts(), per_image)
        if out.shape != (1, 3, 512, 512) or not bool(torch.isfinite(out).all()):
            fail(f"{label} forward: bad output {tuple(out.shape)}")
        ms, launches = forward_device_ms(net, x)
        say(f"[srformer atd serve] {label} 4x: one 128x128 forward {ms:.3f} device ms over "
            f"{launches} launches (fp32; {sum(p.numel() for p in net.parameters()):,d} "
            f"parameters), {per_image} of the port's kernels")
        del net
        torch.cuda.empty_cache()
    return atd_counts


def module_fwd_bwd_ms(fn, leaves, calls: int = 3) -> float:
    """Device ms of one forward and backward of `fn()`, its output's
    gradient all ones, into `leaves` (torch.profiler over `calls` calls
    after two warm-ups: a module of many small launches is host-bound, so
    CUDA events around it would time the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def once():
        out = fn()
        if leaves:
            torch.autograd.grad(out, leaves, torch.ones_like(out))

    for _ in range(2):
        once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            once()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / calls


def phase_srformer_atd_train(seed: int) -> dict[str, int]:
    """65. `train.run` of srformer_fidelity.yml and atd_fidelity.yml as
    shipped (bf16; batch 16 and 4 of 48x48 LR; L1 + MS-SSIM; AdamW, EMA
    0.999; their validation through the fp32 twin), six steps each: ms and
    images/s a step, launches (36 + 36 a step of #2/#7's bf16 forms for
    SRFormer, of #3/#8's 64-wide bf16 forms for ATD; none of the fp32
    forms), peak memory, the validation's PSNR/SSIM, the EMA checkpoint
    served; then one step profiled (device ms, busy share) and the share of
    it that SRFormer's PSA (36 blocks) and ATD's category attention and sort
    (36 layers) take, timed alone in bf16 at the step's shapes. Returns
    atd's run's counts."""
    import torch

    from trainner_redux_tpu_torch.archs import build_network_cast
    from trainner_redux_tpu_torch.archs.atd_arch import category_order
    from trainner_redux_tpu_torch.archs.swinir_arch import window_partition

    counts = {}
    for template, network, label, per_step, per_image in SRF1_ATD_RUNS:
        tag = f"{network} bf16 train"
        hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
        val_hr, val_lr = make_dataset(OUT / "data", seed)
        opt = fidelity_options(f"{network}_x4_fidelity_bf16", hr_dir, lr_dir, seed,
                               (val_hr, val_lr), template=template)
        opt.train.total_iter = SIX_STEPS
        batch = opt.datasets["train"].batch_size_per_gpu
        serving = {k: v * N_IMAGES for k, v in per_image.items()}
        counts[network] = phase_train(
            seed, network, f"{label} bf16 ({template.name})", tag, per_step=per_step,
            serve_want=serving, lq=FID_LQ, losses=FID_LOSSES, opt=opt,
            more_launches=lambda s=serving: s, check=bf16_train_check(tag), batch_size=batch,
            steps=SIX_STEPS)
        dev_ms, step_ms = phase_bf16_profile(seed, template, f"{network}_x4_bf16_profile",
                                             per_step, f"{network} bf16 profile",
                                             f"profile_{network}_bf16_train.txt", batch)
        # the plain modules' share, timed alone in bf16 at the step's shapes
        net = build_network_cast({"type": network, "scale": 4}, torch.bfloat16).cuda().train()
        gen = torch.Generator().manual_seed(seed)
        if network == "srformer":
            blk = net.layers[0].residual_group.blocks[1]  # shifted, as every second block
            x = torch.randn(batch, FID_LQ, FID_LQ, 180, generator=gen).cuda().bfloat16()
            xw = window_partition(x, 24).requires_grad_()
            from trainner_redux_tpu_torch.archs.srformer_arch import _psa_mask

            mask = torch.from_numpy(_psa_mask(FID_LQ, FID_LQ, 24, 12)).cuda()
            ms = module_fwd_bwd_ms(lambda: blk.attn(xw, mask), [xw, *blk.attn.parameters()])
            what = "PSA (q, kv, the permuted attention, proj), forward and backward"
        else:
            layer = net.layers[0].layers[0]
            x = torch.randn(batch, FID_LQ * FID_LQ, AC, generator=gen).cuda().bfloat16()
            td = torch.randn(batch, 128, AC, generator=gen).cuda().bfloat16()
            xg = x.requires_grad_()
            _, sim = layer.attn_atd(x, td)
            sim = sim.detach()
            ms = module_fwd_bwd_ms(lambda: layer.attn_aca(xg, sim),
                                   [xg, *layer.attn_aca.parameters()])
            sort_ms = module_fwd_bwd_ms(lambda: category_order(sim)[1].float(), [])
            what = (f"the category attention (sort {sort_ms:.3f} ms of it: argmax, stable "
                    "argsort, inverse), forward and backward")
        say(f"[{tag}] {what}: {ms:.3f} ms a block alone, x 36 = {36 * ms:.1f} ms, "
            f"{100 * 36 * ms / dev_ms:.1f}% of the step's {dev_ms:.1f} device ms "
            f"(step {step_ms:.1f} ms on the host clock)")
        del net
        torch.cuda.empty_cache()
    return counts["atd"]


def phase_srformer_atd_templates(seed: int) -> None:
    """66. Six bf16 steps each of srformer_light_fidelity.yml (#2/#7's bf16
    forms at C 60, 24 + 24 a step), atd_light_fidelity.yml (#3/#8's bf16
    forms, 32-wide, 24 + 24) and atd_gan.yml (DUnet in bf16; #3/#8's 64-wide
    bf16 forms, 36 + 36), as shipped: every log finite."""
    import yaml

    for template, per_step in (
            (SRF1_TEMPLATES / "srformer_light_fidelity.yml",
             {"fused_ln_mlp_bf16": 24, "fused_ln_mlp_backward_bf16": 24}),
            (ATD_TEMPLATES / "atd_light_fidelity.yml",
             {"fused_window_mhsa_bf16": 24, "fused_window_mhsa_backward_bf16": 24})):
        n = yaml.safe_load(template.read_text())["datasets"]["train"]["batch_size_per_gpu"]
        six_bf16_steps(f"{template.stem} bf16", fidelity_options(
            f"{template.stem}_six", OUT, OUT, seed, template=template),
            gan_batch(seed, n, FID_LQ), per_step)
    gan_vgg_line("atd_gan bf16")
    gan = gan_options("atd_gan_bf16_six", OUT, OUT, seed, template=ATD_TEMPLATES / "atd_gan.yml",
                      as_shipped=True)
    six_bf16_steps("atd_gan bf16", gan,
                   gan_batch(seed, gan.datasets["train"].batch_size_per_gpu, FID_LQ), ATD_STEP)


def phase_atd_fp32(seed: int) -> dict[str, int]:
    """67. fp32: `train.run` of atd (batch 4 of 48x48 LR, L1) for FP32_STEPS
    steps, 36 + 36 launches a step of #3/#8's 64-wide fp32 forms; one fp32
    step of atd_light (TF32 off, 4 crops) on the card against the same step
    on the CPU from the same weights and batch (loss BRANCH_LOSS_TOL
    relative, each gradient BRANCH_GRAD_TOL of its largest). The categories
    of every layer are compared between the two and those that differ
    printed: the two sum in other orders, so a token whose top two sims lie
    within rounding takes one category on the card and another on the CPU,
    and then attends in another group. As `KinkPins` does at a ReLU's kink,
    the card's step takes the CPU's category there, and fails if the card's
    sim at that category lies further than CATEGORY_PIN_TOL from its own
    largest. A gradient below NEAR_NULL of its layer's largest is held
    against the layer's largest (`train_branches`' rule for a zero true
    gradient). Then two 3-step bf16 runs of atd_light_fidelity.yml with
    `deterministic: true`, bit for bit. Returns the fp32 run's counts."""
    import torch

    from trainner_redux_tpu_torch.archs import atd_arch
    from trainner_redux_tpu_torch.models import build_model

    tag = "atd fp32"
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    opt = train_options("atd_x4_train", hr_dir, lr_dir, seed, "atd", FID_LQ, ("l1loss",),
                        FP32_STEPS)
    opt.datasets["train"].batch_size_per_gpu = ATD_B
    fp32_step = {"fused_window_mhsa": 36, "fused_window_mhsa_backward": 36}
    counts = phase_train(seed, "atd", "ATD fp32", tag, per_step=fp32_step,
                         serve_want={"fused_window_mhsa": 36 * N_IMAGES}, lq=FID_LQ, opt=opt,
                         batch_size=ATD_B, steps=FP32_STEPS)

    # the CPU's step first, its categories recorded; then the card's, each
    # category that differs at a near-tie pinned to the CPU's
    light = ATD_TEMPLATES / "atd_light_fidelity.yml"
    opt = fidelity_options("atd_light_x4_fp32_step", OUT, OUT, seed, template=light,
                           compute_dtype="float32")
    batch = gan_batch(seed, CPU_STEP_BATCH, FID_LQ)
    real, cpu_cats, differ = atd_arch.category_order, [], []
    pinned = {"tokens": 0, "gap": 0.0}

    def recorded(sim):
        out = real(sim)
        cpu_cats.append(out[0].clone())
        return out

    def pinned_to_cpu(sim):
        cat, order, inv = real(sim)
        want = cpu_cats[len(differ)].to(sim.device)
        moved = cat != want
        differ.append(int(moved.sum()))
        if not bool(moved.any()):
            return cat, order, inv
        gap = (sim.gather(-1, cat[..., None]) - sim.gather(-1, want[..., None]))[..., 0][moved]
        pinned["tokens"] += differ[-1]
        pinned["gap"] = max(pinned["gap"], float(gap.max()))
        return want, *atd_arch.sort_by_category(want)

    steps = {}
    try:
        for device, order_fn in (("cpu", recorded), ("cuda", pinned_to_cpu)):
            atd_arch.category_order = order_fn
            model = build_model(opt, device=device)
            model.feed_data(batch)
            model.optimize_parameters(1)
            steps[device] = (float(model.log_dict["l_g_total"]),
                             {k: p.grad.detach().cpu() for k, p in model.net_g.named_parameters()})
    finally:
        atd_arch.category_order = real
    (loss_card, g_card), (loss_cpu, g_cpu) = steps["cuda"], steps["cpu"]
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)

    def layer_of(name: str) -> str:
        """`layers.g.layers.j` of an ATD layer's parameter, else the name."""
        parts = name.split(".")
        return ".".join(parts[:4]) if parts[:1] == ["layers"] and parts[2:3] == ["layers"] else name

    layer_max: dict[str, float] = {}
    for k, g in g_cpu.items():
        layer_max[layer_of(k)] = max(layer_max.get(layer_of(k), 0.0), g.abs().max().item())
    worst, near_null = (0.0, ""), []
    for k, g in g_cpu.items():
        ref = g.abs().max().item()
        if ref < NEAR_NULL * layer_max[layer_of(k)]:
            near_null.append(k)
            ref = layer_max[layer_of(k)]
        worst = max(worst, ((g_card[k] - g).abs().max().item() / max(ref, 1e-30), k))
    say(f"[{tag}] one fp32 step of atd_light (TF32 off, {CPU_STEP_BATCH} crops) on the card "
        f"against the CPU: loss {loss_card:.6f} against {loss_cpu:.6f} ({rel:.2e} relative, "
        f"limit {BRANCH_LOSS_TOL:g}); the farthest of {len(g_cpu)} gradients {worst[0]:.2e} of "
        f"its largest ({worst[1]}; limit {BRANCH_GRAD_TOL:g}; {len(near_null)} gradients below "
        f"{NEAR_NULL:g} of their layer's largest held against that: "
        f"{', '.join(sorted({k.split('.', 4)[-1] for k in near_null})) or 'none'}); "
        f"categories that differ between "
        f"the two, of {cpu_cats[0].numel()} tokens a layer: "
        + ", ".join(f"{n}" for n in differ)
        + f" in layers 0-{len(differ) - 1}; {pinned['tokens']} tokens pinned to the CPU's "
        f"category, the card's sim there within {pinned['gap']:.3g} of its largest (limit "
        f"{CATEGORY_PIN_TOL:g})")
    if len(differ) != len(cpu_cats) or not pinned["gap"] <= CATEGORY_PIN_TOL:
        fail(f"{tag}: a category differs between the card and the CPU away from a near-tie")
    if not rel <= BRANCH_LOSS_TOL or not worst[0] <= BRANCH_GRAD_TOL:
        fail(f"{tag}: the card's fp32 step is off the CPU's")

    opt = fidelity_options("atd_light_x4_deterministic", OUT, OUT, seed, template=light,
                           deterministic=True)
    n = opt.datasets["train"].batch_size_per_gpu
    batches = [gan_batch(seed + i, n, FID_LQ) for i in range(3)]
    runs = []
    for _ in range(2):
        model = build_model(opt, device="cuda")
        for i, b in enumerate(batches):
            model.feed_data(b)
            model.optimize_parameters(i + 1)
        runs.append(([float(v) for v in model.log_dict.values()],
                     [p.detach().clone() for p in model.net_g.parameters()]))
    (logs_a, params_a), (logs_b, params_b) = runs
    if logs_a != logs_b or not all(torch.equal(a, b) for a, b in zip(params_a, params_b)):
        fail(f"{tag}: two deterministic 3-step bf16 runs of atd_light differ")
    say(f"[{tag}] two 3-step bf16 runs of atd_light with deterministic: true: bit for bit in "
        f"all {len(logs_a)} logs and {len(params_a)} parameters")
    del model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 68-72. DRCT: #3/#8's 128-wide form and #7 at rows of up to 320
# ---------------------------------------------------------------------------

# drct's residual dense group: (C, heads, hidden) of its five Swin blocks
# (heads of 30, 53, 122, 46 and 77 channels; ws 16); swin_3 and swin_5 run
# #3/#8's 128-wide form, swin_4 and swin_5 #7's split rows stage
DRCT_BLOCKS = ((180, 6, 360), (212, 4, 424), (244, 2, 488), (276, 6, 276), (308, 4, 308))
DRCT_GROUPS = {"drct": 6, "drct_l": 12, "drct_xl": 14}
DRCT_B = 8  # the templates' batch of 48x48 LR crops
DRCT_TEMPLATES = TEMPLATES / "DRCT"
# the new forms' kernels that every DRCT training phase's profile must name
DRCT_BF16_KERNELS = (ATTN_FWD_128_BF, *ATTN_BWD_128_BF, LN_BWD_ROWS_BF, *GROUP_BWD_256)
DRCT_FP32_KERNELS = (ATTN_FWD_128, *ATTN_BWD_128, LN_BWD_ROWS)


def drct_step(network: str = "drct") -> dict[str, int]:
    """A bf16 step's launches: #3/#8 and #2/#7 once a block."""
    n = 5 * DRCT_GROUPS[network]
    return {k: n for k in ("fused_window_mhsa_bf16", "fused_window_mhsa_backward_bf16",
                           "fused_ln_mlp_bf16", "fused_ln_mlp_backward_bf16")}


def drct_forms(network: str = "drct", bf16: bool = True) -> dict[str, int]:
    """A step's (bf16) or a forward's (fp32, no backward) launches of the new
    forms: two blocks a group on the 128-wide #3/#8, two on #7's split rows
    stage."""
    n = 2 * DRCT_GROUPS[network]
    if not bf16:
        return {"fused_window_mhsa_hd128": n}
    return {"fused_window_mhsa_bf16_hd128": n, "fused_window_mhsa_backward_bf16_hd128": n,
            "fused_ln_mlp_backward_bf16_c320": n}


def mlp_c320_record(res: dict, tag: str, label: str, shape, c: int, hidden: int, gen) -> None:
    """#7 at rows of 257-320 channels, fp32 and bf16 (`mlp_half_case`'s
    checks first): its time beside its plain version's and the bound,
    recorded as fused_ln_mlp_backward_c320 / _bf16_c320, and split by stage
    (the split rows stage: two dy products, then ln_bwd_rows_kernel)."""
    import torch

    from trainner_redux_tpu_torch.ops import fused_block as fb

    mlp_half_case(tag, label, shape, c, hidden, 16, gen)
    dev = torch.device("cuda")
    b = shape[0]
    x32, p, _, _ = block_inputs(gen, 1, dev, shape=shape, widths=(c, 4, 16, hidden))
    s = torch.full((b,), 1.0 / 0.9, device=dev)
    params = [p[k] for k in ("g", "be", "w1", "b1", "w2", "b2")]
    dout32 = torch.randn(*shape, c, generator=gen).to(dev)
    tokens = b * shape[1] * shape[2]
    for dtype, name in (("fp32", "fused_ln_mlp_backward_c320"),
                        ("bf16", "fused_ln_mlp_backward_bf16_c320")):
        bf = dtype == "bf16"
        x, dout = (x32.bfloat16(), dout32.bfloat16()) if bf else (x32, dout32)
        kern = fb.fused_ln_mlp_backward_bf16 if bf else fb.fused_ln_mlp_backward
        plain = fb.fused_ln_mlp_bwd_bf16_reference if bf else fb.fused_ln_mlp_bwd_reference
        grads = kern(x, *params, s, dout, 16)
        want = plain(x, *params, s, dout, 16)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(grads, want))
        flops, nb = 10 * tokens * c * hidden, nbytes(x, *params, s, dout, *grads)
        ms = time_ms(lambda: kern(x, *params, s, dout, 16), iters=10, warmup=2)
        plain_ms = time_ms(lambda: plain(x, *params, s, dout, 16), iters=5, warmup=1)
        bms, by = bound(flops, nb, PEAK_BF16 if bf else PEAK_FP32)
        say(f"[{tag}] {name} {label}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library n/a, bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
            f"{nb / 1e6:.2f} MB; {'bf16' if bf else 'fp32'}), {100 * bms / ms:.1f}% of it")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bms, "bound_by": by}
        stage_split(tag, f"{name} {label}", lambda: kern(x, *params, s, dout, 16), flops, nb, ms,
                    STAGES_7_SPLIT_BF16 if bf else STAGES_7_SPLIT,
                    kernels=(LN_BWD_ROWS_BF, *WG_BF16) if bf else (LN_BWD_ROWS,), bf16=bf)


def phase_drct_kernels() -> dict:
    """68. #3 and #8's 128-wide form at drct's swin_3 and swin_5 blocks, fp32
    and bf16, the 32- and 64-wide forms timed beside; #3 at DRCT's serving
    shape; #2/#7 at swin_4's and swin_5's MLP halves (see the module doc)."""
    import torch
    import torch.nn.functional as F

    from trainner_redux_tpu_torch.ops import window_attention as wa

    tag = "drct kernels"
    gen = torch.Generator().manual_seed(68)
    res: dict[str, dict] = {}
    other: dict[str, dict] = {}  # cases timed but not the JSON line's
    blk = (DRCT_B, FID_LQ, FID_LQ)
    names = ("fused_window_mhsa_hd128", "fused_window_mhsa_backward_hd128")
    bf_names = ("fused_window_mhsa_bf16_hd128", "fused_window_mhsa_backward_bf16_hd128")
    c3, nh3, _ = DRCT_BLOCKS[2]
    c5, nh5, _ = DRCT_BLOCKS[4]
    nwin = (FID_LQ // AWS) ** 2
    # #3's stage split and #8's (row pass, key pass, bias table) at every case
    hd64_fp32_case(other, names, f"swin_5 (C {c5}, heads of 77) K=4", blk, c5, nh5, 4, gen,
                   True, tag, (ATTN_FWD_128, *ATTN_BWD_128), stages_8_wide(DRCT_B, nwin, nh5))
    bf16_window_case(other, bf_names, f"drct swin_5 (C {c5}, heads of 77) K=4", blk, AWS, AWS, 4,
                     nh5, c5 // nh5, (AWS // 2, AWS // 2), gen, stages_8_wide(DRCT_B, nwin, nh5))
    for kinds in (4, 1):  # the JSON line reports K=1, the unshifted blocks'
        hd64_fp32_case(res, names, f"swin_3 (C {c3}, heads of 122) K={kinds}", blk, c3, nh3,
                       kinds, gen, True, tag, (ATTN_FWD_128, *ATTN_BWD_128),
                       stages_8_wide(DRCT_B, nwin, nh3))
        bf16_window_case(res, bf_names, f"drct swin_3 (C {c3}, heads of 122) K={kinds}", blk,
                         AWS, AWS, kinds, nh3, c3 // nh3, (AWS // 2, AWS // 2), gen,
                         stages_8_wide(DRCT_B, nwin, nh3))
    # #3's fp32 form at DRCT's serving shape (one 128x128 LR), SDPA's forward
    # beside (float mask)
    for label, (c, nh, _) in (("swin_3", DRCT_BLOCKS[2]), ("swin_5", DRCT_BLOCKS[4])):
        q, t, _ = hd64_inputs(gen, 4, (1, 128, 128), c, nh)
        hd = c // nh
        qw, kw, vw, mask = sdpa_windows(q, t, AWS, AWS, 4, nh, hd)
        with torch.no_grad():
            want = wa.fused_window_mhsa_reference(q, t, nh, hd, AWS)
            err = (wa.fused_window_mhsa(q, t, nh, hd, AWS) - want).abs().max().item()
            if not err <= KERNEL_TOL:
                fail(f"[{tag}] #3 at DRCT's serving shape ({label}): {err:.3g} off its plain "
                     "version")
            f = time_ms(lambda: wa.fused_window_mhsa(q, t, nh, hd, AWS), iters=20)
            fg = graph_ms(lambda: wa.fused_window_mhsa(q, t, nh, hd, AWS))
            lib = time_ms(lambda: F.scaled_dot_product_attention(qw, kw, vw, attn_mask=mask),
                          iters=20)
        say(f"[{tag}] #3 fp32 at DRCT's serving shape ({label}: C {c}, heads of {hd}; B=1, "
            f"128x128 LR, K=4): max_abs_err {err:.3g}, kernel {f:.4f} ms ({fg:.4f} by CUDA "
            f"graphs), SDPA forward {lib:.4f} ms")
    # the three widths of #3/#8 on the same block (K=4), fp32 and bf16
    for label, (c, nh, _) in (("32-wide, swin_1's heads of 30", DRCT_BLOCKS[0]),
                              ("64-wide, swin_2's heads of 53", DRCT_BLOCKS[1]),
                              ("128-wide, swin_3's heads of 122", DRCT_BLOCKS[2])):
        for dtype in (None, torch.bfloat16):
            q, t, d = hd64_inputs(gen, 4, blk, c, nh, dtype=dtype)
            hd = c // nh
            with torch.no_grad():
                f = time_ms(lambda: wa.fused_window_mhsa(q, t, nh, hd, AWS), iters=10, warmup=2)
            b_ = time_ms(lambda: wa.fused_window_mhsa_backward(q, t, d, nh, hd, AWS), iters=10,
                         warmup=2)
            say(f"[{tag}] {label} (B=8, 48x48, K=4) {'bf16' if dtype else 'fp32'}: #3 "
                f"{f:.4f} ms, #8 {b_:.4f} ms")
    mlp_c320_record(res, tag, "swin_5's MLP half", blk, c5, DRCT_BLOCKS[4][2], gen)
    mlp_half_case(tag, "swin_4's MLP half", blk, DRCT_BLOCKS[3][0], DRCT_BLOCKS[3][2], 16, gen)
    torch.cuda.empty_cache()
    return res


def phase_drct_serve(seed: int) -> dict[str, int]:
    """69. `test.run` on seeded drct (a 128x128 and a 100x120 LR), drct_l and
    drct_xl (a 128x128 LR) at 4x: launches of #3 and #2 (once a block) and
    of the 128-wide #3 (two blocks a group); each 128x128 forward's device
    ms, with the three #3 widths' kernels in its profile. Returns drct's
    form counts."""
    import torch

    from trainner_redux_tpu_torch.archs import build_network

    tag = "drct serve"
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(seed)).cuda()
    drct_forms_served: dict[str, int] = {}
    for network, sizes in (("drct", ((128, 128), (100, 120))), ("drct_l", ((128, 128),)),
                           ("drct_xl", ((128, 128),))):
        label = network.replace("drct", "DRCT").replace("_l", "-L").replace("_xl", "-XL")
        hr_dir, lr_dir = make_dataset(OUT / f"{network}_data", seed, sizes)
        net = build_network({"type": network, "scale": 4}).init_weights(
            torch.Generator().manual_seed(seed))
        weights = OUT / f"{network}_x4_seeded.pth"
        torch.save(net.state_dict(), weights)
        served = serve(f"{network}_x4", weights, hr_dir, lr_dir, seed, {}, network,
                       images=len(sizes))
        blocks = 5 * DRCT_GROUPS[network]
        per_run = blocks * len(sizes)
        check_counts(f"{label} serving", served["counts"],
                     {"fused_window_mhsa": per_run, "fused_ln_mlp": per_run})
        wide = {k: v * len(sizes) for k, v in drct_forms(network, bf16=False).items()}
        if served["forms"]["fused_window_mhsa_hd128"] != wide["fused_window_mhsa_hd128"]:
            fail(f"[{tag}] {label}: {served['forms']} of the forms, expected {wide}")
        if network == "drct":
            drct_forms_served = served["forms"]
        weights.unlink()
        shutil.rmtree(OUT / f"{network}_data", ignore_errors=True)
        net = net.cuda().eval()
        ms, launches = forward_device_ms(net, x, tag=tag, kernels=(
            ATTN_FWD[256], ATTN_FWD_64, ATTN_FWD_128, "ln_rows_kernel", "linear_kernel"))
        with torch.inference_mode():
            out = net(x)
        if out.shape != (1, 3, 512, 512) or not bool(torch.isfinite(out).all()):
            fail(f"[{tag}] {label} forward: bad output {tuple(out.shape)}")
        say(f"[{tag}] {label} 4x: one 128x128 forward {ms:.3f} device ms over {launches} "
            f"launches (fp32; {sum(p.numel() for p in net.parameters()):,d} parameters); "
            f"{blocks} #3 and {blocks} #2 launches an image, "
            f"{wide['fused_window_mhsa_hd128'] // len(sizes)} of #3 on the 128-wide form")
        del net
        torch.cuda.empty_cache()
    return drct_forms_served


def phase_drct_train(seed: int) -> dict[str, int]:
    """70. `train.run` of drct_fidelity.yml as shipped, TRAIN_STEPS bf16
    steps, and one step profiled (see the module doc). Returns the run's
    form counts."""
    template = DRCT_TEMPLATES / "drct_fidelity.yml"
    tag = "drct bf16 train"
    hr_dir, lr_dir = make_dataset(OUT / "train_data", seed, ((128, 128),) * 16)
    val_hr, val_lr = make_dataset(OUT / "data", seed)
    opt = fidelity_options("drct_x4_fidelity_bf16", hr_dir, lr_dir, seed, (val_hr, val_lr),
                           template=template)
    serving = {"fused_window_mhsa": 30 * N_IMAGES, "fused_ln_mlp": 30 * N_IMAGES}
    forms: dict[str, int] = {}

    def run_launches():  # read after the run, before the EMA checkpoint is served
        forms.update(read_form_counts())
        return serving

    phase_train(seed, "drct", f"DRCT bf16 ({template.name})", tag, per_step=drct_step(),
                serve_want=serving, lq=FID_LQ, losses=FID_LOSSES, opt=opt,
                more_launches=run_launches, check=bf16_train_check(tag), batch_size=DRCT_B)
    want = {k: v * TRAIN_STEPS for k, v in drct_forms().items()}
    # the validation's fp32 twin
    want["fused_window_mhsa_hd128"] = drct_forms(bf16=False)["fused_window_mhsa_hd128"] * N_IMAGES
    got = {k: forms.get(k, -1) for k in want}
    if got != want:
        fail(f"[{tag}] the new forms' launches {got}, expected {want}")
    say(f"[{tag}] the new forms' launches over the run: {got}")
    dev_ms, step_ms = phase_bf16_profile(
        seed, template, "drct_x4_bf16_profile", drct_step(), "drct bf16 profile",
        "profile_drct_bf16_train.txt", DRCT_B,
        kernels=DRCT_BF16_KERNELS,
        sums={"the 128-wide #8 (row and key passes)": ATTN_BWD_128_BF,
              "the 128-wide #3": (ATTN_FWD_128_BF,),
              "the 32-wide #8 bf16 (swin_1: row pass, key pass, group sums)": GROUP_BWD_256})
    say(f"[{tag}] profiled step: {dev_ms:.3f} device ms, {step_ms:.1f} ms on the host clock")
    return forms


def phase_drct_templates(seed: int) -> None:
    """71. drct_gan.yml, drct_l_fidelity.yml and drct_otf.yml less its
    MS-SSIM six bf16 steps each, drct_xl_fidelity.yml four, as shipped: the
    wrappers' counts of the new forms each step, and one more drct_l step
    profiled, naming them (a profiled DRCT step costs some 10 s of the
    host's time, so one template's)."""
    gan_vgg_line("drct_gan bf16")
    gan = gan_options("drct_gan_bf16_six", OUT, OUT, seed,
                      template=DRCT_TEMPLATES / "drct_gan.yml", as_shipped=True)
    six_bf16_steps("drct_gan bf16", gan,
                   gan_batch(seed, gan.datasets["train"].batch_size_per_gpu, FID_LQ),
                   drct_step(), forms=drct_forms())
    for network, steps in (("drct_l", 6), ("drct_xl", 4)):
        template = DRCT_TEMPLATES / f"{network}_fidelity.yml"
        opt = fidelity_options(f"{network}_x4_bf16_six", OUT, OUT, seed, template=template)
        six_bf16_steps(f"{template.stem} bf16", opt,
                       gan_batch(seed, opt.datasets["train"].batch_size_per_gpu, FID_LQ),
                       drct_step(network), steps=steps, forms=drct_forms(network),
                       kernels=DRCT_BF16_KERNELS if network == "drct_l" else ())
    hr_dir, _ = make_dataset(OUT / "otf_data", seed, ((128, 128),) * 16)
    otf = otf_bf16_options("drct_x4_otf_bf16_six", hr_dir, seed,
                           template=DRCT_TEMPLATES / "drct_otf.yml")
    six_bf16_steps("drct_otf bf16", otf, otf_batch(otf, seed), drct_step(), forms=drct_forms())
    shutil.rmtree(OUT / "otf_data")


def phase_drct_fp32(seed: int) -> dict[str, int]:
    """72. One fp32 step of a one-group drct on the card against the CPU
    (see the module doc). Returns the card step's form counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_redux_tpu_torch.archs import arch_util, drct_arch
    from trainner_redux_tpu_torch.models import build_model

    tag = "drct fp32"
    opt = train_options("drct_one_group_fp32_step", OUT, OUT, seed, "drct", 32, ("l1loss",), 1,
                        network_g={"type": "drct", "num_heads": [6], "depths": [6]})
    opt.datasets["train"].batch_size_per_gpu = 2
    batch = gan_batch(seed, 2, 32)
    real = arch_util.leaky_relu
    cpu_inputs: list = []
    kinks = {"pinned": 0, "share": 0.0, "calls": 0}

    def recorded(x, slope):
        cpu_inputs.append(x.detach().clone())
        return real(x, slope)

    def pinned(x, slope):
        xp = cpu_inputs[kinks["calls"]].to(x.device)
        kinks["calls"] += 1
        side = xp > 0
        moved = side != (x > 0)
        if bool(moved.any()):
            share = max((x.detach()[moved].abs().max() / x.detach().abs().max()).item(),
                        (xp[moved].abs().max() / xp.abs().max()).item())
            if not share <= KINK_TOL:
                fail(f"[{tag}] a LeakyReLU input differs in sign between the card and the CPU "
                     f"at {share:.3g} of its largest |value|")
            kinks["pinned"] += int(moved.sum())
            kinks["share"] = max(kinks["share"], share)
        return torch.where(side, x, arch_util.scale_by(x, slope))

    steps = {}
    try:
        for device, fn in (("cpu", recorded), ("cuda", pinned)):
            arch_util.leaky_relu = drct_arch.leaky_relu = fn
            model = build_model(opt, device=device)
            reset_counts()
            model.feed_data(batch)
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                  if device == "cuda" else nullcontext()) as prof:
                model.optimize_parameters(1)
            if device == "cuda":
                torch.cuda.synchronize()
                counts, forms = read_counts(), read_form_counts()
                check_profiled(tag, "the card's step", device_events(prof), DRCT_FP32_KERNELS)
            steps[device] = (float(model.log_dict["l_g_total"]),
                             {k: p.grad.detach().cpu() for k, p in model.net_g.named_parameters()})
    finally:
        arch_util.leaky_relu = drct_arch.leaky_relu = real
    want = {k: 5 for k in ("fused_window_mhsa", "fused_window_mhsa_backward", "fused_ln_mlp",
                           "fused_ln_mlp_backward")}
    check_counts(f"{tag} card step", counts, want)
    wide = {"fused_window_mhsa_hd128": 2, "fused_window_mhsa_backward_hd128": 2,
            "fused_ln_mlp_backward_c320": 2}
    if {k: forms[k] for k in wide} != wide:
        fail(f"[{tag}] the new fp32 forms' launches {forms}, expected {wide}")
    (loss_card, g_card), (loss_cpu, g_cpu) = steps["cuda"], steps["cpu"]
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)

    def block_of(name: str) -> str:
        """`layers.0.swinK` / `layers.0.adjustK` of a group's parameter, else
        the name."""
        parts = name.split(".")
        return ".".join(parts[:3]) if parts[0] == "layers" else name

    block_max: dict[str, float] = {}
    for k, g in g_cpu.items():
        block_max[block_of(k)] = max(block_max.get(block_of(k), 0.0), g.abs().max().item())
    worst, near_null = (0.0, ""), []
    for k, g in g_cpu.items():
        ref = g.abs().max().item()
        if ref < NEAR_NULL * block_max[block_of(k)]:
            near_null.append(k)
            ref = block_max[block_of(k)]
        worst = max(worst, ((g_card[k] - g).abs().max().item() / max(ref, 1e-30), k))
    say(f"[{tag}] one fp32 step of a one-group drct (embed 180, 2 crops of 32x32 LR, TF32 off) "
        f"on the card against the CPU: loss {loss_card:.6f} against {loss_cpu:.6f} ({rel:.2e} "
        f"relative, limit {BRANCH_LOSS_TOL:g}); the farthest of {len(g_cpu)} gradients "
        f"{worst[0]:.2e} of its largest ({worst[1]}; limit {BRANCH_GRAD_TOL:g}; "
        f"{len(near_null)} below {NEAR_NULL:g} of their block's largest held against that); "
        f"{kinks['pinned']} LeakyReLU inputs pinned to the CPU's side (within "
        f"{kinks['share']:.3g} of their largest); card launches {counts}, forms {wide}")
    if kinks["pinned"] > KINK_MAX:
        fail(f"[{tag}] {kinks['pinned']} LeakyReLU inputs pinned, more than {KINK_MAX}")
    if not rel <= BRANCH_LOSS_TOL or not worst[0] <= BRANCH_GRAD_TOL:
        fail(f"[{tag}] the card's fp32 step is off the CPU's")
    del model
    torch.cuda.empty_cache()
    return forms


def timed(name: str, fn, *args, **kwargs):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    say(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    seed = args.seed

    (OUT / "summary.txt").unlink(missing_ok=True)
    t0 = time.perf_counter()
    info = timed("device", phase_device)
    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels)
    launches = timed("path", phase_path, seed)
    timed("branches", phase_branches, seed)
    timed("profile", phase_profile, seed)
    kernels.update(timed("train kernels", phase_train_kernels))
    train_counts = timed("train", phase_train, seed, steps=FP32_STEPS)
    launches.update({k: train_counts[k] for k in ("fused_swin_block_train",
                                                  "fused_swin_block_train_backward")})
    timed("train branches", phase_train_branches, seed)
    timed("train profile", phase_train_profile, seed)
    kernels.update(timed("hat kernels", phase_hat_kernels))
    timed("hat path", phase_hat_path, seed)
    hat_step = {"fused_window_mhsa": HAT_BLOCKS, "fused_window_mhsa_backward": HAT_BLOCKS,
                "fused_ln_mlp": HAT_MLPS, "fused_ln_mlp_backward": HAT_MLPS}
    hat_counts = timed("hat train", phase_train, seed, "hat_m", "HAT-M", "hat train", hat_step,
                       hat_serving_counts(), steps=FP32_STEPS)
    launches.update(fused_window_mhsa_ws16=hat_counts["fused_window_mhsa"],
                    fused_window_mhsa_backward=hat_counts["fused_window_mhsa_backward"],
                    fused_ln_mlp_backward=hat_counts["fused_ln_mlp_backward"])
    timed("hat train branches", train_branches, seed, "hat_m", "HAT-M", {}, hat_step,
          "hat train branches")
    timed("hat train branches (SwinIR-M unfused)", train_branches, seed, "swinir_m",
          "SwinIR-M unfused", {"TRAINNER_FUSED_BLOCK": "0"},
          {"fused_window_mhsa": BLOCKS, "fused_window_mhsa_backward": BLOCKS},
          "hat train branches")
    timed("hat train profile", phase_train_profile, seed, "hat_m", "hat train profile",
          "profile_hat_train.txt")
    kernels.update(timed("dat kernels", phase_dat_kernels))
    timed("dat path", phase_dat_path, seed)
    dat_step = {"fused_rect_mhsa": DAT_RECT, "fused_rect_mhsa_backward": DAT_RECT}
    dat_losses = ("l1loss", "mssimloss")
    dat_counts = timed("dat train", phase_train, seed, "dat", "DAT", "dat train", dat_step,
                       dat_serving_counts(), DAT_LQ, dat_losses, steps=FP32_STEPS)
    launches.update({k: dat_counts[k] for k in dat_step})
    from trainner_redux_tpu_torch.archs.dat_arch import ZERO_GRAD_PARAMS

    timed("dat train branches", train_branches, seed, "dat", "DAT", {}, dat_step,
          "dat train branches", DAT_LQ, ZERO_GRAD_PARAMS)
    timed("dat train profile", phase_train_profile, seed, "dat", "dat train profile",
          "profile_dat_train.txt", DAT_LQ, dat_losses)
    kernels.update(timed("swin2sr kernels", phase_swin2sr_kernels))
    timed("swin2sr path", phase_branch_path, seed, "swin2sr_m", "Swin2SR-M", "swin2sr path",
          swin2sr_serving_counts(), {"fused_cos_attn_block": SWIN2SR_BLOCKS,
                                     "fused_postnorm_mlp": SWIN2SR_BLOCKS}, "unfused")
    s2_step = {k: SWIN2SR_BLOCKS for k in ("fused_cos_attn_block", "fused_cos_attn_block_backward",
                                           "fused_postnorm_mlp", "fused_postnorm_mlp_backward")}
    s2_counts = timed("swin2sr train", phase_train, seed, "swin2sr_m", "Swin2SR-M",
                      "swin2sr train", s2_step, swin2sr_serving_counts(), S2_LQ, S2_LOSSES,
                      steps=FP32_STEPS)
    launches.update({k: s2_counts[k] for k in s2_step})
    timed("swin2sr train branches", phase_timed_train_branches, seed, "swin2sr_m", "Swin2SR-M",
          "swin2sr train branches", s2_step, S2_LQ, "unfused")
    timed("swin2sr train profile", phase_train_profile, seed, "swin2sr_m",
          "swin2sr train profile", "profile_swin2sr_train.txt", S2_LQ, S2_LOSSES)
    kernels.update(timed("jpeg kernel", phase_jpeg_kernel))
    hr_dir, _ = make_dataset(OUT / "otf_data", seed, ((128, 128),) * 16)
    timed("otf degrade", phase_otf_degrade, seed, hr_dir)
    otf_counts = timed("otf train", phase_otf_train, seed, hr_dir)
    launches["jpeg_block_transform"] = otf_counts["jpeg_block_transform"]
    timed("otf train profile", phase_otf_profile, seed, hr_dir)
    shutil.rmtree(OUT / "otf_data")
    kernels.update(timed("srformerv2 kernels", phase_srformerv2_kernels))
    timed("srformerv2 path", phase_branch_path, seed, "srformerv2", "SRFormerV2",
          "srformerv2 path", srformerv2_serving_counts(),
          {"fused_attn_block": SRF_SWIN, "fused_ln_mlp": SRF_SWIN}, "plain")
    srf_step = {k: SRF_SWIN for k in ("fused_attn_block", "fused_attn_block_backward",
                                      "fused_ln_mlp", "fused_ln_mlp_backward")}
    srf_counts = timed("srformerv2 train", phase_train, seed, "srformerv2", "SRFormerV2",
                       "srformerv2 train", srf_step, srformerv2_serving_counts(), SRF_LQ,
                       S2_LOSSES, steps=FP32_STEPS)
    launches.update(fused_attn_block_ws12=srf_counts["fused_attn_block"],
                    fused_attn_block_backward=srf_counts["fused_attn_block_backward"],
                    fused_ln_mlp_c240=srf_counts["fused_ln_mlp"],
                    fused_ln_mlp_backward_c240=srf_counts["fused_ln_mlp_backward"])
    timed("srformerv2 train branches", phase_timed_train_branches, seed, "srformerv2",
          "SRFormerV2", "srformerv2 train branches", srf_step, SRF_LQ, "plain")
    timed("srformerv2 train profile", phase_train_profile, seed, "srformerv2",
          "srformerv2 train profile", "profile_srformerv2_train.txt", SRF_LQ, S2_LOSSES)
    attn_train, attn_train_counts = timed("attn train", phase_attn_train)
    kernels.update(attn_train)
    launches.update(attn_train_counts)
    timed("deterministic", phase_deterministic, seed)
    timed("gan branches", phase_gan_branches, seed)
    timed("gan train", phase_gan_train, seed, steps=FP32_STEPS)
    timed("gan train profile", phase_gan_profile, seed)
    timed("gan deterministic", phase_gan_deterministic, seed)
    kernels.update(timed("bf16 kernels", phase_bf16_kernels))
    bf16_counts = timed("bf16 train", phase_bf16_train, seed)
    launches.update({k: bf16_counts[k] for k in BF16_TRAIN_STEP})
    timed("bf16 train profile", phase_bf16_profile, seed)
    timed("bf16 branches", phase_bf16_branches, seed)
    kernels.update(timed("bf16 window kernels", phase_bf16_window_kernels))
    fam = {f: timed(f"{f} bf16 train", phase_bf16_family_train, seed, f) for f in BF16_RUNS}
    launches.update({k: fam["hat"][k] for k in BF16_RUNS["hat"][3]})
    launches.update({k: fam["dat"][k] for k in BF16_RUNS["dat"][3]})
    launches.update({f"{k}_ws8": fam["swinir_l"][k] for k in ("fused_window_mhsa_bf16",
                                                              "fused_window_mhsa_backward_bf16")})
    for f in ("hat", "dat"):
        timed(f"{f} bf16 profile and branches", phase_bf16_family_profile_branches, seed, f)
    kernels.update(timed("srformerv2 bf16 kernels", phase_srformerv2_bf16_kernels))
    srf16 = timed("srformerv2 bf16 train", phase_srformerv2_bf16_train, seed)
    launches.update({k: srf16[k] for k in ("fused_attn_block_bf16",
                                           "fused_attn_block_backward_bf16")})
    timed("bf16 gan", phase_bf16_gan, seed)
    hr_dir, _ = make_dataset(OUT / "otf_data", seed, ((128, 128),) * 16)
    timed("otf bf16", phase_otf_bf16, seed, hr_dir)
    shutil.rmtree(OUT / "otf_data")
    kernels.update({k: v for k, v in timed("swin2sr bf16 kernels",
                                           phase_swin2sr_bf16_kernels).items()})
    s2_16 = timed("swin2sr bf16 train", phase_swin2sr_bf16_train, seed)
    launches.update({k: s2_16[k] for k in S2_BF16_STEP})
    timed("swin2sr bf16 branches", phase_bf16_branches, seed, "swin2sr_m", "Swin2SR-M",
          S2_BF16_RUN[0], "swin2sr bf16 branches", S2_BF16_STEP, S2_FP32_STEP,
          tensor_check=False)
    timed("swin2sr bf16 templates", phase_swin2sr_bf16_templates, seed)
    timed("conv serve", phase_conv_serve, seed)
    timed("span_s train", phase_span_s_train, seed)
    timed("conv templates", phase_conv_templates, seed)
    timed("conv bench", phase_conv_bench, seed)
    kernels.update(timed("atd kernels", phase_atd_kernels))
    atd_serve = timed("srformer atd serve", phase_srformer_atd_serve, seed)
    launches["fused_window_mhsa_hd64"] = atd_serve["fused_window_mhsa"]
    atd_bf16 = timed("srformer atd train", phase_srformer_atd_train, seed)
    launches.update(fused_window_mhsa_bf16_hd64=atd_bf16["fused_window_mhsa_bf16"],
                    fused_window_mhsa_backward_bf16_hd64=atd_bf16[
                        "fused_window_mhsa_backward_bf16"])
    timed("srformer atd templates", phase_srformer_atd_templates, seed)
    atd_fp32 = timed("atd fp32", phase_atd_fp32, seed)
    launches["fused_window_mhsa_backward_hd64"] = atd_fp32["fused_window_mhsa_backward"]
    kernels.update(timed("drct kernels", phase_drct_kernels))
    launches["fused_window_mhsa_hd128"] = timed("drct serve", phase_drct_serve, seed)[
        "fused_window_mhsa_hd128"]
    drct_forms_run = timed("drct train", phase_drct_train, seed)
    launches.update({k: drct_forms_run[k] for k in drct_forms()})
    timed("drct templates", phase_drct_templates, seed)
    launches.update({k: v for k, v in timed("drct fp32", phase_drct_fp32, seed).items()
                     if k in ("fused_window_mhsa_backward_hd128", "fused_ln_mlp_backward_c320")})
    say(f"[time] all phases: {time.perf_counter() - t0:.1f} s")

    records = []
    for name in KERNELS:
        rec = kernels[name]
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
