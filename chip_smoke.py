"""Drive the PyTorch port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi)
     and the torch/CUDA versions;
  2. build: compiles the Hopper kernels from videoseal_tpu_torch/csrc, one
     nvcc per source, all at once;
  3. K1 (planar blend) against its plain version at 1080p, F=4, and at
     720x1280 and 128x200 (the prediction downscaled: the kernel's general
     width path), F=2, both JND branches with and without the detect output;
     times each setting at F=128 with its bound, the detect height pass
     alone, and the full-resolution branch with its heat cut down (the
     window alone, the stencil sums: blend_planar_attribution);
  4. K2 (ConvNeXt block: dwln, pw1, grn_stats, pw2) against its plain
     version at the four stage shapes, B=32, and at 3x12x20x96 and
     3x12x20x192 (masked last M tiles), bf16 and f32; per stage in bf16
     times the block twice, each part with its bound, and cuBLAS on the two
     products' shapes (a yardstick the port never calls); then at
     chunkyseal's four stage shapes, B=4 (odd H*W, widths padded to 16),
     and at 3x7x9x40 and 3x5x7x22, bf16 and f32, the pad channels exactly
     0; each chunkyseal stage in bf16 timed twice with its bound and its
     parts, and the 36 blocks of one frame beside their bound;
  5. the planar slice: videoseal_1.0 at random init (seed 0) in bf16,
     embed_detect_planar over 128 planar 1080p frames in the scored and the
     card-default modes; checks shapes, launch counts, the scaling_w=0
     identity, CPU-vs-card agreement on 4 frames; times it, and the scored
     mode with the UNet's s2d and folded routes in turns, at both cuDNN TF32 settings;
     unet (after 5): the serving UNet's two routes (videoseal_tpu_torch/
     kernels/unet_fused.py, the folded forward, and kernels/unet_s2d.py, the
     space-to-depth one; no kernel): with_dtype("bfloat16") on the card
     serves the s2d route, as ROADMAP §3.52 decided (its config
     and counters of each route's calls, apart from the kernels' counts);
     for the four cards' embedders (BatchNorm statistics and rms gains
     drawn) on one chunk of 32 key frames at 256x256, the folded forward
     against the module and the s2d forward against the folded one on the
     card in float32 with TF32 off, each route's bf16 forward on the card
     against the CPU's on a frame; times both routes per chunk in turns at
     PyTorch's TF32 defaults (phase K2 leaves cuDNN's off after it);
     where the card serves the s2d route, every phase that holds a bf16
     card slice against the CPU serves it on the CPU too (cpu_route);
     tools (after unet): the JAX package's timing tools in the port:
     evals/unet_bench.main() (the stages unet_apply_fused chains) and
     evals/stage_bench.main(["--decompose"]) at their defaults (128 u8
     1080p frames, the s2d UNet at its five schedules: K2 1,296, K4 9, K5
     18), each K2, K4 and K5 launch's first call per shape held against
     its plain version; each stage's ms printed, no time asserted;
     layouts (after tools): the JAX package's layout tools in the port at
     2 timed calls a row: unet_bench --s2d and --s2d_pieces, conv_probe,
     resize_probe, dw_mxu_probe (K8 54), planar_probe --lowres_stages (K1
     at each rs of its sweep, bit for bit the default's), r4_probe (K1,
     K2 and K3 over 128 frames); each K1, K2, K3 and K8 launch's first call
     per shape and settings held against its plain version; rows printed,
     no time asserted;
  6. K4, K5, K6 (full-resolution JND on NHWC frames) against their plain
     versions at 1080p, F=4 (K4's delta and blend modes and K5 on u8 and
     f32 frames, K6 with 1- and 3-channel predictions in f32 and bf16),
     K4's four cases, K5 on both frame types and K6 again at F=2 and
     1078x1922 (unaligned rows, ragged groups, strips and chunks), K4's
     four at F=2 and 120x200 (its general width path), and K5(resize(pred))
     against K4(pred); K5 bit for bit against its plain version and against
     its parent, the strip design (K7's full_nosqrt at rs=8), also at
     120x200 and its geometry's edges (K5_EDGES); times each and its plain
     version at F=128, K5 in turns with its parent and over its geometry's
     sweep (K5_SWEEP), with each instance's registers and shared memory;
  7. the NHWC slice: videoseal_1.0 at random init (seed 0) in bf16, embed
     of 128 u8 1080p frames as a video, detect and extract_message of the
     result, embed of 32 float frames as images; checks shapes, launch
     counts, the scaling_w=0 identity, CPU-vs-card agreement on 4 frames;
     times embed+detect, and embed+detect of 32 frames in the
     lowres mode with the UNet's s2d and folded routes in turns;
  8. chunkyseal at full width, random init in bf16: embed of 8 float 1080p
     frames as images (the K6 path; the K6 launch, shapes, the scaling_w=0
     identity), then detect and extract_message of the result (K2 at the
     padded widths, 36 launches a chunk; preds (8, 1025), finite; the
     logits against the CPU's on 2 frames); times embed and detect;
  9. K3 (k ConvNeXt blocks in one launch, on K2's parts) against its plain
     version and, bit for bit, against k K2 launches at the four stage
     shapes, B=32, and at 3x12x20x96 (masked last M tiles), k = 2, 3, 4,
     bf16 and f32; prints each instance's occupancy; times the groups of one
     grouped 32-frame chunk beside the same blocks as K2 launches, and the
     grid barrier on a grid of tiny phases;
 10. the extractor's grouped route: videoseal_1.0 at random init (seed 0) in
     bf16, convnext_apply_fused(max_block_group=4) plus the pixel decoder
     over 128 frames at 256x256 in chunks of 32 (K3 20 and K2 16 launches),
     its logits equal to the max_block_group=1 route's and near the CPU
     route's on 4 frames; times both routes in turns;
 11. the probes: every K7 variant (all strip heights, f32 and u8 frames)
     against its plain version at a small ragged size, K7's production
     variant against K5 (the strip design against the row-streaming one,
     bit for bit); then each probe's main() at the TPU probe's shapes
     (JSON lines); then every case of both sweeps against its plain version
     on the sweep's inputs and shapes (K7 at F=128, 1080p; K8 at
     128x64x64x96 and 128x32x32x192), K8's production_block on a zero
     halo against K2, K7's production variant against K5 again, and the
     plain versions of the two cases the kernels line reports timed;
 12. pixelseal at random init (seed 0) in bf16: NHWC embed of 32 u8 1080p
     frames as a video and detect (K4 1, K2 18), the scored planar mode over
     the same frames (K1 1, K2 18), the scaling_w=0 identity on both, card
     against CPU on 2 frames; timed;
 13. videoseal_0.0 at random init (seed 0) in bf16: NHWC embed of 32 u8
     1080p frames as a video, detect and extract_message (the SAM ViT; no
     kernel on the path, every count 0; preds (32, 97)), the scaling_w=0
     identity, card against CPU on 2 frames in f32 and in bf16; timed;
 14. streaming, videoseal_1.0 in bf16, 96 1080p frames in chunks of 32: prints
     whether the native media runtime loaded (the committed .so or a
     _build/ copy) or why not. With it: a synthesized h264 clip, each stage
     timed alone (decode, encode, the device stage with its copies), then
     embed_video (planar, K1 one a chunk) and detect_video (K2 18 a chunk)
     end to end with stream_fps, overlap_ratio and the engine's device
     timeline (copies, kernels, copies under kernels). Without it: the same
     engine over in-memory planar frames (K1 one a chunk), again with the
     host's copies taken away (the engine bound by the device), and a
     detect stream over its output (K2 18 a chunk), printing "native":
     false, and,
     where cv2 imports, embed_video's NHWC file path through cv2 (mp4v, 64
     frames; K4 one a chunk) and detect_video. Holds each detect stream's logits
     against detect on the same frames, the frame count and a finite PSNR
     of the output against its source;
 15. the evals: evals.speed.test_speed on 32 float 1080p frames (K4, K2) and
     evals.lowres_quality.run on 8 1080p frames (K1 2, K2 36); prints
     their rows;
 16. attacks, videoseal_1.0 in bf16 at PyTorch's TF32 defaults: every aug of
     the image and video grids at each grid strength on the card against
     the CPU (2 float frames at 720x1280, 4 for the video rows; warps,
     blurs and value ops within 1e-5, the JPEG proxy's flipped roundings on
     < 1e-3 of values and within one quantisation step); evals.full.evaluate
     over the image grid (4 float 1080p images, 78 rows: K4 1, K2 1,404; the
     identity row against a direct embed) and the video grid (16 frames at
     720x1280, 36 rows: K4 1, K2 648; the codec rows' route printed; the
     proxy refusing 1080 rows); 16 draws of the augs_geometric augmenter
     forward and backward on 32 watermarked 256x256 images (embed K4 1) and
     a detect of the last (K2 18). Per-row attack and detect ms (CUDA
     events), the slowest five attacks, the grids' walls; rows in
     chiprun_out/attacks_*_grid.csv;
 17. training, videoseal_1.0 at full width: train.main (8 steps at batch 16
     on synthetic images, DEFAULT_AUGS, TensorBoard, one in-training eval:
     K2 72, the steps none; a checkpoint) and a run resumed from it (2 steps,
     its eval: K2 72): every logged value finite, the generator, the
     discriminator and the BatchNorm statistics changed, the resumed run at
     the saved step; ms a step (CUDA events, median of the steps after the
     first two), images/s and peak memory beside the nvidia-smi line; K2 at
     the eval's shapes (B=8, f32) against its plain version; one step's
     parts timed (embed, downstream, backward, discriminator); one image step
     (batch 2) and one video step (a 16-frame clip) of make_train_step on the
     card against the CPU, balanced 0 and 1, TF32 off: losses, scales,
     gradients, updated tensors and BatchNorm statistics. The run's log and
     eval rows in chiprun_out/train/;
 18. data-parallel training and the rest of training, videoseal_1.0 at
     full width (float32, PyTorch's TF32 defaults): two ranks sharing the
     card over gloo (torch.multiprocessing), each on half of a batch of 16
     (or of 2 clips of 16 frames), one SGD step from the same state and
     DEFAULT_AUGS' draws, image and video, balanced 0 and 1, TF32 off (as
     phase 17's card-vs-CPU), against one process on the whole batch
     (losses and scales within 1e-5 relative, BatchNorm statistics within
     1e-5 of each tensor's largest, the parameters as phase 17 holds them,
     the ranks equal, the gradients' gap printed), and the image cases at
     the TF32 defaults (printed, the parameters held); train.main
     --distributed 1 in a subprocess with torchrun's environment (NCCL at
     world size 1; world size 2 where a second card exists): 8 steps at
     batch 16 on 64 PNGs written at start-up, one eval with image and video
     rows (K2 144), a sharded checkpoint (--ckpt_format orbax) and a resume
     from it for 2 steps, its restored state bit for bit the saved one (sha256),
     ms a step with its spread beside phase 17's, peak memory;
     --video_dataset over 2 mp4v clips that cv2 writes at start-up (4 steps
     of 16-frame clips, the video eval: K2 72) and K2 at the video rows'
     shapes against its plain version; lamb and adafactor on the card
     against the CPU (losses and gradients as phase 17; each optimizer
     alone on the CPU's gradients); evals.full --dataset over 4 PNGs (K4 1,
     K2 18 a row) and tools.eval_checkpoint on the video run's checkpoint
     (one image: K4 1, K2 18 a row).
     Logs and eval rows in chiprun_out/dist/.
 19. the presets the cards do not use, at full width in bf16 with
     videoseal_1.0's settings (256 bits, 256 px, step 4, chunk 32,
     jnd_1_1), random init from seed 0, each model written with save_npz
     and loaded back by path (vt.load): (a) unet_small2_yuv_quant_2p1d with
     convnext_tiny_temporal, (b) videoseal_1.0's embedder with
     convnext_tiny_pw. Each: NHWC embed, detect and extract_message of 128
     u8 1080p frames as a video (K4 1, K2 144), (a) embed_detect_planar in
     the scored mode (K1 1, K2 72); each launch's first call per shape held
     against its plain version on the inputs the path gave it; detect of 40
     frames (the last chunk of 8: with (a) padded with 24 copies of frame 0
     as the JAX package pads it, its logits equal to the extractor's on that
     batch; K2 36); the grouped route over one chunk (K3 5, K2 4) equal to the
     single route, its launches held too; card against CPU on 8 frames
     (logits or pixelwise maps elementwise, the bit decisions, (a)'s embed);
     timed. Then sam_small_pw and the hidden embedder and extractor detect
     or embed 8 frames (no kernel: every count 0), and train.main
     --synthetic 1 with convnext_tiny_pw and unet_small2_yuv_quant_2p1d (2
     steps at batch 16) and one video step of the same modules on a 16-frame
     clip, every loss finite. Phase 19 alone: `python3 -c "import torch,
     chip_smoke as cs; smi, _ = cs.phase_device(); cs.phase_build();
     cs.phase_presets(torch.device('cuda', 0), smi)"`.
 20. the last models, videoseal_1.0's settings in bf16, random init from
     seed 0, each written with save_npz and rebuilt from its card with that
     checkpoint: (a) a VAE embedder (VAE_WIDTHS: the JAX module's defaults,
     ch 64, 2 blocks a level, attention at 32 px) with the card's
     extractor: embed of 32 float 1080p frames as images and detect (K6 1,
     K2 18); (b) DVMark's embedder and extractor: embed of 32 float 1080p
     frames as a video (K6 1) and detect, then detect of 40 frames, the last
     chunk padded with frame 0 as the JAX package pads it; (c) a
     dinov2_vits14 extractor (hooks 8-11): detect of 32 float 1080p frames;
     each launch's first call per shape held against its plain version,
     timed, and the float32 model on the card against the CPU's on 2 frames
     (TF32 off); (d) the five baselines with scripted stand-ins at each
     method's size and bits: embed, detect, extract_message of 8 float 1080p
     frames, card against CPU, timed; (e) WmForger: train.main at
     convnext_tiny's full width (256 px, batch 8; 4 steps with one ascent
     step, 4 with gradient matching and the strength contrast: ms a step,
     peak memory), optimize (50 SGD steps on one 256 image), one step of
     every option and 3 optimize steps card against CPU. Phase 20 alone:
     `python3 -c "import torch, chip_smoke as cs; smi, _ = cs.phase_device();
     cs.phase_build(); cs.phase_last(torch.device('cuda', 0), smi)"`.
 21. the rest of the package: (a) the spread-spectrum audio watermark (16
     bits) on 60 s of 48 kHz stereo, embed and detect timed, the bits read
     back, the card against the CPU (PCM within 1e-6, bits equal); (b)
     embed_av on a 64-frame 1080p clip written with cv2, videoseal_1.0 in
     bf16 with the audio processor: the route, the audio's outcome and why,
     the frames, the PSNR and ms a frame, then detect_video of the output
     (K4 and K2 at least once each, their first calls per shape held
     against their plain versions); (c) make_config -> load(card path) on
     the card (the checkpoint's weights), and process_sab on 32 synthetic
     1500x2250 JPEGs (files a second, the card's resize equal to the
     CPU's); (d) both examples and the four notebooks at their default
     sizes on the card (K2 and K4 each, held); (e) the frames axis at
     videoseal_1.0's full width in video mode, 1x2 and 2x2 gloo ranks
     sharing the card, and a 2x1 data-only mesh of the 2p1d UNet and the
     temporal ConvNeXt (modules that mix frames, run on the whole batch by
     every rank), each against one process on the whole batch (2 clips of
     16 frames), TF32 off: losses and scales within 1e-5 relative, the
     BatchNorm statistics within 1e-5 of each tensor's largest, the
     updated parameters as phase 18 holds them, every rank with rank 0's
     parameters; the step times and the largest gradient gap printed.
     (e) alone, also against another checkout's package (run from its
     root): `python3 -c "import chip_smoke as cs; smi, _ =
     cs.phase_device(); cs._rest_frames(smi, cs.FRAMES_RUNS[2:])"`.
     Phase 21 alone: `python3 -c "import torch, chip_smoke as cs;
     smi, _ = cs.phase_device(); cs.phase_build(); cs.phase_rest(
     torch.device('cuda', 0), smi)"`.
 22. the scorer, `videoseal_tpu_torch.bench` (root bench.py's protocol):
     at its defaults (videoseal_1.0 in bf16, 128 planar u8 1080p frames,
     the scored lowres mode and the full-res mode; K1 32, K2 2,304), then
     NHWC at 32 frames in the lowres mode (K2 288) and in the full-res
     mode (K4 16, K2 288); each JSON line printed, the scored value within
     BENCH_FPS_RTOL of phase 5's scored fps; then STAGE_A_STEPS steps of
     docs/training.md's stage A flags through train.main (32 bits, 128 px,
     batch 32, the identity pool by its YAML file's name: no kernel), every
     logged value finite, ms a step; then STAGE_B_STEPS steps of stage B's
     flags (STAGE_B_FLAGS: the default pool at two attacks a step, the
     discriminator, the yuv perceptual loss; no kernel) resumed from that
     checkpoint, the lr of every update equal to the stage-B schedule at the
     restored count plus the updates made (to float32 rounding), every
     logged value finite, ms a step. Phase 22 alone: `python3 -c "import
     torch, chip_smoke as cs; smi, _ = cs.phase_device(); cs.phase_build();
     cs.phase_bench(torch.device('cuda', 0), smi, None)"`.
Each path runs with every launch count set to 0 just before it and read
just after. The line before the last holds the kernels' JSON record, the one
before it the nvidia-smi line; the last line is the device record. Details
go to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --profile

also traces one call of each planar mode and of the NHWC slice with
torch.profiler and prints the device time by kernel, the device's busy
share, the torch elementwise kernels' and the GEMMs' time and the
aten::copy_ calls (tables in chiprun_out/); and checks that K1's and K4's
wrappers launch their own kernels only (no width-resize GEMM) and that the
NHWC embed launches nothing after K4.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from videoseal_tpu_torch.utils.timing import cuda_ms, device_info  # noqa: E402

OUT_DIR = os.path.join(ROOT, "chiprun_out")
H, W, F_SLICE = 1080, 1920, 128
F_CARDS = 32   # frames of the pixelseal and videoseal_0.0 phases: one chunk
F_STREAM, STREAM_CHUNK = 96, 32   # the stream phase: three chunks of 1080p
F_STREAM_CV2 = 64   # cv2's mp4v runs at ~20 fps at 1080p: two chunks there
STAGES = [(64, 64, 96), (32, 32, 192), (16, 16, 384), (8, 8, 768)]
DEPTHS = (3, 3, 9, 3)
# chunkyseal's stages at 256 px (stem 4x4 at stride 2, VALID; dims 128..1024
# scaled by sqrt(1024 / 128)): odd H*W at all four, C % 16 != 0 at three
CHUNKY_STAGES = [(127, 127, 362), (63, 63, 724), (31, 31, 1448), (15, 15, 2896)]
CHUNKY_DEPTHS = (3, 3, 27, 3)
# K1: f32 sums in another order can flip a u8 rounding that lands on .5
K1_U8_MAX, K1_U8_SHARE, K1_DET_ATOL = 1, 1e-3, 2e-3
# K2: same bf16 rounding points as the plain version; f32 sums in another
# order can flip a bf16 rounding of the hidden activation (2^-8 relative)
K2_ATOL, K2_RTOL = 5e-2, 2e-2
# slice, CPU vs card, both bf16 forwards: conv and matmul sums in another
# order move the prediction by bf16 noise, a fraction of an LSB after the
# blend, and the logits (up to ~0.7) by a few of their bf16 ulps: measured
# 7.8e-3 (planar scored), 3.9e-3 (planar default, NHWC) with the new K2
SLICE_U8_MAX, SLICE_U8_SHARE, SLICE_LOGIT_ATOL = 2, 1e-2, 2e-2
SLICE_FLOAT_ATOL = SLICE_U8_MAX / 255.0
# under flax's init the prediction is larger, so bf16 noise moves more u8
# roundings: where the bf16 slice's share exceeds SLICE_U8_SHARE it is held
# to this many times the share where the CPU's bf16 forward differs from its
# own float32 forward on the same frames (the float32 slice and NHWC path,
# TF32 off, stay at SLICE_U8_SHARE); likewise the NHWC path's share,
# videoseal_0.0's bf16 prediction (V0_PRED_*) and the presets' embed share
# and logits (PRESET_LOGIT_ATOL)
SLICE_NOISE_FACTOR = 2
# chunkyseal's detect, CPU vs card, both bf16: 36 blocks (twice
# videoseal_1.0's 18) at widths up to 2896, the same bf16 rounding points
# with sums in another order
CHUNKY_LOGIT_ATOL = 5e-2
# videoseal_0.0, CPU vs card: no JND and scaling_w 1, so the u8 frames carry
# 255 x the prediction and one bf16 ulp of it (2^-8 of a value near 1) moves
# them by a unit: the prediction (in [-1, 1]) and the logits are compared
# instead. In f32 (TF32 off) only the sums' order differs: V0_F32_ATOL. In
# bf16 the deep UNet (8 bottleneck blocks at 144 channels, RMS norms in
# bf16) drifts by bf16 ulps on the two devices' conv algorithms: measured
# 5.27e-2 at most (13 ulps) on 2 frames; the mean stays within a few ulps
V0_F32_ATOL, V0_PRED_ATOL, V0_PRED_MEAN, V0_LOGIT_ATOL = 1e-4, 0.1, 1e-2, 5e-2
# the unet phase: the four cards' embedders on one chunk of key frames at
# their processing size; the folded forward against the module and the
# space-to-depth forward against the folded one in float32 (TF32 off) within
# UNET_F32_RTOL of the output's largest (the JAX package's parity bound);
# each route's bf16 forward on the card against the CPU's on UNET_CPU_FRAMES
# frames under the slice's noise rule (SLICE_NOISE_FACTOR times the CPU's
# bf16 against its float32), chunkyseal's at 128 px (its 2,560-channel
# bottleneck costs ~2 TFLOP a frame at 256 px); each route timed in turns
# over UNET_REPS calls a turn
UNET_CARDS = ("videoseal_1.0", "pixelseal", "chunkyseal", "videoseal_0.0")
UNET_FRAMES, UNET_CPU_FRAMES, UNET_REPS, UNET_PROFILE_KEYS = 32, 1, 5, (32, 8)
UNET_F32_RTOL, UNET_CPU_SIZE = 2e-4, {"chunkyseal": 128}
# the tools phase: calls a stage after the warm-up (the tools' --k default);
# the layouts phase's, reduced
TOOLS_K, LAYOUT_K = 8, 2
# grouped route, card vs CPU on 4 frames: the same bf16 forward with conv and
# matmul sums in another order; measured 3.9e-3 on logits up to ~0.7. On the
# card the grouped route equals the single one: K3 runs K2's parts on K2's
# tiles, with the bf16 rounding between blocks that bf16 activations have.
GROUPED_CPU_ATOL = 2e-2
# the stream phase: detect_video's logits against detect on the same frames
# in the same batches on the same card, the same kernels: equal but for the
# order of cuDNN's sums, should its algorithm differ between two calls
STREAM_LOGIT_ATOL = 1e-3
# K4/K5: the plain versions repeat the kernels' f32 arithmetic with sums in
# another order (K4's width resize and lift as dense matmuls): ~1e-5 relative
# on the delta. K6 output in [0, 1]: that delta error plus f32 rounding
# (6e-8). K4's blend mode on f32 frames: the delta's error (|delta| < 0.02)
# plus the rounding of si * v + delta; on u8 frames K1's rule
DELTA_RTOL, BLEND_ATOL, K4_BLEND_F32_ATOL = 1e-5, 1e-6, 2e-7
# K8 on the probe's inputs (every bias and norm vector N(0, 1), as on the
# TPU): GRN's gain |gamma * nx| reaches ~19, so a hidden activation whose
# bf16 rounding flips (pw1's f32 sums in another order, as for K2) moves the
# GRN output by up to ~19 of its ulps, and pw2 carries that to every channel
# of the pixel: up to 0.125 where |out| ~ 1 (measured at 128x64x64x96; B=32:
# 3 of 12.6M outputs beyond K2's tolerance, mean abs error ~1e-5). Hold K2's
# tolerance on all but a share K8_SHARE of the outputs (one wrong 32-pixel
# tile is 6e-5 of them, one wrong frame 8e-3), the mean abs error under
# K8_MEAN and every output within K8_MAX.
K8_SHARE, K8_MEAN, K8_MAX = 1e-5, 1e-4, 0.5
# phase 16, each grid attack on the card against the CPU from the same frames:
# warps, blurs and value ops run the same float32 operations in the same
# order on both (the warps' parameters solved on the host), the resizes are
# float32 matmuls with their sums in another order; the JPEG proxy can round
# a coefficient that lands within an ulp of .5 the other way, which moves a
# pixel by at most one quantisation step
AUG_ATOL, JPEG_FLIP_SHARE = 1e-5, 1e-3
F_ATTACK_IMAGES, F_ATTACK_VIDEO, F_AUGMENTER = 4, 16, 32
ATTACK_HW = (720, 1280)   # the card-vs-CPU frames and the video grid's
# phase 17: train.main's steps, and the card-vs-CPU video step's clip length.
# Card against CPU, both float32 with TF32 off, from the same weights and
# messages, SGD at lr 1: the losses and scales agree to ~3e-7 relative. The
# gradients do not agree better than convolution algorithms in float32 do:
# the embedder's (8 bottleneck blocks at 384 channels, BatchNorm) lie up to
# 8.3e-3 of its largest gradient from the CPU's, and on the CPU alone
# oneDNN's convolutions and the native ones differ by 6.4e-3 of it (measured
# at this width); so gradients are held to TRAIN_GRAD_RTOL of their module's
# largest, the updated tensors (p - grad) to that of the largest gradient
# plus TRAIN_PARAM_ATOL (p's rounding; the balance makes the gradients
# ~1e2), the BatchNorm statistics to TRAIN_BN_ATOL
TRAIN_STEPS, F_TRAIN_CLIP = 8, 16
TRAIN_LOG_RTOL, TRAIN_GRAD_RTOL, TRAIN_PARAM_ATOL, TRAIN_BN_ATOL = 1e-4, 3e-2, 1e-6, 1e-3
# phase 18, two ranks sharing the card against one process on the whole
# batch, TF32 off (as phase 17 holds the card against the CPU): the same
# float32 arithmetic with the cross-rank sums in another order and cuDNN's
# algorithms picked for batch 8 rather than 16; the losses and scales
# agree to 1.8e-6 relative, the BatchNorm statistics to 4.6e-6 of each
# tensor's largest (9.1e-6 absolute, the running variances reach ~7),
# measured. The updated parameters are held as phase 17 holds the card
# against itself, in every case. With TF32 (PyTorch's default for cuDNN)
# each algorithm rounds differently: the balance's scales moved by 4.2e-5
# and a gradient before a norm by 3.8e-2 of its module's largest
# (measured), so those cases are printed, their parameters held
DIST_LOG_RTOL, DIST_BN_RTOL = 1e-5, 1e-5
# lamb and adafactor on the card from the CPU's gradients: per-tensor norms
# and roots in another order, ~1e-7 of parameters ~1 (measured 2.4e-7)
OPT_ALONE_ATOL = 1e-6
# phase 19: the padded last chunk's detect (a chunk of 32 and 8 frames), and
# the presets' card-vs-CPU tolerance: both bf16, the CPU's convolutions and
# matmuls summing in another order, chunkyseal's bound; the pixelwise maps,
# compared elementwise, pass the decoder's three upsample blocks (bf16 convs
# and LayerNorms over 192, 96 and 48 channels) after the 18 blocks
F_PRESET_PAD, PRESET_LOGIT_ATOL = 40, 5e-2
# phase 20: float 1080p frames of the VAE, DVMark and DINO runs; the card
# against the CPU in float32 with TF32 off on LAST_CPU_FRAMES of them, where
# only the sums' order differs (cuDNN's and oneDNN's convolutions, the
# matmuls): outputs in [0, 1] and the logits of a path without K2 within
# LAST_F32_ATOL, a path through K2 (bf16 inside on both) within
# PRESET_LOGIT_ATOL; WmForger's step: losses within TRAIN_LOG_RTOL, each
# gradient within LAST_GRAD_RTOL of its tensor's largest (no BatchNorm), of
# the module's largest where the tensor's CPU gradient is exactly 0
F_LAST, LAST_CPU_FRAMES, F_BASELINE = 32, 2, 8
LAST_F32_ATOL, LAST_GRAD_RTOL = 1e-4, 1e-3
# the VAE embedder's widths: the JAX module's defaults (ch_mult, z_channels,
# double_z, resolution) and, as no published vae_* configuration is in the
# repository, the run's choice of ch 64, 2 blocks a level and attention at
# 32 px (1,024 tokens)
VAE_WIDTHS = dict(ch=64, out_ch=3, num_res_blocks=2, resolution=256, z_channels=4,
                  ch_mult=[1, 2, 4, 8], attn_resolutions=[32])
# phase 21: seconds of 48 kHz stereo audio; the AV clip's frames (1080p);
# SA-1B's image size and the images process_sab resizes; the frames axis's
# clips (videoseal_1.0 at 256 px, F_TRAIN_CLIP frames a clip) and meshes.
# The audio on the card against the CPU: the same float32 framing and
# sums in another order, the watermark ~3e-2 of the signal (AUDIO_ATOL)
AUDIO_S, AUDIO_SR, AUDIO_ATOL, F_AV = 60, 48000, 1e-6, 64
SAB_HW, SAB_N = (1500, 2250), 32
# (n_data, n_frames, model flags): the frames axis, and a data-only mesh
# whose modules mix frames (each rank runs them on the whole batch)
FRAMES_CLIPS, MIX_FLAGS = 2, ("--embedder_model", "unet_small2_yuv_quant_2p1d",
                              "--extractor_model", "convnext_tiny_temporal")
FRAMES_RUNS = ((1, 2, ("--card", "videoseal_1.0")), (2, 2, ("--card", "videoseal_1.0")),
               (2, 1, MIX_FLAGS))
WMF_STEPS, WMF_GM_STEPS, WMF_OPT_STEPS, WMF_BATCH = 4, 4, 50, 8
# phase 22: the scorer's NHWC frames; how far its scored fps may lie from
# phase 5's (another timing window over other frames of the same call);
# stage A's flags (docs/training.md:74-80) and the steps run here
BENCH_NHWC_FRAMES, BENCH_FPS_RTOL, STAGE_A_STEPS = 32, 0.2, 20
STAGE_A_FLAGS = ("--card", "videoseal_1.0", "--nbits", "32", "--img_size", "128",
                 "--synthetic", "1", "--batch_size", "32", "--num_augs", "1",
                 "--lambda_d", "0", "--lambda_i", "0", "--perceptual_loss", "none",
                 "--scaling_w", "1.0", "--optimizer", "AdamW,lr=5e-4",
                 "--scheduler", "CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1",
                 "--augmentation_config", "videoseal_tpu/configs/augs_identity.yaml")
# stage B's flags (docs/training.md:87-95: the default pool, two attacks a
# step, the discriminator and the yuv perceptual loss; --resume added), the
# steps run here from phase 22's stage A
STAGE_B_STEPS = 20
STAGE_B_FLAGS = ("--card", "videoseal_1.0", "--nbits", "32", "--img_size", "128",
                 "--synthetic", "1", "--batch_size", "32", "--num_augs", "2",
                 "--lambda_d", "0.1", "--lambda_i", "0.1", "--perceptual_loss", "yuv",
                 "--disc_start", "11000", "--scaling_w", "1.0",
                 "--scaling_w_schedule", "Cosine,scaling_min=0.4,start_epoch=25,epochs=50",
                 "--optimizer", "AdamW,lr=2e-4",
                 "--scheduler", "CosineLRScheduler,lr_min=1e-6,t_initial=100,warmup_t=2")
# K5's geometry edges, (F, H, W): a height that no swept strip divides, a
# frame of 3 rows, a width under 16, a ragged last band on the 16-byte
# path (1040: bands of 528 and 512 columns); and its sweep at F=128, 1080p:
# (output rows, columns at most) a block, a whole 1080p row or half of one
K5_EDGES = ((2, 37, 200), (2, 3, 200), (2, 4, 15), (2, 20, 1040))
K5_SWEEP = tuple((r, b) for r in (16, 32, 64) for b in (2048, 1024))
# published H100 SXM peaks: HBM bytes/s, bf16 tensor-core and f32 CUDA-core FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# f32 operations per pixel of jnd_heat.cuh and the luminance before it,
# counted by hand (sqrt, log, exp and one division counted as one each)
HEAT_OPS = 85


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type. The
    tensor cores and the CUDA cores run at once, so the operations take the
    larger of their two times, not the sum."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(f32_ops / F32_FLOPS, bf16_ops / BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_wrappers() -> dict:
    from videoseal_tpu_torch.kernels import fused_blend as fb
    from videoseal_tpu_torch.kernels.convnext_block import (convnext_block_fused,
                                                            convnext_blocks_fused)
    from videoseal_tpu_torch.kernels.convnext_probe import convnext_probe
    from videoseal_tpu_torch.kernels.fused_planar import fused_jnd_blend_planar
    from videoseal_tpu_torch.kernels.jnd_probe import jnd_probe
    return {"K1": fused_jnd_blend_planar, "K2": convnext_block_fused,
            "K3": convnext_blocks_fused, "K4": fb.fused_jnd_delta_up,
            "K5": fb.fused_jnd_delta, "K6": fb.fused_jnd_blend, "K7": jnd_probe,
            "K8": convnext_probe}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def check_counts(path: str, want: dict) -> dict:
    got = read_counts()
    want = {k: want.get(k, 0) for k in got}
    log(f"[{path}] launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{path}: kernel launch counts {got} != {want}")
    return got


def planar_frames(f: int, seed: int, device, h: int = H, w: int = W) -> torch.Tensor:
    from videoseal_tpu_torch.kernels.fused_planar import C0, R0, planar_shape
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.zeros(planar_shape(f, h, w), dtype=torch.uint8, device=device)
    buf[:, :, R0:R0 + h, C0:C0 + w] = torch.randint(
        0, 256, (f, 3, h, w), generator=g, device=device, dtype=torch.uint8)
    return buf


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script "
                         "runs only on a CUDA device")
    smi = device_info(0)["nvidia_smi"]
    if smi.startswith("not read"):
        raise SystemExit(f"chip_smoke: nvidia-smi {smi}")
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi, torch.cuda.get_device_name(0)


def phase_build() -> dict:
    from videoseal_tpu_torch.kernels import _lib
    t0 = time.perf_counter()
    lib = _lib.library()
    secs = time.perf_counter() - t0
    log(f"[build] {len(_lib.sources())} sources -> {lib._name} in {secs:.1f} s")
    # each source's seconds; ptxas -v: each entry function's name, then its
    # registers and spills
    with open(os.path.join(os.path.dirname(lib._name), "build.log")) as f:
        ptxas = [ln.strip() for ln in f if ln.startswith("== ") or "entry function" in ln
                 or "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"[build] {ln[:160]}")
    return {"seconds": secs, "ptxas": ptxas}


def k1_cost(f: int, h: int, w: int, s: int, lowres: bool, ds: int) -> tuple[float, float]:
    """K1's (bytes, f32 operations) for f frames: it reads the (hout, wq)
    window of each u8 plane that it writes out (the JND's halo rows and
    columns come back from L2), the f32 prediction, and writes the u8 planes
    and, with ds, the f32 detect input. Operations: per output pixel the
    width taps of each lift tap, the lift and the blend of three planes,
    with the JND HEAT_OPS; with ds, the two banded downscale products."""
    from videoseal_tpu_torch.kernels.fused_planar import TH, _tables_np, planar_geometry
    n_tiles, _, _, wq = planar_geometry(h, w)
    hout = TH * n_tiles
    tabs = _tables_np(s, h, w, hout, wq, ds)
    lt, wt = tabs["lift"][2], tabs["width"][2]
    px = f * hout * wq
    nbytes = 2 * f * 3 * hout * wq + f * s * s * 4 + (f * 3 * ds * ds * 4 if ds else 0)
    ops = px * (lt * (2 * wt + 2) + 3 * 4 + (0 if lowres else HEAT_OPS))
    if ds:
        ops += f * 3 * hout * ds * 2 * tabs["dw"][2] + f * 3 * ds * ds * 2 * tabs["dh"][2]
    return nbytes, ops


def phase_k1(dev) -> dict:
    """K1 against its plain version in both branches, with and without the
    detect output, at 1080p (F=4) and at 720x1280 (F=2: other lift and width
    tap tables); timed at F=128 in all four settings, each with its bound,
    and the detect height pass alone."""
    from videoseal_tpu_torch.kernels import _lib
    from videoseal_tpu_torch.kernels.fused_planar import (_tables, fused_jnd_blend_planar,
                                                          fused_jnd_blend_planar_plain)
    rec, worst = {}, 0
    # 128x200: the prediction is downscaled in width (more than 2 taps, the
    # kernel's general width path) and in height
    for f, h, w, timed in ((4, H, W, False), (2, 720, 1280, False), (2, 128, 200, False),
                           (F_SLICE, H, W, True)):
        imgs = planar_frames(f, 1, dev, h, w)
        g = torch.Generator(device=dev).manual_seed(2)
        pred = (torch.rand((f, 256, 256), generator=g, device=dev) * 2 - 1) * 0.1
        for lowres in (True, False):
            for ds in (None, 256):
                kern = lambda: fused_jnd_blend_planar(imgs, pred, 0.2, 1.0, h, w, ds, lowres)
                plain = lambda: fused_jnd_blend_planar_plain(imgs, pred, 0.2, 1.0, h, w, ds,
                                                             lowres)
                key = f"lowres={lowres},ds={ds}"
                if not timed:
                    a, b = kern(), plain()
                    torch.cuda.synchronize()
                    (a, da), (b, db) = (a, b) if ds else ((a, None), (b, None))
                    d = (a.int() - b.int()).abs()
                    u8max, share = int(d.max()), float((d > 0).float().mean())
                    det_err = float((da - db).abs().max()) if ds else 0.0
                    log(f"[K1] F={f} {h}x{w} {key}: u8 max diff {u8max}, share differing "
                        f"{share:.2e}, det max abs err {det_err:.3e}")
                    if u8max > K1_U8_MAX or share > K1_U8_SHARE or det_err > K1_DET_ATOL:
                        raise AssertionError(f"K1 disagrees with its plain version at {h}x{w} "
                                             f"{key}")
                    worst = max(worst, u8max)
                    rec.setdefault(key, {})[f"{h}x{w}"] = {"u8_max": u8max, "share": share,
                                                           "det_err": det_err}
                else:
                    ms, pms = cuda_ms(kern, reps=10), cuda_ms(plain)
                    bound_ms, bound_by = bound(*k1_cost(f, h, w, 256, lowres, ds or 0))
                    log(f"[K1] F={f} {key}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                        f"{bound_ms:.3f} ms ({bound_by}), kernel at {bound_ms / ms:.1%} of it")
                    rec[key].update(ms=ms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by)
                    torch.cuda.empty_cache()
        del imgs, pred
    # where the detect output's time goes: the height pass alone, on the
    # vd K1 writes (F, 3, 1152, 256) bf16
    tabs = _tables(256, H, W, 1152, 1920, 256, dev)
    dhs, dhw, dht = tabs["dh"]
    vd = torch.randn((F_SLICE, 3, 1152, 256), device=dev).to(torch.bfloat16)
    det = torch.empty((F_SLICE, 3, 256, 256), device=dev)
    lib, stream = _lib.library(), _lib.stream_ptr(vd)
    height_ms = cuda_ms(lambda: _lib.check(lib.vs_detect_height(
        vd.data_ptr(), dhs.data_ptr(), dhw.data_ptr(), dht, det.data_ptr(), F_SLICE, 1152, 256,
        stream), "vs_detect_height"), reps=10)
    del vd, det
    torch.cuda.empty_cache()
    for lowres in (True, False):
        with_ds = rec[f"lowres={lowres},ds=256"]["ms"]
        without = rec[f"lowres={lowres},ds=None"]["ms"]
        log(f"[K1] F={F_SLICE} lowres={lowres}: the detect output adds {with_ds - without:.3f} ms, "
            f"of which the height pass alone {height_ms:.3f} ms, the in-block width pass and "
            f"the vd store the rest")
    # what holds the full-resolution branch back: the same kernel with its
    # heat cut down to the window alone, then to the stencil sums
    from videoseal_tpu_torch.kernels.fused_planar import blend_planar_attribution
    imgs = planar_frames(F_SLICE, 1, dev)
    pred = (torch.rand((F_SLICE, 256, 256), device=dev) * 2 - 1) * 0.1
    attribution = {m: cuda_ms(lambda m=m: blend_planar_attribution(imgs, pred, 0.2, 1.0, H, W, m),
                              reps=10) for m in ("window", "sums", "production")}
    log(f"[K1] F={F_SLICE} full-resolution branch, no detect output, attribution: " + ", ".join(
        f"{m} {t:.3f} ms" for m, t in attribution.items()) + " (lowres branch "
        f"{rec['lowres=True,ds=None']['ms']:.3f} ms)")
    del imgs, pred
    torch.cuda.empty_cache()
    scored = rec["lowres=True,ds=256"]
    return {"checks": rec, "max_abs_err": worst, "ms": scored["ms"], "attribution": attribution,
            "plain_ms": scored["plain_ms"], "bound_ms": scored["bound_ms"],
            "bound_by": scored["bound_by"], "detect_height_ms": height_ms}


def _random_block(c: int, seed: int, dev, dtype):
    from videoseal_tpu_torch.models.videoseal import init_weights
    from videoseal_tpu_torch.modules.convnext import ConvNeXtBlock
    blk = ConvNeXtBlock(c)
    g = torch.Generator().manual_seed(seed)
    init_weights(blk, g)
    with torch.no_grad():   # GRN and LN at their init values would hide bugs
        for p in (blk.grn.gamma, blk.grn.beta, blk.norm.bias):
            p.normal_(0.0, 0.3, generator=g)
        blk.norm.weight.uniform_(0.5, 1.5, generator=g)
    return blk.to(dev, dtype)


def block_cost(h: int, w: int, c: int, frames: int = 32, k: int = 1) -> tuple:
    """k ConvNeXt blocks in one call over `frames` frames of h x w x c, bf16
    in and out: (bytes of x and the output, each moved once, and of k weight
    sets; bf16 tensor-core operations of the pointwise products; f32
    operations of the depthwise conv, LN, GELU and GRN)."""
    px = frames * h * w
    nbytes = 2 * px * c * 2 + k * (49 * c * 4 + 2 * 4 * c * c * 2 + 15 * c * 4)
    return (nbytes, k * 2 * 2 * px * c * 4 * c,
            k * (px * c * (2 * 49 + 10) + px * 4 * c * 12))


def part_costs(b: int, h: int, w: int, c: int, esize: int, tiles: int) -> dict:
    """Each part of the new K2 on (b, h, w, c) frames of esize-byte elements:
    (bytes, each input read once and each output written once; f32
    operations; bf16 tensor-core operations). tiles: pw1's M tiles a frame."""
    m, n4 = b * h * w, 4 * c
    return {
        "dwln": (m * c * (esize + 2) + 52 * c * 4, m * c * (2 * 49 + 10), 0),
        "pw1": (m * c * 2 + n4 * c * 2 + n4 * 4 + m * n4 * 2 + b * tiles * n4 * 4,
                m * n4 * 14, 2 * m * c * n4),
        "grn_stats": (b * tiles * n4 * 4 + n4 * 4 + b * n4 * 4, b * n4 * (tiles + 6), 0),
        "pw2": (m * n4 * 2 + b * n4 * 4 + n4 * 4 + c * n4 * 2 + c * 4 + 2 * m * c * esize,
                m * n4 * 3 + m * c * 2, 2 * m * n4 * c),
    }


def phase_k2(dev) -> dict:
    """K2 against its plain version at the four stage shapes (B=32) and two
    ragged ones, bf16 and f32; per stage in bf16: the block timed twice, each
    part with its bound, and cuBLAS on the two products' shapes as a
    yardstick. Then chunkyseal's four stage shapes (B=4) and two small ones
    with odd H*W and C, 4C not multiples of 16, at K2's padded width."""
    from videoseal_tpu_torch.kernels import convnext_block as cb
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec, worst, stages = {}, 0.0, []
    chunk = {"ms": 0.0, "plain_ms": 0.0}
    nbytes = f32_ops = bf16_ops = 0.0
    # ragged: 240 pixels a frame, so the last M tile of pw1 (128 rows) and of
    # pw2 (128 rows at C=96, 64 at C=192) is masked
    cases = [(32, h, w, c) for h, w, c in STAGES] + [(3, 12, 20, 96), (3, 12, 20, 192)]
    for i, (b, h, w, c) in enumerate(cases):
        staged = i < len(STAGES)
        if staged:
            nb, bo, fo = block_cost(h, w, c)   # one block of one 32-frame chunk
            nbytes += DEPTHS[i] * nb
            bf16_ops += DEPTHS[i] * bo
            f32_ops += DEPTHS[i] * fo
        for dtype in (torch.bfloat16, torch.float32):
            p = cb.kernel_params(_random_block(c, i, dev, dtype))
            g = torch.Generator(device=dev).manual_seed(10 + i)
            x = torch.randn((b, h, w, c), generator=g, device=dev).to(dtype)
            a, ref = cb.convnext_block_fused(x, p).float(), cb.convnext_block_plain(x, p).float()
            torch.cuda.synchronize()
            err = (a - ref).abs()
            key = f"{b}x{h}x{w}x{c},{str(dtype)[6:]}"
            log(f"[K2] {key}: max abs err {float(err.max()):.3e}, mean {float(err.mean()):.3e}")
            if (not bool(torch.isfinite(a).all())
                    or bool((err > K2_ATOL + K2_RTOL * ref.abs()).any())):
                raise AssertionError(f"K2 disagrees with its plain version at {key}")
            rec[key] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean())}
            worst = max(worst, float(err.max()))
            if not staged or dtype != torch.bfloat16:
                continue
            runs = [cuda_ms(lambda: cb.convnext_block_fused(x, p), reps=10) for _ in range(2)]
            pms = cuda_ms(lambda: cb.convnext_block_plain(x, p))
            calls, buf = cb.k2_parts(x, p)
            costs = part_costs(b, h, w, c, x.element_size(), buf["part"].shape[1])
            parts = {}
            for name, call in calls:
                pb = bound(costs[name][0], f32_ops=costs[name][1], bf16_ops=costs[name][2])
                parts[name] = {"ms": cuda_ms(call, reps=20), "bound_ms": pb[0], "bound_by": pb[1]}
            # cuBLAS on the products' bf16 shapes: yardsticks, never called by the port
            blas = {"pw1": cuda_ms(lambda: torch.matmul(buf["a"], p["w1"].t()), reps=20),
                    "pw2": cuda_ms(lambda: torch.matmul(buf["hid"], p["w2"].t()), reps=20)}
            ms = sum(runs) / 2
            log(f"[K2] B=32 {h}x{w}x{c} bf16: {runs} ms, plain {pms:.3f} ms; " + ", ".join(
                f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, {r['bound_by']})"
                for n, r in parts.items())
                + f"; cuBLAS pw1 {blas['pw1']:.4f} ms, pw2 {blas['pw2']:.4f} ms")
            rec[key].update(ms=ms, runs=runs, plain_ms=pms, parts=parts, cublas_ms=blas)
            stages.append({"shape": [b, h, w, c], "blocks": DEPTHS[i], "ms": ms,
                           "parts": parts, "cublas_ms": blas})
            chunk["ms"] += DEPTHS[i] * ms
            chunk["plain_ms"] += DEPTHS[i] * pms
            del calls, buf
        torch.cuda.empty_cache()
    bound_ms, bound_by = bound(nbytes, f32_ops=f32_ops, bf16_ops=bf16_ops)
    log(f"[K2] 18 blocks of one chunk of 32 frames, bf16: kernel {chunk['ms']:.3f} ms, plain "
        f"{chunk['plain_ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), kernel at "
        f"{bound_ms / chunk['ms']:.1%} of it")
    chunky, chunky_worst = phase_k2_padded(dev, rec)
    return {"checks": rec, "stages": stages, "max_abs_err": max(worst, chunky_worst), **chunk,
            "bound_ms": bound_ms, "bound_by": bound_by, "chunky": chunky}


def phase_k2_padded(dev, rec: dict) -> tuple[dict, float]:
    """K2 at chunkyseal's four stage shapes (B=4) and at 3x7x9x40 (4C = 160)
    and 3x5x7x22 (4C = 88), odd H*W each, bf16 and f32: x at the padded
    width with zero pad channels (as the extractor's route pads it), held
    against the plain version on the true channels with K2's tolerance, the
    pad channels exactly 0. Each chunkyseal stage in bf16 is timed twice with
    its bound (the true widths' work); the 36 blocks of one frame are summed
    beside their bound."""
    import torch.nn.functional as F
    from videoseal_tpu_torch.kernels import convnext_block as cb
    worst, frame = 0.0, {"ms": 0.0, "plain_ms": 0.0}
    nbytes = f32_ops = bf16_ops = 0.0
    stages = []
    cases = [(4, h, w, c) for h, w, c in CHUNKY_STAGES] + [(3, 7, 9, 40), (3, 5, 7, 22)]
    for i, (b, h, w, c) in enumerate(cases):
        staged = i < len(CHUNKY_STAGES)
        cp = cb.padded_width(c)
        for dtype in (torch.bfloat16, torch.float32):
            p = cb.kernel_params(_random_block(c, 50 + i, dev, dtype))
            g = torch.Generator(device=dev).manual_seed(60 + i)
            x = F.pad(torch.randn((b, h, w, c), generator=g, device=dev).to(dtype),
                      (0, cp - c)).contiguous()
            a = cb.convnext_block_fused(x, p).float()
            ref = cb.convnext_block_plain(x, p).float()
            torch.cuda.synchronize()
            err = (a - ref)[..., :c].abs()
            pads_zero = not bool(a[..., c:].any())
            key = f"{b}x{h}x{w}x{c}(padded {cp}),{str(dtype)[6:]}"
            log(f"[K2] {key}: max abs err {float(err.max()):.3e}, mean {float(err.mean()):.3e}, "
                f"pad channels zero {pads_zero}")
            if (not bool(torch.isfinite(a).all()) or not pads_zero
                    or bool((err > K2_ATOL + K2_RTOL * ref[..., :c].abs()).any())):
                raise AssertionError(f"K2 disagrees with its plain version at {key}")
            rec[key] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean())}
            worst = max(worst, float(err.max()))
            if not staged or dtype != torch.bfloat16:
                continue
            runs = [cuda_ms(lambda: cb.convnext_block_fused(x, p), reps=10) for _ in range(2)]
            pms = cuda_ms(lambda: cb.convnext_block_plain(x, p))
            nb, bo, fo = block_cost(h, w, c, frames=b)
            sb = bound(nb, f32_ops=fo, bf16_ops=bo)
            ms = sum(runs) / 2
            # each part on the true widths' work, as phase 4's stages
            calls, buf = cb.k2_parts(x, p)
            costs = part_costs(b, h, w, c, x.element_size(), buf["part"].shape[1])
            parts = {}
            for name, call in calls:
                pb = bound(costs[name][0], f32_ops=costs[name][1], bf16_ops=costs[name][2])
                parts[name] = {"ms": cuda_ms(call, reps=10), "bound_ms": pb[0], "bound_by": pb[1]}
            del calls, buf
            log(f"[K2] B={b} {h}x{w}x{c} (padded {cp}) bf16: {runs} ms, plain {pms:.3f} ms, bound "
                f"{sb[0]:.4f} ms ({sb[1]}), kernel at {sb[0] / ms:.1%} of it; " + ", ".join(
                    f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, {r['bound_by']})"
                    for n, r in parts.items()))
            rec[key].update(ms=ms, runs=runs, plain_ms=pms, bound_ms=sb[0], bound_by=sb[1],
                            parts=parts)
            stages.append({"shape": [b, h, w, c], "padded": cp, "blocks": CHUNKY_DEPTHS[i],
                           "ms": ms, "plain_ms": pms, "bound_ms": sb[0], "bound_by": sb[1]})
            d = CHUNKY_DEPTHS[i] / b   # the stage's blocks over one frame
            frame["ms"] += d * ms
            frame["plain_ms"] += d * pms
            nbytes, bf16_ops, f32_ops = nbytes + d * nb, bf16_ops + d * bo, f32_ops + d * fo
        del p, x, a, ref
        torch.cuda.empty_cache()
    fb = bound(nbytes, f32_ops=f32_ops, bf16_ops=bf16_ops)
    log(f"[K2] chunkyseal's 36 blocks over one frame (B=4 launches), bf16: kernel "
        f"{frame['ms']:.3f} ms, plain {frame['plain_ms']:.3f} ms, bound {fb[0]:.3f} ms "
        f"({fb[1]}), kernel at {fb[0] / frame['ms']:.1%} of it")
    return {"stages": stages, **frame, "bound_ms": fb[0], "bound_by": fb[1]}, worst


def _slice_diff(a: dict, b: dict) -> tuple:
    """Two planar outputs' |u8 difference|, the share of values that
    differ and the logits' max abs difference."""
    d = (a["imgs_w"].cpu().int() - b["imgs_w"].cpu().int()).abs()
    ld = float((a["preds"].cpu().float() - b["preds"].cpu().float()).abs().max())
    return d, float((d > 0).float().mean()), ld


def phase_slice(dev, smi: str) -> dict:
    import videoseal_tpu_torch as vt

    model32 = vt.load("videoseal_1.0", device=dev, seed=0)
    model = model32.with_dtype("bfloat16")
    imgs = planar_frames(F_SLICE, 3, dev)
    msgs = model.get_random_msg(1)
    modes = {"scored": dict(lowres_attenuation=True, fused_detect=True),
             "default": dict(lowres_attenuation=False, fused_detect=False)}

    reset_counts()
    outs = {m: model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw)
            for m, kw in modes.items()}
    rec = {"launches": check_counts("slice", {
        "K1": len(modes), "K2": 18 * math.ceil(F_SLICE / 32) * len(modes)})}
    for m, out in outs.items():
        wm, preds = out["imgs_w"], out["preds"]
        bits = vt.aggregate_message(preds)
        log(f"[slice] {m}: imgs_w {tuple(wm.shape)} {wm.dtype}, preds {tuple(preds.shape)}, "
            f"bits {tuple(bits.shape)}")
        if (tuple(wm.shape) != (F_SLICE, 3, 1152, 1920) or wm.dtype != torch.uint8
                or tuple(preds.shape) != (F_SLICE, 257) or not bool(torch.isfinite(preds).all())
                or tuple(bits.shape) != (1, 256)):
            raise AssertionError(f"slice output of {m} has the wrong shape or is not finite")
        changed = float((wm[:, :, :H, :W] != imgs[:, :, 28:28 + H, 128:128 + W]).float().mean())
        log(f"[slice] {m}: share of pixels the watermark changed {changed:.3f}")
        if changed == 0.0:
            raise AssertionError("the watermark changed no pixel")

    model.scaling_w = 0.0
    for m, kw in modes.items():
        wm = model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw)["imgs_w"]
        if not torch.equal(wm[:, :, :H, :W], imgs[:, :, 28:28 + H, 128:128 + W]):
            raise AssertionError(f"scaling_w=0 is not the identity in mode {m}")
    model.scaling_w = 0.2
    log("[slice] scaling_w=0 leaves the frames unchanged in both modes")

    cpu32 = vt.load("videoseal_1.0", device="cpu", seed=0)
    cpu = cpu_route(cpu32.with_dtype("bfloat16"), model)
    small = imgs[:4]
    for m, kw in modes.items():
        with tf32_off():
            g32 = model32.embed_detect_planar(small, H, W, msgs=msgs, **kw)
        c32 = cpu32.embed_detect_planar(small.cpu(), H, W, msgs=msgs.cpu(), **kw)
        d, share, ld = _slice_diff(g32, c32)
        log(f"[slice] {m}, F=4, card vs CPU in float32, TF32 off: u8 max diff {int(d.max())}, "
            f"share differing {share:.2e}, logits max abs diff {ld:.3e}")
        if int(d.max()) > SLICE_U8_MAX or share > SLICE_U8_SHARE or ld > SLICE_LOGIT_ATOL:
            raise AssertionError(f"card and CPU disagree in float32 in mode {m}")
        g = model.embed_detect_planar(small, H, W, msgs=msgs, **kw)
        c = cpu.embed_detect_planar(small.cpu(), H, W, msgs=msgs.cpu(), **kw)
        d, share, ld = _slice_diff(g, c)
        # the CPU's own bf16 forward against its float32 one: bf16's noise
        # floor on these frames, which bounds the share where the limit
        # does not hold
        _, floor, _ = _slice_diff(c, c32)
        share_max = max(SLICE_U8_SHARE, SLICE_NOISE_FACTOR * floor)
        log(f"[slice] {m}, F=4, card vs CPU in bf16: u8 max diff {int(d.max())}, share "
            f"differing {share:.2e} (the CPU's bf16 against its float32: {floor:.2e}; "
            f"limit {share_max:.2e}), logits max abs diff {ld:.3e}")
        if int(d.max()) > SLICE_U8_MAX or share > share_max or ld > SLICE_LOGIT_ATOL:
            raise AssertionError(f"card and CPU disagree in mode {m}")
        rec[f"{m}_cpu_vs_card"] = {"u8_max": int(d.max()), "u8_share": share,
                                   "u8_share_max": share_max, "bf16_floor": floor,
                                   "logit_max": ld}

    if "--profile" in sys.argv:
        # K1's wrapper launches its kernels only: the prediction's width
        # resize is inside the kernel
        from videoseal_tpu_torch.kernels.fused_planar import fused_jnd_blend_planar
        pred = torch.rand((F_SLICE, 256, 256), device=dev) * 0.2 - 0.1
        calls = {m: (lambda kw=kw: model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw))
                 for m, kw in modes.items()}
        calls["k1_scored"] = lambda: fused_jnd_blend_planar(imgs, pred, 0.2, 1.0, H, W, 256, True)
        calls["k1_default"] = lambda: fused_jnd_blend_planar(imgs, pred, 0.2, 1.0, H, W)
        rec["profile"] = profile(calls)
        for m, want in (("k1_scored", ("blend_planar_kernel", "detect_height_kernel")),
                        ("k1_default", ("blend_planar_kernel",))):
            check_launches(f"K1 wrapper, {m[3:]}", rec["profile"][m]["order"], want)
    for m, kw in modes.items():
        ms = cuda_ms(lambda: model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw))
        fps = F_SLICE / ms * 1000
        log(f"[slice] {m}: {ms:.2f} ms per {F_SLICE} frames at 1080p = {fps:.1f} fps "
            f"({smi})")
        rec[m] = {"ms": ms, "fps": fps}
    rec["route_turns"] = route_turns(
        "slice", model, lambda: model.embed_detect_planar(imgs, H, W, msgs=msgs,
                                                          **modes["scored"]), F_SLICE, smi)
    return rec


def route_turns(tag: str, model, call, frames: int, smi: str) -> dict:
    """fps of `call` with `model`'s UNet on the s2d and the folded route in
    turns (s2d, folded, folded, s2d), each turn `cuda_ms` of UNET_REPS calls
    after a warm-up, at PyTorch's TF32 defaults and then with cuDNN's TF32
    off (keys suffixed `_tf32_off`)."""
    import dataclasses
    cfg = model.cfg
    fps = {"s2d": [], "fused": [], "s2d_tf32_off": [], "fused_tf32_off": []}
    try:
        for cudnn, sfx in ((True, ""), (False, "_tf32_off")):
            with tf32_off(cudnn=cudnn):
                for route in ("s2d", "fused", "fused", "s2d"):
                    model.cfg = dataclasses.replace(cfg, s2d_embedder=route == "s2d")
                    fps[route + sfx].append(frames / cuda_ms(call, UNET_REPS) * 1000)
    finally:
        model.cfg = cfg
    log(f"[{tag}] the UNet's routes in turns, fps: " + ", ".join(
        f"{k} {[round(f, 1) for f in v]}" for k, v in fps.items()) + f" ({smi})")
    return fps


def _unet_embedder(name: str, dev):
    """`name`'s embedder in eval mode, built on the card at random init
    from seed 0, with its BatchNorm statistics and affine and its rms gains
    drawn as well, so that the fold is far from the identity."""
    from videoseal_tpu_torch.cards import CARDS
    from videoseal_tpu_torch.models.embedder import build_embedder
    from videoseal_tpu_torch.models.videoseal import init_weights
    from videoseal_tpu_torch.modules.common import ChanRMSNorm
    card = CARDS[name]
    args, emb = card["args"], card["embedder"]
    with torch.device(dev):
        spec = build_embedder(emb["model"], emb["params"], int(args["nbits"]),
                              float(args.get("hidden_size_multiplier", 2.0)))
    g = torch.Generator(device=dev).manual_seed(0)
    init_weights(spec.module, g)
    with torch.no_grad():
        for m in spec.module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(m, ChanRMSNorm):
                m.gamma.uniform_(0.5, 1.5, generator=g)
    return spec.module.eval(), int(args["nbits"]), spec.yuv


def _route_calls(model, frames) -> dict:
    """Calls of the folded and the space-to-depth UNet forwards in one
    embed of `frames` as a video by `model`."""
    from videoseal_tpu_torch.models import videoseal as vsm
    calls = {"fused": 0, "s2d": 0}
    real = {"fused": vsm.unet_apply_fused, "s2d": vsm.unet_apply_s2d}

    def counted(route):
        def fn(*a):
            calls[route] += 1
            return real[route](*a)
        return fn
    vsm.unet_apply_fused, vsm.unet_apply_s2d = counted("fused"), counted("s2d")
    try:
        model.embed(frames, is_video=True)
    finally:
        vsm.unet_apply_fused, vsm.unet_apply_s2d = real["fused"], real["s2d"]
    return calls


def phase_unet(dev, smi: str) -> dict:
    """The serving UNet's two routes (kernels/unet_fused.py and
    kernels/unet_s2d.py, no kernel of the TPU's): a with_dtype("bfloat16")
    model on the card routes its embedder to the one that
    ROADMAP §3.52 decided, the s2d one; for each of UNET_CARDS'
    embedders, one chunk of UNET_FRAMES key frames at 256x256, the folded
    forward against the module and the s2d forward against the folded one
    on the card in float32 with TF32 off (the lane-packed folded forward
    too), each route's bf16 forward on the card against the CPU's, and the
    routes timed in bf16 in turns at PyTorch's TF32 defaults (the
    lane-packed one too) and with cuDNN's TF32 off."""
    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch.kernels.unet_fused import unet_apply_fused
    from videoseal_tpu_torch.kernels.unet_s2d import schedule_for, unet_apply_s2d
    from videoseal_tpu_torch.ops.resize import resize_bilinear

    m16 = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    g = torch.Generator(device=dev).manual_seed(20)
    frames = torch.randint(0, 256, (8, H, W, 3), generator=g, device=dev, dtype=torch.uint8)
    calls = _route_calls(m16, frames)
    want = "s2d"       # ROADMAP §3.52: JAX's rule, s2d faster on the card
    log(f"[unet] videoseal_1.0.with_dtype('bfloat16') on the card: cfg.fused_embedder "
        f"{m16.cfg.fused_embedder}, cfg.s2d_embedder {m16.cfg.s2d_embedder}; forwards in one "
        f"embed of 8 frames: {calls} (the route ROADMAP §3.52 names: {want})")
    if (not m16.cfg.fused_embedder or not m16.cfg.s2d_embedder
            or calls != {"fused": 0, "s2d": 0} | {want: 1}):
        raise AssertionError(f"with_dtype('bfloat16') on the card does not serve the {want} route")
    del m16, frames
    rec = {"route_calls": calls, "route": want}
    routes = {"fused": unet_apply_fused, "s2d": unet_apply_s2d,
              "lane_pack": functools.partial(unet_apply_fused, lane_pack=True)}
    for name in UNET_CARDS:
        t0 = time.perf_counter()
        emb, nbits, yuv = _unet_embedder(name, dev)
        g = torch.Generator(device=dev).manual_seed(21)
        x = torch.rand((UNET_FRAMES, 256, 256, 1 if yuv else 3), generator=g, device=dev)
        msgs = torch.randint(0, 2, (UNET_FRAMES, nbits), generator=g, device=dev)
        sch = schedule_for(emb.unet, 256)
        with torch.no_grad():
            with tf32_off():
                fused32 = unet_apply_fused(emb.unet, x, msgs)
                ref32 = emb(x, msgs)
                err = float((fused32 - ref32).abs().max())
                top = float(ref32.abs().max())
                del ref32
                s2d_err = float((unet_apply_s2d(emb.unet, x, msgs) - fused32).abs().max())
                lane_err = float((routes["lane_pack"](emb.unet, x, msgs) - fused32).abs().max())
            del fused32
            e16 = emb.to(torch.bfloat16)       # folds and packs anew in bf16 at its next call
            x16 = x.to(torch.bfloat16)
            # in turns on the one card at PyTorch's TF32 defaults: folded, s2d,
            # the folded route with lane-packed convs, and back; then folded and
            # s2d again with cuDNN's TF32 off, the state phase K2 leaves (the s2d
            # route's border strips are float32 convs: unet_s2d._strip_conv)
            times = {"fused": [], "s2d": [], "lane_pack": [], "fused_tf32_off": [],
                     "s2d_tf32_off": []}
            with tf32_off(cudnn=True):
                for r in ("fused", "s2d", "lane_pack", "lane_pack", "s2d", "fused"):
                    times[r].append(cuda_ms(lambda: routes[r](e16.unet, x16, msgs), UNET_REPS))
                module_ms = cuda_ms(lambda: e16(x16, msgs))
            with tf32_off():
                for r in ("fused", "s2d", "s2d", "fused"):
                    times[f"{r}_tf32_off"].append(
                        cuda_ms(lambda: routes[r](e16.unet, x16, msgs), UNET_REPS))
            if name == UNET_CARDS[0]:
                # each route's device time against its wall, at a chunk's keys
                # and at the NHWC scorer's 8: the s2d route launches less
                # device work and issues more host operations (after the
                # turns, so that no timed turn follows a trace)
                with tf32_off(cudnn=True):
                    r_prof = profile({f"{rt}_{k}keys": (lambda fn=routes[rt], k=k: fn(
                        e16.unet, x16[:k], msgs[:k])) for rt in ("fused", "s2d")
                        for k in UNET_PROFILE_KEYS})
            # the CPU's bf16 and float32 forwards of each route on a few
            # frames: its bf16 noise bounds the card's distance from it
            s = UNET_CPU_SIZE.get(name, 256)
            xc = resize_bilinear(x[:UNET_CPU_FRAMES], s, s).to(torch.bfloat16)
            mc = msgs[:UNET_CPU_FRAMES]
            c16 = cpu_copy(e16)
            c32 = cpu_copy(c16).float()
            cmp = {}
            for r in ("fused", "s2d"):
                fn = routes[r]
                card16 = fn(e16.unet, xc, mc).float().cpu()
                cpu16 = fn(c16.unet, xc.cpu(), mc.cpu()).float()
                cpu32 = fn(c32.unet, xc.cpu().float(), mc.cpu()).float()
                d, floor = (card16 - cpu16).abs(), (cpu16 - cpu32).abs()
                cmp[r] = {"bf16_max": float(d.max()), "bf16_mean": float(d.mean()),
                          "bf16_max_limit": SLICE_NOISE_FACTOR * float(floor.max()),
                          "bf16_mean_limit": SLICE_NOISE_FACTOR * float(floor.mean())}
            del c16, c32, e16, emb
        r = {"schedule": sch, "f32_max_abs": err, "f32_out_max": top, "s2d_f32_max_abs": s2d_err,
             "lane_pack_f32_max_abs": lane_err, "cpu": cmp,
             **{f"{k}_ms": v for k, v in times.items()},
             "module_ms": module_ms, "cpu_size": s, "s": time.perf_counter() - t0}
        if name == UNET_CARDS[0]:
            r["profile"] = {k: {f: v[f] for f in ("wall_ms", "kernel_ms")}
                            for k, v in r_prof.items()}
        log(f"[unet] {name}: {UNET_FRAMES} frames at 256x256, float32 (TF32 off) on the card: "
            f"folded vs module max abs diff {err:.3e}, s2d {sch} vs folded {s2d_err:.3e}, "
            f"lane-packed vs folded {lane_err:.3e} "
            f"(limit {UNET_F32_RTOL} x {top:.3f}); bf16 card vs CPU on {UNET_CPU_FRAMES} at "
            f"{s}x{s}: " + "; ".join(
                f"{k} max {c['bf16_max']:.3e} (limit {c['bf16_max_limit']:.3e}), mean "
                f"{c['bf16_mean']:.3e} (limit {c['bf16_mean_limit']:.3e})" for k, c in cmp.items())
            + "; bf16 ms per chunk in turns: " + ", ".join(f"{k} {v}" for k, v in times.items())
            + f", module {module_ms:.3f} ms ({smi}); {r['s']:.1f} s")
        if max(err, s2d_err, lane_err) > UNET_F32_RTOL * top:
            raise AssertionError(f"{name}: the folded UNet disagrees with the module, or the "
                                 f"s2d or lane-packed UNet with the folded one, in float32")
        for k, c in cmp.items():
            if c["bf16_max"] > c["bf16_max_limit"] or c["bf16_mean"] > c["bf16_mean_limit"]:
                raise AssertionError(f"{name}: the card's bf16 {k} UNet disagrees with the CPU's")
        rec[name] = r
        del x, x16, msgs
        torch.cuda.empty_cache()
    return rec


def phase_tools(dev, smi: str) -> dict:
    """The JAX package's two timing tools in the port: unet_bench.main (the
    stages that unet_apply_fused chains, which phase `unet` holds) and
    stage_bench.main --decompose at their defaults (128 u8 1080p frames; the
    folded and the space-to-depth UNet at its five schedules on 32 keys),
    each K2, K4 and K5 launch of the latter held against its plain version,
    the counts of both runs, and each stage's ms printed beside the card's
    name and power limit. No time is asserted; a stage's error row fails
    the phase."""
    from videoseal_tpu_torch.evals import stage_bench, unet_bench

    t0 = time.perf_counter()
    rec = {}
    reset_counts()
    ub = unet_bench.main(["--k", str(TOOLS_K)])
    sb_cap = _Capture(extra=((stage_bench, "fused_jnd_delta", "K5"),))
    with sb_cap:
        sb = stage_bench.main(["--decompose", "--k", str(TOOLS_K)])
    # each stage runs TOOLS_K calls after one warm-up; a detect of the 128
    # frames is 4 chunks of the 18 blocks: extractor(frames@256) and
    # full_embed_extract detect, full_embed_extract embeds (K4 one), K5 runs
    # in fused_jnd_delta+blend(fullres) and fused_jnd_delta(only)
    calls = TOOLS_K + 1
    detect_k2 = F_SLICE // 32 * sum(DEPTHS)
    rec["launches"] = check_counts("tools", {"K2": 2 * calls * detect_k2, "K4": calls,
                                             "K5": 2 * calls})
    rec["held"] = hold_captured("tools", sb_cap.calls)
    del sb_cap
    torch.cuda.empty_cache()
    names = [r["stage"] for r in ub["stages"]]
    if names != ["encoder", "bottleneck", "decoder"]:
        raise AssertionError(f"unet_bench printed the stages {names}")
    want = ["unet_fused(keys)",
            *(f"unet_s2d{'inferred' if sch is None else sch}(keys)"
              for sch in stage_bench.S2D_SCHEDULES),
            "extractor(frames@256)", "resize_down(keys)",
            "resize_up(preds)", "fused_jnd_delta+blend(fullres)", "full_embed_extract",
            "fused_jnd_delta(only)", "blend_elementwise(only)", "hbm_copy_u8(frames)",
            "hbm_copy_f32(preds_plane)"]
    failed = [r for r in sb["stages"] if "error" in r]
    if failed:
        # videoseal_1.0 takes all five schedules: an error row is a fault
        raise AssertionError(f"stage_bench stages failed: {failed}")
    names = [r["stage"] for r in sb["stages"]]
    if names != want:
        raise AssertionError(f"stage_bench printed the stages {names}")
    for tool, r, unit in (("unet_bench", ub, "per_key_us"), ("stage_bench", sb, "per_frame_us")):
        for row in r["stages"]:
            log(f"[tools] {tool} {row['stage']}: {row['ms']:.3f} ms, "
                f"{row[unit]:.2f} {unit} ({smi})")
    rec.update(unet_bench=ub["stages"], stage_bench=sb["stages"], s=time.perf_counter() - t0)
    log(f"[tools] {rec['s']:.1f} s")
    return rec


def phase_layouts(dev, smi: str) -> dict:
    """The JAX package's layout tools in the port, at reduced depth
    (LAYOUT_K timed calls after a warm-up): unet_bench's --s2d and
    --s2d_pieces modes (videoseal_1.0's s2d UNet, stage by stage and level by
    level; no kernel), then the five probes at their default shapes:
    conv_probe (cuDNN and cuBLAS), resize_probe (cuBLAS, cuBLASLt's int8
    product), dw_mxu_probe (its "vpu" form is K8), planar_probe with
    --lowres_stages (K1 at each rs of its sweep, held bit for bit against
    the default rs inside the probe), r4_probe (K1; K2 and K3 through the
    grouped route). The counts of the run, then each K1, K2, K3 and K8
    launch's first call per shape held against its plain version; each
    row printed beside the card's name and power limit. No time is
    asserted."""
    from videoseal_tpu_torch.evals import (dw_mxu_probe, planar_probe, r4_probe, resize_probe,
                                           unet_bench)
    from videoseal_tpu_torch.kernels import conv_probe
    from videoseal_tpu_torch.kernels.convnext_fused import block_groups

    t0 = time.perf_counter()
    k = ["--k", str(LAYOUT_K)]
    calls = LAYOUT_K + 1
    rec = {}
    reset_counts()
    cap = _Capture(extra=((planar_probe, "fused_jnd_blend_planar", "K1"),
                          (r4_probe, "fused_jnd_blend_planar", "K1"),
                          (dw_mxu_probe, "convnext_probe", "K8")))
    with cap:
        rec["unet_bench_s2d"] = unet_bench.main(["--s2d", "1"] + k)["stages"]
        rec["unet_bench_s2d_pieces"] = unet_bench.main(["--s2d_pieces", "1"] + k)["stages"]
        rec["conv_probe"] = conv_probe.main(k)
        rec["resize_probe"] = resize_probe.main(k)
        rec["dw_mxu_probe"] = dw_mxu_probe.main(k)
        rec["planar_probe"] = planar_probe.main(["--lowres_stages"] + k)
        rec["r4_probe"] = r4_probe.main(k)
    # K1: planar_probe's reference, each taken rs's check and timing, the
    # lowres blend; r4_probe's blend, blend+detect and its output for
    # resize_det. K2/K3: r4_probe's two extractor routes over F_SLICE frames
    # in chunks of 32. K8: dw_mxu_probe's vpu form, `depth` launches a call
    taken = sum("ms" in r for r in rec["planar_probe"] if "rs" in r)
    chunks = F_SLICE // 32
    groups = [g for d in DEPTHS for g in block_groups(d, 4)]
    rec["launches"] = check_counts("layouts", {
        "K1": 1 + taken * (1 + calls) + calls + 2 * calls + 1,
        "K2": calls * chunks * (groups.count(1) + sum(DEPTHS)),
        "K3": calls * chunks * sum(g > 1 for g in groups),
        "K8": calls * sum(d for _, _, d in dw_mxu_probe.STAGES)})
    rec["held"] = hold_captured("layouts", cap.calls)
    del cap
    torch.cuda.empty_cache()
    if [r["form"] for r in rec["dw_mxu_probe"]] != ["vpu", "mxu_band", "mxu_band_t",
                                                    "mxu_diag"] * 4:
        raise AssertionError("dw_mxu_probe printed other forms")
    for tool in ("unet_bench_s2d", "unet_bench_s2d_pieces", "conv_probe", "resize_probe",
                 "dw_mxu_probe", "planar_probe", "r4_probe"):
        for row in rec[tool]:
            log(f"[layouts] {tool} {json.dumps(row)} ({smi})")
    rec["s"] = time.perf_counter() - t0
    log(f"[layouts] {rec['s']:.1f} s")
    return rec


def k5_inputs(f: int, h: int, w: int, seed: int, dev) -> list:
    """u8 and [0, 1) f32 frames (f, h, w, 3) and a prediction in [-1, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u8 = torch.randint(0, 256, (f, h, w, 3), generator=g, device=dev, dtype=torch.uint8)
    f32 = torch.rand((f, h, w, 3), generator=g, device=dev)
    pred = torch.rand((f, h, w), generator=g, device=dev) * 2 - 1
    return [("u8", u8, pred), ("f32", f32, pred)]


def k5_turns(key: str, args: tuple, out: torch.Tensor, bound_ms: float, smi: str) -> dict:
    """K5 at F=128 against its parent, the strip design (K7's full_nosqrt at
    rs=8, bit for bit the same delta), in turns (parent, K5, K5, parent),
    then over K5's geometry sweep (K5_SWEEP: output rows and columns a
    block), each instance bit for bit the default's, with its
    registers, spills, shared memory and blocks an SM; and K5's split
    (jnd_probe.k5_split). No time is asserted."""
    from videoseal_tpu_torch.kernels import fused_blend as fb
    from videoseal_tpu_torch.kernels import jnd_probe as jp
    imgs, pred, sw = args
    u8 = imgs.dtype == torch.uint8
    if not torch.equal(out, jp.jnd_probe(imgs, pred, sw, "full_nosqrt", 8)):
        raise AssertionError(f"{key} differs from its parent at F={F_SLICE}")
    parent = lambda: jp.jnd_probe(imgs, pred, sw, "full_nosqrt", 8)
    kern = lambda: fb.fused_jnd_delta(imgs, pred, sw)
    turns = [cuda_ms(f, reps=10) for f in (parent, kern, kern, parent)]
    log(f"[K5] F={F_SLICE} {key} in turns (parent, K5, K5, parent): "
        + ", ".join(f"{t:.3f}" for t in turns) + f" ms; bound {bound_ms:.3f} ms: K5 at "
        f"{bound_ms / turns[1]:.1%} / {bound_ms / turns[2]:.1%}, the parent at "
        f"{bound_ms / turns[0]:.1%} / {bound_ms / turns[3]:.1%} ({smi})")
    # K5's own split at its geometry: the copies, luminance and window
    # (copy), the stencil sums (sums), the whole heat; each bit for bit its
    # plain version
    split = {}
    for mode in jp.SPLIT_MODES:
        got = jp.k5_split(imgs, pred, sw, mode)
        if not torch.equal(got, jp.jnd_probe_plain(imgs, pred, sw, mode)):
            raise AssertionError(f"{key}: K5's split {mode} differs from its plain version")
        del got
        split[mode] = cuda_ms(lambda: jp.k5_split(imgs, pred, sw, mode), reps=10)
    log(f"[K5] F={F_SLICE} {key} split at its geometry: " + ", ".join(
        f"{m} {t:.3f} ms ({bound_ms / t:.1%})" for m, t in split.items()) + f" ({smi})")
    h, w = imgs.shape[1:3]
    sweep, infos = [], {}
    for rows, band_max in K5_SWEEP:
        geo = fb.k5_geometry(h, w, u8, rows, band_max)
        band = geo["band"]
        if band not in infos:
            infos[band] = fb.k5_info(u8, band)
            if infos[band]["smem"] != geo["smem"] or infos[band]["threads"] != geo["threads"]:
                raise AssertionError(f"k5_geometry {geo} disagrees with the kernel's "
                                     f"{infos[band]}")
        run = lambda: fb._delta_cuda(imgs, pred, sw, rows=rows, band_max=band_max)
        if not torch.equal(run(), out):
            raise AssertionError(f"{key} at rows {rows}, band {band} differs from the default "
                                 f"geometry's")
        ms = cuda_ms(run, reps=10)
        sweep.append(dict(rows=rows, band=band, stages=geo["stages"], ms=ms, share=bound_ms / ms,
                          **infos[band]))
        log(f"[K5] F={F_SLICE} {key} sweep: rows {rows}, band {band}, stages {geo['stages']}: "
            f"{ms:.3f} ms, {bound_ms / ms:.1%} of the bound; {infos[band]['registers']} "
            f"registers, {infos[band]['local_bytes']} B local, {geo['smem']} B shared, "
            f"{geo['threads']} threads, {infos[band]['blocks_per_sm']} blocks an SM")
    return {"turns_ms": turns, "parent_ms": (turns[0] + turns[3]) / 2, "split_ms": split,
            "sweep": sweep}


def phase_jnd(dev, smi: str) -> dict:
    """K4 (delta and blend mode, u8 and f32 frames), K5 (u8 and f32 frames),
    K6 against their plain versions at F=4 and at F=2, 1078x1922; K5 bit for
    bit, also at its geometry's edges (K5_EDGES) and against its parent, the
    strip design (K7's full_nosqrt at rs=8); timed at F=128, K5 in turns
    with the parent and over its geometry's sweep (K5_SWEEP), with each
    instance's registers and shared memory."""
    from videoseal_tpu_torch.kernels import jnd_probe as jp
    from videoseal_tpu_torch.kernels import fused_blend as fb
    from videoseal_tpu_torch.kernels.fused_planar import _band
    from videoseal_tpu_torch.ops.resize import _resize_matrix, resize_bilinear
    s = 256
    lift_taps = _band(_resize_matrix(s, H))[2]
    width_taps = _band(_resize_matrix(s, W), 2)[2]

    def cases(f: int, seed: int, h: int = H, w: int = W, all_cases: bool = True) -> dict:
        g = torch.Generator(device=dev).manual_seed(seed)
        u8 = torch.randint(0, 256, (f, h, w, 3), generator=g, device=dev, dtype=torch.uint8)
        f32 = torch.rand((f, h, w, 3), generator=g, device=dev)
        pred_low = (torch.rand((f, s, s), generator=g, device=dev) * 2 - 1).contiguous()
        px = f * h * w
        # per pixel: the width taps of each lift tap, the lift, the heat, the
        # delta; the blend mode 3 more per value
        up_ops = px * (HEAT_OPS + lift_taps * (2 * width_taps + 2) + 2)
        out = {}
        for name, im in (("u8", u8), ("f32", f32)):
            out[f"K4,{name}"] = ("K4", fb.fused_jnd_delta_up, fb.fused_jnd_delta_up_plain,
                                 (im, pred_low, 0.2), up_ops)
            out[f"K4b,{name}"] = ("K4", fb.fused_jnd_blend_up, fb.fused_jnd_blend_up_plain,
                                  (im, pred_low, 0.95, 0.2), up_ops + 3 * px * 4)
        if not all_cases:
            return out
        pred = resize_bilinear(pred_low[..., None], h, w)[..., 0].contiguous()
        p1 = torch.rand((f, h, w, 1), generator=g, device=dev) * 2 - 1
        p3 = torch.rand((f, h, w, 3), generator=g, device=dev) * 2 - 1
        for name, im in (("u8", u8), ("f32", f32)):
            out[f"K5,{name}"] = ("K5", fb.fused_jnd_delta, fb.fused_jnd_delta_plain,
                                 (im, pred, 0.2), px * (HEAT_OPS + 1))
        for name, pr in (("f32,c1", p1), ("f32,c3", p3), ("bf16,c1", p1.to(torch.bfloat16)),
                         ("bf16,c3", p3.to(torch.bfloat16))):
            out[f"K6,{name}"] = ("K6", fb.fused_jnd_blend, fb.fused_jnd_blend_plain,
                                 (f32, pr, 1.0, 0.2), px * (HEAT_OPS + 15))
        return out

    rec, worst = {}, {"K4": 0.0, "K5": 0.0, "K6": 0.0}

    def hold(tag: str, key: str, k: str, kern, plain, args) -> float:
        a, b = kern(*args), plain(*args)
        torch.cuda.synchronize()
        if a.dtype == torch.uint8:   # K4's blend mode on u8 frames
            d = (a.int() - b.int()).abs()
            err, share = float(d.max()), float((d > 0).float().mean())
            log(f"[{k}] {tag} {key}: u8 max diff {int(err)}, share differing {share:.2e}")
            if err > K1_U8_MAX or share > K1_U8_SHARE:
                raise AssertionError(f"{key} at {tag} disagrees with its plain version")
            worst[k] = max(worst[k], err)
            return err
        err = float((a - b).abs().max())
        tol = (BLEND_ATOL if k == "K6" else K4_BLEND_F32_ATOL if key.startswith("K4b")
               else 0.0 if k == "K5" else DELTA_RTOL * float(b.abs().max()))
        log(f"[{k}] {tag} {key}: max abs err {err:.3e} (tolerance {tol:.3e}), "
            f"max |plain| {float(b.abs().max()):.4f}")
        if not bool(torch.isfinite(a).all()) or err > tol:
            raise AssertionError(f"{key} at {tag} disagrees with its plain version")
        worst[k] = max(worst[k], err)
        return err

    small = cases(4, 7)
    for key, (k, kern, plain, args, _) in small.items():
        rec[key] = {"max_abs_err": hold("F=4", key, k, kern, plain, args)}
    # a height that the row strips do not divide, and a width whose NHWC rows
    # are not 16-byte aligned and whose last 16-pixel group is ragged: K4's
    # masked scalar path; K5 and K6's 8-row strips and 256-column chunks
    hr, wr = H - 2, W + 2
    for key, (k, kern, plain, args, _) in cases(2, 9, hr, wr).items():
        if k == "K4" or key in ("K5,u8", "K5,f32", "K6,f32,c3"):
            rec[key]["ragged_max_abs_err"] = hold(f"F=2 {hr}x{wr}", key, k, kern, plain, args)
    # 120x200 frames: the prediction downscaled in width, K4's general path
    for key, (k, kern, plain, args, _) in cases(2, 10, 120, 200, all_cases=False).items():
        rec[key]["small_max_abs_err"] = hold("F=2 120x200", key, k, kern, plain, args)
    # K5's geometry at its edges, against its plain version and its parent
    # (K7's full_nosqrt at rs=8), both bit for bit
    _, he, we = K5_EDGES[-1]
    for u8 in (True, False):
        geo = fb.k5_geometry(he, we, u8)
        if geo["bands"] * geo["band"] <= we or not geo["vec_frames"]:
            raise AssertionError(f"K5's edge {he}x{we} has no ragged band on the 16-byte "
                                 f"path: {geo}")
    for i, (f, h, w) in enumerate(((2, 120, 200),) + K5_EDGES):
        for name, im, pred in k5_inputs(f, h, w, 20 + i, dev):
            key, tag = f"K5,{name}", f"F={f} {h}x{w}"
            err = hold(tag, key, "K5", fb.fused_jnd_delta, fb.fused_jnd_delta_plain,
                       (im, pred, 0.2))
            same = torch.equal(fb.fused_jnd_delta(im, pred, 0.2),
                               jp.jnd_probe(im, pred, 0.2, "full_nosqrt", 8))
            log(f"[K5] {tag} {name}: identical to the parent (K7 full_nosqrt, rs=8): {same}")
            if not same:
                raise AssertionError(f"K5 differs from its parent at {tag} {name}")
            rec[key][f"edge_{h}x{w}"] = err
    torch.cuda.empty_cache()
    # K5 on the upsampled prediction is K4 on the low-res one
    pred_full = small["K5,f32"][3][1]
    for key in ("K4,u8", "K4,f32"):
        imgs, pred_low, sw = small[key][3]
        a = fb.fused_jnd_delta_up(imgs, pred_low, sw)
        b = fb.fused_jnd_delta(imgs, pred_full, sw)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        log(f"[K4] F=4 {key} against K5 on the upsampled prediction: max abs err {err:.3e}")
        if err > DELTA_RTOL * float(b.abs().max()):
            raise AssertionError(f"K4 and K5 disagree on {key}")
        rec[key]["vs_K5"] = err
    del small, pred_full
    for key, (k, kern, plain, args, ops) in cases(F_SLICE, 8).items():
        ms, pms = cuda_ms(lambda: kern(*args), reps=10), cuda_ms(lambda: plain(*args))
        out = kern(*args)
        # each input read once (frames and pred_low), each output written once
        nbytes = sum(t.numel() * t.element_size() for t in args if torch.is_tensor(t))
        bound_ms, bound_by = bound(nbytes + out.numel() * out.element_size(), f32_ops=ops)
        log(f"[{k}] F={F_SLICE} {key}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), kernel at {bound_ms / ms:.1%} of it")
        rec[key].update(ms=ms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by)
        if k == "K5":
            rec[key].update(k5_turns(key, args, out, bound_ms, smi))
        del out
        torch.cuda.empty_cache()
    # K4: its main-path instance, the blend mode on u8 frames (NHWC embed);
    # K5 on f32 frames, the instance its earlier rows were timed on
    main_case = {"K4": "K4b,u8", "K5": "K5,f32", "K6": "K6,f32,c3"}
    return {k: dict(rec[c], case=c, max_abs_err=worst[k]) for k, c in main_case.items()} | {
        "checks": rec}


def phase_nhwc(dev, smi: str) -> dict:
    """videoseal_1.0 over NHWC frames: embed (u8 video, float images),
    detect, extract_message."""
    import videoseal_tpu_torch as vt

    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    g = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randint(0, 256, (F_SLICE, H, W, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    imgs = torch.rand((32, H, W, 3), generator=g, device=dev)
    msgs = model.get_random_msg(1)

    reset_counts()
    vid = model.embed(frames, msgs=msgs, is_video=True)
    preds = model.detect(vid["imgs_w"])["preds"]
    bits = model.extract_message(vid["imgs_w"])
    img = model.embed(imgs, is_video=False)
    blocks = sum(len(stage) for stage in model.extractor.convnext.stages)   # 18
    per_detect = blocks * math.ceil(F_SLICE / model.cfg.chunk_size)
    rec = {"launches": check_counts("nhwc", {"K4": 2, "K2": 2 * per_detect})}
    wm, pw = vid["imgs_w"], vid["preds_w"]
    log(f"[nhwc] video: imgs_w {tuple(wm.shape)} {wm.dtype}, preds_w {tuple(pw.shape)} "
        f"{pw.dtype}, preds {tuple(preds.shape)}, bits {tuple(bits.shape)} {bits.dtype}; "
        f"images: imgs_w {tuple(img['imgs_w'].shape)} {img['imgs_w'].dtype}")
    iw = img["imgs_w"]
    if (tuple(wm.shape) != (F_SLICE, H, W, 3) or wm.dtype != torch.uint8
            or tuple(pw.shape) != (F_SLICE, H, W, 1) or pw.dtype != torch.float32
            or tuple(preds.shape) != (F_SLICE, 1 + model.nbits)
            or not bool(torch.isfinite(preds).all())
            or tuple(bits.shape) != (1, model.nbits) or bits.dtype != torch.int32
            or tuple(iw.shape) != (32, H, W, 3) or iw.dtype != torch.float32
            or tuple(img["preds_w"].shape) != (32, H, W, 1) or not bool(torch.isfinite(iw).all())
            or float(iw.min()) < 0.0 or float(iw.max()) > 1.0):
        raise AssertionError("NHWC slice output has the wrong shape, dtype or range")
    changed = float((wm != frames).float().mean())
    log(f"[nhwc] share of u8 values the watermark changed {changed:.3f}")
    if changed == 0.0:
        raise AssertionError("the watermark changed no pixel")

    sw = model.scaling_w
    model.scaling_w = 0.0
    same_u8 = torch.equal(model.embed(frames, msgs=msgs, is_video=True)["imgs_w"], frames)
    same_f = torch.equal(model.embed(imgs)["imgs_w"], imgs)
    model.scaling_w = sw
    log(f"[nhwc] scaling_w=0: u8 video unchanged {same_u8}, float images unchanged {same_f}")
    if not (same_u8 and same_f):
        raise AssertionError("scaling_w=0 is not the identity on the NHWC path")

    model32 = vt.load("videoseal_1.0", device=dev, seed=0)
    cpu32 = vt.load("videoseal_1.0", device="cpu", seed=0)
    cpu = cpu_route(cpu32.with_dtype("bfloat16"), model)
    with tf32_off():
        g32 = model32.embed(frames[:4], msgs=msgs, is_video=True)["imgs_w"]
        l32 = model32.detect(g32)["preds"].cpu()
    c32 = cpu32.embed(frames[:4].cpu(), msgs=msgs.cpu(), is_video=True)["imgs_w"]
    d = (g32.cpu().int() - c32.int()).abs()
    share, ld = float((d > 0).float().mean()), float((l32 - cpu32.detect(g32.cpu())["preds"])
                                                     .abs().max())
    log(f"[nhwc] F=4, card vs CPU in float32, TF32 off: u8 max diff {int(d.max())}, share "
        f"differing {share:.2e}, logits max abs diff {ld:.3e}")
    if int(d.max()) > SLICE_U8_MAX or share > SLICE_U8_SHARE or ld > SLICE_LOGIT_ATOL:
        raise AssertionError("card and CPU disagree on the NHWC path in float32")
    g4 = model.embed(frames[:4], msgs=msgs, is_video=True)["imgs_w"]
    c4 = cpu.embed(frames[:4].cpu(), msgs=msgs.cpu(), is_video=True)["imgs_w"]
    d = (g4.cpu().int() - c4.int()).abs()
    ld = float((model.detect(g4)["preds"].cpu() - cpu.detect(g4.cpu())["preds"]).abs().max())
    m4 = model.get_random_msg(4)
    fd = float((model.embed(imgs[:4], msgs=m4)["imgs_w"].cpu()
                - cpu.embed(imgs[:4].cpu(), msgs=m4.cpu())["imgs_w"]).abs().max())
    share = float((d > 0).float().mean())
    floor = float((c4 != c32).float().mean())      # the CPU's bf16 against its float32
    share_max = max(SLICE_U8_SHARE, SLICE_NOISE_FACTOR * floor)
    log(f"[nhwc] F=4, card vs CPU in bf16: u8 max diff {int(d.max())}, share differing "
        f"{share:.2e} (the CPU's bf16 against its float32: {floor:.2e}; limit {share_max:.2e}), "
        f"logits max abs diff {ld:.3e}, float images max abs diff {fd:.3e}")
    if (int(d.max()) > SLICE_U8_MAX or share > share_max or ld > SLICE_LOGIT_ATOL
            or fd > SLICE_FLOAT_ATOL):
        raise AssertionError("card and CPU disagree on the NHWC path")
    rec["cpu_vs_card"] = {"u8_max": int(d.max()), "u8_share": share, "u8_share_max": share_max,
                          "bf16_floor": floor, "logit_max": ld,
                          "float_max": fd}
    del cpu

    def embed_detect():
        return model.detect(model.embed(frames, msgs=msgs, is_video=True)["imgs_w"])

    if "--profile" in sys.argv:
        # K4's blend mode launches its kernel only, and embed launches nothing
        # over the full-resolution frames after it
        from videoseal_tpu_torch.kernels.fused_blend import fused_jnd_blend_up
        pred_low = torch.rand((F_SLICE, 256, 256), device=dev) * 2 - 1
        rec["profile"] = profile({
            "nhwc": embed_detect,
            "nhwc_embed_u8": lambda: model.embed(frames, msgs=msgs, is_video=True),
            "nhwc_embed_f32": lambda: model.embed(imgs),
            "k4_blend": lambda: fused_jnd_blend_up(frames, pred_low, 1.0, 0.2)})
        check_launches("K4 wrapper, blend mode", rec["profile"]["k4_blend"]["order"],
                       ("jnd_up_kernel",))
        for m in ("nhwc_embed_u8", "nhwc_embed_f32"):
            check_launches(m, rec["profile"][m]["order"], after="jnd_up_kernel")
    few = frames[:BENCH_NHWC_FRAMES]     # the NHWC scorer's frames, lowres mode
    rec["route_turns"] = route_turns(
        "nhwc", model, lambda: model.detect(model.embed(
            few, msgs=msgs, is_video=True, lowres_attenuation=True)["imgs_w"]),
        BENCH_NHWC_FRAMES, smi)
    ms = cuda_ms(embed_detect)
    ems = cuda_ms(lambda: model.embed(frames, msgs=msgs, is_video=True))
    fps = F_SLICE / ms * 1000
    log(f"[nhwc] embed+detect: {ms:.2f} ms per {F_SLICE} u8 frames at 1080p = {fps:.1f} fps "
        f"(embed alone {ems:.2f} ms) ({smi})")
    rec.update(ms=ms, fps=fps, embed_ms=ems)
    return rec


def cpu_route(cpu, card):
    """`cpu`, a with_dtype model on the CPU (where the rule serves the
    folded UNet), serving the card model's UNet route (the space-to-depth
    one by s2d_embedder_rule), so that the two run one function on
    their two devices."""
    import dataclasses
    cpu.cfg = dataclasses.replace(cpu.cfg, s2d_embedder=card.cfg.s2d_embedder)
    return cpu


def cpu_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A CPU copy of a model's module, without the kernel parameters or
    folded weights its blocks cached on the card (the CPU builds its own)."""
    import copy
    out = copy.deepcopy(module).cpu()
    for m in out.modules():
        m.__dict__.pop("_kernel_params", None)
        m.__dict__.pop("_fused_params", None)
        m.__dict__.pop("_s2d_params", None)
    return out


def phase_chunky(dev, smi: str) -> dict:
    """chunkyseal at full width: the float embed (the K6 path), then detect
    and extract_message of the watermarked frames (K2 at the padded widths,
    36 launches a chunk), the logits against the CPU's on 2 frames."""
    import videoseal_tpu_torch as vt

    t0 = time.perf_counter()
    model = vt.load("chunkyseal", device=dev, seed=0).with_dtype("bfloat16")
    build_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(6)
    imgs = torch.rand((8, H, W, 3), generator=g, device=dev)
    reset_counts()
    out = model.embed(imgs, is_video=False)
    rec = {"launches": check_counts("chunky", {"K6": 1}), "build_s": build_s}
    wm, pw = out["imgs_w"], out["preds_w"]
    log(f"[chunky] built in {build_s:.1f} s; imgs_w {tuple(wm.shape)} {wm.dtype}, preds_w "
        f"{tuple(pw.shape)}")
    if (tuple(wm.shape) != (8, H, W, 3) or wm.dtype != torch.float32
            or tuple(pw.shape) != (8, H, W, 3) or not bool(torch.isfinite(wm).all())
            or float(wm.min()) < 0.0 or float(wm.max()) > 1.0 or torch.equal(wm, imgs)):
        raise AssertionError("chunkyseal embed output has the wrong shape or range, "
                             "or is unchanged")
    sw = model.scaling_w
    model.scaling_w = 0.0
    same = torch.equal(model.embed(imgs)["imgs_w"], imgs)
    model.scaling_w = sw
    log(f"[chunky] scaling_w=0 leaves the frames unchanged: {same}")
    if not same:
        raise AssertionError("scaling_w=0 is not the identity on the K6 path")
    rec["ms"] = cuda_ms(lambda: model.embed(imgs))
    log(f"[chunky] embed of 8 float 1080p frames: {rec['ms']:.2f} ms")

    from videoseal_tpu_torch.models.videoseal import detect_pipeline
    blocks = sum(len(stage) for stage in model.extractor.convnext.stages)   # 36
    reset_counts()
    preds = model.detect(wm)["preds"]
    bits = model.extract_message(wm)
    got = check_counts("chunky detect", {"K2": 2 * blocks * math.ceil(8 / model.cfg.chunk_size)})
    rec["launches"] = {k: rec["launches"][k] + got[k] for k in got}
    log(f"[chunky] detect: preds {tuple(preds.shape)}, max |logit| "
        f"{float(preds.abs().max()):.3f}, bits {tuple(bits.shape)}")
    if (tuple(preds.shape) != (8, 1 + model.nbits) or not bool(torch.isfinite(preds).all())
            or tuple(bits.shape) != (1, model.nbits)):
        raise AssertionError("chunkyseal detect output has the wrong shape or is not finite")
    cpu_ext = cpu_copy(model.extractor)
    c2 = detect_pipeline(cpu_ext, model.cfg, wm[:2].cpu())
    ld = float((preds[:2].cpu() - c2).abs().max())
    del cpu_ext
    log(f"[chunky] detect, 2 frames, card vs CPU: logits max abs diff {ld:.3e} (tolerance "
        f"{CHUNKY_LOGIT_ATOL})")
    if ld > CHUNKY_LOGIT_ATOL:
        raise AssertionError("card and CPU disagree on chunkyseal's logits")
    rec["detect_cpu_vs_card"] = ld
    rec["detect_ms"] = cuda_ms(lambda: model.detect(wm))
    log(f"[chunky] detect of 8 1080p frames: {rec['detect_ms']:.2f} ms ({smi})")
    del model
    torch.cuda.empty_cache()
    return rec

def phase_pixelseal(dev, smi: str) -> dict:
    """pixelseal at random init (seed 0) in bf16: the NHWC embed of 32 u8
    1080p frames as a video and detect (K4 1, K2 18), the scored planar mode
    over the same frames (K1 1, K2 18), the scaling_w=0 identity on both,
    card against CPU on 2 frames; timed."""
    import videoseal_tpu_torch as vt

    f = F_CARDS
    model = vt.load("pixelseal", device=dev, seed=0).with_dtype("bfloat16")
    g = torch.Generator(device=dev).manual_seed(14)
    frames = torch.randint(0, 256, (f, H, W, 3), generator=g, device=dev, dtype=torch.uint8)
    msgs = model.get_random_msg(1)
    blocks = sum(len(stage) for stage in model.extractor.convnext.stages)   # 18
    reset_counts()
    vid = model.embed(frames, msgs=msgs, is_video=True)
    preds = model.detect(vid["imgs_w"])["preds"]
    rec = {"launches": check_counts("pixelseal nhwc", {"K4": 1, "K2": blocks})}
    planar = vt.pack_planar(frames)
    scored = dict(lowres_attenuation=True, fused_detect=True)
    reset_counts()
    pout = model.embed_detect_planar(planar, H, W, msgs=msgs, **scored)
    got = check_counts("pixelseal planar", {"K1": 1, "K2": blocks})
    rec["launches"] = {k: rec["launches"][k] + got[k] for k in got}
    wm, pw, pwm, pp = vid["imgs_w"], vid["preds_w"], pout["imgs_w"], pout["preds"]
    log(f"[pixelseal] video: imgs_w {tuple(wm.shape)} {wm.dtype}, preds_w {tuple(pw.shape)}, "
        f"preds {tuple(preds.shape)}; planar: imgs_w {tuple(pwm.shape)}, preds {tuple(pp.shape)}")
    if (tuple(wm.shape) != (f, H, W, 3) or wm.dtype != torch.uint8
            or tuple(pw.shape) != (f, H, W, 1) or tuple(preds.shape) != (f, 1 + model.nbits)
            or not bool(torch.isfinite(preds).all())
            or tuple(pwm.shape[:2]) != (f, 3) or pwm.shape[2] < H or pwm.shape[3] < W
            or tuple(pp.shape) != (f, 1 + model.nbits) or not bool(torch.isfinite(pp).all())
            or torch.equal(wm, frames)):
        raise AssertionError("pixelseal output has the wrong shape, is not finite or is "
                             "unchanged")
    sw = model.scaling_w
    model.scaling_w = 0.0
    same = torch.equal(model.embed(frames, msgs=msgs, is_video=True)["imgs_w"], frames)
    same_p = torch.equal(model.embed_detect_planar(planar, H, W, msgs=msgs, **scored)[
        "imgs_w"][:, :, :H, :W], planar[:, :, 28:28 + H, 128:128 + W])
    model.scaling_w = sw
    log(f"[pixelseal] scaling_w=0: u8 video unchanged {same}, planar unchanged {same_p}")
    if not (same and same_p):
        raise AssertionError("scaling_w=0 is not the identity on pixelseal's paths")
    cpu = cpu_route(vt.load("pixelseal", device="cpu", seed=0).with_dtype("bfloat16"), model)
    g2 = model.embed(frames[:2], msgs=msgs, is_video=True)["imgs_w"]
    c2 = cpu.embed(frames[:2].cpu(), msgs=msgs.cpu(), is_video=True)["imgs_w"]
    d = (g2.cpu().int() - c2.int()).abs()
    ld = float((model.detect(g2)["preds"].cpu() - cpu.detect(g2.cpu())["preds"]).abs().max())
    share = float((d > 0).float().mean())
    del cpu
    log(f"[pixelseal] F=2, card vs CPU: u8 max diff {int(d.max())}, share differing "
        f"{share:.2e}, logits max abs diff {ld:.3e}")
    if int(d.max()) > SLICE_U8_MAX or share > SLICE_U8_SHARE or ld > SLICE_LOGIT_ATOL:
        raise AssertionError("card and CPU disagree on pixelseal")
    rec["cpu_vs_card"] = {"u8_max": int(d.max()), "u8_share": share, "logit_max": ld}
    rec["nhwc_ms"] = cuda_ms(lambda: model.detect(
        model.embed(frames, msgs=msgs, is_video=True)["imgs_w"]))
    rec["planar_ms"] = cuda_ms(lambda: model.embed_detect_planar(planar, H, W, msgs=msgs,
                                                                 **scored))
    log(f"[pixelseal] {f} u8 1080p frames: NHWC embed+detect {rec['nhwc_ms']:.2f} ms, planar "
        f"scored {rec['planar_ms']:.2f} ms ({smi})")
    del model
    torch.cuda.empty_cache()
    return rec


def phase_v0(dev, smi: str) -> dict:
    """videoseal_0.0 at random init (seed 0) in bf16: the NHWC embed of 32 u8
    1080p frames as a video (no JND: the 3-channel prediction upsampled and
    blended at scaling_w 1), detect and extract_message through the SAM ViT;
    no kernel of the port lies on this path (nor a Pallas kernel on the JAX
    package's), so every count reads 0; the scaling_w=0 identity, card
    against CPU on 2 frames; timed."""
    import videoseal_tpu_torch as vt

    f = F_CARDS
    model = vt.load("videoseal_0.0", device=dev, seed=0).with_dtype("bfloat16")
    g = torch.Generator(device=dev).manual_seed(15)
    frames = torch.randint(0, 256, (f, H, W, 3), generator=g, device=dev, dtype=torch.uint8)
    msgs = model.get_random_msg(1)
    reset_counts()
    vid = model.embed(frames, msgs=msgs, is_video=True)
    preds = model.detect(vid["imgs_w"])["preds"]
    bits = model.extract_message(vid["imgs_w"])
    rec = {"launches": check_counts("videoseal_0.0", {})}
    wm, pw = vid["imgs_w"], vid["preds_w"]
    log(f"[v0] video: imgs_w {tuple(wm.shape)} {wm.dtype}, preds_w {tuple(pw.shape)}, preds "
        f"{tuple(preds.shape)}, max |logit| {float(preds.abs().max()):.3f}, bits "
        f"{tuple(bits.shape)}")
    if (tuple(wm.shape) != (f, H, W, 3) or wm.dtype != torch.uint8
            or tuple(pw.shape) != (f, H, W, 3) or tuple(preds.shape) != (f, 97)
            or not bool(torch.isfinite(preds).all()) or tuple(bits.shape) != (1, 96)
            or torch.equal(wm, frames)):
        raise AssertionError("videoseal_0.0 output has the wrong shape, is not finite or is "
                             "unchanged")
    sw = model.scaling_w
    model.scaling_w = 0.0
    same = torch.equal(model.embed(frames, msgs=msgs, is_video=True)["imgs_w"], frames)
    model.scaling_w = sw
    log(f"[v0] scaling_w=0: u8 video unchanged {same}")
    if not same:
        raise AssertionError("scaling_w=0 is not the identity on videoseal_0.0's path")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu32 = vt.load("videoseal_0.0", device="cpu", seed=0)
    gpu32 = vt.load("videoseal_0.0", device=dev, seed=0)
    cp32 = cpu32.embed(frames[:2].cpu(), msgs=msgs.cpu(), is_video=True)["preds_w"]
    d32 = float((gpu32.embed(frames[:2], msgs=msgs, is_video=True)["preds_w"].cpu() - cp32)
                .abs().max())
    l32 = float((gpu32.detect(wm[:2])["preds"].cpu() - cpu32.detect(wm[:2].cpu())["preds"])
                .abs().max())
    cpu = cpu_route(cpu32.with_dtype("bfloat16"), model)
    del cpu32, gpu32
    gp = model.embed(frames[:2], msgs=msgs, is_video=True)["preds_w"]
    cp = cpu.embed(frames[:2].cpu(), msgs=msgs.cpu(), is_video=True)["preds_w"]
    diff = (gp.cpu() - cp).abs()
    pd, pm = float(diff.max()), float(diff.mean())
    # the CPU's bf16 prediction against its float32 one: bf16's noise floor,
    # which bounds the card's where the fixed limits do not hold
    floor = (cp - cp32).abs()
    pd_max = max(V0_PRED_ATOL, SLICE_NOISE_FACTOR * float(floor.max()))
    pm_max = max(V0_PRED_MEAN, SLICE_NOISE_FACTOR * float(floor.mean()))
    ld = float((model.detect(wm[:2])["preds"].cpu() - cpu.detect(wm[:2].cpu())["preds"])
               .abs().max())
    del cpu, diff
    log(f"[v0] F=2, card vs CPU in f32: prediction max abs diff {d32:.3e}, logits {l32:.3e} "
        f"(tolerance {V0_F32_ATOL}); in bf16: prediction max abs diff {pd:.3e} (tolerance "
        f"{pd_max:.3e}; the CPU's bf16 against its f32: {float(floor.max()):.3e}), mean "
        f"{pm:.3e} (tolerance {pm_max:.3e}; CPU: {float(floor.mean()):.3e}), logits max abs "
        f"diff {ld:.3e} (tolerance {V0_LOGIT_ATOL})")
    if (d32 > V0_F32_ATOL or l32 > V0_F32_ATOL or pd > pd_max or pm > pm_max
            or ld > V0_LOGIT_ATOL):
        raise AssertionError("card and CPU disagree on videoseal_0.0")
    rec["cpu_vs_card"] = {"f32_pred_max": d32, "f32_logit_max": l32, "pred_max": pd,
                          "pred_mean": pm, "pred_max_limit": pd_max, "pred_mean_limit": pm_max,
                          "logit_max": ld}
    rec["ms"] = cuda_ms(lambda: model.detect(
        model.embed(frames, msgs=msgs, is_video=True)["imgs_w"]))
    rec["detect_ms"] = cuda_ms(lambda: model.detect(wm))
    log(f"[v0] {f} u8 1080p frames: embed+detect {rec['ms']:.2f} ms, detect alone "
        f"{rec['detect_ms']:.2f} ms ({smi})")
    del model
    torch.cuda.empty_cache()
    return rec


def phase_k3(dev) -> dict:
    """K3 against its plain version and, bit for bit, against k K2 launches
    (K3 runs K2's parts on K2's tiles, with the bf16 rounding between
    blocks) at the four stage shapes, B=32, and at 3x12x20x96, k = 2, 3, 4,
    bf16 and f32; each instance's occupancy; times the K3 groups of one
    grouped 32-frame chunk beside the same blocks as K2 launches, and the
    grid barrier."""
    from videoseal_tpu_torch.kernels import convnext_block as cb
    from videoseal_tpu_torch.kernels.convnext_fused import block_groups

    def seq_k2(x, ps):
        y = x
        for p in ps[:-1]:
            y = cb._launch(y, p).to(torch.bfloat16)
        return cb._launch(y.to(x.dtype), ps[-1])

    rec, worst, occupancy = {}, 0.0, {}
    chunk = {"ms": 0.0, "plain_ms": 0.0, "k2_ms": 0.0}
    nbytes = f32_ops = bf16_ops = 0.0
    cases = [(32, h, w, c) for h, w, c in STAGES] + [(3, 12, 20, 96)]
    for i, (b, h, w, c) in enumerate(cases):
        staged = i < len(STAGES)
        groups = [k for k in block_groups(DEPTHS[i], 4) if k > 1] if staged else []
        for dtype in (torch.bfloat16, torch.float32):
            ps = [cb.block_params(_random_block(c, 20 + 4 * i + j, dev, dtype)) for j in range(4)]
            g = torch.Generator(device=dev).manual_seed(30 + i)
            x = torch.randn((b, h, w, c), generator=g, device=dev).to(dtype)
            shape = f"{b}x{h}x{w}x{c},{str(dtype)[6:]}"
            occupancy[shape] = cb.group_occupancy(x)
            log(f"[K3] {shape}: occupancy {occupancy[shape]}")
            for k in (2, 3, 4):
                a = cb.convnext_blocks_fused(x, ps[:k]).float()
                ref = cb.convnext_blocks_plain(x, ps[:k]).float()
                q = seq_k2(x, ps[:k]).float()
                torch.cuda.synchronize()
                err, same = (a - ref).abs(), torch.equal(a, q)
                key = f"{shape},k={k}"
                log(f"[K3] {key}: vs plain max abs err {float(err.max()):.3e}, mean "
                    f"{float(err.mean()):.3e}; identical to {k} K2 launches: {same}")
                if (not bool(torch.isfinite(a).all())
                        or bool((err > K2_ATOL + K2_RTOL * ref.abs()).any()) or not same):
                    raise AssertionError(f"K3 disagrees with its plain version, or is not "
                                         f"bit-identical to {k} K2 launches, at {key}")
                rec[key] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                            "vs_k2_identical": same}
                if dtype != torch.bfloat16:
                    continue
                worst = max(worst, float(err.max()))
                if k not in groups:
                    continue
                # in turns on the one card: K2 launches, K3, K3, K2 launches
                t = {"k3": [], "k2": []}
                for name in ("k2", "k3", "k3", "k2"):
                    fn = (lambda: cb.convnext_blocks_fused(x, ps[:k])) if name == "k3" else (
                        lambda: seq_k2(x, ps[:k]))
                    t[name].append(cuda_ms(fn, reps=10))
                ms, qms = sum(t["k3"]) / 2, sum(t["k2"]) / 2
                pms = cuda_ms(lambda: cb.convnext_blocks_plain(x, ps[:k]))
                log(f"[K3] B=32 {key}: kernel {t['k3']} ms, {k} K2 launches {t['k2']} ms, "
                    f"plain {pms:.3f} ms")
                rec[key].update(ms=ms, plain_ms=pms, k2_ms=qms, turns=t)
                n = groups.count(k)
                nb, bo, fo = block_cost(h, w, c, k=k)
                nbytes, bf16_ops, f32_ops = nbytes + n * nb, bf16_ops + n * bo, f32_ops + n * fo
                for name, v in (("ms", ms), ("plain_ms", pms), ("k2_ms", qms)):
                    chunk[name] += n * v
            del ps, x
        torch.cuda.empty_cache()
    # the grid barrier: K3 on 264 frames of 8x2x16, so that the dwln phase
    # fills the 2 x 132 co-resident blocks and every phase's work is tiny;
    # k = 4 runs 12 barriers (and 12 tiny phases) more than k = 1
    ps = [cb.block_params(_random_block(16, 40 + j, dev, torch.bfloat16)) for j in range(4)]
    xs = torch.randn((264, 8, 2, 16), device=dev).to(torch.bfloat16)
    tk = {k: cuda_ms(lambda k=k: cb.convnext_blocks_fused(xs, ps[:k]), reps=20) for k in (1, 4)}
    barrier_us = (tk[4] - tk[1]) / 12 * 1e3
    log(f"[K3] tiny phases on grid {cb.group_occupancy(xs)['grid']}: k=1 {tk[1]:.4f} ms, k=4 "
        f"{tk[4]:.4f} ms: {barrier_us:.2f} us a barrier with its tiny phase (an upper bound "
        f"on the barrier)")
    bound_ms, bound_by = bound(nbytes, f32_ops=f32_ops, bf16_ops=bf16_ops)
    groups = [k for d in DEPTHS for k in block_groups(d, 4) if k > 1]
    log(f"[K3] the {len(groups)} groups ({sum(groups)} blocks) of one grouped chunk of 32 "
        f"frames, bf16: kernel {chunk['ms']:.3f} ms, the same blocks as K2 launches "
        f"{chunk['k2_ms']:.3f} ms ({chunk['ms'] / chunk['k2_ms'] - 1:+.1%}), plain "
        f"{chunk['plain_ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), kernel at "
        f"{bound_ms / chunk['ms']:.1%} of it")
    return {"checks": rec, "max_abs_err": worst, **chunk, "bound_ms": bound_ms,
            "bound_by": bound_by, "occupancy": occupancy, "barrier_us": barrier_us,
            "tiny_ms": tk}


def phase_grouped(dev, smi: str) -> dict:
    """The extractor's grouped route at full width, r4_probe's extract
    stage: convnext_apply_fused(max_block_group=4) plus the pixel decoder."""
    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch.evals import r4_probe
    from videoseal_tpu_torch.kernels.convnext_fused import block_groups

    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    s, cs = model.cfg.img_size, model.cfg.chunk_size
    g = torch.Generator(device=dev).manual_seed(12)
    frames = torch.rand((F_SLICE, s, s, 3), generator=g, device=dev).to(torch.bfloat16)
    extract = lambda ext, x, mbg: r4_probe.extract(ext, x, mbg, cs)

    groups = [k for st in model.extractor.convnext.stages for k in block_groups(len(st), 4)]
    chunks = math.ceil(F_SLICE / cs)
    reset_counts()
    grouped = extract(model.extractor, frames, 4)
    rec = {"launches": check_counts("grouped", {"K3": chunks * sum(k > 1 for k in groups),
                                                "K2": chunks * groups.count(1)})}
    single = extract(model.extractor, frames, 1)
    same = torch.equal(grouped, single)
    cpu = vt.load("videoseal_1.0", device="cpu", seed=0).with_dtype("bfloat16")
    cd = float((grouped[:4].cpu() - extract(cpu.extractor, frames[:4].cpu(), 4)).abs().max())
    del cpu
    log(f"[grouped] logits {tuple(grouped.shape)}, max |logit| "
        f"{float(grouped.abs().max()):.3f}; identical to the single route: {same}; "
        f"F=4, card vs CPU max abs diff {cd:.3e}")
    if (tuple(grouped.shape) != (F_SLICE, 1 + model.nbits)
            or not bool(torch.isfinite(grouped).all()) or not same or cd > GROUPED_CPU_ATOL):
        raise AssertionError("grouped route logits have the wrong shape, are not finite, "
                             "differ from the single route or disagree with the CPU")
    rec.update(identical_to_single=same, cpu_vs_card=cd)
    # in turns on the one card: grouped, single, single, grouped
    times = {"grouped": [], "single": []}
    for name, mbg in (("grouped", 4), ("single", 1), ("single", 1), ("grouped", 4)):
        times[name].append(cuda_ms(lambda: extract(model.extractor, frames, mbg)))
    log(f"[grouped] extractor over {F_SLICE} frames at {s}x{s}, bf16: grouped "
        f"{times['grouped']} ms, single {times['single']} ms ({smi})")
    rec.update(times)
    del model
    torch.cuda.empty_cache()
    return rec


def phase_probes(dev) -> dict:
    """K7 against its plain version at a small ragged size (every strip
    height), each probe's sweep at the TPU probe's shapes, then every case of
    the sweeps against its plain version on the sweep's own inputs, outside
    the counted run; the plain versions of the cases the kernels line reports
    are timed there."""
    from videoseal_tpu_torch.kernels import convnext_probe as cp
    from videoseal_tpu_torch.kernels import fused_blend as fb
    from videoseal_tpu_torch.kernels import jnd_probe as jp
    from videoseal_tpu_torch.kernels.convnext_block import _launch as k2_launch
    errs = {}

    def hold7(tag: str, a: torch.Tensor, b: torch.Tensor) -> float:
        torch.cuda.synchronize()
        err, tol = float((a - b).abs().max()), DELTA_RTOL * float(b.abs().max())
        errs[tag] = err
        if not bool(torch.isfinite(a).all()) or err > tol:
            raise AssertionError(f"{tag} disagrees with its plain version: {err:.3e} > {tol:.3e}")
        return err

    hs, ws = 120, 200   # ragged for the 16- and 32-row strips and the 256-column chunks
    for dtype in (torch.float32, torch.uint8):
        imgs, pred = jp.probe_inputs(2, hs, ws, dtype, dev, seed=13)
        worst = {}
        for mode in jp.MODES:
            b = jp.jnd_probe_plain(imgs, pred, 0.2, mode)
            for rs in jp.RS_SWEEP:
                err = hold7(f"K7,{mode},rs={rs},{str(dtype)[6:]},2x{hs}x{ws}",
                            jp.jnd_probe(imgs, pred, 0.2, mode, rs), b)
                worst[mode] = max(worst.get(mode, 0.0), err)
        same = torch.equal(jp.jnd_probe(imgs, pred, 0.2, "full_nosqrt", 8),
                           fb.fused_jnd_delta(imgs, pred, 0.2))
        log(f"[K7] 2x{hs}x{ws} {str(dtype)[6:]}: max abs err against plain, by mode (worst "
            f"strip height): " + ", ".join(f"{m} {e:.3e}" for m, e in worst.items())
            + f"; full_nosqrt identical to K5: {same}")
        if not same:
            raise AssertionError("K7 full_nosqrt differs from K5")

    calls = 4   # each sweep case: one warm-up and three timed calls (run's reps=3)
    reset_counts()
    sweep7 = jp.main()
    launches = check_counts("K7 sweep", {"K7": calls * len(sweep7)})
    reset_counts()
    sweep8 = cp.main([]) + cp.main(["--dw"])
    launches8 = check_counts("K8 sweep", {"K8": calls * len(sweep8)})
    launches = {k: launches[k] + launches8[k] for k in launches}
    torch.cuda.empty_cache()

    # K7: every case of the sweep on run()'s inputs, F=128 at 1080p
    k7_plain = None
    for dtype in (torch.float32, torch.uint8):
        name = str(dtype)[6:]
        imgs, pred = jp.probe_inputs(F_SLICE, H, W, dtype, dev)
        for mode in jp.MODES:
            b = jp.jnd_probe_plain(imgs, pred, 0.2, mode)
            for rs in sorted(r["rs"] for r in sweep7 if (r["mode"], r["dtype"]) == (mode, name)):
                err = hold7(f"K7,{mode},rs={rs},{name}", jp.jnd_probe(imgs, pred, 0.2, mode, rs),
                            b)
                log(f"[K7] F={F_SLICE} {H}x{W} {name} {mode} rs={rs}: max abs err {err:.3e}, "
                    f"max |plain| {float(b.abs().max()):.4f}")
            if mode == "full_nosqrt":
                same = torch.equal(jp.jnd_probe(imgs, pred, 0.2, mode, 8),
                                   fb.fused_jnd_delta(imgs, pred, 0.2))
                log(f"[K7] F={F_SLICE} {H}x{W} {name}: full_nosqrt identical to K5: {same}")
                if not same:
                    raise AssertionError("K7 full_nosqrt differs from K5 at full size")
                if dtype == torch.float32:
                    k7_plain = cuda_ms(lambda: jp.jnd_probe_plain(imgs, pred, 0.2, mode))
            del b
            torch.cuda.empty_cache()
        del imgs, pred
        torch.cuda.empty_cache()
    px = F_SLICE * H * W
    k7_bound = bound(px * (12 + 4 + 4), f32_ops=px * (HEAT_OPS + 1))

    # K8: every case of the sweeps on run()'s inputs, at its shape
    k8_plain, k8_bound = None, None
    for shape in dict.fromkeys(tuple(r["shape"]) for r in sweep8):
        xpad, p = cp.probe_inputs(*shape, dev)
        for v in dict.fromkeys(r["variant"] for r in sweep8 if tuple(r["shape"]) == shape):
            a = cp.convnext_probe(xpad, p, v).float()
            b = cp.convnext_probe_plain(xpad, p, v).float()
            torch.cuda.synchronize()
            err = (a - b).abs()
            key = f"K8,{v},{'x'.join(map(str, shape))}"
            errs[key] = float(err.max())
            share = float((err > K2_ATOL + K2_RTOL * b.abs()).float().mean())
            log(f"[K8] {'x'.join(map(str, shape))} {v}: max abs err {float(err.max()):.3e}, "
                f"mean {float(err.mean()):.3e}, share beyond K2's tolerance {share:.2e}")
            if (not bool(torch.isfinite(a).all()) or share > K8_SHARE
                    or float(err.mean()) > K8_MEAN or float(err.max()) > K8_MAX):
                raise AssertionError(f"K8 {v} at {shape} disagrees with its plain version")
            del a, b, err
            if v == "production_block":
                # K2's own block: on a zero halo, K2 bit for bit
                z = torch.zeros_like(xpad)
                z[:, 3:-3, 3:-3] = xpad[:, 3:-3, 3:-3]
                same = torch.equal(cp.convnext_probe(z, p, v),
                                   k2_launch(z[:, 3:-3, 3:-3].contiguous(), p))
                log(f"[K8] {'x'.join(map(str, shape))} production_block on a zero halo identical "
                    f"to K2: {same}")
                if not same:
                    raise AssertionError(f"K8 production_block differs from K2 at {shape}")
                errs[f"{key},zero_halo_is_k2"] = same
                del z
            if v == "production_block" and k8_plain is None:
                k8_case = (key, shape)
                k8_plain = cuda_ms(lambda: cp.convnext_probe_plain(xpad, p, v))
                bsz, h, w, c = shape
                nb, bo, fo = block_cost(h, w, c, frames=bsz)
                k8_bound = bound(nb + 2 * (xpad.numel() - bsz * h * w * c), f32_ops=fo,
                                 bf16_ops=bo)
        del xpad, p
        torch.cuda.empty_cache()

    k7 = next(r for r in sweep7 if (r["mode"], r["rs"], r["dtype"]) == ("full_nosqrt", 8,
                                                                         "float32"))
    k8 = next(r for r in sweep8 if r["variant"] == "production_block"
              and tuple(r["shape"]) == k8_case[1])
    out = {"K7": {"case": f"full_nosqrt, rs=8, f32 frames, F={F_SLICE}, 1080p", "ms": k7["ms"],
                  "plain_ms": k7_plain, "bound_ms": k7_bound[0], "bound_by": k7_bound[1],
                  "max_abs_err": errs["K7,full_nosqrt,rs=8,float32"]},
           "K8": {"case": f"production_block, {'x'.join(map(str, k8_case[1]))}",
                  "ms": k8["ms"], "plain_ms": k8_plain, "bound_ms": k8_bound[0],
                  "bound_by": k8_bound[1], "max_abs_err": errs[k8_case[0]]}}
    for k, r in out.items():
        log(f"[{k}] {r['case']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), kernel at {r['bound_ms'] / r['ms']:.1%} "
            f"of it")
    return out | {"launches": launches, "checks": errs, "sweep_K7": sweep7, "sweep_K8": sweep8}


def _stream_report(tag: str, stats: dict, walls: dict, smi: str) -> dict:
    """A stream's fps, its stage walls' overlap and its device timeline."""
    n = stats["frames"]
    rec = dict(stats, fps=n / stats["wall_s"])
    line = f"[stream] {tag}: {n} frames in {stats['wall_s'] * 1e3:.1f} ms = {rec['fps']:.1f} fps"
    if walls:
        rec["walls_s"] = walls
        rec["overlap_ratio"] = sum(walls.values()) / stats["wall_s"]
        line += (" (alone: " + ", ".join(f"{k} {n / v:.1f} fps" for k, v in walls.items())
                 + f"; overlap_ratio {rec['overlap_ratio']:.3f})")
    if "h2d_ms" in stats:
        line += (f"; device: h2d {stats['h2d_ms']:.2f} ms, kernels {stats['kernels_ms']:.2f}, "
                 f"d2h {stats['d2h_ms']:.2f}, copies under kernels "
                 f"{stats['copies_under_kernels_ms']:.2f}, span {stats['device_span_ms']:.2f}")
    log(f"{line} ({smi})")
    return rec


def _stream_run(tag: str, model, fill, chunk_shape, step, sink, want: dict, smi: str,
                walls: dict) -> dict:
    """One stream through the engine with every count at 0 just before it
    and read just after."""
    from videoseal_tpu_torch.inference_streaming import run_stream

    reset_counts()
    stats = run_stream(fill, chunk_shape, step, sink, model.device)
    launches = check_counts(f"stream {tag}", want)
    return {"launches": launches, **_stream_report(tag, stats, walls, smi)}


def _stream_memory(model, dev, smi: str) -> dict:
    """The planar stream over in-memory frames (the host codec replaced by
    copies), then the detect stream over its output."""
    from videoseal_tpu_torch.evals.streaming_bench import device_stage, planar_step
    from videoseal_tpu_torch.inference_streaming import detect_step, unit_frames
    from videoseal_tpu_torch.kernels.fused_planar import C0, R0, TH, planar_geometry, planar_shape

    n_tiles, _, _, wq = planar_geometry(H, W)
    out_shape = (F_STREAM, 3, TH * n_tiles, wq)
    src = planar_frames(F_STREAM, 11, dev, H, W).cpu().numpy()
    msgs = model.get_random_msg(1)
    step = planar_step(model, H, W, msgs)
    chunks = [src[i:i + STREAM_CHUNK] for i in range(0, F_STREAM, STREAM_CHUNK)]
    n_chunks = len(chunks)
    pinned = dev.type == "cuda"
    buf = torch.zeros(planar_shape(STREAM_CHUNK, H, W), dtype=torch.uint8,
                      pin_memory=pinned).numpy()
    t0 = time.perf_counter()
    for c in chunks:
        buf[:c.shape[0]] = c
    t_fill = time.perf_counter() - t0
    t_dev = device_stage(step, chunks, dev)
    out = np.zeros(out_shape, np.uint8)
    out.fill(0)   # touch every page before the sink is timed
    done = 0

    def sink(a):
        nonlocal done
        out[done:done + a.shape[0]] = a
        done += a.shape[0]

    zeros = torch.zeros((STREAM_CHUNK,) + out_shape[1:], dtype=torch.uint8,
                        pin_memory=pinned).numpy()
    t0 = time.perf_counter()
    for c in chunks:
        sink(zeros[:c.shape[0]])
    t_sink = time.perf_counter() - t0
    done = 0

    def fill_from(frames):
        pos = [0]

        def fill(b):
            k = min(b.shape[0], frames.shape[0] - pos[0])
            b[:k] = frames[pos[0]:pos[0] + k]
            pos[0] += k
            return k
        return fill

    rec = {"embed": _stream_run("planar embed, in-memory frames", model, fill_from(src),
                                planar_shape(STREAM_CHUNK, H, W), step, sink,
                                {"K1": n_chunks}, smi,
                                {"fill": t_fill, "device": t_dev, "sink": t_sink})}
    if done != F_STREAM:
        raise AssertionError(f"the stream wrote {done} frames of {F_STREAM}")
    # the stream's output against embed_planar of the same chunk, called directly
    i = min(1, n_chunks - 1) * STREAM_CHUNK
    direct = step(torch.from_numpy(chunks[i // STREAM_CHUNK]).to(dev)).cpu().numpy()
    d = np.abs(direct.astype(np.int16) - out[i:i + direct.shape[0]].astype(np.int16))
    log(f"[stream] in-memory: frames {i}.. against embed_planar called directly: u8 max diff "
        f"{int(d.max())}, share differing {float((d > 0).mean()):.2e}")
    if int(d.max()) > K1_U8_MAX or float((d > 0).mean()) > K1_U8_SHARE:
        raise AssertionError("the stream's output differs from embed_planar's")

    # the same stream with the host's copies taken away (fill writes nothing,
    # the buffers keep earlier chunks; sink drops the result): the engine
    # bound by the device, where the copies can run under the kernels
    left = [F_STREAM]

    def fill_nothing(b):
        k = min(b.shape[0], left[0])
        left[0] -= k
        return k

    rec["device_bound"] = _stream_run("planar embed, host copies taken away", model,
                                      fill_nothing, planar_shape(STREAM_CHUNK, H, W), step,
                                      lambda a: None, {"K1": n_chunks}, smi, {"device": t_dev})

    nhwc = np.ascontiguousarray(out[:, :, :H, :W].transpose(0, 2, 3, 1))
    logits = []
    rec["detect"] = _stream_run("detect, in-memory frames", model, fill_from(nhwc),
                                (STREAM_CHUNK, H, W, 3), detect_step(model),
                                lambda a: logits.append(a.copy()),
                                {"K2": 18 * n_chunks}, smi, {})
    want = model.detect(unit_frames(torch.from_numpy(nhwc).to(dev)), is_video=True)["preds"]
    rec.update(_hold_stream(np.concatenate(logits), want.float().cpu().numpy(),
                            src[:, :, R0:R0 + H, C0:C0 + W].transpose(0, 2, 3, 1), nhwc,
                            F_STREAM))
    return rec


def _hold_stream(logits: np.ndarray, want: np.ndarray, src: np.ndarray,
                 out: np.ndarray, frames: int) -> dict:
    """The stream's logits against detect's on the same frames; the frame
    count; the watermarked output's PSNR against its source."""
    from videoseal_tpu_torch.ops.metrics import psnr

    ld = float(np.abs(logits - want).max())
    p = float(psnr(torch.from_numpy(src).float() / 255.0,
                   torch.from_numpy(out).float() / 255.0, is_video=True))
    log(f"[stream] detect stream vs detect on the same frames: logits max abs diff {ld:.3e}; "
        f"frames {out.shape[0]}; PSNR of the output against its source {p:.2f} dB")
    if logits.shape != want.shape or ld > STREAM_LOGIT_ATOL:
        raise AssertionError("the detect stream's logits differ from detect's")
    if out.shape[0] != frames or not math.isfinite(p):
        raise AssertionError(f"stream output: {out.shape[0]} frames, PSNR {p}")
    return {"logit_max": ld, "psnr": p}


def _stream_files(model, dev, smi: str, planar: bool) -> dict:
    """The file entry points on a synthesized clip: embed_video (planar
    through the native runtime, else NHWC through cv2), then detect_video
    of the output. Each stage is timed alone first."""
    import tempfile

    from videoseal_tpu_torch import inference_streaming as st
    from videoseal_tpu_torch.evals import streaming_bench as sb
    from videoseal_tpu_torch.kernels.fused_planar import C0, R0

    frames = F_STREAM if planar else F_STREAM_CV2
    n_chunks = math.ceil(frames / STREAM_CHUNK)
    msgs = model.get_random_msg(1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        src, dst = os.path.join(tmp, "src.mp4"), os.path.join(tmp, "wm.mp4")
        t0 = time.perf_counter()
        sb.synth_video(src, frames, H, W)
        log(f"[stream] synthesized {frames} frames of {W}x{H} in "
            f"{time.perf_counter() - t0:.2f} s")
        if planar:
            chunks, t_dec = sb.decode_stage(src, STREAM_CHUNK)
            t_enc = sb.encode_stage(chunks, os.path.join(tmp, "copy.mp4"), H, W)
            step = sb.planar_step(model, H, W, msgs)
        else:
            t0 = time.perf_counter()
            reader, chunks = st.open_reader(src), []
            while True:
                c = reader.read(STREAM_CHUNK, np.empty((STREAM_CHUNK, H, W, 3), np.uint8))
                if c.shape[0] == 0:
                    break
                chunks.append(c)
            reader.close()
            t_dec = time.perf_counter() - t0
            t0 = time.perf_counter()
            wr = st.open_writer(os.path.join(tmp, "copy.mp4"), W, H, 24)
            for c in chunks:
                wr.write(c)
            wr.close()
            t_enc = time.perf_counter() - t0
            step = st.embed_step(model, msgs)
        t_dev = sb.device_stage(step, chunks, dev)
        walls = {"decode": t_dec, "device": t_dev, "encode": t_enc}
        n = sum(c.shape[0] for c in chunks)

        reset_counts()
        info = st.embed_video(model, src, dst, chunk_size=STREAM_CHUNK)
        tag = "planar embed_video (native)" if planar else "NHWC embed_video (cv2, mp4v)"
        launches = check_counts(f"stream {tag}", {"K1": n_chunks} if planar else {"K4": n_chunks})
        rec = {"embed": {"launches": launches,
                         **_stream_report(tag, info["stats"], walls, smi)}}
        if info["frames"] != n:
            raise AssertionError(f"embed_video wrote {info['frames']} frames of {n}")

        reset_counts()
        t0 = time.perf_counter()
        msg, logits = st.detect_video(model, dst, chunk_size=STREAM_CHUNK, return_preds=True)
        t_det = time.perf_counter() - t0
        rec["detect"] = {"launches": check_counts("stream detect_video", {"K2": 18 * n_chunks}),
                         "wall_s": t_det, "fps": n / t_det}
        log(f"[stream] detect_video: {n} frames in {t_det * 1e3:.1f} ms = {n / t_det:.1f} fps "
            f"({smi})")
        reader = st.open_reader(dst)
        out = reader.read(frames + 1, np.empty((frames + 1, H, W, 3), np.uint8))
        reader.close()
    src_frames = np.concatenate(
        [c[:, :, R0:R0 + H, C0:C0 + W].transpose(0, 2, 3, 1) if planar else c for c in chunks])
    want = model.detect(st.unit_frames(torch.from_numpy(np.ascontiguousarray(out)).to(dev)),
                        is_video=True)["preds"].float().cpu().numpy()
    rec.update(_hold_stream(logits.numpy(), want, src_frames, out, frames))
    bits = float((msg.cpu() == msgs.cpu()).float().mean())
    log(f"[stream] bit accuracy of detect_video's message (random weights: ~0.5 expected) "
        f"{bits:.3f}")
    return rec


def phase_stream(dev, smi: str) -> dict:
    """Streaming on the card, videoseal_1.0 in bf16, 96 1080p frames in
    chunks of 32: the planar file path where the native media runtime loads;
    else the same engine over in-memory frames, and the NHWC file path
    through cv2 where cv2 imports."""
    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch import native

    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    ok = native.available()
    if ok:
        where = ("the committed .so" if native.origin() == native._COMMITTED
                 else "a _build/ copy")
        log(f"[stream] native media runtime: loaded {where} ({native.origin()})")
    else:
        log(f"[stream] native media runtime: unavailable: {native.last_error()}")
    rec = {"native": ok, "native_origin": native.origin(),
           "native_error": None if ok else native.last_error()}
    log(json.dumps({"native": ok}))
    if ok:
        rec["files"] = _stream_files(model, dev, smi, planar=True)
    else:
        rec["memory"] = _stream_memory(model, dev, smi)
        try:
            import cv2  # noqa: F401
        except ImportError:
            log("[stream] cv2 is not installed: no file path to drive")
        else:
            rec["files"] = _stream_files(model, dev, smi, planar=False)
    runs = [r[k]["launches"] for r in (rec.get("files"), rec.get("memory")) if r
            for k in ("embed", "detect", "device_bound") if k in r]
    rec["launches"] = {k: sum(r[k] for r in runs) for k in runs[0]}
    return rec


def phase_evals(dev, smi: str) -> dict:
    """evals.speed.test_speed (32 float 1080p frames, bf16) and
    evals.lowres_quality.run (8 1080p frames, f32, as the JAX harness
    loads it), each with the counts at 0 just before it."""
    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch.evals import lowres_quality, speed

    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    g = torch.Generator(device=dev).manual_seed(13)
    frames = torch.rand((32, H, W, 3), generator=g, device=dev)
    reps = 3
    reset_counts()
    row = speed.test_speed(model, frames, num_runs=reps)
    # cuda_ms: one warm-up call and `reps` timed calls of embed and of detect
    rec = {"speed": row, "launches_speed": check_counts(
        "evals speed", {"K4": reps + 1, "K2": 18 * (reps + 1)})}
    log(f"[evals] speed: {json.dumps(row)} ({smi})")
    reset_counts()
    rows = lowres_quality.run("videoseal_1.0", H, W, 8, 0, device=dev)
    rec["lowres_quality"] = rows
    rec["launches_lowres"] = check_counts("evals lowres_quality", {"K1": 2, "K2": 36})
    for r in rows:
        log(f"[evals] lowres_quality: {json.dumps(r)} ({smi})")
    if not all(math.isfinite(r["psnr"]) and math.isfinite(r["ssim"]) for r in rows[:2]):
        raise AssertionError("lowres_quality gave a PSNR or SSIM that is not finite")
    rec["launches"] = {k: rec["launches_speed"][k] + rec["launches_lowres"][k]
                       for k in rec["launches_speed"]}
    return rec


def _is_jpeg_proxy(aug) -> bool:
    """Does the aug (or the first of a Sequential) run the JPEG proxy?"""
    from videoseal_tpu_torch.augmentation import augs as A
    first = aug.augs[0] if hasattr(aug, "augs") else aug
    return isinstance(first, (A.JPEG, A.VideoCompressionProxy))


def _jpeg_step(aug, strength) -> float:
    """One quantisation step of the largest table entry at the aug's
    quality, in [0, 1] pixels."""
    from videoseal_tpu_torch.augmentation import augs as A
    from videoseal_tpu_torch.ops import jpeg
    first = aug.augs[0] if hasattr(aug, "augs") else aug
    s = strength[0] if isinstance(strength, tuple) else strength
    q = s if isinstance(first, A.JPEG) else A.crf_to_quality(s)
    return float(max(jpeg.scaled_table(jpeg._Q_LUMA, q).max(),
                     jpeg.scaled_table(jpeg._Q_CHROMA, q).max())) / 255.0


def _attacks_card_vs_cpu(dev) -> dict:
    """Every aug of the image and video grids at each of its strengths on
    the card and on the CPU from the same frames (2 at 720x1280, 4 for the
    video rows): within AUG_ATOL, the JPEG proxy within its flip rule."""
    from videoseal_tpu_torch.augmentation.validation import get_validation_augs
    from videoseal_tpu_torch.evals.full import synthetic_samples

    x = torch.from_numpy(next(synthetic_samples(1, (4, *ATTACK_HW, 3), seed=21)))
    rec, t_cpu = {}, 0.0
    for is_video, n in ((False, 2), (True, 4)):
        xc = x[:n]
        mc = torch.ones(xc.shape[:-1] + (1,))
        xg, mg = xc.to(dev), mc.to(dev)
        for aug, strengths in get_validation_augs(is_video):
            worst, share, bound = 0.0, 0.0, AUG_ATOL
            for s in strengths:
                t0 = time.perf_counter()
                oc, mo_c = aug.apply_strength(xc, mc, s)
                t_cpu += time.perf_counter() - t0
                og, mo_g = aug.apply_strength(xg, mg, s)
                d = (og.cpu() - oc).abs()
                dm = float((mo_g.cpu() - mo_c).abs().max())
                if _is_jpeg_proxy(aug):
                    bound = _jpeg_step(aug, s)
                    share = max(share, float((d > AUG_ATOL).float().mean()))
                    ok = share < JPEG_FLIP_SHARE and float(d.max()) <= bound
                else:
                    ok = float(d.max()) <= AUG_ATOL
                worst = max(worst, float(d.max()))
                if not ok or dm > AUG_ATOL:
                    raise AssertionError(f"attack {aug!r}@{s}: card against CPU max abs diff "
                                         f"{float(d.max()):.3e} (share over {AUG_ATOL}: "
                                         f"{float((d > AUG_ATOL).float().mean()):.2e}), mask "
                                         f"{dm:.3e}")
            key = f"{'video' if is_video else 'image'}:{aug!r}"
            rec[key] = {"strengths": [str(s) for s in strengths], "max_abs_diff": worst,
                        "share_over_atol": share}
            rule = (f"share over {AUG_ATOL} {share:.2e} < {JPEG_FLIP_SHARE}, max <= {bound:.4f}"
                    if _is_jpeg_proxy(aug) else f"<= {AUG_ATOL}")
            log(f"[attacks] card vs CPU, {key} at {len(strengths)} strengths: max abs diff "
                f"{worst:.3e} ({rule})")
    log(f"[attacks] card vs CPU: {len(rec)} grid rows hold; the CPU side took {t_cpu:.1f} s")
    return {"rows": rec, "cpu_s": t_cpu}


def _grid_report(tag: str, rows: list, wall_s: float, smi: str) -> dict:
    att = [r["attack_time"] * 1e3 for r in rows]
    ext = [r["extract_time"] * 1e3 for r in rows]
    slow = sorted(rows, key=lambda r: -r["attack_time"])[:5]
    rest = wall_s - (sum(att) + sum(ext)) / 1e3 - rows[0]["embed_time"]
    log(f"[attacks] {tag}: {len(rows)} rows in {wall_s:.2f} s wall; per row: attack "
        f"{np.mean(att):.3f} ms (max {max(att):.3f}), detect {np.mean(ext):.3f} ms (max "
        f"{max(ext):.3f}) (CUDA events); embed {rows[0]['embed_time'] * 1e3:.1f} ms; the "
        f"rest (quality metrics, p-values, the host between rows) {rest:.2f} s ({smi})")
    log(f"[attacks] {tag}: slowest attacks: " + "; ".join(
        f"{r['aug'].split('(')[0]}@{r['strength']} {r['attack_time'] * 1e3:.3f} ms"
        for r in slow) + f" ({smi})")
    bad = [r["aug"] for r in rows if not all(math.isfinite(r[k])
                                             for k in ("psnr", "ssim", "bit_acc"))]
    if bad:
        raise AssertionError(f"{tag}: psnr, ssim or bit_acc not finite in {bad[:3]}")
    return {"rows": len(rows), "wall_s": wall_s, "rest_s": rest,
            "embed_ms": rows[0]["embed_time"] * 1e3, "attack_ms_mean": float(np.mean(att)),
            "detect_ms_mean": float(np.mean(ext)),
            "slowest": [(r["aug"], r["strength"], r["attack_time"] * 1e3) for r in slow],
            "bit_acc_mean": float(np.mean([r["bit_acc"] for r in rows])),
            "psnr": rows[0]["psnr"], "ssim": rows[0]["ssim"]}


def phase_attacks(dev, smi: str) -> dict:
    """The attack simulator and the robustness eval, videoseal_1.0 in bf16 at
    random init (seed 0): every grid aug on the card against the CPU; the
    image grid (78 rows) over 4 float 1080p images and the video grid (36
    rows) over 16 frames at 720x1280 through evals.full.evaluate; 16 draws
    of the training-path augmenter forward and backward."""
    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch import native
    from videoseal_tpu_torch.augmentation import AUGS, build_augmenter
    from videoseal_tpu_torch.augmentation import augs as A
    from videoseal_tpu_torch.augmentation.validation import get_validation_augs
    from videoseal_tpu_torch.evals.full import evaluate, synthetic_samples
    from videoseal_tpu_torch.utils.timing import timed
    from videoseal_tpu_torch.ops import metrics

    # PyTorch's defaults (earlier phases turned TF32 off): the attacks must
    # not depend on them (the DCT and the blur are elementwise float32)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    rec = {"card_vs_cpu": _attacks_card_vs_cpu(dev)}
    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    blocks = sum(len(stage) for stage in model.extractor.convnext.stages)   # 18
    os.makedirs(OUT_DIR, exist_ok=True)

    # the image grid
    imgs = next(synthetic_samples(1, (F_ATTACK_IMAGES, H, W, 3), seed=22))
    grid = get_validation_augs(False)
    model.generator.manual_seed(7)   # the direct embed below draws the same messages
    reset_counts()
    t0 = time.perf_counter()
    rows = evaluate(model, [imgs], is_video=False, validation_augs=grid, verbose=False,
                    out_csv=os.path.join(OUT_DIR, "attacks_image_grid.csv"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_rows = sum(len(s) for _, s in grid)
    got = check_counts("attacks image grid", {"K4": 1, "K2": blocks * n_rows})
    if len(rows) != n_rows or n_rows != 78:
        raise AssertionError(f"the image grid gave {len(rows)} rows, expected 78")
    rec["image_grid"] = dict(_grid_report("image grid", rows, wall, smi), launches=got)
    ident = rows[0]
    model.generator.manual_seed(7)
    direct = model.embed(torch.as_tensor(imgs, device=dev))["imgs_w"]
    direct_psnr = float(metrics.psnr(direct, torch.as_tensor(imgs, device=dev)).mean())
    log(f"[attacks] image grid identity row: linf {ident['linf']:.3f}, psnr "
        f"{ident['psnr']:.3f} dB against a direct embed's {direct_psnr:.3f} dB, ssim "
        f"{ident['ssim']:.5f}, bit_acc {ident['bit_acc']:.4f} (random weights)")
    if ident["aug"] != "Identity()" or not ident["linf"] > 0 \
            or abs(ident["psnr"] - direct_psnr) > 0.5:
        raise AssertionError("the image grid's identity row disagrees with a direct embed")
    rec["image_grid"]["direct_psnr"] = direct_psnr

    # the video grid, its codec rows on the rule of validation._codec
    codecs = {a.codec: type(a).__name__ for a, _ in get_validation_augs(True)
              if hasattr(a, "codec")}
    why = ("the native runtime loaded" if native.available()
           else f"the native runtime does not load: {native.last_error()}")
    log(f"[attacks] video grid codec route: {codecs} ({why})")
    vid = next(synthetic_samples(1, (F_ATTACK_VIDEO, *ATTACK_HW, 3), seed=23))
    vgrid = get_validation_augs(True)
    reset_counts()
    t0 = time.perf_counter()
    vrows = evaluate(model, [vid], is_video=True, validation_augs=vgrid, verbose=False,
                     out_csv=os.path.join(OUT_DIR, "attacks_video_grid.csv"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_vrows = sum(len(s) for _, s in vgrid)
    got = check_counts("attacks video grid", {"K4": 1, "K2": blocks * n_vrows})
    if len(vrows) != n_vrows or n_vrows != 36:
        raise AssertionError(f"the video grid gave {len(vrows)} rows, expected 36")
    rec["video_grid"] = dict(_grid_report("video grid", vrows, wall, smi), launches=got,
                             codec_route=codecs, native=native.available())
    try:
        A.VideoCompressionProxy(codec="h264").apply_strength(
            torch.zeros((1, H, W, 3), device=dev), torch.ones((1, H, W, 1), device=dev), 30)
    except ValueError as e:
        log(f"[attacks] the proxy at {H}x{W} raises as it must: {e}")
    else:
        raise AssertionError(f"the codec proxy took a {H}x{W} frame (540 chroma rows)")

    # the training-path augmenter: 16 draws, forward and backward
    aug = build_augmenter(AUGS["augs_geometric"])
    clean = torch.as_tensor(next(synthetic_samples(1, (F_AUGMENTER, 256, 256, 3), seed=24)),
                            device=dev)
    reset_counts()
    imgs_w = model.embed(clean)["imgs_w"].detach().requires_grad_()
    names = aug.aug_names(is_video=True)
    v = torch.randn(imgs_w.shape, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)

    def step():
        out, _, sel = aug(g, imgs_w, clean, is_video=True)
        grad, = torch.autograd.grad((out * v).sum(), imgs_w)
        return out, sel, grad

    # the same 16 draws twice, timed the second time (the first pays each
    # op's first use on the device)
    for _ in range(2):
        g = torch.Generator().manual_seed(0)
        draws = []
        for _ in range(16):
            (out, sel, grad), secs = timed(step, imgs_w.device)
            name = names[sel[0]]
            finite, nonzero = bool(torch.isfinite(grad).all()), bool((grad != 0).any())
            draws.append({"aug": name, "ms": secs * 1e3, "finite": finite,
                          "nonzero": nonzero})
            if not finite or (name != "identity" and not nonzero):
                raise AssertionError(f"augmenter draw {name}: gradient finite {finite}, "
                                     f"non-zero {nonzero}")
    preds = model.detect(out.detach())["preds"]
    got = check_counts("attacks augmenter", {"K4": 1, "K2": blocks})
    if not bool(torch.isfinite(preds).all()):
        raise AssertionError("the detect after the augmenter gave logits that are not finite")
    log("[attacks] augmenter (augs_geometric, video pool), forward+backward per draw: "
        + ", ".join(f"{d['aug']} {d['ms']:.2f} ms" for d in draws)
        + f" (CUDA events) ({smi})")
    rec["augmenter"] = {"draws": draws, "launches": got}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    rec["launches"] = {k: sum(rec[p]["launches"][k]
                              for p in ("image_grid", "video_grid", "augmenter"))
                       for k in rec["augmenter"]["launches"]}
    return rec



# -- phase 17: training -------------------------------------------------------------

def _train_cases_card_vs_cpu(dev) -> dict:
    """One image step (batch 2) and one video step (one clip of 16 frames) of
    make_train_step at videoseal_1.0's full width, balanced 0 and 1, from the
    same weights on the card and on the CPU: the dummy augmenter, injected
    messages, SGD at lr 1 (so each updated tensor is p - grad), TF32 off."""
    import dataclasses

    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.augmentation.augmenter import get_dummy_augmenter
    from videoseal_tpu_torch.parallel.trainer import create_train_state, make_train_step
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, False
    s = 256
    rng = np.random.default_rng(17)
    cases = {"image": rng.uniform(0, 1, (2, s, s, 3)).astype(np.float32),
             "video": rng.uniform(0, 1, (1, F_TRAIN_CLIP, s, s, 3)).astype(np.float32)}
    msgs = torch.as_tensor(rng.integers(0, 2, (2, 256)))
    out, worst = {}, {"logs": 0.0, "grads": 0.0, "params": 0.0, "bn": 0.0}
    for balanced in (0, 1):
        args = train.get_parser().parse_args(["--balanced", str(balanced)])
        for kind, imgs in cases.items():
            res = {}
            for where in (dev, torch.device("cpu")):
                mods, _, _ = train.build_trainer(args, where)
                mods = dataclasses.replace(mods, augmenter=get_dummy_augmenter())
                state = create_train_state(mods, "SGD,lr=1.0", "SGD,lr=1.0")
                step = make_train_step(mods, is_video=kind == "video")
                t0 = time.perf_counter()
                _, logs = step(state, {"imgs": torch.as_tensor(imgs, device=where)},
                               torch.Generator().manual_seed(0), msgs=msgs[:imgs.shape[0]])
                if where.type == "cuda":
                    torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                mods_ = (state.embedder, state.extractor, state.discriminator)
                res[where.type] = {
                    "secs": secs, "logs": {k: float(v) for k, v in logs.items()},
                    "grads": {f"{i}.{n}": p.grad.detach().cpu() for i, m in enumerate(mods_)
                              for n, p in m.named_parameters()},
                    "params": {f"{i}.{n}": p.detach().cpu() for i, m in enumerate(mods_)
                               for n, p in m.named_parameters()},
                    "bn": {n: b.detach().cpu() for n, b in state.embedder.named_buffers()
                           if n.endswith(("running_mean", "running_var"))}}
            card, cpu = res["cuda"], res["cpu"]
            # each gradient's error against its module's largest gradient: a
            # bias before a GroupNorm has gradients that are mostly
            # cancellation, so its own largest is no scale for its error
            scale = {m: max(float(g.abs().max()) for k, g in cpu["grads"].items()
                            if k.startswith(m)) for m in ("0.", "1.", "2.")}
            gerr = {k: float((card["grads"][k] - g).abs().max()) / scale[k[:2]]
                    for k, g in cpu["grads"].items()}
            own = {k: float((card["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                   for k, g in cpu["grads"].items()}
            err = {"logs": max(abs(card["logs"][k] - v) / max(abs(v), 1e-6)
                               for k, v in cpu["logs"].items()),
                   "grads": max(gerr.values()),
                   "params": max(float((card["params"][k] - p).abs().max())
                                 for k, p in cpu["params"].items()),
                   "bn": max(float((card["bn"][k] - b).abs().max()) for k, b in cpu["bn"].items())}
            tag = f"{kind}, balanced {balanced}"
            log(f"[train] card vs CPU, {tag}: losses/scales rel {err['logs']:.2e}, grads (of "
                f"the module's largest) {err['grads']:.2e} (at {max(gerr, key=gerr.get)}; "
                f"0 embedder, 1 extractor, 2 discriminator; of its own largest at most "
                f"{max(own.values()):.2e} at {max(own, key=own.get)}), updated params abs "
                f"{err['params']:.2e}, BN stats abs {err['bn']:.2e}; CPU step "
                f"{cpu['secs']:.1f} s, card step {card['secs'] * 1e3:.1f} ms (first)")
            if (err["logs"] > TRAIN_LOG_RTOL or err["grads"] > TRAIN_GRAD_RTOL
                    or err["bn"] > TRAIN_BN_ATOL
                    or err["params"] > TRAIN_GRAD_RTOL * max(scale.values()) + TRAIN_PARAM_ATOL
                    or not all(math.isfinite(v) for v in card["logs"].values())):
                raise AssertionError(f"train step, card against CPU, {tag}: {err}")
            out[tag] = err
            for k in worst:
                worst[k] = max(worst[k], err[k])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"cases": out, "worst": worst}


def _train_split(dev) -> dict:
    """The parts of one batch-16 step at full width, each between CUDA events
    in stream order (the host runs ahead, so each span is the device's time
    for that part): embed (the forward with the BatchNorm update), downstream
    (blend, JND, augmenter, resize, extractor, losses), backward with the
    generator's update, the discriminator's step. Mirrors make_train_step at
    balanced 0 (train.py's default) with DEFAULT_AUGS."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.ops.resize import resize_bilinear
    from videoseal_tpu_torch.parallel.trainer import _frozen, embed_batch, watermark
    args = train.get_parser().parse_args([])
    mods, state, _ = train.build_trainer(args, dev)
    imgs = torch.rand((16, 256, 256, 3), generator=torch.Generator().manual_seed(5)).to(dev)
    msgs = torch.randint(0, 2, (16, 256), generator=torch.Generator().manual_seed(6)).to(dev)
    gen = torch.Generator().manual_seed(7)
    spans = {k: [] for k in ("embed", "downstream", "backward", "disc")}
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        state.opt_g.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)
        ev[0].record()
        preds_w, mf = embed_batch(mods, state.embedder, imgs, msgs, False)
        ev[1].record()
        imgs_w = watermark(mods, imgs, preds_w, state.scaling_w)
        aug, mask, _ = mods.augmenter(gen, imgs_w, imgs, None, is_video=False, train=True)
        preds = state.extractor(resize_bilinear(aug, 256, 256)) / mods.temperature
        losses, weights = mods.loss.generator_losses(imgs, imgs_w, mask, mf, preds,
                                                     _frozen(state.discriminator), 0)
        total, _ = mods.loss.combine(losses, weights, None)
        ev[2].record()
        total.backward()
        state.opt_g.step()
        ev[3].record()
        d_loss, _ = mods.loss.discriminator_loss(state.discriminator, imgs, imgs_w, 0)
        d_loss.backward()
        state.opt_d.step()
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(spans):
            spans[k].append(ev[i].elapsed_time(ev[i + 1]))
    # the first two pay cuDNN's first calls; the augmenter draws differ a step
    return {k: float(np.median(v[2:])) for k, v in spans.items()}


def phase_train(dev, smi: str) -> dict:
    """videoseal_1.0 trained on the card through train.main: 8 steps at batch
    16 on synthetic images, one in-training eval (K2, 18 blocks a row of the
    subset grid), TensorBoard, a checkpoint; then a run resumed from it for
    2 more steps (and its eval). Then the card against the CPU on one image
    and one video step at full width, K2 at the eval's shapes against its
    plain version, and the step's parts timed."""
    import shutil
    import tempfile

    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.kernels import convnext_block as cb
    # the run's directory is temporary: its checkpoint (~0.4 GB with AdamW's
    # moments) is too large to keep among the script's outputs; the log and
    # the eval rows are copied to OUT_DIR/train
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    out = os.path.join(tmp.name, "run")
    # the timed steps run at PyTorch's defaults: TF32 in cuDNN's convolutions,
    # not in matmuls
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    log("[train] TF32: cudnn.allow_tf32=True, cuda.matmul.allow_tf32=False (PyTorch's "
        "defaults) for train.main; both off for the card-vs-CPU steps")
    common = ["--card", "videoseal_1.0", "--synthetic", "1", "--batch_size", "16",
              "--eval_freq", "1", "--tensorboard", "1", "--output_dir", out]
    blocks = sum(DEPTHS)
    rows = 4                      # the subset grid's image rows, one mask
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, logger, step_ms = train.main(common + ["--steps", str(TRAIN_STEPS)])
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    got = check_counts("train", {"K2": rows * blocks})
    ckpt = os.path.join(out, "checkpoint.npz")
    with np.load(ckpt) as data:
        saved_step = int(data["step"])
    if state.step != TRAIN_STEPS or saved_step != TRAIN_STEPS:
        raise AssertionError(f"train: state at step {state.step}, checkpoint {saved_step}")
    logged = [json.loads(ln) for ln in open(os.path.join(out, "log.txt"))]
    evals = [json.loads(ln) for ln in open(os.path.join(out, "eval.jsonl"))]
    if not logged or not all(math.isfinite(v) for r in logged for v in r.values()):
        raise AssertionError(f"train: a logged value is not finite: {logged}")
    if len(evals) != 1 or not all(math.isfinite(v) for k, v in evals[0].items()
                                  if k != "modality"):
        raise AssertionError(f"train: eval rows {evals}")
    tb = os.listdir(os.path.join(out, "tensorboard"))
    if not tb:
        raise AssertionError("train: no TensorBoard event file")
    # what moved: the generator, the discriminator, the BatchNorm statistics
    args = train.get_parser().parse_args(common + ["--steps", str(TRAIN_STEPS)])
    _, fresh, _ = train.build_trainer(args, dev)
    moved = {}
    for name, a, b in (("embedder", state.embedder, fresh.embedder),
                       ("extractor", state.extractor, fresh.extractor),
                       ("discriminator", state.discriminator, fresh.discriminator)):
        pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
        moved[name] = sum(not torch.equal(pa[k], pb[k]) for k in pa) / len(pa)
    ba, bb = dict(state.embedder.named_buffers()), dict(fresh.embedder.named_buffers())
    stats = [k for k in ba if k.endswith(("running_mean", "running_var"))]
    moved["bn_stats"] = sum(not torch.equal(ba[k], bb[k]) for k in stats) / len(stats)
    if min(moved.values()) < 0.5:
        raise AssertionError(f"train: share of tensors that changed {moved}")
    del fresh
    # resume for 2 more steps (and the eval at its epoch's end)
    reset_counts()
    state2, _, _ = train.main(common + ["--steps", "2", "--resume", ckpt])
    got_resume = check_counts("train resume", {"K2": rows * blocks})
    if state2.step != TRAIN_STEPS + 2:
        raise AssertionError(f"train: the resumed run ended at step {state2.step}")
    del state, state2
    torch.cuda.empty_cache()
    keep = os.path.join(OUT_DIR, "train")
    os.makedirs(keep, exist_ok=True)
    for f in ("log.txt", "eval.jsonl"):
        shutil.copy(os.path.join(out, f), keep)
    tmp.cleanup()

    timed_ms = step_ms[2:]
    med = float(np.median(timed_ms))
    log(f"[train] {smi} | videoseal_1.0 full width, batch 16 at 256x256, DEFAULT_AUGS: "
        f"{med:.2f} ms a step (CUDA events, median of steps 3-{TRAIN_STEPS}: "
        f"{[round(t, 2) for t in timed_ms]}; the first two {[round(t, 1) for t in step_ms[:2]]}), "
        f"{16e3 / med:.1f} images/s, peak memory {peak_gib:.2f} GiB; main() wall "
        f"{wall:.1f} s; K2 {got['K2']} launches in the in-training eval, {got_resume['K2']} in "
        f"the resumed run's; checkpoint at step {saved_step}, resumed to {TRAIN_STEPS + 2}; "
        f"tensors changed {moved}")

    # K2 at the in-training eval's shapes (8 float32 images at 256x256)
    worst = 0.0
    for i, (h, w, c) in enumerate(STAGES):
        p = cb.kernel_params(_random_block(c, 40 + i, dev, torch.float32))
        x = torch.randn((8, h, w, c), generator=torch.Generator(device=dev).manual_seed(i),
                        device=dev)
        a, ref = cb.convnext_block_fused(x, p).float(), cb.convnext_block_plain(x, p).float()
        err = (a - ref).abs()
        if not bool(torch.isfinite(a).all()) or bool((err > K2_ATOL + K2_RTOL * ref.abs()).any()):
            raise AssertionError(f"K2 disagrees with its plain version at 8x{h}x{w}x{c} f32")
        worst = max(worst, float(err.max()))
    log(f"[train] K2 at the eval's shapes (B=8, f32) against its plain version: max abs err "
        f"{worst:.3e}")
    split = _train_split(dev)
    log(f"[train] {smi} | one batch-16 step's parts (median of 4, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"; sum {sum(split.values()):.2f}")
    vs_cpu = _train_cases_card_vs_cpu(dev)
    return {"launches": {k: got[k] + got_resume[k] for k in got}, "step_ms": step_ms,
            "median_ms": med, "images_per_s": 16e3 / med, "peak_gib": peak_gib,
            "wall_s": wall, "moved": moved, "k2_eval_max_abs_err": worst, "split_ms": split,
            "card_vs_cpu": vs_cpu, "evals": evals[0], "log": logged}


# -- phase 18: data-parallel training and the rest of ROADMAP 1.8 -----------------------

# (modality, balanced, TF32 in cuDNN): with TF32 off, as phase 17 holds the
# card against the CPU; then the image cases at PyTorch's TF32 defaults
DIST_CASES = [("image", 0, False), ("image", 1, False), ("video", 0, False),
              ("video", 1, False), ("image", 0, True), ("image", 1, True)]


def _module_errors(got: dict, want: dict) -> dict:
    """Two steps' records compared as phase 17 compares the card with the
    CPU: logs relative, BatchNorm statistics absolute (and of each tensor's
    largest), gradients of their module's largest, updated parameters absolute; with
    the scale of the largest gradient."""
    scale = {m: max(float(g.abs().max()) for k, g in want["grads"].items() if k.startswith(m))
             for m in ("0.", "1.", "2.")}
    gerr = {k: float((got["grads"][k].float() - g.float()).abs().max()) / scale[k[:2]]
            for k, g in want["grads"].items()}
    return {"logs": max(abs(got["logs"][k] - v) / max(abs(v), 1e-6)
                        for k, v in want["logs"].items()),
            "grads": max(gerr.values()), "grads_at": max(gerr, key=gerr.get),
            "params": max(float((got["params"][k] - p).abs().max())
                          for k, p in want["params"].items()),
            "bn": max(float((got["bn"][k] - b).abs().max()) for k, b in want["bn"].items()),
            "bn_rel": max(float((got["bn"][k] - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                          for k, b in want["bn"].items()),
            "scale": max(scale.values())}


def _step_record(state, logs) -> dict:
    mods = (state.embedder, state.extractor, state.discriminator)
    named = [(f"{i}.{n}", p) for i, m in enumerate(mods) for n, p in m.named_parameters()]
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {k: p.grad.detach().clone() for k, p in named if p.grad is not None},
            "params": {k: p.detach().clone() for k, p in named},
            "bn": {n: b.detach().clone() for n, b in state.embedder.named_buffers()
                   if n.endswith(("running_mean", "running_var"))}}


def rank_dist_step(rank: int, dev_name: str, card_args: list, size: int) -> list:
    """On each of two ranks (a gloo group, both ranks on one device): for
    each DIST_CASES case, one SGD step at lr 1 on the rank's half of a
    global batch (16 images, or 2 clips of 16 frames) with DEFAULT_AUGS'
    draws from one generator seed. Rank 0 then runs one process's step on
    the whole batch from the same state and draws and returns the errors;
    rank 1 returns how far its parameters are from rank 0's."""
    import torch.distributed as dist

    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh()
    out = []
    for kind, balanced, tf32 in DIST_CASES:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32, False
        video = kind == "video"
        shape = (2, F_TRAIN_CLIP, size, size, 3) if video else (16, size, size, 3)
        imgs = torch.as_tensor(np.random.default_rng(31).uniform(0, 1, shape)
                               .astype(np.float32))
        args = train.get_parser().parse_args(card_args + [
            "--balanced", str(balanced), "--optimizer", "SGD,lr=1.0",
            "--optimizer_d", "SGD,lr=1.0"])
        rec = {}
        for where, m in (("ranks", mesh), ("one", None)):
            if where == "one" and rank != 0:
                break
            mods, state, _ = train.build_trainer(args, dev, m)
            step = make_train_step(mods, is_video=video)
            x = shard_batch(m, imgs) if m is not None else imgs
            t0 = time.perf_counter()
            _, logs = step(state, {"imgs": x.to(dev)}, torch.Generator().manual_seed(7))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            rec[where] = _step_record(state, logs)
            rec[where + "_s"] = time.perf_counter() - t0
            if where == "ranks":
                flat = torch.cat([p.reshape(-1) for p in rec["ranks"]["params"].values()])
                ref = flat.clone()
                dist.broadcast(ref, 0, group=mesh.group)
                rec["rank_gap"] = float((flat - ref).abs().max())
            del mods, state
        if rank == 0:
            out.append({"case": f"{kind}, balanced {balanced}, TF32 {'on' if tf32 else 'off'}",
                        "rank_gap": rec["rank_gap"],
                        "ranks_s": rec["ranks_s"], "one_s": rec["one_s"],
                        **_module_errors(rec["ranks"], rec["one"])})
        else:
            out.append({"rank_gap": rec["rank_gap"]})
        del rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def state_digest(state) -> str:
    """sha256 over a TrainState: every module tensor, both optimizers'
    states and param groups, the step and scaling_w."""
    import hashlib
    h = hashlib.sha256()
    for name in ("embedder", "extractor", "discriminator"):
        for k, v in sorted(getattr(state, name).state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    for name in ("opt_g", "opt_d"):
        sd = getattr(state, name).state_dict()
        h.update(json.dumps(sd["param_groups"], sort_keys=True).encode())
        for i in sorted(sd["state"]):
            for k, v in sorted(sd["state"][i].items()):
                h.update(f"{i}.{k}".encode())
                h.update(v.detach().cpu().contiguous().numpy().tobytes())
    h.update(f"{state.step} {state.scaling_w!r}".encode())
    return h.hexdigest()


def train_child(argv: list, out_json: str, resume_dir: str | None = None) -> None:
    """A rank of `train.main(argv)` (run as a subprocess with the torchrun
    environment): its step times, peak memory, the kernels it launched and
    the digest of its final state to `out_json`. With resume_dir, first the
    digest of a fresh state restored from that sharded checkpoint."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    args = train.get_parser().parse_args(argv)
    dev = torch.device("cpu" if args.device == "cpu" else
                       f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()
    res = {}
    if resume_dir:
        _, fresh, _ = train.build_trainer(args, dev)
        res["loaded_step"] = ckpt_io.load_train_state_sharded(resume_dir, fresh)
        res["loaded_digest"] = state_digest(fresh)
        del fresh
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, _, step_ms = train.main(argv)
    res.update(wall_s=time.perf_counter() - t0, step=state.step, step_ms=step_ms,
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if dev.type == "cuda" else float("nan")),
               launches=read_counts(), digest=state_digest(state))
    with open(out_json, "w") as f:
        json.dump(res, f)


def _run_ranks(world: int, argv: list, out_dir: str, tag: str,
               resume_dir: str | None = None, timeout: float = 600) -> list:
    """`train_child` on `world` subprocesses with torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL, one card
    a rank. Returns each rank's record; a failed rank fails the run."""
    from videoseal_tpu_torch.parallel.launch import free_port
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        out_json = os.path.join(out_dir, f"{tag}_rank{r}.json")
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as cs; "
                f"cs.train_child({argv!r}, {out_json!r}, {resume_dir!r})")
        log_f = open(os.path.join(out_dir, f"{tag}_rank{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                       stdout=log_f, stderr=subprocess.STDOUT), log_f, out_json))
    recs = []
    try:
        for p, log_f, out_json in procs:
            rc = p.wait(timeout=timeout)
            log_f.close()
            if rc != 0:
                with open(log_f.name) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(f"{tag}: rank exited with {rc}:\n{tail}")
            with open(out_json) as f:
                recs.append(json.load(f))
    finally:
        for p, log_f, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log_f.close()
    return recs


def _write_pngs(d: str, n: int, size: int, seed: int) -> str:
    import cv2

    from videoseal_tpu_torch.data.datasets import SyntheticImages
    os.makedirs(d, exist_ok=True)
    ds = SyntheticImages(n, img_size=size, seed=seed)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"{i:03d}.png"),
                    np.clip(ds[i][0] * 255.0 + 0.5, 0, 255).astype(np.uint8)[..., ::-1])
    return d


def _write_clips(d: str, n: int, frames: int, size: int, seed: int) -> str:
    """n mp4v clips of `frames` frames: a synthetic image drifting sideways."""
    import cv2

    from videoseal_tpu_torch.data.datasets import SyntheticImages
    os.makedirs(d, exist_ok=True)
    ds = SyntheticImages(n, img_size=size, seed=seed)
    for i in range(n):
        path = os.path.join(d, f"clip{i}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (size, size))
        if not vw.isOpened():
            raise AssertionError(f"cv2 cannot write mp4v to {path}")
        base = np.clip(ds[i][0] * 255.0 + 0.5, 0, 255).astype(np.uint8)[..., ::-1]
        for t in range(frames):
            vw.write(np.ascontiguousarray(np.roll(base, 3 * t, axis=1)))
        vw.release()
    return d


def _opt_card_vs_cpu(dev) -> dict:
    """lamb and adafactor with phase 17's card-against-CPU case: one image
    step (batch 2, balanced 0, the dummy augmenter, injected messages, TF32
    off) at full width on the card and on the CPU from the same weights;
    the losses and the gradients held as phase 17 holds them. The update
    is each optimizer's function of those gradients, so it is held apart:
    the optimizer on the card, given the CPU's gradients and starting
    parameters, against the CPU's update; the whole step's update gap is
    printed (it carries the gradients' gap through lamb's and adafactor's
    per-element scaling)."""
    import dataclasses

    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.augmentation.augmenter import get_dummy_augmenter
    from videoseal_tpu_torch.parallel.trainer import create_train_state, make_train_step
    from videoseal_tpu_torch.utils.optim import build_optimizer
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, False
    rng = np.random.default_rng(23)
    imgs = rng.uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    msgs = torch.as_tensor(rng.integers(0, 2, (2, 256)))
    out = {}
    for spec in ("lamb,lr=1e-3", "adafactor,lr=1e-3"):
        args = train.get_parser().parse_args([])
        res = []
        for where in (dev, torch.device("cpu")):
            mods, _, _ = train.build_trainer(args, where)
            mods = dataclasses.replace(mods, augmenter=get_dummy_augmenter())
            state = create_train_state(mods, spec, spec)
            named = [(f"{i}.{n}", p) for i, m in enumerate(
                (state.embedder, state.extractor, state.discriminator))
                for n, p in m.named_parameters()]
            before = {k: p.detach().cpu().clone() for k, p in named}
            _, logs = make_train_step(mods)(state, {"imgs": torch.as_tensor(imgs, device=where)},
                                            torch.Generator().manual_seed(0), msgs=msgs)
            res.append({"logs": {k: float(v) for k, v in logs.items()}, "before": before,
                        "grads": {k: p.grad.detach().cpu() for k, p in named},
                        "after": {k: p.detach().cpu() for k, p in named}})
            del mods, state
        card, cpu = res
        log_err = max(abs(card["logs"][k] - v) / max(abs(v), 1e-6) for k, v in cpu["logs"].items())
        scale = {m: max(float(g.abs().max()) for k, g in cpu["grads"].items() if k.startswith(m))
                 for m in ("0.", "1.", "2.")}
        grad_err = max(float((card["grads"][k] - g).abs().max()) / scale[k[:2]]
                       for k, g in cpu["grads"].items())
        step_gap = max(float(((card["after"][k] - card["before"][k])
                              - (a - cpu["before"][k])).abs().max())
                       / max(float((a - cpu["before"][k]).abs().max()), 1e-30)
                       for k, a in cpu["after"].items())
        # the optimizer alone on the card: the CPU's gradients and start
        params = [torch.nn.Parameter(cpu["before"][k].to(dev)) for k in cpu["after"]]
        opt = build_optimizer(spec, params)
        for p, k in zip(params, cpu["after"]):
            p.grad = cpu["grads"][k].to(dev)
        opt.step()
        alone = max(float((p.detach().cpu() - cpu["after"][k]).abs().max())
                    for p, k in zip(params, cpu["after"]))
        out[spec] = {"logs": log_err, "grads": grad_err, "opt_alone_abs": alone,
                     "step_update_gap": step_gap}
        log(f"[dist] {spec.split(',')[0]}, card vs CPU: losses rel {log_err:.2e}, grads (of the "
            f"module's largest) {grad_err:.2e}; the optimizer alone on the CPU's gradients: "
            f"params abs {alone:.2e}; the whole step's update, card against CPU, at most "
            f"{step_gap:.2e} of a tensor's largest update")
        if log_err > TRAIN_LOG_RTOL or grad_err > TRAIN_GRAD_RTOL or alone > OPT_ALONE_ATOL:
            raise AssertionError(f"{spec}, card against CPU: {out[spec]}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def phase_dist(dev, smi: str, phase17: dict) -> dict:
    """Data-parallel training and the rest of ROADMAP 1.8 at videoseal_1.0's
    full width: two gloo ranks on the card against one process;
    train.main --distributed 1 over NCCL (world size 1, and 2 where a
    second card exists) with image and video eval rows, a sharded
    checkpoint and its exact resume; --video_dataset; lamb and adafactor
    against the CPU; evals.full --dataset and tools.eval_checkpoint."""
    import shutil
    import tempfile

    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.evals import full
    from videoseal_tpu_torch.kernels import convnext_block as cb
    from videoseal_tpu_torch.parallel.launch import run_local
    from videoseal_tpu_torch.tools import eval_checkpoint
    launches = {k: 0 for k in kernel_wrappers()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # two ranks sharing the card over gloo, against one process on all 16
    t0 = time.perf_counter()
    recs = run_local(rank_dist_step, 2, "cuda:0", ["--card", "videoseal_1.0"], 256,
                     backend="gloo", timeout=900)
    pair_s = time.perf_counter() - t0
    worst = {"logs": 0.0, "grads": 0.0, "params": 0.0, "bn": 0.0, "bn_rel": 0.0,
             "rank_gap": 0.0}      # over the TF32-off cases
    for r0, r1 in zip(*recs):
        gap = max(r0["rank_gap"], r1["rank_gap"])
        log(f"[dist] two gloo ranks on one card vs one process, {r0['case']}: losses/scales "
            f"rel {r0['logs']:.2e}, BN stats abs {r0['bn']:.2e} (of each tensor's largest "
            f"{r0['bn_rel']:.2e}), grads (of the module's "
            f"largest) {r0['grads']:.2e} at {r0['grads_at']}, updated params abs "
            f"{r0['params']:.2e} (largest gradient {r0['scale']:.3g}), rank 1 from rank 0 "
            f"{gap:.2e}; step {r0['ranks_s'] * 1e3:.0f} ms on the ranks, "
            f"{r0['one_s'] * 1e3:.0f} ms one process (first calls)")
        strict = r0["case"].endswith("TF32 off")
        if (gap != 0.0 or r0["params"] > TRAIN_GRAD_RTOL * r0["scale"] + TRAIN_PARAM_ATOL
                or strict and (r0["logs"] > DIST_LOG_RTOL or r0["bn_rel"] > DIST_BN_RTOL)):
            raise AssertionError(f"two ranks against one process, {r0['case']}: {r0}")
        for k in worst if strict else ():
            worst[k] = max(worst[k], gap if k == "rank_gap" else r0[k])
    log(f"[dist] the two-rank check took {pair_s:.1f} s (two spawned ranks, "
        f"{len(DIST_CASES)} cases)")

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    pngs = _write_pngs(os.path.join(tmp.name, "pngs"), 64, 256, seed=3)
    clips = _write_clips(os.path.join(tmp.name, "clips"), 2, 40, 256, seed=4)
    keep = os.path.join(OUT_DIR, "dist")
    os.makedirs(keep, exist_ok=True)
    # NCCL at world size 1 through torchrun's environment: 8 image steps (the
    # PNG folder: 4 batches an epoch), the eval after epoch 2 with image and
    # video rows (--prop_img_vid 0 trains on images only), a sharded checkpoint
    run = os.path.join(tmp.name, "nccl1")
    common = ["--card", "videoseal_1.0", "--distributed", "1", "--image_dataset", pngs,
              "--video_dataset", clips, "--prop_img_vid", "0", "--batch_size", "16",
              "--batch_size_video", "2", "--frames_per_clip", str(F_TRAIN_CLIP), "--eval_freq", "2",
              "--ckpt_format", "orbax", "--output_dir", run]
    first = _run_ranks(1, common + ["--steps", str(TRAIN_STEPS)], keep, "nccl1")[0]
    resumed = _run_ranks(1, common + ["--steps", "2", "--resume", os.path.join(run, "ckpts")],
                         keep, "nccl1_resume", resume_dir=os.path.join(run, "ckpts"))[0]
    add(first["launches"])
    add(resumed["launches"])
    exact = resumed["loaded_digest"] == first["digest"]
    evals = [json.loads(ln) for ln in open(os.path.join(run, "eval.jsonl"))]
    for f in ("log.txt", "eval.jsonl"):
        shutil.copy(os.path.join(run, f), os.path.join(keep, f"nccl1_{f}"))
    if (first["step"] != TRAIN_STEPS or resumed["loaded_step"] != TRAIN_STEPS
            or resumed["step"] != TRAIN_STEPS + 2 or not exact):
        raise AssertionError(f"NCCL run: {first['step']}, resumed from "
                             f"{resumed['loaded_step']} to {resumed['step']}, exact {exact}")
    modalities = [r["modality"] for r in evals]
    if modalities != ["img", "vid"] or not all(
            math.isfinite(v) for r in evals for k, v in r.items() if k != "modality"):
        raise AssertionError(f"NCCL run's eval rows: {evals}")
    want_k2 = 2 * 4 * sum(DEPTHS)          # 4 subset rows a modality, one call a row
    if first["launches"]["K2"] != want_k2 or resumed["launches"]["K2"] != 0:
        raise AssertionError(f"NCCL run: K2 {first['launches']['K2']} (expected {want_k2}), "
                             f"resumed {resumed['launches']['K2']}")
    timed_ms = first["step_ms"][2:]
    q = np.percentile(timed_ms, [0, 25, 50, 75, 100])
    log(f"[dist] {smi} | train.main --distributed 1, NCCL at world size 1, videoseal_1.0, "
        f"batch 16 at 256x256: {q[2]:.2f} ms a step (CUDA events, median of steps "
        f"3-{TRAIN_STEPS}; min {q[0]:.2f}, quartiles {q[1]:.2f}-{q[3]:.2f}, max {q[4]:.2f}; "
        f"steps {[round(t, 2) for t in first['step_ms']]}) beside phase 17's "
        f"{phase17['median_ms']:.2f} ms without a process group ({q[2] - phase17['median_ms']:+.2f} "
        f"ms: the BatchNorm reductions, the gradient and log all-reduces); peak memory "
        f"{first['peak_gib']:.2f} GiB (phase 17: {phase17['peak_gib']:.2f}); the eval's K2 "
        f"{first['launches']['K2']} (image and video rows); sharded checkpoint at step "
        f"{resumed['loaded_step']} restored bit for bit: {exact}; resumed to {resumed['step']}")
    if torch.cuda.device_count() >= 2:
        two = _run_ranks(2, common[:-1] + [os.path.join(tmp.name, "nccl2"), "--steps",
                                           str(TRAIN_STEPS)], keep, "nccl2")
        for r in two:
            add(r["launches"])
        if len({r["digest"] for r in two}) != 1:
            raise AssertionError("NCCL at world size 2: the ranks' states differ")
        med2 = float(np.median(two[0]["step_ms"][2:]))
        log(f"[dist] {smi} | NCCL at world size 2 (two cards, batch 16 = 8 a rank): "
            f"{med2:.2f} ms a step (median of steps 3-{TRAIN_STEPS}), peak "
            f"{max(r['peak_gib'] for r in two):.2f} GiB a card; the ranks' states equal")
    else:
        log(f"[dist] NCCL at world size 2 not run: torch.cuda.device_count() is "
            f"{torch.cuda.device_count()} (it needs two cards)")

    # --video_dataset: 4 video steps (one 16-frame clip each) and the video eval
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    vid_run = os.path.join(tmp.name, "video")
    reset_counts()
    t0 = time.perf_counter()
    vstate, _, vms = train.main(["--card", "videoseal_1.0", "--video_dataset", clips,
                                 "--frames_per_clip", str(F_TRAIN_CLIP), "--batch_size_video",
                                 "1", "--steps", "4", "--eval_freq", "1", "--output_dir",
                                 vid_run])
    vwall = time.perf_counter() - t0
    got_vid = check_counts("video train", {"K2": 4 * sum(DEPTHS)})
    add(got_vid)
    vrows = [json.loads(ln) for ln in open(os.path.join(vid_run, "eval.jsonl"))]
    if vstate.step != 4 or [r["modality"] for r in vrows] != ["vid"]:
        raise AssertionError(f"video run: step {vstate.step}, eval rows {vrows}")
    del vstate
    torch.cuda.empty_cache()
    log(f"[dist] {smi} | --video_dataset (2 mp4v clips, 16-frame clips at 256x256): 4 steps "
        f"{[round(t, 1) for t in vms]} ms, main() wall {vwall:.1f} s; the eval's video rows "
        f"{ {k: round(v, 4) for k, v in vrows[0].items() if k.startswith('vid_')} }; K2 "
        f"{got_vid['K2']}")
    # K2 at the video rows' shapes: 16 frames a launch, f32
    k2_err = 0.0
    for i, (h, w, c) in enumerate(STAGES):
        p = cb.kernel_params(_random_block(c, 60 + i, dev, torch.float32))
        x = torch.randn((F_TRAIN_CLIP, h, w, c),
                        generator=torch.Generator(device=dev).manual_seed(i), device=dev)
        a, ref = cb.convnext_block_fused(x, p).float(), cb.convnext_block_plain(x, p).float()
        err = (a - ref).abs()
        if not bool(torch.isfinite(a).all()) or bool((err > K2_ATOL + K2_RTOL * ref.abs()).any()):
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"{F_TRAIN_CLIP}x{h}x{w}x{c} f32")
        k2_err = max(k2_err, float(err.max()))
    log(f"[dist] K2 at the video rows' shapes ({F_TRAIN_CLIP} frames, f32) against its plain "
        f"version: max abs err {k2_err:.3e}")

    # lamb and adafactor on the card against the CPU
    opts = _opt_card_vs_cpu(dev)

    # evals.full --dataset over 4 PNGs, tools.eval_checkpoint on the video run's checkpoint
    few = _write_pngs(os.path.join(tmp.name, "four"), 4, 256, seed=5)
    reset_counts()
    rows = full.main(["--card", "videoseal_1.0", "--dataset", few, "--device", "cuda",
                      "--bdrate", "0", "--output_dir", os.path.join(tmp.name, "full")])
    n_grid = len(rows)
    # one NHWC embed of the sample (K4's blend mode), a detect a row
    got_full = check_counts("evals.full --dataset", {"K4": 1, "K2": n_grid * sum(DEPTHS)})
    add(got_full)
    reset_counts()
    erows = eval_checkpoint.main(["--checkpoint", os.path.join(vid_run, "checkpoint.npz"),
                                  "--card", "videoseal_1.0", "--nbits", "256", "--img_size",
                                  "256", "--scaling_w", "0.2", "--samples", "1",
                                  "--sample_size", "256", "--device", "cuda", "--out_csv",
                                  os.path.join(keep, "eval_checkpoint.csv")])
    got_ec = check_counts("eval_checkpoint", {"K4": 1, "K2": len(erows) * sum(DEPTHS)})
    add(got_ec)
    bad = [r for r in rows + erows if not math.isfinite(r["bit_acc"])]
    if bad or len(rows) != len(erows):
        raise AssertionError(f"evals.full --dataset {len(rows)} rows, eval_checkpoint "
                             f"{len(erows)}; not finite: {bad[:2]}")
    log(f"[dist] evals.full --dataset (4 PNGs at 256x256): {len(rows)} rows, identity "
        f"bit_acc {rows[0]['bit_acc']:.4f}, psnr {rows[0]['psnr']:.2f}; "
        f"tools.eval_checkpoint on the video run's checkpoint: {len(erows)} rows, identity "
        f"bit_acc {erows[0]['bit_acc']:.4f}")
    tmp.cleanup()
    return {"launches": launches, "two_ranks": recs[0], "two_ranks_worst": worst,
            "nccl1": {k: first[k] for k in ("step_ms", "peak_gib", "launches", "wall_s")},
            "nccl1_median_ms": float(q[2]), "nccl1_quartiles_ms": [float(v) for v in q],
            "resume_exact": exact, "video": {"step_ms": vms, "k2": got_vid["K2"],
                                             "eval": vrows[0]},
            "k2_video_max_abs_err": k2_err, "optimizers": opts}


class _Capture:
    """Wraps the kernel wrappers where the pipeline calls them (K1, K4 and K6
    in models/videoseal.py, K2 and K3 in kernels/convnext_fused.py, and the
    (module, name, kernel) of `extra`) for one run and keeps each wrapper's
    first call per input shapes and keyword settings, so that its kernel can
    be held against its plain version on the inputs the path gave it, after
    the run's counts are read."""

    def __init__(self, extra: tuple = ()):
        from videoseal_tpu_torch.kernels import convnext_fused as cf
        from videoseal_tpu_torch.models import videoseal as mv
        self.sites = [(cf, "convnext_block_fused", "K2"), (cf, "convnext_blocks_fused", "K3"),
                      (mv, "fused_jnd_blend_up", "K4"), (mv, "fused_jnd_blend_planar", "K1"),
                      (mv, "fused_jnd_blend", "K6"), *extra]
        self.calls = {}

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self.sites]
        for (mod, name, k), (_, _, fn) in zip(self.sites, self.saved):
            def wrap(*args, fn=fn, k=k, **kw):
                key = (k, tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)),
                       tuple(sorted((n, v) for n, v in kw.items()
                                    if not isinstance(v, torch.Tensor))))
                self.calls.setdefault(key, (fn, args, kw))
                return fn(*args, **kw)
            setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def hold_captured(tag: str, calls: dict) -> dict:
    """Each captured launch against its plain version: K2, K3 and K8 at
    K2's tolerance, K1's and K4's u8 frames at K1's rule, K5 within
    DELTA_RTOL of the plain delta's largest, K6 at BLEND_ATOL."""
    from videoseal_tpu_torch.kernels import convnext_block as cb
    from videoseal_tpu_torch.kernels import fused_blend as fb
    from videoseal_tpu_torch.kernels import fused_planar as fp
    from videoseal_tpu_torch.kernels.convnext_probe import convnext_probe_plain
    plain = {"K2": cb.convnext_block_plain, "K3": cb.convnext_blocks_plain,
             "K4": fb.fused_jnd_blend_up_plain, "K1": fp.fused_jnd_blend_planar_plain,
             "K5": fb.fused_jnd_delta_plain, "K6": fb.fused_jnd_blend_plain,
             "K8": convnext_probe_plain}
    worst = {}
    for (k, shapes, _), (fn, args, kw) in sorted(calls.items(), key=lambda c: str(c[0])):
        a, b = fn(*args, **kw), plain[k](*args, **kw)
        torch.cuda.synchronize()
        if k == "K1" and isinstance(a, tuple):
            (a, da), (b, db) = a, b
            det = float((da - db).abs().max())
            if det > K1_DET_ATOL:
                raise AssertionError(f"{tag}: K1's detect output at {shapes} disagrees "
                                     f"with its plain version ({det:.3e})")
        if a.dtype == torch.uint8:
            d = (a.int() - b.int()).abs()
            err, share = float(d.max()), float((d > 0).float().mean())
            log(f"[{tag}] {k} at {shapes}: u8 max diff {int(err)}, share differing {share:.2e}")
            if err > K1_U8_MAX or share > K1_U8_SHARE:
                raise AssertionError(f"{tag}: {k} at {shapes} disagrees with its plain version")
        else:
            a, b = a.float(), b.float()
            e = (a - b).abs()
            err = float(e.max())
            log(f"[{tag}] {k} at {shapes}: max abs err {err:.3e}")
            tol = (BLEND_ATOL if k == "K6" else DELTA_RTOL * float(b.abs().max())
                   if k == "K5" else K2_ATOL + K2_RTOL * b.abs())
            if not bool(torch.isfinite(a).all()) or bool((e > tol).any()):
                raise AssertionError(f"{tag}: {k} at {shapes} disagrees with its plain version")
        worst[k] = max(worst.get(k, 0.0), err)
    return worst


def hold_padded_chunk(tag: str, model, f40: torch.Tensor, p40: torch.Tensor) -> dict:
    """The last chunk of detect over F_PRESET_PAD frames (p40: 8 frames),
    which a model that mixes frames runs with 24 copies of frame 0 (JAX's
    pad) and a 2D model alone: its logits equal the extractor's on that
    batch. Returns mixes_frames and how far the pad moves the logits."""
    from videoseal_tpu_torch.modules.common import mixes_frames
    from videoseal_tpu_torch.ops.resize import resize_bilinear
    s = model.cfg.img_size
    x40 = resize_bilinear(f40, s, s, precision=model.cfg.resize_precision)
    if not f40.is_floating_point():
        x40 = x40 * (1.0 / 255.0)
    padded = torch.cat([x40[32:], x40[:1].expand(24, -1, -1, -1)])
    dt = next(model.extractor.parameters()).dtype
    with torch.no_grad():
        direct = {n: model.extractor(b.to(dt)).float()[:8]
                  for n, b in (("padded", padded), ("alone", x40[32:]))}
    pad = mixes_frames(model.extractor)
    same = torch.equal(direct["padded" if pad else "alone"], p40[32:])
    moves = float((direct["padded"] - direct["alone"]).abs().max())
    log(f"[{tag}] F={F_PRESET_PAD}, frames mixed {pad}: the last 8 frames' logits equal the "
        f"extractor's on them {'padded with frame 0' if pad else 'alone'}: {same}; the pad "
        f"moves them by {moves:.3e}")
    if not same:
        raise AssertionError(f"{tag}: the last chunk is not run as JAX runs it")
    return {"mixes_frames": pad, "pad_moves": moves}


def _preset_card(embedder: str, extractor: str) -> tuple[dict, dict]:
    """(card, training args): videoseal_1.0's settings with the two presets."""
    import copy
    from videoseal_tpu_torch import presets
    from videoseal_tpu_torch.utils.cfg import load_card
    card = load_card("videoseal_1.0")
    args = dict(card["args"], embedder_model=embedder, extractor_model=extractor)
    card["embedder"] = {"model": embedder, "params": copy.deepcopy(presets.EMBEDDER[embedder])}
    card["extractor"] = {"model": extractor,
                         "params": copy.deepcopy(presets.EXTRACTOR[extractor])}
    return card, args


def _load_through_npz(dev, tmp: str, embedder: str, extractor: str):
    """A model of the presets at random init (seed 0), written with
    save_npz and loaded back by path on the card, its weights the same."""
    import videoseal_tpu_torch as vt
    card, args = _preset_card(embedder, extractor)
    src = vt.VideoSeal.from_card(card, device=dev, seed=0)
    path = os.path.join(tmp, f"{embedder}-{extractor}.npz")
    vt.save_npz(path, src, args=args)
    model = vt.load(path, device=dev)
    same = all(torch.equal(model.state_dict()[k], v) for k, v in src.state_dict().items())
    if not same or model.card["extractor"]["model"] != extractor:
        raise AssertionError(f"{path} did not load back as the model it holds")
    del src
    return model.with_dtype("bfloat16"), path


def _card_vs_cpu(tag: str, model, path: str, frames: torch.Tensor, embed: bool) -> dict:
    """The card against the CPU on 8 frames, both bf16: the logits (or
    pixelwise maps, elementwise) within PRESET_LOGIT_ATOL, the bit decisions
    equal but where the CPU logit lies within it of 0; with `embed` the u8
    embed output as the slice holds it. Where a limit does not hold, the
    CPU's own bf16 output against its float32 one (bf16's noise floor on
    these frames) times SLICE_NOISE_FACTOR bounds it instead."""
    import videoseal_tpu_torch as vt
    cpu32 = vt.load(path, device="cpu")
    cpu = cpu_route(cpu32.with_dtype("bfloat16"), model)
    msgs = model.get_random_msg(1)
    rec = {}
    if embed:
        g = model.embed(frames, msgs=msgs, is_video=True)["imgs_w"]
        c = cpu.embed(frames.cpu(), msgs=msgs.cpu(), is_video=True)["imgs_w"]
        c32 = cpu32.embed(frames.cpu(), msgs=msgs.cpu(), is_video=True)["imgs_w"]
        d = (g.cpu().int() - c.int()).abs()
        rec["u8_max"], rec["u8_share"] = int(d.max()), float((d > 0).float().mean())
        rec["u8_floor"] = float((c != c32).float().mean())
        share_max = max(SLICE_U8_SHARE, SLICE_NOISE_FACTOR * rec["u8_floor"])
        log(f"[{tag}] embed, 8 frames, card vs CPU: u8 max diff {rec['u8_max']}, share "
            f"differing {rec['u8_share']:.2e} (the CPU's bf16 against its float32: "
            f"{rec['u8_floor']:.2e}; limit {share_max:.2e})")
        if rec["u8_max"] > SLICE_U8_MAX or rec["u8_share"] > share_max:
            raise AssertionError(f"{tag}: card and CPU disagree on the embed")
    gp = model.detect(frames)["preds"].cpu()
    cp = cpu.detect(frames.cpu())["preds"].float()
    floor = float((cp - cpu32.detect(frames.cpu())["preds"]).abs().max())
    atol = max(PRESET_LOGIT_ATOL, SLICE_NOISE_FACTOR * floor)
    diff = float((gp - cp).abs().max())
    sure = cp[..., 1:].abs() > atol
    flips = int(((gp[..., 1:] > 0) != (cp[..., 1:] > 0))[sure].sum())
    rec.update(logit_max=diff, logit_floor=floor, logit_atol=atol, flips=flips,
               shape=list(gp.shape))
    log(f"[{tag}] detect, 8 frames, card vs CPU: preds {tuple(gp.shape)}, max abs diff "
        f"{diff:.3e} (tolerance {atol:.3e}; the CPU's bf16 against its float32: {floor:.3e}), "
        f"bit decisions differing where the CPU logit is beyond it: {flips}")
    if diff > atol or flips:
        raise AssertionError(f"{tag}: card and CPU disagree on detect")
    del cpu, cpu32
    return rec


def phase_presets(dev, smi: str) -> dict:
    """The presets the cards do not use, at full width in bf16 with
    videoseal_1.0's settings, each built through a .npz loaded by path:
    (a) unet_small2_yuv_quant_2p1d with convnext_tiny_temporal and (b)
    videoseal_1.0's embedder with convnext_tiny_pw, NHWC and (a) planar
    over 128 u8 1080p frames, 40 frames (the padded last chunk), the
    grouped route, card against CPU, each kernel launch against its plain
    version; train.main with the pixelwise extractor and the 2p1d embedder;
    sam_small_pw and the hidden presets, which run no kernel."""
    import shutil
    import tempfile

    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch.kernels.convnext_fused import block_groups, convnext_apply_fused
    from videoseal_tpu_torch.models.videoseal import _chunked_apply

    tmp = tempfile.mkdtemp(prefix="chip_smoke_presets_")
    rec = {"launches": {k: 0 for k in kernel_wrappers()}}

    def add(got):
        rec["launches"] = {k: rec["launches"][k] + got[k] for k in got}

    g = torch.Generator(device=dev).manual_seed(19)
    frames = torch.randint(0, 256, (F_SLICE, H, W, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    chunks = math.ceil(F_SLICE / 32)
    try:
        for tag, emb, ext in (("temporal", "unet_small2_yuv_quant_2p1d", "convnext_tiny_temporal"),
                              ("pixelwise", "unet_small2_yuv_quant", "convnext_tiny_pw")):
            model, path = _load_through_npz(dev, tmp, emb, ext)
            blocks = sum(len(st) for st in model.extractor.convnext.stages)   # 18
            msgs = model.get_random_msg(1)
            pw = model.extractor_spec.pixelwise
            with _Capture() as cap:
                reset_counts()
                vid = model.embed(frames, msgs=msgs, is_video=True)
                preds = model.detect(vid["imgs_w"])["preds"]
                bits = model.extract_message(vid["imgs_w"])
                add(check_counts(f"presets {tag} nhwc", {"K4": 1, "K2": 2 * blocks * chunks}))
                if tag == "temporal":
                    planar = vt.pack_planar(frames)
                    reset_counts()
                    pout = model.embed_detect_planar(planar, H, W, msgs=msgs,
                                                     lowres_attenuation=True, fused_detect=True)
                    add(check_counts(f"presets {tag} planar", {"K1": 1, "K2": blocks * chunks}))
            s = model.cfg.img_size
            want = (F_SLICE, s // 2, s // 2, 257) if pw else (F_SLICE, 257)
            wm = vid["imgs_w"]
            log(f"[presets] {tag}: imgs_w {tuple(wm.shape)} {wm.dtype}, preds "
                f"{tuple(preds.shape)}, bits {tuple(bits.shape)}")
            if (tuple(wm.shape) != (F_SLICE, H, W, 3) or wm.dtype != torch.uint8
                    or torch.equal(wm, frames) or tuple(preds.shape) != want
                    or not bool(torch.isfinite(preds).all()) or tuple(bits.shape) != (1, 256)):
                raise AssertionError(f"presets {tag}: output of the wrong shape, not finite or "
                                     "unchanged")
            if tag == "temporal" and (tuple(pout["preds"].shape) != (F_SLICE, 257)
                                      or not bool(torch.isfinite(pout["preds"]).all())):
                raise AssertionError("presets temporal: planar preds wrong or not finite")
            # the last chunk of 40 frames: 8 frames, which a model that mixes
            # frames runs with 24 copies of frame 0 (JAX's pad) and a 2D model
            # alone, so they equal a direct call on that batch
            f40 = wm[:F_PRESET_PAD]
            reset_counts()
            p40 = model.detect(f40)["preds"]
            add(check_counts(f"presets {tag} F={F_PRESET_PAD}", {"K2": 2 * blocks}))
            r = {"worst": hold_captured(f"presets {tag}", cap.calls),
                 **hold_padded_chunk(f"presets {tag}", model, f40, p40)}
            # the grouped route over one chunk: K3 5, K2 16, equal to the single route
            from videoseal_tpu_torch.ops.resize import resize_bilinear
            x32 = (resize_bilinear(f40[:32], s, s, precision=model.cfg.resize_precision)
                   * (1.0 / 255.0)).to(torch.bfloat16)
            ext_mod = model.extractor
            groups = [k for st in ext_mod.convnext.stages for k in block_groups(len(st), 4)]
            with _Capture() as gcap:
                reset_counts()
                with torch.no_grad():
                    grouped = ext_mod.pixel_decoder(convnext_apply_fused(
                        ext_mod.convnext, x32 * 2 - 1, max_block_group=4)).float()
                add(check_counts(f"presets {tag} grouped", {"K3": sum(k > 1 for k in groups),
                                                          "K2": groups.count(1)}))
            with torch.no_grad():
                single = ext_mod(x32).float()
            r["grouped_identical"] = torch.equal(grouped, single)
            log(f"[presets] {tag}: grouped route identical to the single route: "
                f"{r['grouped_identical']}")
            if not r["grouped_identical"]:
                raise AssertionError(f"presets {tag}: grouped and single routes differ")
            gw = hold_captured(f"presets {tag} grouped", gcap.calls)
            r["worst"].update({k: max(v, r["worst"].get(k, 0.0)) for k, v in gw.items()})
            r["cpu_vs_card"] = _card_vs_cpu(f"presets {tag}", model, path, wm[:8],
                                            embed=tag == "temporal")
            r["nhwc_ms"] = cuda_ms(lambda: model.detect(
                model.embed(frames, msgs=msgs, is_video=True)["imgs_w"]))
            r["detect40_ms"] = cuda_ms(lambda: model.detect(f40))
            line = (f"[presets] {tag}: NHWC embed+detect of {F_SLICE} u8 1080p frames "
                    f"{r['nhwc_ms']:.2f} ms, detect of {F_PRESET_PAD} {r['detect40_ms']:.2f} ms")
            if tag == "temporal":
                r["planar_ms"] = cuda_ms(lambda: model.embed_detect_planar(
                    planar, H, W, msgs=msgs, lowres_attenuation=True, fused_detect=True))
                line += f", planar scored {r['planar_ms']:.2f} ms"
                del planar, pout
            log(f"{line} ({smi})")
            rec[tag] = r
            del model, vid, preds, wm, f40
            torch.cuda.empty_cache()

        # models without a kernel on their path: every count stays 0
        for tag, emb, ext in (("sam_small_pw", "unet_small2_yuv_quant", "sam_small_pw"),
                              ("hidden", "hidden", "hidden")):
            model, _ = _load_through_npz(dev, tmp, emb, ext)
            eight = frames[:8]
            reset_counts()
            if tag == "hidden":
                out = model.embed(eight, is_video=False)["imgs_w"]
                preds = model.detect(out)["preds"]
                want = (8, 257)
            else:
                out = eight
                preds = model.detect(eight)["preds"]
                want = (8, model.cfg.img_size, model.cfg.img_size, 257)
            add(check_counts(f"presets {tag}", {}))
            ms = cuda_ms(lambda: model.detect(out))
            log(f"[presets] {tag}: preds {tuple(preds.shape)}, detect of 8 frames {ms:.2f} ms "
                f"({smi})")
            if (tuple(preds.shape) != want or not bool(torch.isfinite(preds).all())
                    or (tag == "hidden" and (out.dtype != torch.uint8
                                             or torch.equal(out, eight)))):
                raise AssertionError(f"presets {tag}: wrong shape, not finite or unchanged")
            rec[tag] = {"detect_ms": ms, "preds": list(preds.shape)}
            del model
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del frames
    torch.cuda.empty_cache()
    rec["train"] = _presets_train(dev, smi)
    add(rec["train"].pop("launches"))
    return rec


def _presets_train(dev, smi: str) -> dict:
    """train.main --synthetic 1 with the pixelwise extractor and the 2p1d
    embedder (2 image steps at batch 16; the pixelwise loss holds the mask's
    share of each prediction pixel), then one video step (a 16-frame clip)
    of the same modules: every loss finite."""
    import shutil
    import tempfile

    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    out = tempfile.mkdtemp(prefix="chip_smoke_presets_train_")
    flags = ["--extractor_model", "convnext_tiny_pw",
             "--embedder_model", "unet_small2_yuv_quant_2p1d", "--batch_size", "16"]
    try:
        reset_counts()
        t0 = time.perf_counter()
        state, logger, step_ms = train.main(flags + ["--synthetic", "1", "--steps", "2",
                                                     "--eval_freq", "0", "--tensorboard", "0",
                                                     "--output_dir", out])
        wall = time.perf_counter() - t0
        launches = check_counts("presets train", {})
    finally:
        shutil.rmtree(out, ignore_errors=True)
    logs = {k: m.global_avg for k, m in logger.meters.items()}
    mods, st, _ = train.build_trainer(train.get_parser().parse_args(flags), dev)
    clip = torch.rand((1, F_TRAIN_CLIP, 256, 256, 3), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))
    _, vlogs = make_train_step(mods, is_video=True)(st, {"imgs": clip},
                                                    torch.Generator(device=dev).manual_seed(6))
    vlogs = {k: float(v) for k, v in vlogs.items()}
    log(f"[presets] train.main, convnext_tiny_pw + unet_small2_yuv_quant_2p1d: 2 steps at "
        f"batch 16 in {wall:.1f} s (the synthetic pool included), steps {step_ms} ms; "
        f"loss_decode {logs.get('loss_decode', math.nan):.4f}, bit_acc "
        f"{logs.get('bit_acc', math.nan):.4f}; video step on a {F_TRAIN_CLIP}-frame clip: "
        f"total_loss {vlogs.get('total_loss', math.nan):.4f} ({smi})")
    if (state.step != 2 or "loss_decode" not in logs
            or not all(math.isfinite(v) for v in [*logs.values(), *vlogs.values()])):
        raise AssertionError("presets train: a loss is not finite or a step did not run")
    del mods, st, state
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "wall_s": wall, "logs": logs,
            "video_logs": vlogs}


class _BaselineEnc(torch.nn.Module):
    """A stand-in for a baseline's TorchScript embedder: a residual from the
    image and the message."""

    def __init__(self, nbits: int):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 16, 3, padding=1)
        self.msg = torch.nn.Linear(nbits, 16)
        self.conv2 = torch.nn.Conv2d(16, 3, 3, padding=1)

    def forward(self, x, m):
        h = torch.relu(self.conv1(x) + self.msg(m)[:, :, None, None])
        return x + 0.1 * torch.tanh(self.conv2(h))


class _BaselineDec(torch.nn.Module):
    """A stand-in for a baseline's TorchScript extractor: nbits logits, with
    a detection logit before them where `with_detect`."""

    def __init__(self, nbits: int, with_detect: bool):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 32, 3, stride=4)
        self.head = torch.nn.Linear(32, nbits + int(with_detect))

    def forward(self, x):
        return self.head(torch.relu(self.conv(x)).mean(dim=(2, 3)))


@contextlib.contextmanager
def tf32_off(cudnn: bool = False):
    """cuBLAS's TF32 off inside, and cuDNN's unless `cudnn` (True: PyTorch's
    defaults, which phase K2 leaves off for the phases after it), restored
    after."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _last_cards() -> dict:
    """videoseal_1.0's card (256 bits, 256 px, step 4, chunk 32, jnd_1_1)
    with (a) a VAE embedder, (b) DVMark's embedder and extractor, (c) a
    dinov2_vits14 extractor (hooks 8-11, the card's pixel-decoder keys with
    embed_dim 4 x 384)."""
    from videoseal_tpu_torch.utils.cfg import load_card
    cards = {k: load_card("videoseal_1.0") for k in ("vae", "dvmark", "dino")}
    cards["vae"]["embedder"] = {"model": "vae", "params": {
        "msg_processor": {"msg_processor_type": "binary+concat"},
        "encoder": dict(VAE_WIDTHS, double_z=True), "decoder": dict(VAE_WIDTHS)}}
    cards["dvmark"]["embedder"] = {"model": "dvmark", "params": {}}
    cards["dvmark"]["extractor"] = {"model": "dvmark", "params": {}}
    pd = dict(cards["dino"]["extractor"]["params"]["pixel_decoder"], embed_dim=4 * 384)
    cards["dino"]["extractor"] = {"model": "dino2s_indices", "params": {
        "encoder": {"name": "dinov2_vits14", "hook_indices": [8, 9, 10, 11]},
        "pixel_decoder": pd}}
    return cards


def _last_model(dev, tmp: str, tag: str, card: dict):
    """(model in float32 at random init from seed 0, rebuilt on the card
    from the .npz that save_npz wrote of it, its weights the same; the
    path)."""
    import videoseal_tpu_torch as vt
    src = vt.VideoSeal.from_card(card, device=dev, seed=0)
    path = os.path.join(tmp, f"{tag}.npz")
    vt.save_npz(path, src, args=card["args"])
    model = vt.VideoSeal.from_card(card, checkpoint=path, device=dev)
    if not all(torch.equal(model.state_dict()[k], v) for k, v in src.state_dict().items()):
        raise AssertionError(f"last {tag}: {path} did not load back as the model it holds")
    del src
    return model, path


def _last_card_vs_cpu(tag: str, model, card: dict, path: str, frames: torch.Tensor,
                      embed: bool, video: bool, through_k2: bool) -> dict:
    """The float32 model on the card against the CPU's from the same .npz,
    TF32 off, on LAST_CPU_FRAMES float frames: the embed output within
    LAST_F32_ATOL, the logits of the card's output within LAST_F32_ATOL (or
    PRESET_LOGIT_ATOL through K2, no bit decision flipped beyond it)."""
    import videoseal_tpu_torch as vt
    cpu = vt.VideoSeal.from_card(card, checkpoint=path, device="cpu")
    x = frames[:LAST_CPU_FRAMES]
    msgs = model.get_random_msg(1 if video else x.shape[0])
    rec = {}
    with tf32_off():
        if embed:
            g = model.embed(x, msgs=msgs, is_video=video)["imgs_w"]
            c = cpu.embed(x.cpu(), msgs=msgs.cpu(), is_video=video)["imgs_w"]
            rec["embed_max"] = float((g.cpu() - c).abs().max())
            x = g
        gp = model.detect(x)["preds"].cpu()
        cp = cpu.detect(x.cpu())["preds"]
    tol = PRESET_LOGIT_ATOL if through_k2 else LAST_F32_ATOL
    rec["logit_max"] = float((gp - cp).abs().max())
    sure = cp[:, 1:].abs() > tol
    rec["flips"] = int(((gp[:, 1:] > 0) != (cp[:, 1:] > 0))[sure].sum())
    emb = (f"embed max diff {rec['embed_max']:.3e} (tolerance {LAST_F32_ATOL}), "
           if embed else "")
    log(f"[last] {tag}, {LAST_CPU_FRAMES} frames, card vs CPU (float32, TF32 off): {emb}logits "
        f"{rec['logit_max']:.3e} (tolerance {tol}), bit decisions flipped beyond it "
        f"{rec['flips']}")
    if rec.get("embed_max", 0.0) > LAST_F32_ATOL or rec["logit_max"] > tol or rec["flips"]:
        raise AssertionError(f"last {tag}: card and CPU disagree")
    return rec


def _last_baselines(dev, tmp: str, smi: str) -> dict:
    """Each baseline method with scripted stand-ins at its size and bits
    (every other one with a detection logit): embed, detect and
    extract_message of F_BASELINE float 1080p frames on the card, against
    the CPU on LAST_CPU_FRAMES of them (TF32 off); embed+detect timed."""
    from videoseal_tpu_torch.models import baselines as bl
    g = torch.Generator(device=dev).manual_seed(21)
    frames = torch.rand((F_BASELINE, H, W, 3), generator=g, device=dev)
    out = {}
    for i, method in enumerate(sorted(bl._BASELINE_SPECS)):
        nbits = bl._DEFAULT_BITS[method]
        torch.manual_seed(i)
        ep, dp = os.path.join(tmp, f"{method}_enc.pt"), os.path.join(tmp, f"{method}_dec.pt")
        torch.jit.script(_BaselineEnc(nbits)).save(ep)
        torch.jit.script(_BaselineDec(nbits, i % 2 == 0)).save(dp)
        model = bl.build_baseline(f"baseline/{method}", ep, dp, device=dev)
        msgs = model.get_random_msg(F_BASELINE)
        reset_counts()
        emb = model.embed(frames, msgs=msgs)
        preds = model.detect(emb["imgs_w"])["preds"]
        bits = model.extract_message(emb["imgs_w"])
        check_counts(f"last baseline/{method}", {})
        if (tuple(emb["imgs_w"].shape) != (F_BASELINE, H, W, 3)
                or tuple(preds.shape) != (F_BASELINE, nbits + 1)
                or tuple(bits.shape) != (1, nbits) or not bool(torch.isfinite(preds).all())
                or torch.equal(emb["imgs_w"], frames)):
            raise AssertionError(f"baseline/{method}: wrong shape, not finite or unchanged")
        cpu = bl.build_baseline(f"baseline/{method}", ep, dp, device="cpu")
        x, m = frames[:LAST_CPU_FRAMES], msgs[:LAST_CPU_FRAMES]
        with tf32_off():
            gw = model.embed(x, msgs=m)["imgs_w"]
            cw = cpu.embed(x.cpu(), msgs=m.cpu())["imgs_w"]
            err = max(float((gw.cpu() - cw).abs().max()),
                      float((model.detect(gw)["preds"].cpu() - cpu.detect(gw.cpu())["preds"])
                            .abs().max()))
        ms = cuda_ms(lambda: model.detect(model.embed(frames, msgs=msgs)["imgs_w"]))
        log(f"[last] baseline/{method} ({bl._BASELINE_SPECS[method]['img_size']} px, {nbits} "
            f"bits): embed+detect of {F_BASELINE} float 1080p frames {ms:.2f} ms; card vs CPU "
            f"max diff {err:.3e} (tolerance {LAST_F32_ATOL}) ({smi})")
        if err > LAST_F32_ATOL:
            raise AssertionError(f"baseline/{method}: card and CPU disagree")
        out[method] = {"ms": ms, "cpu_max": err}
    return out


def _wmforger_inputs() -> tuple:
    """(batch, draws) of phase 20's card-against-CPU WmForger step: two
    synthetic 256 images and their waves-watermarked copies, one
    perturbation's draws."""
    import random

    from videoseal_tpu_torch.data.datasets import SyntheticImages
    from videoseal_tpu_torch.wmforger import generators
    from videoseal_tpu_torch.wmforger import train as wtrain
    random.seed(1)
    np.random.seed(1)
    imgs = torch.as_tensor(np.stack([SyntheticImages(2, 256)[i][0] for i in range(2)]))
    batch = {"imgs": imgs, "imgs_w": generators.build_generator("waves").embed(imgs)["imgs_w"]}
    draws = wtrain.sample_draws(torch.Generator().manual_seed(2), 1, imgs.shape, "cpu",
                                use_rand_perturbation=True)
    return batch, draws


def _wmforger_step(d, img, batch: dict, draws: dict) -> tuple:
    """A convnext_tiny preference model (init seed 0) on device d: 3 optimize
    steps on img, then one train step of every option (bt_nll, a
    perturbation step, gradient matching, the strength contrast) ->
    (logs, each parameter's gradient on the CPU, the optimized image)."""
    from videoseal_tpu_torch.models.videoseal import init_weights
    from videoseal_tpu_torch.wmforger import optimize_image as wopt
    from videoseal_tpu_torch.wmforger import train as wtrain
    m = wtrain.build_preference_model(256, [3, 3, 9, 3], [96, 192, 384, 768])
    init_weights(m, torch.Generator().manual_seed(0))
    m = m.to(d)
    o = wopt.optimize(img.to(d), m, 3).cpu()
    step = wtrain.make_train_step(m, "bt_nll", torch.optim.AdamW(m.parameters()),
                                  n_perturbation_steps=1, grad_matching=True,
                                  strength_contrasting=True)
    logs = step({n: v.to(d) for n, v in batch.items()}, dict(draws, init=draws["init"].to(d)))
    return logs, {n: p.grad.float().cpu() for n, p in m.named_parameters()}, o


def _grad_err(card: dict, cpu: dict) -> float:
    """The largest of each gradient's max |card - CPU| over its tensor's
    largest CPU value. A tensor whose CPU gradient is exactly 0 (the
    preference head's bias: the Bradley-Terry loss reads only score
    differences) has no scale of its own, and its error is taken over the
    module's largest CPU gradient."""
    top = max(float(g.abs().max()) for g in cpu.values())
    return max(float((card[n] - g).abs().max()) / (float(g.abs().max()) or top)
               for n, g in cpu.items())


def _last_wmforger(dev, tmp: str, smi: str) -> dict:
    """wmforger.train.main at convnext_tiny's full width (img 256, batch 8):
    WMF_STEPS steps with one ascent step, WMF_GM_STEPS with gradient
    matching and the strength contrast; ms a step after the first and peak
    memory; optimize (WMF_OPT_STEPS SGD steps) on one 256 image; one step of
    every option at batch 2 and 3 optimize steps on the card against the
    CPU (float32, TF32 off)."""
    import random

    from videoseal_tpu_torch.data.datasets import SyntheticImages
    from videoseal_tpu_torch.wmforger import optimize_image as wopt
    from videoseal_tpu_torch.wmforger import train as wtrain
    common = ["--synthetic", "1", "--batch_size", str(WMF_BATCH), "--img_size", "256"]
    rec = {}
    for tag, flags in (("perturb", ["--steps", str(WMF_STEPS), "--n_perturbation_steps", "1"]),
                       ("grad_matching", ["--steps", str(WMF_GM_STEPS), "--grad_matching", "1",
                                          "--watermark_strength_contrasting", "1"])):
        random.seed(0)
        np.random.seed(0)
        ckpt = os.path.join(tmp, f"wmforger_{tag}.npz")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        _, step_ms = wtrain.main(common + flags + ["--output", ckpt])
        wall = time.perf_counter() - t0
        check_counts(f"last wmforger {tag}", {})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        after = float(np.median(step_ms[1:]))
        log(f"[last] wmforger.train.main ({tag}): {len(step_ms)} steps at batch {WMF_BATCH}, "
            f"256 px, convnext_tiny's full width: step ms {[round(v, 2) for v in step_ms]}, "
            f"{after:.2f} ms a step after the first, peak {peak:.2f} GiB, {wall:.1f} s "
            f"({smi})")
        if not all(math.isfinite(v) for v in step_ms):
            raise AssertionError(f"wmforger {tag}: a step did not run")
        rec[tag] = {"step_ms": step_ms, "ms_after_first": after, "peak_gib": peak, "wall_s": wall}
    model = wopt.load_preference_model(ckpt, dev)
    img = torch.as_tensor(SyntheticImages(1, 256)[0][0], device=dev)
    reset_counts()
    opt = wopt.optimize(img, model, WMF_OPT_STEPS)
    check_counts("last wmforger optimize", {})
    cleaned, wm = wopt.get_watermark(img, opt)
    rec["optimize_ms"] = cuda_ms(lambda: wopt.optimize(img, model, WMF_OPT_STEPS), reps=1)
    log(f"[last] optimize: {WMF_OPT_STEPS} steps on one 256 image {rec['optimize_ms']:.2f} ms, "
        f"the watermark's largest {float(wm.abs().max()):.4f} ({smi})")
    if not bool(torch.isfinite(cleaned).all()):
        raise AssertionError("wmforger optimize: not finite")

    # the card against the CPU: one step of every option, 3 optimize steps
    batch, draws = _wmforger_inputs()
    with tf32_off():
        card_logs, card_grads, card_opt = _wmforger_step(dev, img, batch, draws)
        logs, grads, opt_cpu = _wmforger_step(torch.device("cpu"), img, batch, draws)
    # the losses (acc and ranking count signs, which a logit near 0 may flip)
    log_err = max(abs(float(card_logs[n]) - float(v)) / max(abs(float(v)), 1e-6)
                  for n, v in logs.items() if n.startswith("loss"))
    grad_err = _grad_err(card_grads, grads)
    opt_err = float((card_opt - opt_cpu).abs().max())
    rec["cpu"] = {"log_rel": log_err, "grad_rel": grad_err, "optimize_max": opt_err}
    log(f"[last] wmforger, card vs CPU (float32, TF32 off, batch 2, every option): logs "
        f"{log_err:.3e} relative (tolerance {TRAIN_LOG_RTOL}), gradients {grad_err:.3e} of "
        f"each tensor's largest, the module's where a tensor's is 0 (tolerance "
        f"{LAST_GRAD_RTOL}); optimize, 3 steps: {opt_err:.3e} "
        f"(tolerance {LAST_F32_ATOL})")
    if log_err > TRAIN_LOG_RTOL or grad_err > LAST_GRAD_RTOL or opt_err > LAST_F32_ATOL:
        raise AssertionError("wmforger: card and CPU disagree")
    return rec


def phase_last(dev, smi: str) -> dict:
    """The last models at full width with videoseal_1.0's settings, random
    init from seed 0, each built through a .npz: (a) the VAE embedder
    (float embed of F_LAST 1080p frames as images, detect: K6 1, K2 18),
    (b) DVMark's embedder and extractor (embed of F_LAST float 1080p frames
    as a video: K6 1; detect, then a 40-frame detect whose last chunk is
    padded with frame 0), (c) the DINO extractor (detect of F_LAST float
    1080p frames), each in bf16 with its launches held against their plain
    versions, timed, and in float32 on the card against the CPU; (d) the
    five baselines; (e) WmForger's training and forging tool."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_last_")
    rec = {"launches": {k: 0 for k in kernel_wrappers()}}

    def add(got):
        rec["launches"] = {k: rec["launches"][k] + got[k] for k in got}

    g = torch.Generator(device=dev).manual_seed(20)
    frames = torch.rand((F_LAST, H, W, 3), generator=g, device=dev)
    cards = _last_cards()
    try:
        for tag in ("vae", "dvmark", "dino"):
            card = cards[tag]
            f32, path = _last_model(dev, tmp, tag, card)
            model = f32.with_dtype("bfloat16")
            embeds = tag != "dino"
            video = tag == "dvmark"
            blocks = 18 if tag == "vae" else 0
            msgs = model.get_random_msg(1 if video else F_LAST)
            with _Capture() as cap:
                reset_counts()
                wm = model.embed(frames, msgs=msgs, is_video=video)["imgs_w"] if embeds else frames
                preds = model.detect(wm)["preds"]
                add(check_counts(f"last {tag}", {"K6": int(embeds), "K2": blocks}))
            if (tuple(wm.shape) != (F_LAST, H, W, 3) or tuple(preds.shape) != (F_LAST, 257)
                    or not bool(torch.isfinite(preds).all())
                    or (embeds and torch.equal(wm, frames))):
                raise AssertionError(f"last {tag}: output of the wrong shape, not finite or "
                                     "unchanged")
            r = {"worst": hold_captured(f"last {tag}", cap.calls)}
            if video:
                f40 = torch.cat([wm, wm[:F_PRESET_PAD - F_LAST]])
                reset_counts()
                p40 = model.detect(f40)["preds"]
                add(check_counts(f"last {tag} F={F_PRESET_PAD}", {}))
                r.update(hold_padded_chunk(f"last {tag}", model, f40, p40))
                r["detect40_ms"] = cuda_ms(lambda: model.detect(f40))
            if embeds:
                r["ms"] = cuda_ms(lambda: model.detect(
                    model.embed(frames, msgs=msgs, is_video=video)["imgs_w"]))
                what = f"embed ({'video' if video else 'images'})+detect"
            else:
                r["ms"] = cuda_ms(lambda: model.detect(frames))
                what = "detect"
            log(f"[last] {tag}: {what} of {F_LAST} float 1080p frames {r['ms']:.2f} ms"
                + (f", detect of {F_PRESET_PAD} {r['detect40_ms']:.2f} ms" if video else "")
                + f" ({smi})")
            del model
            r["cpu_vs_card"] = _last_card_vs_cpu(tag, f32, card, path, frames, embeds, video,
                                                 through_k2=tag == "vae")
            rec[tag] = r
            del f32, wm, preds
            torch.cuda.empty_cache()
        rec["baselines"] = _last_baselines(dev, tmp, smi)
        del frames
        torch.cuda.empty_cache()
        rec["wmforger"] = _last_wmforger(dev, tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def rank_frames_step(rank: int, dev_name: str, card_args: list, size: int, n_data: int,
                     n_frames: int) -> dict:
    """On each rank of an n_data x n_frames mesh (a gloo group, every rank
    on one device), TF32 off: two video steps at SGD lr 1 on the rank's
    block of FRAMES_CLIPS clips of F_TRAIN_CLIP frames (its clips by data
    rank, its frames by frames rank) with DEFAULT_AUGS' draws from one
    generator seed. Rank 0 then runs one process's two steps on the whole
    batch from the same state and draws and returns the first steps'
    errors; every rank returns how far its parameters are from rank 0's."""
    import torch.distributed as dist

    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    dev = torch.device(dev_name)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(n_data, n_frames)
    imgs = torch.as_tensor(np.random.default_rng(41).uniform(
        0, 1, (FRAMES_CLIPS, F_TRAIN_CLIP, size, size, 3)).astype(np.float32))
    args = train.get_parser().parse_args(card_args + [
        "--balanced", "1", "--optimizer", "SGD,lr=1.0", "--optimizer_d", "SGD,lr=1.0"])
    rec = {}
    for where, m in (("ranks", mesh), ("one", None)):
        if where == "one" and rank != 0:
            break
        mods, state, _ = train.build_trainer(args, dev, m)
        step = make_train_step(mods, is_video=True)
        x = imgs if m is None else (shard_batch(m, imgs, frames_axis=1) if n_frames > 1
                                    else shard_batch(m, imgs))
        x = x.to(dev)
        gen = torch.Generator().manual_seed(7)
        times = []
        for i in range(2):
            sync()
            t0 = time.perf_counter()
            _, logs = step(state, {"imgs": x}, gen)
            sync()
            times.append(time.perf_counter() - t0)
            if i == 0:
                rec[where] = _step_record(state, logs)
        rec[where + "_s"] = times
        if where == "ranks":
            flat = torch.cat([p.detach().reshape(-1) for p in state.embedder.parameters()]
                             + [p.detach().reshape(-1) for p in state.extractor.parameters()])
            ref = flat.clone()
            dist.broadcast(ref, 0)
            rec["rank_gap"] = float((flat - ref).abs().max())
        del mods, state
        if cuda:
            torch.cuda.empty_cache()
    if rank != 0:
        return {"rank_gap": rec["rank_gap"]}
    return {"rank_gap": rec["rank_gap"], "ranks_s": rec["ranks_s"], "one_s": rec["one_s"],
            **_module_errors(rec["ranks"], rec["one"])}


def check_some(path: str, want: tuple, allowed: tuple = ()) -> dict:
    """A path's counts where its chunking sets them: each kernel of `want`
    launched at least once, none but those and `allowed`."""
    got = read_counts()
    log(f"[{path}] launches {got} (each of {want} at least once, no other"
        f"{' but ' + str(allowed) if allowed else ''})")
    if any(got[k] == 0 for k in want) or any(
            v for k, v in got.items() if k not in want + allowed):
        raise AssertionError(f"{path}: kernel launch counts {got}")
    return got


def _rest_audio(dev, smi: str) -> dict:
    """(a) the spread-spectrum watermark, 16 bits, on AUDIO_S seconds of
    48 kHz stereo: embed and detect timed on the card, the bits read back,
    and the card against the CPU."""
    from videoseal_tpu_torch.audio_wm import SpreadSpectrumAudio
    rng = np.random.default_rng(5)
    t = np.arange(AUDIO_S * AUDIO_SR) / AUDIO_SR
    x = sum(a * np.sin(2 * np.pi * f * t) for a, f in [(0.3, 220.0), (0.2, 440.0), (0.15, 3e3)])
    x = x + rng.normal(0, 0.05, t.shape)
    x = (x / (np.abs(x).max() * 1.2)).astype(np.float32)
    pcm = np.stack([x, np.roll(x, 7)])
    card, cpu = (SpreadSpectrumAudio(nbits=16, key=0, device=d) for d in (dev, "cpu"))
    msg = card.get_random_msg(torch.Generator().manual_seed(0))
    x_dev = torch.from_numpy(pcm).to(dev)
    marked = card.embed(x_dev, AUDIO_SR, msg)
    bits, conf = card.detect(marked, AUDIO_SR)
    want = cpu.embed(pcm, AUDIO_SR, msg.cpu())
    cbits, cconf = cpu.detect(want, AUDIO_SR)
    err = float((marked.cpu() - want).abs().max())
    embed_ms = cuda_ms(lambda: card.embed(x_dev, AUDIO_SR, msg))
    detect_ms = cuda_ms(lambda: card.detect(marked, AUDIO_SR))
    log(f"[rest] audio watermark, 16 bits, {AUDIO_S} s of {AUDIO_SR} Hz stereo: embed "
        f"{embed_ms:.3f} ms, detect {detect_ms:.3f} ms ({smi}); bits equal to the message: "
        f"{bool(torch.equal(bits, msg))}, confidence {float(conf.mean()):.3f}; card vs CPU: "
        f"PCM max abs {err:.2e}, bits equal {bool(torch.equal(bits.cpu(), cbits))}, "
        f"confidence max abs {float((conf.cpu() - cconf).abs().max()):.2e}")
    if not torch.equal(bits, msg) or err > AUDIO_ATOL or not torch.equal(bits.cpu(), cbits):
        raise AssertionError(f"audio watermark: bits {bits.tolist()} vs {msg.tolist()}, "
                             f"card vs CPU {err:.3e}")
    return {"embed_ms": embed_ms, "detect_ms": detect_ms, "cpu_err": err}


def _write_clip_cv2(path: str, frames: np.ndarray) -> None:
    import cv2
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                         (frames.shape[2], frames.shape[1]))
    for fr in frames:
        wr.write(np.ascontiguousarray(fr[..., ::-1]))
    wr.release()


def _read_clip_cv2(path: str) -> np.ndarray:
    import cv2
    cap, out = cv2.VideoCapture(path), []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        out.append(fr[..., ::-1])
    cap.release()
    return np.stack(out)


def _rest_av(dev, tmp: str, smi: str) -> dict:
    """(b) embed_av on an F_AV-frame 1080p clip written with cv2,
    videoseal_1.0 at full width in bf16 with its default audio processor,
    then the output's message (detect_video)."""
    import shutil as sh

    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch import native
    from videoseal_tpu_torch.audio_wm import SpreadSpectrumAudio, make_audio_processor
    from videoseal_tpu_torch.evals.full import synthetic_samples
    from videoseal_tpu_torch.inference_av import embed_av
    from videoseal_tpu_torch.inference_streaming import detect_video
    src, dst = os.path.join(tmp, "av_in.mp4"), os.path.join(tmp, "av_out.mp4")
    clip = next(synthetic_samples(1, (F_AV, H, W, 3), seed=9))
    _write_clip_cv2(src, np.clip(clip * 255 + 0.5, 0, 255).astype(np.uint8))
    del clip
    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    wm = SpreadSpectrumAudio(nbits=16, device=dev)
    proc = make_audio_processor(wm.get_random_msg(torch.Generator().manual_seed(0)), wm)
    ffmpeg = sh.which("ffmpeg")
    with _Capture() as cap:
        reset_counts()
        t0 = time.perf_counter()
        info = embed_av(model, src, dst, audio_processor=proc)
        wall = time.perf_counter() - t0
        embed_counts = check_some("rest embed_av", ("K4",))
        reset_counts()
        msg = detect_video(model, dst)
        detect_counts = check_some("rest embed_av detect", ("K2",))
    worst = hold_captured("rest embed_av", cap.calls)
    a, b = _read_clip_cv2(src).astype(np.float64), _read_clip_cv2(dst).astype(np.float64)
    psnr = float(20 * np.log10(255.0) - 10 * np.log10(np.mean((a - b) ** 2)))
    acc = float((msg.cpu() == info["msgs"].cpu()).float().mean())
    log(f"[rest] embed_av, videoseal_1.0 bf16, {F_AV} 1080p frames: route {info['route']}, "
        f"audio muxed {info['audio']}, watermarked {info['audio_wm']}"
        f"{' (' + info['audio_note'] + ')' if info['audio_note'] else ''}; native runtime "
        f"{native.available()}, ffmpeg {ffmpeg}; frames written {info['frames']}; PSNR "
        f"{psnr:.2f} dB (the two files decoded by cv2: the codec's loss included); "
        f"{wall * 1e3 / info['frames']:.2f} ms a frame ({smi}; host clock, decode, device, "
        f"encode and mux); the output's bits against the message {acc:.3f} (random weights)")
    if info["frames"] != F_AV or not math.isfinite(psnr):
        raise AssertionError(f"embed_av: {info['frames']} frames, PSNR {psnr}")
    if not native.available() and ffmpeg is None and info["audio"] is not False:
        raise AssertionError("embed_av without the native runtime and ffmpeg muxed audio")
    del model
    torch.cuda.empty_cache()
    return {"route": info["route"], "audio": info["audio"], "audio_note": info["audio_note"],
            "psnr": psnr, "ms_per_frame": wall * 1e3 / info["frames"], "bit_acc": acc,
            "worst": worst,
            "launches": {k: embed_counts[k] + detect_counts[k] for k in embed_counts}}


def _rest_scripts(dev, tmp: str, smi: str) -> dict:
    """(c) make_config -> load(card_path) on the card, and process_sab on
    SAB_N synthetic SA-1B-sized JPEGs (all in the train split)."""
    import cv2

    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch.ops.resize import resize_bicubic_pil
    from videoseal_tpu_torch.scripts import make_config, process_sab
    from videoseal_tpu_torch.utils.cfg import load_card
    card = load_card("videoseal_1.0")
    ckpt = os.path.join(tmp, "ckpt", "checkpoint.npz")
    os.makedirs(os.path.dirname(ckpt))
    targs = {**card["args"], "img_size": 256, "embedder_card": card["embedder"],
             "extractor_card": card["extractor"]}
    with open(os.path.join(os.path.dirname(ckpt), "args.json"), "w") as f:
        json.dump(targs, f)
    # the model the card describes: make_config keeps five of the training
    # args, as the JAX package's does (hidden_size_multiplier falls back to 2)
    src_card = {k: v for k, v in make_config.make_card(ckpt, targs).items()
                if k != "checkpoint_path"}
    src_model = vt.VideoSeal.from_card(src_card, device=dev, seed=3)
    vt.save_npz(ckpt, src_model)
    card_path = os.path.join(tmp, "card.yaml")
    make_config.main([ckpt, "--output", card_path])
    model = vt.load(card_path, device=dev)
    same = all(torch.equal(model.state_dict()[k], v) for k, v in src_model.state_dict().items())
    log(f"[rest] make_config -> load({os.path.basename(card_path)}) on {model.device}: "
        f"{sum(p.numel() for m in (model.embedder, model.extractor) for p in m.parameters())} "
        f"parameters, equal to the checkpoint's: "
        f"{same}")
    if not same or model.device.type != dev.type:
        raise AssertionError("make_config: the card did not load the checkpoint on the card")
    del model, src_model
    sab_src, sab_dst = os.path.join(tmp, "sab"), os.path.join(tmp, "sab_out")
    os.makedirs(sab_src)
    rng = np.random.default_rng(11)
    h, w = SAB_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(SAB_N):
        img = np.stack([yy / h * 200 + 20 * i % 50, xx / w * 180, (xx + yy) % 255], -1)
        img += rng.normal(0, 12, (h // 8 + 1, w // 8 + 1, 3)).repeat(8, 0).repeat(8, 1)[:h, :w]
        cv2.imwrite(os.path.join(sab_src, f"sa_{i:05d}.jpg"),
                    np.clip(img, 0, 255).astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 90])
    t0 = time.perf_counter()
    res = process_sab.main([sab_src, sab_dst, "--num_test", "0", "--num_val", "0", "--size",
                            "256", "--workers", "8", "--device", str(dev)])
    secs = time.perf_counter() - t0
    outs = sorted(os.listdir(os.path.join(sab_dst, "train")))
    shapes = {cv2.imread(os.path.join(sab_dst, "train", f)).shape for f in outs}
    two = torch.from_numpy(np.stack([cv2.imread(os.path.join(sab_src, f)) for f in outs[:2]]))
    exact = torch.equal(resize_bicubic_pil(two.to(dev), 256, 256).cpu(),
                        resize_bicubic_pil(two, 256, 256))
    log(f"[rest] process_sab: {res['train']} {h}x{w} JPEGs -> 256x256 in {secs:.2f} s, "
        f"{res['train'] / secs:.1f} files/s (8 I/O threads, one resize call on the card; "
        f"{smi}); the card's resize equal to the CPU's: {exact}")
    if len(outs) != SAB_N or shapes != {(256, 256, 3)} or not exact:
        raise AssertionError(f"process_sab: {len(outs)} files of {shapes}, exact {exact}")
    torch.cuda.empty_cache()
    return {"files_per_s": res["train"] / secs, "seconds": secs}


def run_notebook(path: str, out_dir: str) -> dict:
    """A notebook's code cells top to bottom in one namespace, its first
    cell's out_dir set to `out_dir` (the device stays the card)."""
    with open(path) as f:
        cells = ["".join(c["source"]) for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    ns: dict = {"__name__": "__main__"}
    for i, cell in enumerate(cells):
        exec(compile(cell, f"{os.path.basename(path)}[{i}]", "exec"), ns)
        if i == 0:
            if ns.get("device") != "cuda":
                raise AssertionError(f"{path}: its first cell does not set device = 'cuda'")
            ns["out_dir"] = out_dir
    return ns


def _rest_examples(dev, tmp: str, smi: str) -> dict:
    """(d) both examples and all four notebooks on the card, at their
    default sizes, each launch's first call per shape held against its
    plain version."""
    from videoseal_tpu_torch.examples import image_watermarking, video_watermarking
    nb_dir = os.path.join(ROOT, "videoseal_tpu_torch", "notebooks")
    launches = {k: 0 for k in kernel_wrappers()}
    rec = {}
    runs = [("image example", lambda: image_watermarking.main(
                ["--out_dir", os.path.join(tmp, "ex_img")])),
            ("video example", lambda: video_watermarking.main(
                ["--out", os.path.join(tmp, "ex_video.mp4")]))]
    runs += [(f"notebook {n}", lambda n=n: run_notebook(
        os.path.join(nb_dir, n + ".ipynb"), os.path.join(tmp, "nb_" + n)))
        for n in ("image_inference", "video_inference", "video_inference_streaming",
                  "av_inference")]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with _Capture() as cap:
            for tag, fn in runs:
                reset_counts()
                t0 = time.perf_counter()
                out = fn()
                secs = time.perf_counter() - t0
                # the streaming notebook takes the planar route (K1) where the
                # native runtime loads
                got = check_some(f"rest {tag}", ("K2", "K4"), allowed=("K1",))
                launches = {k: launches[k] + got[k] for k in got}
                if tag.startswith("notebook") and tag.endswith("av_inference"):
                    info = out["info"]
                    note = f"; route {info['route']}, audio {info['audio']} ({info['audio_note']})"
                elif tag.startswith("notebook"):
                    note = ""
                else:
                    note = f"; {json.dumps(out)}"
                    if not math.isfinite(out["psnr"]):
                        raise AssertionError(f"{tag}: PSNR {out['psnr']}")
                log(f"[rest] {tag} on the card: {secs:.2f} s{note}")
                rec[tag] = secs
    finally:
        os.chdir(cwd)
    rec["worst"] = hold_captured("rest examples", cap.calls)
    rec["launches"] = launches
    torch.cuda.empty_cache()
    return rec


def _rest_frames(smi: str, runs=FRAMES_RUNS, dev_name: str = "cuda:0", size: int = 256) -> dict:
    """(e) the frames axis at videoseal_1.0's full width in video mode, and
    a data-only mesh whose embedder and extractor mix frames (the 2p1d
    UNet, the temporal ConvNeXt): each of `runs` on gloo ranks sharing the
    card against one process on the whole batch, TF32 off, held to phase
    18's tolerances. Each run's line is printed before it is held."""
    from videoseal_tpu_torch.parallel.launch import run_local
    rec = {}
    for nd, nf, flags in runs:
        t0 = time.perf_counter()
        res = run_local(rank_frames_step, nd * nf, dev_name, list(flags), size, nd, nf,
                        backend="gloo", timeout=600)
        r0, gap = res[0], max(r["rank_gap"] for r in res)
        what = ("frames axis, videoseal_1.0" if nf > 1 else
                "data axis, modules that mix frames (" + " ".join(flags[1::2]) + ")")
        log(f"[rest] {what}, {nd}x{nf} ({nd * nf} gloo ranks on one card), video step, "
            f"{FRAMES_CLIPS} clips of {F_TRAIN_CLIP} frames at {size}x{size}, TF32 off, vs "
            f"one process: losses/scales rel {r0['logs']:.2e}, BN stats of each tensor's largest "
            f"{r0['bn_rel']:.2e} (abs {r0['bn']:.2e}), largest gradient gap (of its module's "
            f"largest) {r0['grads']:.2e} at {r0['grads_at']}, updated params abs "
            f"{r0['params']:.2e} (largest gradient {r0['scale']:.3g}), ranks' parameters from "
            f"rank 0 {gap:.2e}; step on the mesh {r0['ranks_s'][0] * 1e3:.0f} ms first, "
            f"{r0['ranks_s'][1] * 1e3:.0f} ms second; one process {r0['one_s'][0] * 1e3:.0f} ms "
            f"first, {r0['one_s'][1] * 1e3:.0f} ms second ({smi}; host clock, the ranks share "
            f"the card); {time.perf_counter() - t0:.1f} s with the spawn")
        if (gap != 0.0 or r0["logs"] > DIST_LOG_RTOL or r0["bn_rel"] > DIST_BN_RTOL
                or r0["params"] > TRAIN_GRAD_RTOL * r0["scale"] + TRAIN_PARAM_ATOL):
            raise AssertionError(f"{what} {nd}x{nf} against one process: {r0}, gap {gap}")
        rec[f"{nd}x{nf}" + ("" if nf > 1 else " mix")] = {
            **{k: v for k, v in r0.items() if k != "grads_at"}, "rank_gap": gap}
    return rec


def phase_rest(dev, smi: str) -> dict:
    """Phase 21: the audio watermark, embed_av, make_config and
    process_sab, the examples and notebooks, and the frames axis."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    rec = {"launches": {k: 0 for k in kernel_wrappers()}}
    try:
        rec["audio"] = _rest_audio(dev, smi)
        rec["av"] = _rest_av(dev, tmp, smi)
        rec["scripts"] = _rest_scripts(dev, tmp, smi)
        rec["examples"] = _rest_examples(dev, tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for part in ("av", "examples"):
        rec["launches"] = {k: rec["launches"][k] + rec[part]["launches"][k]
                           for k in rec["launches"]}
    rec["frames"] = _rest_frames(smi)
    torch.cuda.empty_cache()
    return rec


def phase_bench(dev, smi: str, slice_fps: float | None) -> dict:
    """Phase 22: the port's scorer at its defaults and on NHWC frames in both
    JND modes, its scored fps against phase 5's; then stage A's first steps
    through train.main, and stage B resumed from them."""
    import tempfile

    from videoseal_tpu_torch import bench, train

    calls = 1 + 3 * 5           # bench's warm-up, then 3 repeats of 5 calls
    chunks = math.ceil(F_SLICE / 32)
    runs = [("planar", [], {"K1": 2 * calls, "K2": 2 * calls * 18 * chunks}),
            ("nhwc lowres", ["--layout", "nhwc", "--frames", str(BENCH_NHWC_FRAMES)],
             {"K2": calls * 18}),
            ("nhwc full-res", ["--layout", "nhwc", "--frames", str(BENCH_NHWC_FRAMES),
                               "--lowres_attenuation", "0"], {"K2": calls * 18, "K4": calls})]
    rec = {"launches": {k: 0 for k in kernel_wrappers()}}
    for tag, argv, want in runs:
        reset_counts()
        line = bench.main(argv)
        got = check_counts(f"bench {tag}", want)
        rec["launches"] = {k: rec["launches"][k] + got[k] for k in got}
        log(f"[bench] {tag} ({smi}): {json.dumps(line)}")
        keys = {"metric", "value", "unit", "runs", "spread_pct"}
        if tag == "planar":
            keys |= {"mode", "fullres_jnd_fps", "fullres_jnd_runs"}
        if set(line) != keys or not all(math.isfinite(v) and v > 0 for v in
                                        [line["value"], *line["runs"]]):
            raise AssertionError(f"bench {tag}: line {line}")
        rec[tag] = line
    scored = rec["planar"]["value"]
    if slice_fps is not None:
        gap = abs(scored - slice_fps) / slice_fps
        log(f"[bench] scored {scored:.1f} fps against phase 5's {slice_fps:.1f}: "
            f"{100 * gap:.1f}% apart (limit {100 * BENCH_FPS_RTOL:.0f}%)")
        if gap > BENCH_FPS_RTOL:
            raise AssertionError(f"bench: scored {scored} fps, phase 5 {slice_fps}")
    torch.cuda.empty_cache()


    # stage A's first steps: the flags as the recipe gives them, the identity
    # pool taken by its YAML file's name; then stage B resumed from them
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stagea_") as tmp:
        reset_counts()
        t0 = time.perf_counter()
        state, _, step_ms = train.main(list(STAGE_A_FLAGS) + [
            "--steps", str(STAGE_A_STEPS), "--output_dir", tmp])
        wall = time.perf_counter() - t0
        check_counts("stage A", {})
        logged = [json.loads(ln) for ln in open(os.path.join(tmp, "log.txt"))]
        if state.step != STAGE_A_STEPS or not logged or not all(
                math.isfinite(v) for r in logged for v in r.values()):
            raise AssertionError(f"stage A: step {state.step}, log {logged}")
        del state
        torch.cuda.empty_cache()
        med = float(np.median(step_ms[2:]))
        log(f"[bench] {smi} | stage A (videoseal_1.0, 32 bits, batch 32 at 128x128, identity "
            f"pool, decode loss only; TF32 cudnn={torch.backends.cudnn.allow_tf32} "
            f"matmul={torch.backends.cuda.matmul.allow_tf32}): {med:.2f} ms a step (CUDA "
            f"events, median of steps 3-{STAGE_A_STEPS}; the first two "
            f"{[round(t, 1) for t in step_ms[:2]]}), main() wall {wall:.1f} s; last log "
            f"{json.dumps(logged[-1])}")
        rec["stage_a"] = {"median_ms": med, "step_ms": step_ms, "wall_s": wall, "log": logged}
        rec["stage_b"] = _stage_b(os.path.join(tmp, "checkpoint.npz"),
                                  os.path.join(tmp, "stage_b"), smi)
    return rec


def _stage_b(ckpt: str, out: str, smi: str) -> dict:
    """STAGE_B_STEPS steps of stage B's flags through train.main, resumed
    from phase 22's stage A: the lr of every update (read by a step hook
    on the generator's optimizer) equal to the port's stage-B schedule at
    the restored count plus the updates made, every logged value finite."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.parallel import trainer
    from videoseal_tpu_torch.utils.optim import build_lr_schedule, parse_params

    args = train.get_parser().parse_args(list(STAGE_B_FLAGS))
    sched = build_lr_schedule(args.scheduler, args.iter_per_epoch,
                              parse_params(args.optimizer)["lr"])
    lrs = []
    make_state = trainer.create_train_state

    def recording(*a, **kw):
        state = make_state(*a, **kw)
        state.opt_g.register_step_pre_hook(lambda opt, *_: lrs.append(opt.param_groups[0]["lr"]))
        return state

    trainer.create_train_state = recording
    try:
        reset_counts()
        t0 = time.perf_counter()
        state, _, step_ms = train.main(list(STAGE_B_FLAGS) + [
            "--steps", str(STAGE_B_STEPS), "--resume", ckpt, "--output_dir", out])
        wall = time.perf_counter() - t0
        check_counts("stage B", {})
    finally:
        trainer.create_train_state = make_state
    logged = [json.loads(ln) for ln in open(os.path.join(out, "log.txt"))]
    if state.step != STAGE_A_STEPS + STAGE_B_STEPS or not logged or not all(
            math.isfinite(v) for r in logged for v in r.values()):
        raise AssertionError(f"stage B: step {state.step}, log {logged}")
    want = [sched(STAGE_A_STEPS + k) for k in range(STAGE_B_STEPS)]
    lr_err = max((abs(a - b) / b for a, b in zip(lrs, want)), default=math.inf)
    log(f"[bench] stage B resumed at step {STAGE_A_STEPS}: lr of updates 1-{len(lrs)} "
        f"{lrs[0]:.6e} ... {lrs[-1]:.6e}, the stage-B schedule's {want[0]:.6e} ... "
        f"{want[-1]:.6e}, largest relative gap {lr_err:.2e} (limit 2^-23)")
    if len(lrs) != STAGE_B_STEPS or not lr_err <= 2.0 ** -23:
        raise AssertionError(f"stage B: lr of the resumed updates {lrs}, schedule {want}")
    del state
    torch.cuda.empty_cache()
    med = float(np.median(step_ms[2:]))
    log(f"[bench] {smi} | stage B (videoseal_1.0, 32 bits, batch 32 at 128x128, the default "
        f"pool at 2 attacks a step, the discriminator, yuv perceptual): {med:.2f} ms a step "
        f"(CUDA events, median of steps 3-{STAGE_B_STEPS}; the first two "
        f"{[round(t, 1) for t in step_ms[:2]]}), main() wall {wall:.1f} s")
    log(f"[bench] last log {json.dumps(logged[-1])}")
    return {"median_ms": med, "step_ms": step_ms, "wall_s": wall, "log": logged, "lrs": lrs,
            "lr_rel_err": lr_err}


def _is_elementwise(name: str) -> bool:
    return "elementwise" in name


def _is_gemm(name: str) -> bool:
    n = name.lower()
    return any(t in n for t in ("gemm", "xmma", "cutlass", "cublas"))


def profile(calls: dict) -> dict:
    """Device time by kernel over one run of each call, the busy share
    (summed kernel time over the call's wall time), the torch elementwise
    kernels' time, the GEMMs' time, the aten::copy_ calls and the kernels in
    launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    rec = {}
    for m, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        avg = prof.key_averages()
        kern = [e for e in avg if e.device_type == DeviceType.CUDA]
        order = [_short(e.name) for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        busy = sum(e.self_device_time_total for e in kern)
        elem = sum(e.self_device_time_total for e in kern if _is_elementwise(e.key)) / 1e3
        gemm = sum(e.self_device_time_total for e in kern if _is_gemm(e.key)) / 1e3
        copies = sum(e.count for e in avg if e.key == "aten::copy_")
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"profile_{m}.txt"), "w") as f:
            f.write(avg.table(sort_by="self_cuda_time_total", row_limit=60))
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
        log(f"[profile] {m}: wall {wall_us / 1e3:.2f} ms, kernels {busy / 1e3:.2f} ms, "
            f"busy share {busy / wall_us:.3f}; torch elementwise kernels {elem:.3f} ms, "
            f"GEMMs {gemm:.3f} ms, aten::copy_ calls {copies}")
        for e in top:
            log(f"[profile] {m}:   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} "
                f"{e.key[:100]}")
        rec[m] = {"wall_ms": wall_us / 1e3, "kernel_ms": busy / 1e3, "elementwise_ms": elem,
                  "gemm_ms": gemm, "copy_calls": copies, "order": order,
                  "top": [(e.key[:100], e.self_device_time_total / 1e3, e.count) for e in top]}
    return rec


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace, template and
    parameter lists."""
    n = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return n.split("<")[0].split("(")[0].strip()[-60:] or name[:60]


def check_launches(tag: str, order: list, want: tuple | None = None,
                   after: str | None = None) -> list | None:
    """A profiled call's kernels: exactly the port's `want` kernels (no torch
    GEMM, pad or elementwise pass around them), or none after the last
    `after` kernel. A profile that recorded no kernel list is logged as
    unverified."""
    if not order:
        log(f"[profile] {tag}: the profiler recorded no kernel list; not verified")
        return None
    if after is not None:
        last = max((i for i, n in enumerate(order) if after in n), default=None)
        if last is None:
            raise AssertionError(f"{tag}: no {after} among its kernels")
        tail = order[last + 1:]
        log(f"[profile] {tag}: {len(order)} kernels, {len(tail)} after {after} {tail}")
        if tail:
            raise AssertionError(f"{tag} launches {tail} after {after}")
        return tail
    log(f"[profile] {tag} launches {order}")
    if len(order) != len(want) or sorted(
            next((w for w in want if w in n), n) for n in order) != sorted(want):
        raise AssertionError(f"{tag} launches {order}, expected {want}")
    return order


def main() -> int:
    t0 = time.perf_counter()
    smi, kind = phase_device()
    dev = torch.device("cuda", 0)
    rec = {"device": smi, "build": phase_build()}
    rec["K1"] = phase_k1(dev)
    rec["K2"] = phase_k2(dev)
    rec["slice"] = phase_slice(dev, smi)
    rec["unet"] = phase_unet(dev, smi)
    rec["tools"] = phase_tools(dev, smi)
    rec["layouts"] = phase_layouts(dev, smi)
    rec["jnd"] = phase_jnd(dev, smi)
    rec["nhwc"] = phase_nhwc(dev, smi)
    rec["chunky"] = phase_chunky(dev, smi)
    rec["K3"] = phase_k3(dev)
    rec["grouped"] = phase_grouped(dev, smi)
    rec["probes"] = phase_probes(dev)
    rec["pixelseal"] = phase_pixelseal(dev, smi)
    rec["v0"] = phase_v0(dev, smi)
    rec["stream"] = phase_stream(dev, smi)
    rec["evals"] = phase_evals(dev, smi)
    rec["attacks"] = phase_attacks(dev, smi)
    rec["train"] = phase_train(dev, smi)
    rec["dist"] = phase_dist(dev, smi, rec["train"])
    rec["presets"] = phase_presets(dev, smi)
    rec["last"] = phase_last(dev, smi)
    rec["rest"] = phase_rest(dev, smi)
    rec["bench"] = phase_bench(dev, smi, rec["slice"]["scored"]["fps"])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    # each kernel's launches, summed over the paths' runs
    paths = [rec[p]["launches"] for p in ("slice", "tools", "layouts", "nhwc", "chunky",
                                            "pixelseal", "v0",
                                            "grouped", "probes", "stream", "evals",
                                            "attacks", "train", "dist", "presets", "last",
                                            "rest", "bench")]
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}
    measured = {"K1": rec["K1"], "K2": rec["K2"], "K3": rec["K3"],
                **{k: rec["jnd"][k] for k in ("K4", "K5", "K6")},
                **{k: rec["probes"][k] for k in ("K7", "K8")}}
    sources = {
        "K1": ("fused_jnd_blend_planar", "fused_planar.cu", "fused_planar.py:315"),
        "K2": ("convnext_block_fused", "convnext_pw.cu", "convnext_block.py:185"),
        "K3": ("convnext_blocks_fused", "convnext_group.cu", "convnext_block.py:259"),
        "K4": ("fused_jnd_delta_up", "jnd_up.cu", "fused_blend.py:435"),
        "K5": ("fused_jnd_delta", "jnd_delta.cu", "fused_blend.py:487"),
        "K6": ("fused_jnd_blend", "jnd_delta.cu", "fused_blend.py:538"),
        "K7": ("jnd_probe", "jnd_probe.cu", "jnd_probe.py:146"),
        "K8": ("convnext_probe", "convnext_probe.cu", "convnext_probe.py:149"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": f"videoseal_tpu_torch/csrc/{src}",
         "replaces": f"videoseal_tpu/kernels/{tpu}", "launches": launches[k],
         "max_abs_err": measured[k]["max_abs_err"], "ms": measured[k]["ms"],
         "plain_ms": measured[k]["plain_ms"], "bound_ms": measured[k]["bound_ms"],
         "bound_by": measured[k]["bound_by"], "library_ms": None}
        for k, (name, src, tpu) in sources.items()]
    # K2 is four launches from two sources on the shared parts' headers and
    # the GEMM core, which K3 and K8 run too; K1 and K4 share blend_up.cuh
    # (and the heat with K5-K7); K5 runs jnd_rows.cuh's kernel
    parts = ("convnext_dwln.cuh", "convnext_pw.cuh", "gemm_tn.cuh")
    for i, files in ((1, ("convnext_dwln.cu", "convnext_pw.cu", *parts)),
                     (2, ("convnext_group.cu", "convnext_group_f32.cu", "convnext_group.cuh",
                          *parts)),
                     (7, ("convnext_probe.cu", *parts)),
                     (0, ("fused_planar.cu", "blend_up.cuh", "jnd_heat.cuh")),
                     (4, ("jnd_delta.cu", "jnd_rows.cuh", "jnd_heat.cuh")),
                     (3, ("jnd_up.cu", "blend_up.cuh", "jnd_heat.cuh"))):
        kernels[i]["sources"] = [f"videoseal_tpu_torch/csrc/{f}" for f in files]
    log(f"[main] every phase in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
