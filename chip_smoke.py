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
     identity, CPU-vs-card agreement on 4 frames; times it;
  6. K4, K5, K6 (full-resolution JND on NHWC frames) against their plain
     versions at 1080p, F=4 (K4's delta and blend modes on u8 and f32 frames,
     K5, K6 with 1- and 3-channel predictions in f32 and bf16), K4's four
     cases, K5 and K6 again at F=2 and 1078x1922 (unaligned rows, ragged
     groups, strips and chunks), K4's four at F=2 and 120x200 (its general
     width path), and K5(resize(pred)) against K4(pred);
     times each and its plain version at F=128;
  7. the NHWC slice: videoseal_1.0 at random init (seed 0) in bf16, embed
     of 128 u8 1080p frames as a video, detect and extract_message of the
     result, embed of 32 float frames as images; checks shapes, launch
     counts, the scaling_w=0 identity, CPU-vs-card agreement on 4 frames;
     times embed+detect;
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
     variant against K5; then each probe's main() at the TPU probe's shapes
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
     chiprun_out/attacks_*_grid.csv.
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
from videoseal_tpu_torch.utils.timing import cuda_ms  # noqa: E402

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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
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


def phase_slice(dev, smi: str) -> dict:
    import videoseal_tpu_torch as vt

    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
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

    cpu = vt.load("videoseal_1.0", device="cpu", seed=0).with_dtype("bfloat16")
    small = imgs[:4]
    for m, kw in modes.items():
        g = model.embed_detect_planar(small, H, W, msgs=msgs, **kw)
        c = cpu.embed_detect_planar(small.cpu(), H, W, msgs=msgs.cpu(), **kw)
        d = (g["imgs_w"].cpu().int() - c["imgs_w"].int()).abs()
        ld = float((g["preds"].cpu() - c["preds"]).abs().max())
        log(f"[slice] {m}, F=4, card vs CPU: u8 max diff {int(d.max())}, share differing "
            f"{float((d > 0).float().mean()):.2e}, logits max abs diff {ld:.3e}")
        if (int(d.max()) > SLICE_U8_MAX or float((d > 0).float().mean()) > SLICE_U8_SHARE
                or ld > SLICE_LOGIT_ATOL):
            raise AssertionError(f"card and CPU disagree in mode {m}")
        rec[f"{m}_cpu_vs_card"] = {"u8_max": int(d.max()), "logit_max": ld}

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
    return rec


def phase_jnd(dev) -> dict:
    """K4 (delta and blend mode, u8 and f32 frames), K5, K6 against their
    plain versions at F=4 and at F=2, 1078x1922; timed at F=128."""
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
        out["K5,f32"] = ("K5", fb.fused_jnd_delta, fb.fused_jnd_delta_plain, (f32, pred, 0.2),
                         px * (HEAT_OPS + 1))
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
               else DELTA_RTOL * float(b.abs().max()))
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
        if k == "K4" or key in ("K5,f32", "K6,f32,c3"):
            rec[key]["ragged_max_abs_err"] = hold(f"F=2 {hr}x{wr}", key, k, kern, plain, args)
    # 120x200 frames: the prediction downscaled in width, K4's general path
    for key, (k, kern, plain, args, _) in cases(2, 10, 120, 200, all_cases=False).items():
        rec[key]["small_max_abs_err"] = hold("F=2 120x200", key, k, kern, plain, args)
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
        del out
        torch.cuda.empty_cache()
    # K4: its main-path instance, the blend mode on u8 frames (NHWC embed)
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

    cpu = vt.load("videoseal_1.0", device="cpu", seed=0).with_dtype("bfloat16")
    g4 = model.embed(frames[:4], msgs=msgs, is_video=True)["imgs_w"]
    c4 = cpu.embed(frames[:4].cpu(), msgs=msgs.cpu(), is_video=True)["imgs_w"]
    d = (g4.cpu().int() - c4.int()).abs()
    ld = float((model.detect(g4)["preds"].cpu() - cpu.detect(g4.cpu())["preds"]).abs().max())
    m4 = model.get_random_msg(4)
    fd = float((model.embed(imgs[:4], msgs=m4)["imgs_w"].cpu()
                - cpu.embed(imgs[:4].cpu(), msgs=m4.cpu())["imgs_w"]).abs().max())
    share = float((d > 0).float().mean())
    log(f"[nhwc] F=4, card vs CPU: u8 max diff {int(d.max())}, share differing {share:.2e}, "
        f"logits max abs diff {ld:.3e}, float images max abs diff {fd:.3e}")
    if (int(d.max()) > SLICE_U8_MAX or share > SLICE_U8_SHARE or ld > SLICE_LOGIT_ATOL
            or fd > SLICE_FLOAT_ATOL):
        raise AssertionError("card and CPU disagree on the NHWC path")
    rec["cpu_vs_card"] = {"u8_max": int(d.max()), "u8_share": share, "logit_max": ld,
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
    ms = cuda_ms(embed_detect)
    ems = cuda_ms(lambda: model.embed(frames, msgs=msgs, is_video=True))
    fps = F_SLICE / ms * 1000
    log(f"[nhwc] embed+detect: {ms:.2f} ms per {F_SLICE} u8 frames at 1080p = {fps:.1f} fps "
        f"(embed alone {ems:.2f} ms) ({smi})")
    rec.update(ms=ms, fps=fps, embed_ms=ems)
    return rec


def cpu_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A CPU copy of a model's module, without the kernel parameters its
    blocks cached on the card (the CPU builds its own)."""
    import copy
    out = copy.deepcopy(module).cpu()
    for m in out.modules():
        m.__dict__.pop("_kernel_params", None)
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
    cpu = vt.load("pixelseal", device="cpu", seed=0).with_dtype("bfloat16")
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
    d32 = float((gpu32.embed(frames[:2], msgs=msgs, is_video=True)["preds_w"].cpu()
                 - cpu32.embed(frames[:2].cpu(), msgs=msgs.cpu(), is_video=True)["preds_w"])
                .abs().max())
    l32 = float((gpu32.detect(wm[:2])["preds"].cpu() - cpu32.detect(wm[:2].cpu())["preds"])
                .abs().max())
    cpu = cpu32.with_dtype("bfloat16")
    del cpu32, gpu32
    gp = model.embed(frames[:2], msgs=msgs, is_video=True)["preds_w"]
    cp = cpu.embed(frames[:2].cpu(), msgs=msgs.cpu(), is_video=True)["preds_w"]
    diff = (gp.cpu() - cp).abs()
    pd, pm = float(diff.max()), float(diff.mean())
    ld = float((model.detect(wm[:2])["preds"].cpu() - cpu.detect(wm[:2].cpu())["preds"])
               .abs().max())
    del cpu, diff
    log(f"[v0] F=2, card vs CPU in f32: prediction max abs diff {d32:.3e}, logits {l32:.3e} "
        f"(tolerance {V0_F32_ATOL}); in bf16: prediction max abs diff {pd:.3e} (tolerance "
        f"{V0_PRED_ATOL}), mean {pm:.3e} (tolerance {V0_PRED_MEAN}), logits max abs diff "
        f"{ld:.3e} (tolerance {V0_LOGIT_ATOL})")
    if (d32 > V0_F32_ATOL or l32 > V0_F32_ATOL or pd > V0_PRED_ATOL or pm > V0_PRED_MEAN
            or ld > V0_LOGIT_ATOL):
        raise AssertionError("card and CPU disagree on videoseal_0.0")
    rec["cpu_vs_card"] = {"f32_pred_max": d32, "f32_logit_max": l32, "pred_max": pd,
                          "pred_mean": pm, "logit_max": ld}
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
    """The extractor's grouped route at full width, as r4_probe's extract
    stage: convnext_apply_fused(max_block_group=4) plus the pixel decoder."""
    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch.kernels.convnext_fused import block_groups, convnext_apply_fused
    from videoseal_tpu_torch.models.videoseal import _chunked_apply

    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    s, cs = model.cfg.img_size, model.cfg.chunk_size
    g = torch.Generator(device=dev).manual_seed(12)
    frames = torch.rand((F_SLICE, s, s, 3), generator=g, device=dev).to(torch.bfloat16)

    def extract(ext, x, mbg):
        with torch.no_grad():
            return _chunked_apply(lambda b: ext.pixel_decoder(convnext_apply_fused(
                ext.convnext, b[0] * 2 - 1, max_block_group=mbg)).float(), (x,), cs)

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
    smi, kind = phase_device()
    dev = torch.device("cuda", 0)
    rec = {"device": smi, "build": phase_build()}
    rec["K1"] = phase_k1(dev)
    rec["K2"] = phase_k2(dev)
    rec["slice"] = phase_slice(dev, smi)
    rec["jnd"] = phase_jnd(dev)
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
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    # each kernel's launches, summed over the paths' runs
    paths = [rec[p]["launches"] for p in ("slice", "nhwc", "chunky", "pixelseal", "v0",
                                            "grouped", "probes", "stream", "evals",
                                            "attacks")]
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
    # (and the heat with K5-K7)
    parts = ("convnext_dwln.cuh", "convnext_pw.cuh", "gemm_tn.cuh")
    for i, files in ((1, ("convnext_dwln.cu", "convnext_pw.cu", *parts)),
                     (2, ("convnext_group.cu", "convnext_group_f32.cu", "convnext_group.cuh",
                          *parts)),
                     (7, ("convnext_probe.cu", *parts)),
                     (0, ("fused_planar.cu", "blend_up.cuh", "jnd_heat.cuh")),
                     (3, ("jnd_up.cu", "blend_up.cuh", "jnd_heat.cuh"))):
        kernels[i]["sources"] = [f"videoseal_tpu_torch/csrc/{f}" for f in files]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
