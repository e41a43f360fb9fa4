"""Drive the PyTorch port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi)
     and the torch/CUDA versions;
  2. build: compiles the Hopper kernels from videoseal_tpu_torch/csrc, one
     nvcc per source, all at once;
  3. K1 (planar blend) against its plain version at 1080p, F=4, both JND
     branches with and without the detect output; times it at F=128;
  4. K2 (ConvNeXt block: dwln, pw1, grn_stats, pw2) against its plain
     version at the four stage shapes, B=32, and at 3x12x20x96 and
     3x12x20x192 (masked last M tiles), bf16 and f32; per stage in bf16
     times the block in turns with the earlier split kernels (split, new,
     new, split), each part with its bound, and cuBLAS on the two products'
     shapes (a yardstick the port never calls);
  5. the planar slice: videoseal_1.0 at random init (seed 0) in bf16,
     embed_detect_planar over 128 planar 1080p frames in the scored and the
     card-default modes; checks shapes, launch counts, the scaling_w=0
     identity, CPU-vs-card agreement on 4 frames; times it;
  6. K4, K5, K6 (full-resolution JND on NHWC frames) against their plain
     versions at 1080p, F=4 (K4 on u8 and f32 frames, K5, K6 with 1- and
     3-channel predictions in f32 and bf16), K4, K5 and K6 again at F=2 and
     1078x1922 (ragged strips and column chunks), and K5(resize(pred))
     against K4(pred); times each and its plain version at F=128;
  7. the NHWC slice: videoseal_1.0 at random init (seed 0) in bf16, embed
     of 128 u8 1080p frames as a video, detect and extract_message of the
     result, embed of 32 float frames as images; checks shapes, launch
     counts, the scaling_w=0 identity, CPU-vs-card agreement on 4 frames;
     times embed+detect;
  8. the K6 path at full width: chunkyseal at random init in bf16, embed of
     8 float 1080p frames as images; checks the K6 launch, shapes and the
     scaling_w=0 identity (chunkyseal's detect is not run);
  9. K3 (k ConvNeXt blocks in one launch) against its plain version and, bit
     for bit, against k sequential launches of the earlier, split K2
     kernels at the four stage shapes, B=32, k = 2, 3, 4, bf16 and f32;
     times the groups of one grouped 32-frame chunk;
 10. the extractor's grouped route: videoseal_1.0 at random init (seed 0) in
     bf16, convnext_apply_fused(max_block_group=4) plus the pixel decoder
     over 128 frames at 256x256 in chunks of 32 (K3 20 and K2 16 launches),
     its logits near the max_block_group=1 route's and the CPU route's on 4
     frames; times both routes in turns;
 11. the probes: every K7 variant (all strip heights, f32 and u8 frames)
     against its plain version at a small ragged size, K7's production
     variant against K5; then each probe's main() at the TPU probe's shapes
     (JSON lines); then every case of both sweeps against its plain version
     on the sweep's inputs and shapes (K7 at F=128, 1080p; K8 at
     128x64x64x96 and 128x32x32x192), K7's production variant against K5
     again, and the plain versions of the two cases the kernels line
     reports timed.
Each path runs with every launch count set to 0 just before it and read
just after. The line before the last holds the kernels' JSON record, the one
before it the nvidia-smi line; the last line is the device record. Details
go to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --profile

also traces one call of each planar mode and of the NHWC slice with
torch.profiler and prints the device time by kernel and the device's busy
share (tables in chiprun_out/).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from videoseal_tpu_torch.utils.timing import cuda_ms  # noqa: E402

OUT_DIR = os.path.join(ROOT, "chiprun_out")
H, W, F_SLICE = 1080, 1920, 128
STAGES = [(64, 64, 96), (32, 32, 192), (16, 16, 384), (8, 8, 768)]
DEPTHS = (3, 3, 9, 3)
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
# grouped route, card vs CPU on 4 frames: the same bf16 forward with conv and
# matmul sums in another order; measured 3.9e-3 on logits up to ~0.7. The
# grouped route against the single one on the card: K3 runs the earlier split
# block, the single route the new K2, whose pw1 sums in another order, so a
# bf16 rounding of the hidden may flip: held to the same bound.
GROUPED_CPU_ATOL = 2e-2
# K4/K5: the plain versions repeat the kernels' f32 arithmetic with sums in
# another order (K4's lift as a dense matmul): ~1e-5 relative on the delta.
# K6 output in [0, 1]: that delta error plus f32 rounding (6e-8)
DELTA_RTOL, BLEND_ATOL = 1e-5, 1e-6
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


def planar_frames(f: int, seed: int, device) -> torch.Tensor:
    from videoseal_tpu_torch.kernels.fused_planar import C0, R0, planar_shape
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.zeros(planar_shape(f, H, W), dtype=torch.uint8, device=device)
    buf[:, :, R0:R0 + H, C0:C0 + W] = torch.randint(
        0, 256, (f, 3, H, W), generator=g, device=device, dtype=torch.uint8)
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


def phase_k1(dev) -> dict:
    from videoseal_tpu_torch.kernels.fused_planar import (fused_jnd_blend_planar,
                                                          fused_jnd_blend_planar_plain)
    rec, worst = {}, 0
    for f, timed in ((4, False), (F_SLICE, True)):
        imgs = planar_frames(f, 1, dev)
        g = torch.Generator(device=dev).manual_seed(2)
        pred = (torch.rand((f, 256, 256), generator=g, device=dev) * 2 - 1) * 0.1
        for lowres in (True, False):
            for ds in (None, 256):
                kern = lambda: fused_jnd_blend_planar(imgs, pred, 0.2, 1.0, H, W, ds, lowres)
                plain = lambda: fused_jnd_blend_planar_plain(imgs, pred, 0.2, 1.0, H, W, ds,
                                                             lowres)
                key = f"lowres={lowres},ds={ds}"
                if not timed:
                    a, b = kern(), plain()
                    torch.cuda.synchronize()
                    (a, da), (b, db) = (a, b) if ds else ((a, None), (b, None))
                    d = (a.int() - b.int()).abs()
                    u8max, share = int(d.max()), float((d > 0).float().mean())
                    det_err = float((da - db).abs().max()) if ds else 0.0
                    log(f"[K1] F={f} {key}: u8 max diff {u8max}, share differing "
                        f"{share:.2e}, det max abs err {det_err:.3e}")
                    if u8max > K1_U8_MAX or share > K1_U8_SHARE or det_err > K1_DET_ATOL:
                        raise AssertionError(f"K1 disagrees with its plain version at {key}")
                    worst = max(worst, u8max)
                    rec[key] = {"u8_max": u8max, "share": share, "det_err": det_err}
                else:
                    ms, pms = cuda_ms(kern), cuda_ms(plain)
                    log(f"[K1] F={f} {key}: kernel {ms:.3f} ms, plain {pms:.3f} ms")
                    rec[key].update(ms=ms, plain_ms=pms)
                    torch.cuda.empty_cache()
    # bound of the scored branch at F=128 (pred: the last loop's input). It
    # reads the (hout, wq) window of each u8 plane that it writes out, with
    # no halo, the f32 prediction, and writes the f32 detect input.
    from videoseal_tpu_torch.kernels.fused_planar import TH, _tables_np, planar_geometry
    n_tiles, _, _, wq = planar_geometry(H, W)
    hout, f = TH * n_tiles, F_SLICE
    taps = {k: v[2] for k, v in _tables_np(256, H, W, hout, 256).items()}
    nbytes = 2 * f * 3 * hout * wq + pred.numel() * 4 + f * 3 * 256 * 256 * 4
    ops = (f * hout * wq * (2 * taps["lift"] + 15) + f * 3 * hout * 256 * 2 * taps["dw"]
           + f * 3 * 256 * 256 * 2 * taps["dh"])
    scored = rec["lowres=True,ds=256"]
    bound_ms, bound_by = bound(nbytes, f32_ops=ops)
    log(f"[K1] scored branch, F={f}: bound {bound_ms:.3f} ms ({bound_by}), kernel at "
        f"{bound_ms / scored['ms']:.1%} of it")
    return {"checks": rec, "max_abs_err": worst, "ms": scored["ms"],
            "plain_ms": scored["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by}


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
    ragged ones, bf16 and f32; per stage in bf16: the block and the earlier
    split kernels in turns, each part with its bound, and cuBLAS on the two
    products' shapes as a yardstick."""
    from videoseal_tpu_torch.kernels import convnext_block as cb
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec, worst, stages = {}, 0.0, []
    chunk = {"ms": 0.0, "split_ms": 0.0, "plain_ms": 0.0}
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
            # in turns on the one card: split, new, new, split
            t = {"split": [], "new": []}
            for name in ("split", "new", "new", "split"):
                fn = cb._launch_split if name == "split" else cb.convnext_block_fused
                t[name].append(cuda_ms(lambda: fn(x, p), reps=10))
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
            new_ms, split_ms = sum(t["new"]) / 2, sum(t["split"]) / 2
            log(f"[K2] B=32 {h}x{w}x{c} bf16: new {t['new']} ms, split {t['split']} ms, plain "
                f"{pms:.3f} ms; " + ", ".join(
                    f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, {r['bound_by']})"
                    for n, r in parts.items())
                + f"; cuBLAS pw1 {blas['pw1']:.4f} ms, pw2 {blas['pw2']:.4f} ms")
            rec[key].update(ms=new_ms, split_ms=split_ms, turns=t, plain_ms=pms, parts=parts,
                            cublas_ms=blas)
            stages.append({"shape": [b, h, w, c], "blocks": DEPTHS[i], "ms": new_ms,
                           "split_ms": split_ms, "parts": parts, "cublas_ms": blas})
            chunk["ms"] += DEPTHS[i] * new_ms
            chunk["split_ms"] += DEPTHS[i] * split_ms
            chunk["plain_ms"] += DEPTHS[i] * pms
            del calls, buf
        torch.cuda.empty_cache()
    bound_ms, bound_by = bound(nbytes, f32_ops=f32_ops, bf16_ops=bf16_ops)
    log(f"[K2] 18 blocks of one chunk of 32 frames, bf16: kernel {chunk['ms']:.3f} ms, the earlier "
        f"split kernels {chunk['split_ms']:.3f} ms ({chunk['ms'] / chunk['split_ms']:.1%} of "
        f"it), plain {chunk['plain_ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), kernel "
        f"at {bound_ms / chunk['ms']:.1%} of it")
    return {"checks": rec, "stages": stages, "max_abs_err": worst, **chunk,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
        rec["profile"] = profile({
            m: (lambda kw=kw: model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw))
            for m, kw in modes.items()})
    for m, kw in modes.items():
        ms = cuda_ms(lambda: model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw))
        fps = F_SLICE / ms * 1000
        log(f"[slice] {m}: {ms:.2f} ms per {F_SLICE} frames at 1080p = {fps:.1f} fps "
            f"({smi})")
        rec[m] = {"ms": ms, "fps": fps}
    return rec


def phase_jnd(dev) -> dict:
    """K4, K5, K6 against their plain versions at F=4, timed at F=128."""
    from videoseal_tpu_torch.kernels import fused_blend as fb
    from videoseal_tpu_torch.kernels.fused_planar import _band
    from videoseal_tpu_torch.ops.resize import _resize_matrix, resize_bilinear
    s = 256
    lift_taps = _band(_resize_matrix(s, H))[2]
    width_taps = _band(_resize_matrix(s, W))[2]

    def cases(f: int, seed: int) -> dict:
        g = torch.Generator(device=dev).manual_seed(seed)
        u8 = torch.randint(0, 256, (f, H, W, 3), generator=g, device=dev, dtype=torch.uint8)
        f32 = torch.rand((f, H, W, 3), generator=g, device=dev)
        pred_low = (torch.rand((f, s, s), generator=g, device=dev) * 2 - 1).contiguous()
        pred = resize_bilinear(pred_low[..., None], H, W)[..., 0].contiguous()
        p1 = torch.rand((f, H, W, 1), generator=g, device=dev) * 2 - 1
        p3 = torch.rand((f, H, W, 3), generator=g, device=dev) * 2 - 1
        px = f * H * W
        up_ops = px * (HEAT_OPS + 2 * lift_taps + 1) + f * s * W * 2 * width_taps
        out = {"K4,u8": ("K4", fb.fused_jnd_delta_up, fb.fused_jnd_delta_up_plain,
                         (u8, pred_low, 0.2), up_ops),
               "K4,f32": ("K4", fb.fused_jnd_delta_up, fb.fused_jnd_delta_up_plain,
                          (f32, pred_low, 0.2), up_ops),
               "K5,f32": ("K5", fb.fused_jnd_delta, fb.fused_jnd_delta_plain,
                          (f32, pred, 0.2), px * (HEAT_OPS + 1))}
        for name, pr in (("f32,c1", p1), ("f32,c3", p3), ("bf16,c1", p1.to(torch.bfloat16)),
                         ("bf16,c3", p3.to(torch.bfloat16))):
            out[f"K6,{name}"] = ("K6", fb.fused_jnd_blend, fb.fused_jnd_blend_plain,
                                 (f32, pr, 1.0, 0.2), px * (HEAT_OPS + 15))
        return out

    rec, worst = {}, {"K4": 0.0, "K5": 0.0, "K6": 0.0}

    def hold(tag: str, key: str, k: str, kern, plain, args) -> float:
        a, b = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        tol = BLEND_ATOL if k == "K6" else DELTA_RTOL * float(b.abs().max())
        log(f"[{k}] {tag} {key}: max abs err {err:.3e} (tolerance {tol:.3e}), "
            f"max |plain| {float(b.abs().max()):.4f}")
        if not bool(torch.isfinite(a).all()) or err > tol:
            raise AssertionError(f"{key} at {tag} disagrees with its plain version")
        worst[k] = max(worst[k], err)
        return err

    small = cases(4, 7)
    for key, (k, kern, plain, args, _) in small.items():
        rec[key] = {"max_abs_err": hold("F=4", key, k, kern, plain, args)}
    # a height that the 8-row strips do not divide and a width that the
    # 256-column chunks do not divide: the masked edges
    hr, wr = H - 2, W + 2
    g = torch.Generator(device=dev).manual_seed(9)
    u8r = torch.randint(0, 256, (2, hr, wr, 3), generator=g, device=dev, dtype=torch.uint8)
    f32r = torch.rand((2, hr, wr, 3), generator=g, device=dev)
    plr = (torch.rand((2, s, s), generator=g, device=dev) * 2 - 1).contiguous()
    pr = resize_bilinear(plr[..., None], hr, wr)[..., 0].contiguous()
    p3r = torch.rand((2, hr, wr, 3), generator=g, device=dev) * 2 - 1
    for key, k, kern, plain, args in (
            ("K4,u8", "K4", fb.fused_jnd_delta_up, fb.fused_jnd_delta_up_plain, (u8r, plr, 0.2)),
            ("K5,f32", "K5", fb.fused_jnd_delta, fb.fused_jnd_delta_plain, (f32r, pr, 0.2)),
            ("K6,f32,c3", "K6", fb.fused_jnd_blend, fb.fused_jnd_blend_plain,
             (f32r, p3r, 1.0, 0.2))):
        rec[key]["ragged_max_abs_err"] = hold(f"F=2 {hr}x{wr}", key, k, kern, plain, args)
    del u8r, f32r, plr, pr, p3r
    # K5 on the upsampled prediction is K4 on the low-res one
    for key in ("K4,u8", "K4,f32"):
        imgs, pred_low, sw = small[key][3]
        a = fb.fused_jnd_delta_up(imgs, pred_low, sw)
        b = fb.fused_jnd_delta(imgs, small["K5,f32"][3][1], sw)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        log(f"[K4] F=4 {key} against K5 on the upsampled prediction: max abs err {err:.3e}")
        if err > DELTA_RTOL * float(b.abs().max()):
            raise AssertionError(f"K4 and K5 disagree on {key}")
        rec[key]["vs_K5"] = err
    del small
    for key, (k, kern, plain, args, ops) in cases(F_SLICE, 8).items():
        ms, pms = cuda_ms(lambda: kern(*args)), cuda_ms(lambda: plain(*args))
        out = kern(*args)
        nbytes = sum(t.numel() * t.element_size() for t in args if torch.is_tensor(t))
        bound_ms, bound_by = bound(nbytes + out.numel() * out.element_size(), f32_ops=ops)
        log(f"[{k}] F={F_SLICE} {key}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), kernel at {bound_ms / ms:.1%} of it")
        rec[key].update(ms=ms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by)
        del out
    torch.cuda.empty_cache()
    main_case = {"K4": "K4,u8", "K5": "K5,f32", "K6": "K6,f32,c3"}
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
        rec["profile"] = profile({"nhwc": embed_detect})
    ms = cuda_ms(embed_detect)
    ems = cuda_ms(lambda: model.embed(frames, msgs=msgs, is_video=True))
    fps = F_SLICE / ms * 1000
    log(f"[nhwc] embed+detect: {ms:.2f} ms per {F_SLICE} u8 frames at 1080p = {fps:.1f} fps "
        f"(embed alone {ems:.2f} ms) ({smi})")
    rec.update(ms=ms, fps=fps, embed_ms=ems)
    return rec


def phase_chunky(dev) -> dict:
    """chunkyseal's float embed at full width: the K6 path."""
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
    del model
    torch.cuda.empty_cache()
    return rec

def phase_k3(dev) -> dict:
    """K3 against its plain version and, bit for bit, against k sequential
    launches of the earlier, split K2 kernels (the device functions K3 runs,
    the same bf16 rounding between blocks) at the four stage shapes, B=32,
    k = 2, 3, 4, bf16 and f32; times the K3 groups of one grouped 32-frame
    chunk."""
    from videoseal_tpu_torch.kernels.convnext_block import (_launch_split, block_params,
                                                            convnext_blocks_fused,
                                                            convnext_blocks_plain)
    from videoseal_tpu_torch.kernels.convnext_fused import block_groups
    rec, worst = {}, 0.0
    chunk = {"ms": 0.0, "plain_ms": 0.0, "k2_ms": 0.0}
    nbytes = f32_ops = bf16_ops = 0.0
    for i, (h, w, c) in enumerate(STAGES):
        groups = [k for k in block_groups(DEPTHS[i], 4) if k > 1]
        for dtype in (torch.bfloat16, torch.float32):
            ps = [block_params(_random_block(c, 20 + 4 * i + j, dev, dtype)) for j in range(4)]
            g = torch.Generator(device=dev).manual_seed(30 + i)
            x = torch.randn((32, h, w, c), generator=g, device=dev).to(dtype)
            for k in (2, 3, 4):
                def seq_k2(k=k):
                    y = x
                    for p in ps[:k - 1]:
                        y = _launch_split(y, p).to(torch.bfloat16)
                    return _launch_split(y.to(dtype), ps[k - 1])
                a = convnext_blocks_fused(x, ps[:k]).float()
                b = convnext_blocks_plain(x, ps[:k]).float()
                q = seq_k2().float()
                torch.cuda.synchronize()
                err, qerr = (a - b).abs(), (a - q).abs()
                key = f"{h}x{w}x{c},{str(dtype)[6:]},k={k}"
                log(f"[K3] B=32 {key}: vs plain max abs err {float(err.max()):.3e}, mean "
                    f"{float(err.mean()):.3e}; vs {k} split K2 launches max abs err "
                    f"{float(qerr.max()):.3e} (identical {bool(torch.equal(a, q))})")
                if (not bool(torch.isfinite(a).all())
                        or bool((err > K2_ATOL + K2_RTOL * b.abs()).any())
                        or not torch.equal(a, q)):
                    raise AssertionError(f"K3 disagrees with its plain version, or is not "
                                         f"bit-identical to {k} split K2 launches, at {key}")
                rec[key] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                            "vs_k2_max_abs_err": float(qerr.max()),
                            "vs_k2_identical": bool(torch.equal(a, q))}
                if dtype != torch.bfloat16:
                    continue
                worst = max(worst, float(err.max()))
                if k not in groups:
                    continue
                ms = cuda_ms(lambda: convnext_blocks_fused(x, ps[:k]))
                pms = cuda_ms(lambda: convnext_blocks_plain(x, ps[:k]))
                qms = cuda_ms(seq_k2)
                log(f"[K3] B=32 {key}: kernel {ms:.3f} ms, {k} split K2 launches {qms:.3f} ms, "
                    f"plain {pms:.3f} ms")
                rec[key].update(ms=ms, plain_ms=pms, k2_ms=qms)
                n = groups.count(k)
                nb, bo, fo = block_cost(h, w, c, k=k)
                nbytes, bf16_ops, f32_ops = nbytes + n * nb, bf16_ops + n * bo, f32_ops + n * fo
                for name, t in (("ms", ms), ("plain_ms", pms), ("k2_ms", qms)):
                    chunk[name] += n * t
        torch.cuda.empty_cache()
    bound_ms, bound_by = bound(nbytes, f32_ops=f32_ops, bf16_ops=bf16_ops)
    groups = [k for d in DEPTHS for k in block_groups(d, 4) if k > 1]
    log(f"[K3] the {len(groups)} groups ({sum(groups)} blocks) of one grouped chunk of 32 "
        f"frames, bf16: kernel {chunk['ms']:.3f} ms, the same blocks as split K2 launches "
        f"{chunk['k2_ms']:.3f} ms, plain {chunk['plain_ms']:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}), kernel at {bound_ms / chunk['ms']:.1%} of it")
    return {"checks": rec, "max_abs_err": worst, **chunk, "bound_ms": bound_ms,
            "bound_by": bound_by}


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
    ld = float((grouped - single).abs().max())
    cpu = vt.load("videoseal_1.0", device="cpu", seed=0).with_dtype("bfloat16")
    cd = float((grouped[:4].cpu() - extract(cpu.extractor, frames[:4].cpu(), 4)).abs().max())
    del cpu
    log(f"[grouped] logits {tuple(grouped.shape)}, max |logit| "
        f"{float(grouped.abs().max()):.3f}; grouped vs single route max abs diff {ld:.3e}; "
        f"F=4, card vs CPU max abs diff {cd:.3e}")
    if (tuple(grouped.shape) != (F_SLICE, 1 + model.nbits)
            or not bool(torch.isfinite(grouped).all())
            or ld > GROUPED_CPU_ATOL or cd > GROUPED_CPU_ATOL):
        raise AssertionError("grouped route logits have the wrong shape, are not finite, or "
                             "disagree with the single route or the CPU")
    rec.update(vs_single=ld, cpu_vs_card=cd)
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


def profile(calls: dict) -> dict:
    """Device time by kernel over one run of each call, and the busy share
    (summed kernel time over the call's wall time)."""
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
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"profile_{m}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
        log(f"[profile] {m}: wall {wall_us / 1e3:.2f} ms, kernels {busy / 1e3:.2f} ms, "
            f"busy share {busy / wall_us:.3f}")
        for e in top:
            log(f"[profile] {m}:   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} "
                f"{e.key[:100]}")
        rec[m] = {"wall_ms": wall_us / 1e3, "kernel_ms": busy / 1e3,
                  "top": [(e.key[:100], e.self_device_time_total / 1e3, e.count) for e in top]}
    return rec


def main() -> int:
    smi, kind = phase_device()
    dev = torch.device("cuda", 0)
    rec = {"device": smi, "build": phase_build()}
    rec["K1"] = phase_k1(dev)
    rec["K2"] = phase_k2(dev)
    rec["slice"] = phase_slice(dev, smi)
    rec["jnd"] = phase_jnd(dev)
    rec["nhwc"] = phase_nhwc(dev, smi)
    rec["chunky"] = phase_chunky(dev)
    rec["K3"] = phase_k3(dev)
    rec["grouped"] = phase_grouped(dev, smi)
    rec["probes"] = phase_probes(dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    # each kernel's launches, summed over the paths' runs
    paths = [rec[p]["launches"] for p in ("slice", "nhwc", "chunky", "grouped", "probes")]
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}
    measured = {"K1": rec["K1"], "K2": rec["K2"], "K3": rec["K3"],
                **{k: rec["jnd"][k] for k in ("K4", "K5", "K6")},
                **{k: rec["probes"][k] for k in ("K7", "K8")}}
    sources = {
        "K1": ("fused_jnd_blend_planar", "fused_planar.cu", "fused_planar.py:315"),
        "K2": ("convnext_block_fused", "convnext_pw.cu", "convnext_block.py:185"),
        "K3": ("convnext_blocks_fused", "convnext_group.cu", "convnext_block.py:259"),
        "K4": ("fused_jnd_delta_up", "jnd_delta.cu", "fused_blend.py:435"),
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
    # K2 is four launches from two sources and the GEMM core they share
    kernels[1]["sources"] = [f"videoseal_tpu_torch/csrc/{f}" for f in
                             ("convnext_dwln.cu", "convnext_pw.cu", "gemm_tn.cuh")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
