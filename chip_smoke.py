"""Drive the PyTorch port's planar serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi)
     and the torch/CUDA versions;
  2. build: compiles the Hopper kernels from videoseal_tpu_torch/csrc;
  3. K1 (planar blend) against its plain version at 1080p, F=4, both JND
     branches with and without the detect output; times it at F=128;
  4. K2 (ConvNeXt block) against its plain version at the four stage shapes,
     B=32, bf16 and f32; times it;
  5. the slice: videoseal_1.0 at random init (seed 0) in bf16,
     embed_detect_planar over 128 planar 1080p frames in the scored and the
     card-default modes; checks shapes, launch counts, the scaling_w=0
     identity, CPU-vs-card agreement on 4 frames; times it.
The line before the last holds the kernels' JSON record, the one before it
the nvidia-smi line; the last line is the device record. Details go to
chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --profile

also traces one call of each mode with torch.profiler and prints the device
time by kernel and the device's busy share (tables in chiprun_out/).
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
# order move the prediction by bf16 noise, a fraction of an LSB after the blend
SLICE_U8_MAX, SLICE_U8_SHARE, SLICE_LOGIT_ATOL = 2, 1e-2, 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean ms per call over `reps` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    with open(os.path.join(os.path.dirname(lib._name), "build.log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"[build] {ln}")
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
    scored = rec["lowres=True,ds=256"]
    return {"checks": rec, "max_abs_err": worst, "ms": scored["ms"],
            "plain_ms": scored["plain_ms"]}


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


def phase_k2(dev) -> dict:
    from videoseal_tpu_torch.kernels.convnext_block import (block_params,
                                                            convnext_block_fused,
                                                            convnext_block_plain)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec, worst, chunk_ms, chunk_plain = {}, 0.0, 0.0, 0.0
    for i, (h, w, c) in enumerate(STAGES):
        for dtype in (torch.bfloat16, torch.float32):
            blk = _random_block(c, i, dev, dtype)
            p = block_params(blk)
            g = torch.Generator(device=dev).manual_seed(10 + i)
            x = torch.randn((32, h, w, c), generator=g, device=dev).to(dtype)
            a, b = convnext_block_fused(x, p).float(), convnext_block_plain(x, p).float()
            torch.cuda.synchronize()
            err = (a - b).abs()
            bound = K2_ATOL + K2_RTOL * b.abs()
            key = f"{h}x{w}x{c},{str(dtype)[6:]}"
            ms = cuda_ms(lambda: convnext_block_fused(x, p))
            pms = cuda_ms(lambda: convnext_block_plain(x, p))
            log(f"[K2] B=32 {key}: max abs err {float(err.max()):.3e}, mean "
                f"{float(err.mean()):.3e}; kernel {ms:.3f} ms, plain {pms:.3f} ms")
            if not bool(torch.isfinite(a).all()) or bool((err > bound).any()):
                raise AssertionError(f"K2 disagrees with its plain version at {key}")
            rec[key] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                        "ms": ms, "plain_ms": pms}
            if dtype == torch.bfloat16:
                worst = max(worst, float(err.max()))
                chunk_ms += DEPTHS[i] * ms
                chunk_plain += DEPTHS[i] * pms
    log(f"[K2] 18 blocks of one chunk of 32 frames, bf16: kernel {chunk_ms:.3f} ms, "
        f"plain {chunk_plain:.3f} ms")
    return {"checks": rec, "max_abs_err": worst, "ms": chunk_ms, "plain_ms": chunk_plain}


def phase_slice(dev, smi: str) -> dict:
    import videoseal_tpu_torch as vt
    from videoseal_tpu_torch.kernels.convnext_block import convnext_block_fused
    from videoseal_tpu_torch.kernels.fused_planar import fused_jnd_blend_planar

    model = vt.load("videoseal_1.0", device=dev, seed=0).with_dtype("bfloat16")
    imgs = planar_frames(F_SLICE, 3, dev)
    msgs = model.get_random_msg(1)
    modes = {"scored": dict(lowres_attenuation=True, fused_detect=True),
             "default": dict(lowres_attenuation=False, fused_detect=False)}

    fused_jnd_blend_planar.launches = 0
    convnext_block_fused.launches = 0
    outs = {m: model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw)
            for m, kw in modes.items()}
    torch.cuda.synchronize()
    launches = {"K1": fused_jnd_blend_planar.launches, "K2": convnext_block_fused.launches}
    want = {"K1": len(modes), "K2": 18 * math.ceil(F_SLICE / 32) * len(modes)}
    log(f"[slice] launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches} != {want}")
    rec = {"launches": launches}
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
        rec["profile"] = profile_slice(model, imgs, msgs, modes)
    for m, kw in modes.items():
        ms = cuda_ms(lambda: model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw))
        fps = F_SLICE / ms * 1000
        log(f"[slice] {m}: {ms:.2f} ms per {F_SLICE} frames at 1080p = {fps:.1f} fps "
            f"({smi})")
        rec[m] = {"ms": ms, "fps": fps}
    return rec


def profile_slice(model, imgs, msgs, modes) -> dict:
    """Device time by kernel over one call of each mode, and the busy share
    (summed kernel time over the call's wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rec = {}
    for m, kw in modes.items():
        model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.embed_detect_planar(imgs, H, W, msgs=msgs, **kw)
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
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    rec = {"device": smi, "build": phase_build()}
    rec["K1"] = phase_k1(dev)
    rec["K2"] = phase_k2(dev)
    rec["slice"] = phase_slice(dev, smi)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    launches = rec["slice"]["launches"]
    kernels = [
        {"name": "fused_jnd_blend_planar", "route": "cuda",
         "source": "videoseal_tpu_torch/csrc/fused_planar.cu",
         "replaces": "videoseal_tpu/kernels/fused_planar.py:315",
         "launches": launches["K1"], "max_abs_err": rec["K1"]["max_abs_err"],
         "ms": rec["K1"]["ms"], "plain_ms": rec["K1"]["plain_ms"]},
        {"name": "convnext_block_fused", "route": "cuda",
         "source": "videoseal_tpu_torch/csrc/convnext_block.cu",
         "replaces": "videoseal_tpu/kernels/convnext_block.py:185",
         "launches": launches["K2"], "max_abs_err": rec["K2"]["max_abs_err"],
         "ms": rec["K2"]["ms"], "plain_ms": rec["K2"]["plain_ms"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
