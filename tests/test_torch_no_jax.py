"""Guards for the machine that serves the port, which has no jax, flax, yaml
or pandas: the package must import and run its planar and NHWC paths,
loading by path, streaming, the metrics, the attack simulator and the evals
without them (and without cv2, which the streaming path and the exact
codecs import only where they need it)."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "videoseal_tpu_torch")

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "yaml", "pandas", "videoseal_tpu", "cv2"):
    sys.modules[name] = None          # any import of these now raises
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import videoseal_tpu_torch as vt
from torch_port import tiny_card
model = vt.VideoSeal.from_card(tiny_card(img_size=128), device="cpu").with_dtype("bfloat16")
imgs = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (4, 160, 256, 3), np.uint8))
out = model.embed_detect_planar(vt.pack_planar(imgs), 160, 256, lowres_attenuation=True)
assert tuple(out["imgs_w"].shape) == (4, 3, 192, 256)
assert tuple(out["preds"].shape) == (4, 17) and bool(torch.isfinite(out["preds"]).all())
assert tuple(vt.aggregate_message(out["preds"]).shape) == (1, 16)
rng = np.random.default_rng(1)
frames = torch.as_tensor(rng.integers(0, 256, (5, 72, 120, 3), np.uint8))
emb = model.embed(frames, is_video=True)
assert emb["imgs_w"].dtype == torch.uint8 and tuple(emb["imgs_w"].shape) == (5, 72, 120, 3)
assert tuple(emb["preds_w"].shape) == (5, 72, 120, 1)
det = model.detect(emb["imgs_w"])["preds"]
assert tuple(det.shape) == (5, 17) and bool(torch.isfinite(det).all())
assert tuple(model.extract_message(emb["imgs_w"]).shape) == (1, 16)
fl = torch.as_tensor(rng.uniform(0, 1, (2, 72, 120, 3)).astype(np.float32))
assert model.embed(fl)["imgs_w"].dtype == torch.float32

# loading by path, from the presets a checkpoint's args name
import os, tempfile
from torch_port import tiny_preset_card
from videoseal_tpu_torch import inference_streaming as st, native
from videoseal_tpu_torch.evals import lowres_quality, speed, streaming_bench
from videoseal_tpu_torch.ops import metrics
tmp = tempfile.mkdtemp()
card, args = tiny_preset_card()
ckpt = os.path.join(tmp, "m.npz")
vt.save_npz(ckpt, vt.VideoSeal.from_card(card, device="cpu"), args=args)
loaded = vt.load(ckpt, device="cpu")
assert loaded.card["embedder"]["model"] == "unet_tiny_yuv_quant" and loaded.supports_planar

# the metrics and the evals
x = torch.rand((2, 48, 64, 3), generator=torch.Generator().manual_seed(0))
y = (x + 0.01).clamp(0, 1)
assert bool(torch.isfinite(metrics.psnr(x, y)).all()) and metrics.ssim(x, y).shape == (2,)
assert float(metrics.capacity(torch.tensor([0.9]), 16)[0]) > 0
assert metrics.pvalue(np.array([0.9]), 16).shape == (1,)
rows = speed.test_speed(loaded, np.random.default_rng(2).uniform(0, 1, (2, 64, 96, 3)), 1)
assert rows["device"] == "cpu" and rows["embed_fps"] > 0
assert len(lowres_quality.run("videoseal_1.0", 64, 96, 1, 0, device="cpu")) == 3

# streaming: files through the native runtime where it loads, else the
# engine on in-memory chunks
if native.available():
    src, dst = os.path.join(tmp, "s.mp4"), os.path.join(tmp, "d.mp4")
    streaming_bench.synth_video(src, 6, 64, 96)
    assert st.embed_video(loaded, src, dst, chunk_size=4)["frames"] == 6
    assert tuple(st.detect_video(loaded, dst, chunk_size=4).shape) == (1, 16)
frames = np.random.default_rng(3).integers(0, 256, (5, 64, 96, 3), np.uint8)
pos, out = [0], []
def fill(buf):
    n = min(buf.shape[0], 5 - pos[0]); buf[:n] = frames[pos[0]:pos[0] + n]; pos[0] += n
    return n
stats = st.run_stream(fill, (2, 64, 96, 3), st.detect_step(loaded), out.append, "cpu")
assert stats["frames"] == 5 and stats["chunks"] == 3

# the attack simulator and the robustness eval: one proxy-codec row on the
# tiny card, and the training-path augmenter from a preset
from videoseal_tpu_torch import augmentation
from videoseal_tpu_torch.augmentation import augs as A
from videoseal_tpu_torch.evals import full
vid = next(full.synthetic_samples(1, (4, 64, 96, 3)))
rows = full.evaluate(model, [vid], is_video=True, verbose=False,
                     validation_augs=[(A.VideoCompressionProxy(codec="h264"), [30])],
                     out_csv=os.path.join(tmp, "metrics.csv"))
assert len(rows) == 1 and rows[0]["aug"].startswith("VideoCompressionProxy(")
assert np.isfinite(rows[0]["psnr"]) and os.path.exists(os.path.join(tmp, "metrics.csv"))
aug = augmentation.build_augmenter(augmentation.AUGS["augs_geometric"])
imgs = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(0))
out, mask, sel = aug(torch.Generator().manual_seed(1), imgs, imgs)
assert out.shape == imgs.shape and len(sel) == 1
print("OK")
"""


def test_slice_runs_without_jax_flax_yaml():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, ROOT, os.path.join(ROOT, "tests")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_native_tree_untouched():
    """Loading and running the native media runtime (in the script above and
    in the other tests) writes nothing under native/: the committed library
    stays as it is."""
    if not os.path.isdir(os.path.join(ROOT, ".git")):
        pytest.skip("not a git checkout")
    from videoseal_tpu_torch import native
    native.available()
    out = subprocess.run(["git", "status", "--porcelain", "native/"], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out == "", out


def test_package_source_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|yaml|pandas|videoseal_tpu)\b",
                     re.MULTILINE)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 10
    # cv2 only inside the functions that use it, never at module level
    top_cv2 = re.compile(r"^(import|from)\s+cv2\b", re.MULTILINE)
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not pat.search(src), f"{path} imports {pat.search(src).group(0)}"
        assert not top_cv2.search(src), f"{path} imports cv2 at module level"
