"""Guards for the machine that serves the port, which has no jax, flax, yaml
or pandas: the package must import and run its planar and NHWC paths,
loading by path, streaming, the metrics, the attack simulator, the evals,
the losses and a few training steps (with lamb, adafactor and the sharded
checkpoint; and the training entry point's --help), the temporal, pixelwise
and HiDDeN models and the inflation script, the VAE, DVMark and DINO models,
the TorchScript baselines and WmForger, the audio watermark, the card files
and the PIL-semantics resize, the package-level exports, the scorer
(``bench``), the detect-input eval, the two timing tools, the
space-to-depth UNet route and the five layout probes, and import
every other module, without them (and without PIL, and without cv2, which
the streaming path and the exact codecs import only where they need it). The examples' and notebooks' code
imports none of jax, yaml, PIL or the JAX package either."""

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
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "pandas", "videoseal_tpu",
             "cv2", "PIL"):
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

# training: the losses, the discriminators, the step and the entry point
from videoseal_tpu_torch import train
from videoseal_tpu_torch.data import datasets, loader, transforms  # noqa: F401
from videoseal_tpu_torch.evals import intrain  # noqa: F401
from videoseal_tpu_torch.losses import lpips, perceptual, videosealloss, watson_fft  # noqa: F401
from videoseal_tpu_torch.modules import discriminator  # noqa: F401
from videoseal_tpu_torch.parallel import trainer  # noqa: F401
from videoseal_tpu_torch.utils import display, logger, optim, tensorboard  # noqa: F401
assert float(perceptual.build_perceptual_loss("0.5_mse+yuv+watson_dft")(imgs, out)) > 0
state, _, step_ms = train.main(["--device", "cpu", "--tiny", "1", "--synthetic", "1",
                                "--steps", "2", "--batch_size", "2", "--img_size", "64",
                                "--eval_freq", "0", "--output_dir", os.path.join(tmp, "train")])
assert state.step == 2 and len(step_ms) == 2
assert os.path.exists(os.path.join(tmp, "train", "checkpoint.npz"))

# the rest of training: the mesh, lamb and adafactor, the sharded checkpoint,
# the datasets' and tools' modules
from videoseal_tpu_torch.augmentation import doaugs  # noqa: F401
from videoseal_tpu_torch.parallel import launch, mesh  # noqa: F401
from videoseal_tpu_torch.tools import convert_lpips, eval_checkpoint  # noqa: F401
from videoseal_tpu_torch.utils import checkpoint, dist, rle  # noqa: F401
assert mesh.make_mesh().size == 1 and dist.get_world_size() == 1
state, _, _ = train.main(["--device", "cpu", "--tiny", "1", "--synthetic", "1", "--steps", "1",
                          "--batch_size", "2", "--img_size", "64", "--eval_freq", "0",
                          "--optimizer", "adafactor,lr=1e-3", "--optimizer_d", "lamb,lr=1e-3",
                          "--ckpt_format", "orbax", "--output_dir", os.path.join(tmp, "t2")])
assert checkpoint.checkpoint_steps(os.path.join(tmp, "t2", "ckpts")) == [1]

# the preset variants: a 2p1d embedder with a temporal, pixelwise ConvNeXt,
# HiDDeN, and the inflation script
from videoseal_tpu_torch.modules import hidden  # noqa: F401
from videoseal_tpu_torch.scripts import inflate_model_to_temporal as inflate
tc = tiny_card(img_size=64, chunk=4)
tc["embedder"]["params"]["unet"]["conv_layer"] = "conv2p1d"
tc["extractor"]["params"]["encoder"]["temporal_convs"] = True
tc["extractor"]["params"]["pixel_decoder"].update(pixelwise=True, upscale_stages=[4, 2, 2])
tm = vt.VideoSeal.from_card(tc, device="cpu")
clip = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (6, 64, 96, 3), np.uint8))
tw = tm.embed(clip, is_video=True)["imgs_w"]
assert tuple(tm.detect(tw)["preds"].shape) == (6, 32, 32, 17)
assert tuple(tm.extract_message(tw).shape) == (1, 16)
from videoseal_tpu_torch import presets
hc = dict(tc, embedder={"model": "hidden", "params": presets.EMBEDDER["hidden"]},
          extractor={"model": "hidden", "params": presets.EXTRACTOR["hidden"]})
hm = vt.VideoSeal.from_card(hc, device="cpu")
assert tuple(hm.detect(hm.embed(clip[:2])["imgs_w"])["preds"].shape) == (2, 17)
inflate.main([ckpt, os.path.join(tmp, "inflated.npz")])
assert "temporal" in checkpoint.load_npz(os.path.join(tmp, "inflated.npz"))[0]["params"][
    "unet"]["inc"]["conv1"]

# the VAE, DVMark and DINO models, the baselines, utils/{image,layout}, WmForger
from videoseal_tpu_torch.models import baselines
from videoseal_tpu_torch.utils import image, layout
from videoseal_tpu_torch.wmforger import optimize_image, train as wtrain
vae = {"ch": 16, "out_ch": 3, "num_res_blocks": 1, "resolution": 32, "ch_mult": [1, 2],
       "attn_resolutions": [16]}
for emb, ext, s in ((("vae_small", {"encoder": dict(vae, z_channels=4),
                                   "decoder": dict(vae, tanh_out=True)}),
                     tiny_card(img_size=64)["extractor"], 64),
                    (("dvmark", {}), {"model": "dvmark", "params": {}}, 16),
                    ((tc["embedder"]["model"], tc["embedder"]["params"]),
                     {"model": "dino2s", "params": {"pixel_decoder": {"upscale_stages": [1]}}},
                     28)):
    c = dict(tc, args=dict(tc["args"], img_size_proc=s),
             embedder={"model": emb[0], "params": emb[1]}, extractor=ext)
    m = vt.VideoSeal.from_card(c, device="cpu")
    w = m.embed(clip[:3].float() / 255, is_video=True)["imgs_w"]
    assert tuple(m.detect(w)["preds"].shape) == (3, 17), emb[0]
vt.save_npz(os.path.join(tmp, "dv.npz"), m)
class Dec(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 48)
    def forward(self, x):
        return self.lin(x.mean(dim=(2, 3)))
class Enc(torch.nn.Module):
    def forward(self, x, m):
        return x + 0.01 * m.mean()
x128 = torch.rand(2, 3, 128, 128)   # traced: a script run by -c has no source to script
torch.jit.trace(Enc(), (x128, torch.ones(2, 48))).save(os.path.join(tmp, "e.pt"))
torch.jit.trace(Dec(), x128).save(os.path.join(tmp, "d.pt"))
b = baselines.build_baseline("baseline/hidden", os.path.join(tmp, "e.pt"),
                             os.path.join(tmp, "d.pt"), device="cpu")
assert tuple(b.extract_message(b.embed(clip[:2].float() / 255)["imgs_w"]).shape) == (1, 48)
assert tuple(layout.nhwc_to_nchw(clip).shape) == (6, 3, 64, 96)
assert image.median_filter(clip[:1].float(), 3).shape == clip[:1].shape
ck = os.path.join(tmp, "wmforger.npz")
wtrain.main(["--device", "cpu", "--tiny", "1", "--synthetic", "1", "--steps", "1",
             "--batch_size", "2", "--img_size", "32", "--output", ck])
pm = optimize_image.load_preference_model(ck, "cpu")
assert optimize_image.optimize(torch.rand(32, 32, 3), pm, num_steps=2).shape == (32, 32, 3)

# the audio watermark, the AV entry point, card files, the SA-1B script's
# resize, the examples and the frames mesh
from videoseal_tpu_torch import audio_wm, inference_av  # noqa: F401
from videoseal_tpu_torch.examples import image_watermarking, video_watermarking  # noqa: F401
from videoseal_tpu_torch.ops.resize import resize_bicubic_pil
from videoseal_tpu_torch.scripts import make_config, process_sab  # noqa: F401
wm = audio_wm.SpreadSpectrumAudio(nbits=8, device="cpu")
pcm = np.random.default_rng(5).normal(0, 0.1, (2, 48000)).astype(np.float32)
msg = wm.get_random_msg(torch.Generator().manual_seed(0))
assert torch.equal(wm.detect(wm.embed(pcm, 48000, msg), 48000)[0], msg)
card_path = os.path.join(tmp, "card.yaml")
with open(card_path, "w") as f:
    f.write(make_config.dumps(tiny_card(img_size=64)))
assert vt.load(card_path, device="cpu").nbits == 16
assert resize_bicubic_pil(clip[:2], 24, 24).dtype == torch.uint8
assert mesh.Mesh(rank=1, size=2, frames_rank=1, frames_size=2).rows(1, 2).tolist() == [6, 7]

# the package-level names (their import builds no CUDA library), the
# scorer, the detect-input eval and the recipe's pool by its YAML file's name
import json
from videoseal_tpu_torch import bench, setup_model_from_model_card  # noqa: F401
from videoseal_tpu_torch.evals import detect_input
from videoseal_tpu_torch.kernels import _lib, fused_jnd_blend, supports_fused_blend  # noqa: F401
from videoseal_tpu_torch.losses import PerceptualLoss, VideoSealLoss, build_perceptual_loss  # noqa: F401
from videoseal_tpu_torch.models import VideoSeal, build_embedder, build_extractor  # noqa: F401
from videoseal_tpu_torch.modules.convnext import CONVNEXT_PRESETS
from videoseal_tpu_torch.ops import resize_to, rgb_to_yuv, yuv_to_rgb
from videoseal_tpu_torch.parallel import (TrainerModules, TrainState,  # noqa: F401
                                          create_train_state, make_mesh, make_train_step)
from videoseal_tpu_torch.ops.resize import upsample_nearest
assert _lib._lib is None
assert torch.allclose(yuv_to_rgb(rgb_to_yuv(x)), x, atol=1e-4)   # 5-digit constants
assert resize_to(x, 32).shape == (2, 32, 32, 3) and upsample_nearest(x, 2).shape == (2, 96, 128, 3)
assert CONVNEXT_PRESETS["tiny"]["dims"] == (96, 192, 384, 768)
card_128 = os.path.join(tmp, "tiny128.json")
with open(card_128, "w") as f:
    json.dump(tiny_card(img_size=128), f)
line = bench.main(["--device", "cpu", "--card", card_128, "--frames", "2", "--height", "64",
                   "--width", "96", "--runs", "1", "--repeats", "1"])
assert line["mode"] == "lowres_attenuation" and "vs_baseline" not in line
assert detect_input.run(model, detect_input.smooth_frames(2, 64, 96, 0))[-1]["imgs_w_equal"]
assert (train.augmentation_config("videoseal_tpu/configs/augs_identity.yaml")
        == augmentation.AUGS["augs_identity"])

# the timing tools on the CPU
from videoseal_tpu_torch.evals import stage_bench, unet_bench
rec = unet_bench.main(["--device", "cpu", "--card", card_128, "--keys", "2", "--k", "1"])
assert [r["stage"] for r in rec["stages"]] == ["encoder", "bottleneck", "decoder"]
rec = stage_bench.main(["--device", "cpu", "--card", card_128, "--frames", "2", "--height",
                        "64", "--width", "96", "--k", "1"])
assert rec["device"] == "cpu" and len(rec["stages"]) == 10
rec = unet_bench.main(["--device", "cpu", "--card", card_128, "--keys", "2", "--k", "1",
                       "--s2d_pieces", "1"])
assert rec["schedule"] == (4, 4) and len(rec["stages"]) == 2

# the space-to-depth UNet route and the layout probes
import dataclasses
s2d_model = vt.VideoSeal.from_card(tiny_card(img_size=128), device="cpu").with_dtype("bfloat16")
s2d_model.cfg = dataclasses.replace(s2d_model.cfg, s2d_embedder=True)
assert s2d_model.embed(frames, is_video=True)["imgs_w"].shape == frames.shape
from videoseal_tpu_torch.evals import dw_mxu_probe, planar_probe, r4_probe, resize_probe
from videoseal_tpu_torch.kernels import conv_probe, lane_pack
assert len(conv_probe.main(["--device", "cpu", "--k", "1", "--batch", "1", "--hdiv", "8"])) == 9
assert len(resize_probe.main(["--device", "cpu", "--k", "1", "--frames", "1", "--h", "32",
                              "--w", "48", "--s", "16"])) == 4
assert len(dw_mxu_probe.main(["--device", "cpu", "--k", "1", "--frames", "1",
                              "--stages", "3"])) == 4
assert len(planar_probe.main(["--device", "cpu", "--k", "1", "--frames", "1", "--height", "64",
                              "--width", "96", "--proc", "64", "--rs", "32"])) == 1
assert len(r4_probe.main(["--device", "cpu", "--card", card_128, "--k", "1", "--frames", "2",
                          "--height", "64", "--width", "96"])) == 5
print("OK")
"""

_BLOCK = ("import sys\n"
          "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'yaml', 'pandas',"
          " 'videoseal_tpu', 'cv2', 'PIL'):\n"
          "    sys.modules[name] = None\n")


def test_slice_runs_without_jax_flax_yaml():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, ROOT, os.path.join(ROOT, "tests")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_train_help_without_jax_flax_yaml():
    """`python -m videoseal_tpu_torch.train --help` with jax, flax, optax,
    orbax's host packages, yaml and the JAX package unimportable."""
    code = (_BLOCK + "import runpy\n"
            "sys.argv = ['videoseal_tpu_torch.train', '--help']\n"
            "runpy.run_module('videoseal_tpu_torch.train', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--device" in proc.stdout and "--perceptual_loss" in proc.stdout


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
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|yaml|pandas|PIL|"
                     r"videoseal_tpu)\b",
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


def test_notebooks_import_no_jax():
    """The port's notebooks' code cells import none of jax, yaml, PIL or the
    JAX package, and set the device in their first code cell."""
    import json
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|yaml|pandas|PIL|"
                     r"matplotlib|videoseal_tpu)\b", re.MULTILINE)
    nb_dir = os.path.join(PKG, "notebooks")
    names = sorted(f for f in os.listdir(nb_dir) if f.endswith(".ipynb"))
    assert names == ["av_inference.ipynb", "image_inference.ipynb", "video_inference.ipynb",
                     "video_inference_streaming.ipynb"]
    for name in names:
        with open(os.path.join(nb_dir, name)) as f:
            code = ["".join(c["source"]) for c in json.load(f)["cells"]
                    if c["cell_type"] == "code"]
        assert 'device = "cuda"' in code[0], name
        for cell in code:
            assert not pat.search(cell), f"{name} imports {pat.search(cell).group(0)}"
