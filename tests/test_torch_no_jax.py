"""Guards for the machine that serves the port, which has no jax, flax or
yaml: the package must import and run its planar and NHWC paths without
them."""

import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "videoseal_tpu_torch")

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "yaml", "videoseal_tpu"):
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
print("OK")
"""


def test_slice_runs_without_jax_flax_yaml():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, ROOT, os.path.join(ROOT, "tests")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_package_source_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|yaml|videoseal_tpu)\b",
                     re.MULTILINE)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not pat.search(src), f"{path} imports {pat.search(src).group(0)}"
