"""The port's scripts, examples and notebooks on the CPU.

* ``scripts/make_config``: the port's card file read with yaml.safe_load
  equals the JAX package's, and the JAX package's `load` and the port's
  `load(path, device="cpu")` of it hold the same parameters (the JAX ones
  through ``from_jax_variables``); a YAML card the port cannot read is
  refused naming JSON.
* ``scripts/process_sab``: the same split and shard lists as the JAX
  package's, test and val files byte for byte, the train images of PNG
  inputs within 1 u8 level of the JAX package's (Pillow's resize), and
  ``resize_bicubic_pil`` against Pillow at several shapes.
* Each example and each notebook's code cells run top to bottom on the CPU
  at a tiny card, the notebooks' first cell's device and sizes overridden.
"""

import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from torch_port import tiny_card

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOKS = os.path.join(REPO, "videoseal_tpu_torch", "notebooks")


@pytest.fixture(scope="module")
def card_file(tmp_path_factory):
    """videoseal_1.0's layout at the tiny test widths, as a card file."""
    path = str(tmp_path_factory.mktemp("card") / "tiny_card.json")
    with open(path, "w") as f:
        json.dump(tiny_card(img_size=64, step=2, chunk=4), f)
    return path


# -- make_config --------------------------------------------------------------------------

def test_make_config_matches_jax(tmp_path, monkeypatch):
    import videoseal_tpu as vs
    from videoseal_tpu.scripts import make_config as jax_make_config
    from videoseal_tpu_torch import VideoSeal, save_npz
    from videoseal_tpu_torch.scripts import make_config
    from videoseal_tpu_torch.utils.cfg import load
    from videoseal_tpu_torch.utils.convert import from_jax_variables
    card = tiny_card(img_size=64)
    model = VideoSeal.from_card(card, device="cpu", seed=3)
    ckpt = str(tmp_path / "ckpt" / "checkpoint.npz")
    os.makedirs(os.path.dirname(ckpt))
    save_npz(ckpt, model)
    targs = {"nbits": 16, "img_size": 64, "scaling_w": 0.2, "scaling_i": 1.0,
             "attenuation": "jnd_1_1", "lr": 1e-5, "embedder_card": card["embedder"],
             "extractor_card": card["extractor"]}
    with open(os.path.join(os.path.dirname(ckpt), "args.json"), "w") as f:
        json.dump(targs, f)
    jpath, ppath = str(tmp_path / "jax.yaml"), str(tmp_path / "port.yaml")
    monkeypatch.setattr(sys, "argv", ["make_config", ckpt, "--output", jpath])
    jax_make_config.main()
    make_config.main([ckpt, "--output", ppath])
    with open(jpath) as f, open(ppath) as g:
        want, text = yaml.safe_load(f), g.read()
    assert yaml.safe_load(text) == want == json.loads(text)
    assert want["checkpoint_path"] == os.path.abspath(ckpt)

    jm = vs.load(jpath)
    pm = load(ppath, device="cpu")
    emb, ext = from_jax_variables(jm.embedder_vars, jm.extractor_vars)
    for got, want_sd in ((pm.embedder.state_dict(), emb), (pm.extractor.state_dict(), ext)):
        assert got.keys() == want_sd.keys()
        for k, v in want_sd.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    for k, v in model.embedder.state_dict().items():      # the checkpoint's weights
        assert torch.equal(pm.embedder.state_dict()[k], v), k


def test_card_file_must_be_json(tmp_path):
    from videoseal_tpu_torch.utils.cfg import load_card
    path = tmp_path / "card.yaml"
    path.write_text("args:\n  nbits: 16\n")
    with pytest.raises(ValueError, match="JSON"):
        load_card(str(path))
    with pytest.raises(FileNotFoundError):
        load_card(str(tmp_path / "missing.yaml"))
    assert load_card("videoseal")["args"]["nbits"] == 256


# -- process_sab --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 48, 16, 16), (150, 225, 64, 64), (37, 53, 100, 80),
                                   (64, 64, 64, 30)])
def test_resize_bicubic_pil_matches_pillow(shape):
    from PIL import Image

    from videoseal_tpu_torch.ops.resize import resize_bicubic_pil
    h, w, oh, ow = shape
    rng = np.random.default_rng(h * w)
    a = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    got = resize_bicubic_pil(torch.from_numpy(a), oh, ow).numpy()
    for i in range(2):
        want = np.asarray(Image.fromarray(a[i]).resize((ow, oh)))
        assert np.array_equal(got[i], want)
    grey = rng.integers(0, 256, (h, w, 1), np.uint8)
    want = np.asarray(Image.fromarray(grey[..., 0]).resize((ow, oh)))
    assert np.array_equal(resize_bicubic_pil(torch.from_numpy(grey), oh, ow).numpy()[..., 0],
                          want)


def test_process_sab_matches_jax(tmp_path):
    from videoseal_tpu.scripts import process_sab as jax_sab
    from videoseal_tpu_torch.scripts import process_sab
    files = [f"{i:04d}.jpg" for i in range(11)]
    assert process_sab.split_files(files, 2, 3) == jax_sab.split_files(files, 2, 3)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:60, 0:90]
    for i in range(3):      # the held-out splits: copied as they are
        cv2.imwrite(str(src / f"a{i}.jpg"), rng.integers(0, 255, (40, 56, 3), np.uint8))
    for i in range(5):      # the train split: smooth and noisy content, two shapes
        img = np.stack([yy * 2 + i * 9, xx * 3, (xx + yy) % 256], -1) \
            + rng.integers(0, 30, (60, 90, 3))
        if i % 2:
            img = img[:48, :64]
        cv2.imwrite(str(src / f"b{i}.png"), np.clip(img, 0, 255).astype(np.uint8))
    flags = ["--size", "24", "--num_test", "2", "--num_val", "1", "--num_shards", "2"]
    for shard in range(2):
        jax_sab.main([str(src), str(tmp_path / "jax"), *flags, "--shard", str(shard)])
        process_sab.main([str(src), str(tmp_path / "port"), *flags, "--shard", str(shard),
                          "--device", "cpu", "--workers", str(shard * 2)])
    for split, names in (("test", ["a0.jpg", "a1.jpg"]), ("val", ["a2.jpg"]),
                         ("train", [f"b{i}.png" for i in range(5)])):
        assert sorted(os.listdir(tmp_path / "jax" / split)) == names
        assert sorted(os.listdir(tmp_path / "port" / split)) == names
    for split, name in (("test", "a0.jpg"), ("test", "a1.jpg"), ("val", "a2.jpg")):
        got = (tmp_path / "port" / split / name).read_bytes()
        assert got == (src / name).read_bytes() == (tmp_path / "jax" / split / name).read_bytes()
    for i in range(5):
        want = cv2.imread(str(tmp_path / "jax" / "train" / f"b{i}.png"), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(tmp_path / "port" / "train" / f"b{i}.png"), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape == (24, 24, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_process_sab_defaults_to_the_card(tmp_path, monkeypatch):
    from videoseal_tpu_torch.scripts import process_sab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        process_sab.main([str(tmp_path), str(tmp_path / "dst")])


# -- examples and notebooks ---------------------------------------------------------------

def test_image_example(card_file, tmp_path):
    from videoseal_tpu_torch.examples import image_watermarking
    image = str(tmp_path / "in.png")
    cv2.imwrite(image, np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8))
    out_dir = tmp_path / "out"
    res = image_watermarking.main(["--card", card_file, "--device", "cpu", "--image", image,
                                   "--out_dir", str(out_dir)])
    assert np.isfinite(res["psnr"]) and set(res["bit_acc"]) == {"clean", "jpeg50"}
    assert sorted(os.listdir(out_dir)) == ["difference_x10.png", "original.png",
                                           "watermarked.png"]


def test_video_example(card_file, tmp_path):
    from videoseal_tpu_torch import native
    from videoseal_tpu_torch.examples import video_watermarking
    from videoseal_tpu_torch.inference_streaming import open_writer
    clip, out = str(tmp_path / "in.mp4"), str(tmp_path / "v.mp4")
    wr = open_writer(clip, 96, 64, 24)
    try:
        wr.write(np.random.default_rng(0).integers(0, 256, (8, 64, 96, 3), np.uint8))
    finally:
        wr.close()
    res = video_watermarking.main(["--card", card_file, "--device", "cpu", "--frames", "8",
                                   "--input", clip, "--out", out])
    assert res["frames"] == 8 and np.isfinite(res["psnr"]) and 0 <= res["bit_acc"] <= 1
    assert res["codec"] == ("h264" if native.available() else "mpeg4")
    assert os.path.getsize(out) > 0


# each notebook's first code cell's names, overridden for a tiny CPU run
NB_OVERRIDES = {
    "image_inference": {"img_size": 64},
    "video_inference": {"n_frames": 6, "size": 64},
    "video_inference_streaming": {"n_frames": 12, "height": 64, "width": 96},
    "av_inference": {"n_frames": 12, "height": 64, "width": 96},
}


@pytest.mark.parametrize("name", sorted(NB_OVERRIDES))
def test_notebook_runs(name, card_file, tmp_path, monkeypatch):
    with open(os.path.join(NOTEBOOKS, name + ".ipynb")) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    first = "".join(cells[0]["source"])
    assert 'device = "cuda"' in first
    monkeypatch.chdir(tmp_path)
    ns: dict = {"__name__": "__main__"}
    exec(compile(first, f"{name}[0]", "exec"), ns)
    for k in NB_OVERRIDES[name]:
        assert k in ns, k
    ns.update(device="cpu", card=card_file, out_dir=str(tmp_path / "out"), **NB_OVERRIDES[name])
    for i, cell in enumerate(cells[1:], 1):
        exec(compile("".join(cell["source"]), f"{name}[{i}]", "exec"), ns)
    assert os.listdir(tmp_path / "out")
    assert ns["model"].device.type == "cpu"
    if name == "av_inference":
        assert ns["info"]["frames"] == 12
        assert ns["info"]["route"] == ("native" if ns["native"].available() else "cv2")
        assert ns["info"]["audio"] == ns["native"].available()
    shutil.rmtree(tmp_path / "out")
