"""The COCO-mask and video-clip datasets, the RLE decoder, the evals' sample
iterator, the in-training eval's video rows and the video training path,
against the JAX package on files the tests write (cv2 writes mp4v clips).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _jax_mods
from torch_port import LOGIT_ATOL, port_train_mods, train_weights

torch.set_num_threads(4)


def _encode_rle(mask: np.ndarray) -> str:
    """COCO's compressed RLE of an (h, w) {0, 1} mask (the encoder of
    pycocotools' maskApi, column-major runs starting with 0s)."""
    flat = mask.T.reshape(-1)
    counts, val, run = [], 0, 0
    for v in flat:
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    counts.append(run)
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def _runs(mask: np.ndarray) -> list:
    flat, counts, val, run = mask.T.reshape(-1), [], 0, 0
    for v in flat:
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    return counts + [run]


@pytest.fixture(scope="module")
def masks():
    rng = np.random.default_rng(0)
    m = np.zeros((37, 53), np.uint8)
    m[5:20, 8:40] = 1
    m[25:30, 1:3] = 1
    m |= (rng.uniform(size=m.shape) < 0.05).astype(np.uint8)
    return m


@pytest.mark.parametrize("kind", ["polygons", "rle_list", "rle_string"])
def test_rle_matches_jax(masks, kind):
    from videoseal_tpu.utils import rle as J
    from videoseal_tpu_torch.utils import rle as P
    h, w = masks.shape
    if kind == "polygons":
        seg = [[3, 4, 40, 6, 30, 30, 5, 25], [45.5, 2, 52, 2, 50, 20.7]]
    elif kind == "rle_list":
        seg = {"counts": _runs(masks), "size": [h, w]}
    else:
        seg = {"counts": _encode_rle(masks), "size": [h, w]}
    got = P.segmentation_to_mask(seg, h, w)
    assert np.array_equal(got, J.segmentation_to_mask(seg, h, w))
    if kind != "polygons":
        assert np.array_equal(got, masks)
    else:
        assert got.sum() > 100 and got.max() == 1


def _write_images(d, n, rng, hw=(60, 80)):
    import cv2
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"im{i}.png"),
                    rng.integers(0, 256, (hw[0] + 4 * i, hw[1], 3), dtype=np.uint8))


def write_clips(d, n=2, f=24, h=64, w=96, seed=0):
    """n mp4v clips of f frames (a random image drifting sideways)."""
    import cv2
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        vw = cv2.VideoWriter(os.path.join(d, f"c{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                             24, (w, h))
        base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for t in range(f):
            vw.write(np.roll(base, 2 * t, axis=1))
        vw.release()


def test_coco_masks_dataset_matches_jax(tmp_path, masks):
    from videoseal_tpu.data.datasets import CocoMasksDataset as J
    from videoseal_tpu_torch.data.datasets import CocoMasksDataset as P
    rng = np.random.default_rng(1)
    _write_images(str(tmp_path), 3, rng, hw=(37, 53))
    h, w = masks.shape
    anns = [{"image_id": 0, "segmentation": [[3, 4, 40, 6, 30, 30, 5, 25]]},
            {"image_id": 0, "segmentation": {"counts": _runs(masks), "size": [h, w]}},
            {"image_id": 2, "segmentation": {"counts": _encode_rle(masks[:, ::-1].copy()),
                                             "size": [h + 8, w]}},
            {"image_id": 2, "segmentation": [[1, 1, 20, 1, 20, 20]]},
            {"image_id": 2, "segmentation": [[30, 30, 50, 30, 50, 40]]}]
    coco = {"images": [{"id": i, "file_name": f"im{i}.png"} for i in range(3)],
            "annotations": anns}
    ann = str(tmp_path / "ann.json")
    with open(ann, "w") as f:
        json.dump(coco, f)
    for kw in ({}, {"max_objects": 2, "seed": 3}):
        j, p = J(str(tmp_path), ann, img_size=32, **kw), P(str(tmp_path), ann, img_size=32, **kw)
        assert len(p) == len(j) == 2
        for i in range(2):
            for a, b in zip(j[i], p[i]):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_video_clip_dataset_matches_jax(tmp_path):
    from videoseal_tpu.data.datasets import VideoClipDataset as J
    from videoseal_tpu_torch.data.datasets import LRUDict
    from videoseal_tpu_torch.data.datasets import VideoClipDataset as P
    write_clips(str(tmp_path))
    for kw in ({"frames_per_clip": 8}, {"frames_per_clip": 4, "frame_step": 2, "num_clips": 3}):
        j = J(str(tmp_path), img_size=48, seed=2, **kw)
        p = P(str(tmp_path), img_size=48, seed=2, max_open=1, **kw)
        assert len(p) == len(j)
        for i in list(range(len(p))) + [0, 3]:       # the cache closes and reopens
            a, b = j[i], p[i]
            assert a[0].shape == b[0].shape == (kw["frames_per_clip"], 48, 48, 3)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    lru = LRUDict(2)
    closed = []

    class H:
        def __init__(self, k):
            self.k = k

        def release(self):
            closed.append(self.k)

    for k in ("a", "b", "a", "c"):
        lru.get_or(k, lambda k=k: H(k))
    assert list(lru) == ["a", "c"] and closed == ["b"]


@pytest.mark.parametrize("is_video", [False, True])
def test_iter_samples_matches_jax(tmp_path, is_video):
    from videoseal_tpu.data.datasets import iter_samples as J
    from videoseal_tpu_torch.data.datasets import iter_samples as P
    if is_video:
        write_clips(str(tmp_path), n=1, f=40)
    else:
        _write_images(str(tmp_path), 6, np.random.default_rng(2))
    got = list(P(str(tmp_path), is_video=is_video, img_size=32))
    want = list(J(str(tmp_path), is_video=is_video, img_size=32))
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def test_intrain_eval_video_rows_match_jax():
    """The in-training eval's video rows (two clips of 4 frames, the
    identity grid) against JAX's make_intrain_eval(is_video=True) on the
    same state, clips and messages; the subset video grid's rows (the codec
    row on the proxy, as JAX's in-training eval runs it) by name."""
    from videoseal_tpu.evals.intrain import make_intrain_eval as jax_eval
    from videoseal_tpu.parallel.trainer import TrainState
    from videoseal_tpu_torch.evals.intrain import make_intrain_eval
    ev, xv, dv = train_weights()
    jmods = _jax_mods(False)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), embedder_params=ev["params"],
                        embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
                        disc_params=dv["params"], opt_state_g=None, opt_state_d=None,
                        scaling_w=jnp.float32(0.2))
    clips = np.random.default_rng(12).uniform(0, 1, (2, 4, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want, jimgs_w = jax_eval(jmods, eval_augs="identity", is_video=True)(jstate, clips, key)
    msgs = np.asarray(jax.random.randint(key, (2, 8), 0, 2))
    mods, state = port_train_mods((ev, xv, dv), False)
    got, imgs_w = make_intrain_eval(mods, eval_augs="identity", is_video=True)(
        state, clips, torch.Generator(), msgs=torch.from_numpy(msgs.astype(np.int64)))
    assert set(got) == set(want) and tuple(imgs_w.shape) == clips.shape
    np.testing.assert_allclose(imgs_w.numpy(), np.asarray(jimgs_w), atol=1e-6)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    jlogits = np.asarray(jmods.extractor.apply({"params": xv["params"]},
                                               jnp.asarray(jimgs_w).reshape(8, 64, 64, 3)))
    unsure = float((np.abs(jlogits[:, 1:]) < LOGIT_ATOL).mean())
    assert abs(got["bit_acc_identity_0"] - want["bit_acc_identity_0"]) <= unsure
    sub, _ = make_intrain_eval(mods, eval_augs="subset", is_video=True)(
        state, clips, torch.Generator().manual_seed(0))
    assert set(sub) == {"psnr", "ssim", "bit_acc_identity_0", "bit_acc_crop_0.71",
                        "bit_acc_brightness_1.5", "bit_acc_h264_30"}
    assert all(np.isfinite(v) for v in sub.values())


def test_train_main_video_dataset(tmp_path):
    """--video_dataset: the clip loader, the video step and the eval's
    video rows, on the CPU."""
    from videoseal_tpu_torch import train
    write_clips(str(tmp_path / "clips"))
    out = str(tmp_path / "run")
    state, _, step_ms = train.main([
        "--device", "cpu", "--tiny", "1", "--img_size", "64", "--video_dataset",
        str(tmp_path / "clips"), "--frames_per_clip", "4", "--batch_size_video", "1",
        "--steps", "2", "--iter_per_epoch", "2", "--eval_freq", "1", "--eval_samples", "4",
        "--output_dir", out])
    assert state.step == 2 and len(step_ms) == 2
    rows = [json.loads(ln) for ln in open(os.path.join(out, "eval.jsonl"))]
    assert [r["modality"] for r in rows] == ["vid"]
    assert "vid_bit_acc_identity_0" in rows[0] and np.isfinite(rows[0]["vid_psnr"])


def test_evals_full_dataset(tmp_path):
    """evals.full --dataset over a folder of PNGs, through iter_samples."""
    import videoseal_tpu_torch as vt
    from torch_port import tiny_preset_card
    from videoseal_tpu_torch.evals import full
    _write_images(str(tmp_path / "imgs"), 5, np.random.default_rng(3), hw=(64, 64))
    card, args = tiny_preset_card()
    ckpt = str(tmp_path / "m.npz")
    vt.save_npz(ckpt, vt.VideoSeal.from_card(card, device="cpu"), args=args)
    rows = full.main(["--card", ckpt, "--dataset", str(tmp_path / "imgs"), "--device", "cpu",
                      "--only_identity", "1", "--num_samples", "5", "--output_dir",
                      str(tmp_path / "out")])
    # 5 images in batches of 4: two samples, one identity row each
    assert [r["sample"] for r in rows] == [0, 1]
    assert os.path.exists(tmp_path / "out" / "metrics.csv")
