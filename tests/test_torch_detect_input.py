"""`evals/detect_input.py` on the CPU at the tiny card: the planar path's
two detect inputs (K1's in-kernel downscale, here its plain version, and
the separate planar resize) after one embed, on a train state written by
`train.main` and at random init.
"""

import os

import numpy as np
import pytest
import torch

from torch_port import LOGIT_ATOL, tiny_card


def test_smooth_frames():
    from videoseal_tpu_torch.evals.detect_input import smooth_frames
    a, b = smooth_frames(3, 20, 36, 0), smooth_frames(3, 20, 36, 0)
    assert a.dtype == np.uint8 and a.shape == (3, 20, 36, 3) and np.array_equal(a, b)
    assert not np.array_equal(a, smooth_frames(3, 20, 36, 1))
    # 8x8 blocks of one colour under N(0, 6) noise: neighbours within a block
    # differ by the noise only
    assert np.abs(np.diff(a[:, :8, :8].astype(int), axis=2)).mean() < 12


def test_run_on_random_init():
    from videoseal_tpu_torch import VideoSeal
    from videoseal_tpu_torch.evals.detect_input import run, smooth_frames
    model = VideoSeal.from_card(tiny_card(img_size=128), device="cpu").with_dtype("bfloat16")
    rows = run(model, smooth_frames(3, 72, 96, 0))
    fused, separate, delta = rows
    assert fused["detect_input"].startswith("fused") and separate["detect_input"].startswith(
        "separate")
    assert fused["psnr"] == separate["psnr"] and delta["imgs_w_equal"]
    # the two inputs differ by the bf16 rounding of the downscale
    assert delta["logits_max_abs_diff"] <= LOGIT_ATOL
    for r in (fused, separate):
        assert 0.0 <= r["bit_acc_per_frame"] <= 1.0 and r["nbits"] == 16


def test_main_on_a_train_state(tmp_path):
    """train.main's checkpoint (the tiny card at 128 px) loaded as main loads
    it, through tools/eval_checkpoint.load_trained_model with scaling_w 1."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.evals.detect_input import run, smooth_frames
    from videoseal_tpu_torch.tools.eval_checkpoint import load_trained_model
    out = str(tmp_path / "run")
    train.main(["--device", "cpu", "--tiny", "1", "--synthetic", "1", "--steps", "1",
                "--batch_size", "2", "--img_size", "128", "--eval_freq", "0",
                "--augmentation_config", "augs_identity", "--output_dir", out])
    model = load_trained_model(os.path.join(out, "checkpoint.npz"), train.TINY_CARD, 16, 128,
                               scaling_w=1.0, device="cpu").with_dtype("bfloat16")
    rows = run(model, smooth_frames(2, 64, 96, 0))
    assert rows[-1]["imgs_w_equal"] and rows[-1]["logits_max_abs_diff"] <= LOGIT_ATOL
    assert [r["nbits"] for r in rows[:2]] == [16, 16]


def test_default_device_is_the_card(monkeypatch):
    from videoseal_tpu_torch.evals import detect_input
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        detect_input.main([])
