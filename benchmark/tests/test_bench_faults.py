"""A whole run of a tiny cell on the CPU, past the harness's look for a
card: sound, it comes out correct; with the timed path broken underneath
(a step that returns its state unchanged, half of the clip left out, a
frame's answer altered where it is produced) or with the control (the
reference with fp8 operands) in the program's place, it comes out not
correct. One chip serves every cell, so no exchange between chips can be
left out."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny
from videoseal_tpu_torch.models import videoseal as vsm


def _run(key: str, seed: int = 21):
    workload, config = tiny.cell(key)
    return harness.run_cell(workload, config, seed, 0.3, False, "cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("key", sorted(tiny.CELLS))
def test_sound_run_is_correct(key):
    run = _run(key)
    assert run.correct, run.readings
    assert run.attempted == len(run.spans) > 0 and run.failed == 0




FAULTS = {
    # a step that returns its state unchanged: the blend adds nothing
    "planar-unchanged": ("planar", "fused_jnd_blend_planar",
                         lambda f: lambda imgs_p, pred, *a, **k: f(imgs_p, pred * 0, *a, **k)),
    "embed-unchanged": ("embed", "fused_jnd_blend_up",
                        lambda f: lambda imgs, pred, *a, **k: f(imgs, pred * 0, *a, **k)),
    # (the 3-channel card's prediction is zeroed where it is upsampled)
    "embed3-unchanged": ("embed3", "resize_bilinear",
                         lambda f: lambda x, oh, ow, **k: f(x, oh, ow, **k) * (
                             0 if oh > x.shape[-3] else 1)),
    # half of the clip left out: the second half's predictions dropped
    "planar-half": ("planar", "_expand_video_mode",
                    lambda f: lambda p, n, *a: _half(f(p, n, *a))),
    "embed-half": ("embed", "_expand_video_mode", lambda f: lambda p, n, *a: _half(f(p, n, *a))),
    # the extractor over half the clip, the rest its mean
    "detect-half": ("detect", "_detect_resized", lambda f: lambda e, c, x: _half_mean(f(e, c, x))),
    "planar-detect-half": ("planar", "_detect_resized",
                           lambda f: lambda e, c, x: _half_mean(f(e, c, x))),
    # one frame's answer altered where it is produced
    "detect-altered": ("detect", "_detect_resized", lambda f: lambda e, c, x: _alter(f(e, c, x))),
    "planar-altered": ("planar", "fused_jnd_blend_planar",
                       lambda f: lambda *a, **k: _alter_frame(f(*a, **k))),
    "embed-altered": ("embed", "fused_jnd_blend_up", lambda f: lambda *a, **k: _alter(f(*a, **k))),
}


def _half(p):
    p = p.clone()
    p[p.shape[0] // 2:] = 0
    return p


def _half_mean(logits):
    out = logits.clone()
    out[out.shape[0] // 2:] = logits[:out.shape[0] // 2].mean(dim=0)
    return out


def _alter(t):
    t = t.clone()
    t[-1] = t[-1] + 8 if t.dtype == torch.uint8 else t[-1] + 1.0
    return t


def _alter_frame(out):
    if isinstance(out, tuple):
        return (_alter(out[0]),) + tuple(out[1:])
    return _alter(out)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    key, name, wrap = FAULTS[fault]
    monkeypatch.setattr(vsm, name, wrap(getattr(vsm, name)))
    run = _run(key)
    assert not run.correct, run.readings


@pytest.mark.parametrize("key", ["planar", "detect", "embed"])
def test_control_is_not_correct(key):
    """The control at test size on three seeds: none passes the limits.
    (The 3-channel tiny embed's UNet, 4 channels wide, reads its control as
    low as 2.3x its program: its cell at full width is held on the card.)"""
    workload, config = tiny.cell(key)
    for seed in (1, 2, 3):
        readings = control.control_readings(workload, config, seed, "cpu")
        assert not harness.passes(readings, workload["limits"]), (seed, readings)
