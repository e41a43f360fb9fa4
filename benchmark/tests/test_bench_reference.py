"""The plain float32 reference (benchmark/reference/) against the port's
CPU path, its kernels' plain versions, in float32 on seeded weights: at
tiny widths for both cards' structure and at videoseal_1.0's published
widths on a few small frames. On the card, against the port's bf16
serving path at a small size (marked `card`)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import checks, harness, program, weights
from benchmark.reference import nets, pipelines
from benchmark.tests import tiny

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def _port_f32(card: dict, seed: int):
    """The port in float32 on the CPU, loaded with the benchmark's weights."""
    sd = weights.draw(program.state_shapes(card), seed, "cpu", torch.float32)
    model = program._meta_model(card)
    for m in (model.embedder, model.extractor):
        m.to_empty(device="cpu")
    model.load_state_dict(sd)
    return model, sd


def _frames(n: int, h: int, w: int, seed: int) -> torch.Tensor:
    return checks.draw_frames(n, h, w, torch.Generator().manual_seed(seed), "cpu")


def _hold(card: dict, seed: int, n: int, h: int, w: int):
    model, sd = _port_f32(card, seed)
    frames = _frames(n, h, w, seed + 1)
    msg = torch.randint(0, 2, (1, card["args"]["nbits"]), generator=torch.Generator().manual_seed(seed))
    for lowres in (False, True):
        out = model.embed(frames, msgs=msg, is_video=True, lowres_attenuation=lowres)["imgs_w"]
        ref = pipelines.embed_video(sd, card, frames, msg[0], lowres)
        d = (out.int() - ref.int()).abs()
        # float32 both sides: the u8 outputs agree but for a rounding tie now and then
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3, lowres
        assert (ref.int() - frames.int()).abs().float().mean() > 0.05   # a watermark is there
    logits = model.detect(out, is_video=True)["preds"]
    # the port's ConvNeXt blocks round to bf16 inside, as the TPU kernel does
    assert checks.logit_gap(logits, pipelines.detect(sd, card, out)) < 0.02


@pytest.mark.parametrize("name", ["tiny_vs", "tiny_chunky"])
def test_reference_matches_port_tiny(name):
    _hold(tiny.config(name)["card"], 5, 8, 72, 128)


def test_reference_matches_port_videoseal_1_0():
    with open(os.path.join(CONFIGS, "videoseal_1.0.json")) as f:
        card = json.load(f)["card"]
    _hold(card, 7, 4, 72, 128)


def test_reference_planar_matches_nhwc():
    """The planar entry's reference reads the clip out of the padded buffer
    the harness packs: the same frames as the NHWC clip."""
    workload, config = tiny.cell("planar")
    tm = harness.traffic("embed_detect_planar")
    clip = tm.inputs(workload, config["card"], torch.Generator().manual_seed(3), "cpu")
    nhwc = tm.nhwc(clip, workload)
    assert nhwc.shape == (8, 72, 128, 3)
    assert int(clip.sum()) == int(nhwc.long().sum())   # nothing outside the image


def test_fp8_ops_round_to_e4m3():
    t = torch.tensor([1.0, 1.06, 448.0, -3.3])
    q = nets.Fp8Ops().prep(t)
    assert torch.equal(q, torch.tensor([1.0, 1.0, 448.0, -3.25]))


@pytest.mark.card
def test_reference_matches_port_on_card():
    """A tiny planar cell run on the card: its bf16 serving path against the
    reference (the check of a benchmark run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    workload, config = tiny.cell("planar")
    run = harness.run_cell(workload, config, 11, 0.5, False, torch.device("cuda", 0))
    assert run.correct, run.readings
