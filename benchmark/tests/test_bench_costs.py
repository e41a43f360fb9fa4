"""The yardstick's arithmetic against values worked by hand."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import costs
from benchmark.reference import nets
from benchmark.tests import tiny


def test_bound_takes_the_larger_time():
    assert costs.bound(3.35e9) == pytest.approx((1.0, "bytes"))
    assert costs.bound(0, f32_ops=67e9) == pytest.approx((1.0, "operations"))
    assert costs.bound(3.35e9, f32_ops=2 * 67e9, bf16_ops=989e9) == pytest.approx(
        (2.0, "operations"))


def test_taps():
    # 1080 -> 256 antialiased: a triangle 4.22 rows wide each side, 9 rows;
    # 1920 -> 256: 7.5 each side, 15; 256 -> 1080: 2 taps
    assert costs.taps(costs.resize_matrix_np(256, 1080)) == 2
    assert costs.taps(costs.resize_matrix_np(1080, 256)) == 9
    assert costs.taps(costs.resize_matrix_np(1920, 256)) == 15
    assert costs.taps(costs.resize_matrix_np(1080, 1080), 2) == 2


def test_k1_cost_at_1080p():
    # F=1, 1080x1920 lowres with a 256 detect: 12 tiles of 96 rows, rows of 1920;
    # lift 2 taps, width 2: (2 (2 2 + 2) + 12) a pixel; detect taps 15 wide, 9 high
    nbytes, ops = costs.k1_cost(1, 1080, 1920, 256, True, 256)
    px = 1152 * 1920
    assert nbytes == 2 * 3 * px + 256 * 256 * 4 + 3 * 256 * 256 * 4
    assert ops == px * (2 * (2 * 2 + 2) + 12) + 3 * 1152 * 256 * 2 * 15 + 3 * 256 * 256 * 2 * 9


def test_k4_cost_at_1080p():
    nbytes, ops = costs.k4_cost(1, 1080, 1920, 256)
    px = 1080 * 1920
    assert nbytes == 6 * px + 256 * 256 * 4
    assert ops == px * (85 + 2 * (2 * 2 + 2) + 2) + 12 * px


def test_block_cost_one_block():
    nbytes, bf16_ops, f32_ops = costs.block_cost(2, 3, 16, frames=1)
    px = 6
    assert nbytes == 2 * px * 16 * 2 + 49 * 16 * 4 + 2 * 4 * 16 * 16 * 2 + 15 * 16 * 4
    assert bf16_ops == 2 * 2 * px * 16 * 64
    assert f32_ops == px * 16 * 108 + px * 64 * 12


def test_stage_shapes_of_the_cards():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "configs", "chunkyseal.json")) as f:
        chunky = json.load(f)["card"]
    with open(os.path.join(here, "configs", "videoseal_1.0.json")) as f:
        vs1 = json.load(f)["card"]
    assert nets.stage_shapes(vs1) == [(3, 64, 64, 96), (3, 32, 32, 192), (9, 16, 16, 384),
                                      (3, 8, 8, 768)]
    assert nets.stage_shapes(chunky) == [(3, 127, 127, 362), (3, 63, 63, 724),
                                         (27, 31, 31, 1448), (3, 15, 15, 2896)]


def test_model_flops_of_a_tiny_extractor():
    """The count of a tiny ConvNeXt by hand: 2 FLOPs a multiply-add of every
    convolution and dense layer."""
    card = tiny.config("tiny_vs")["card"]
    got = costs.model_flops(card, detect_frames=2)
    n, want = 2, 0
    (d0, h0, _, c0), *_ = stages = nets.stage_shapes(card)
    want += 2 * n * h0 * h0 * c0 * 3 * 16          # 4x4 stem
    prev = None
    for depth, h, _, c in stages:
        if prev:
            want += 2 * n * h * h * c * prev * 4   # 2x2 downsample
        want += depth * 2 * n * h * h * (49 * c + 2 * 4 * c * c)
        prev = c
    hl, cl = stages[-1][1], stages[-1][3]
    want += 2 * n * hl * hl * cl * cl * 9 + 2 * n * cl * (card["args"]["nbits"] + 1)
    assert got == want
