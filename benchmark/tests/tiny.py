"""Tiny cells for the CPU tests: the two cards' structure at small widths
(tests/data/tiny_*.json), 72x128 frames, short windows."""

from __future__ import annotations

import json
import os

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# (entry, config, lowres, frames, limits): limits between the tiny cells'
# bf16 program readings on the CPU (frame gap 0.005-0.016, logit gap
# 0.004-0.009) and their controls' (0.07-0.17, except the 3-channel embed's)
CELLS = {
    "planar": ("embed_detect_planar", "tiny_vs", True, 8,
               {"frame_gap_lsb": 0.04, "logit_gap": 0.03}),
    "detect": ("detect", "tiny_chunky", False, 4, {"logit_gap": 0.03}),
    "embed": ("embed", "tiny_vs", False, 8, {"frame_gap_lsb": 0.04}),
    "embed3": ("embed", "tiny_chunky", False, 16, {"frame_gap_lsb": 0.04}),
}


def config(name: str) -> dict:
    with open(os.path.join(DATA, f"{name}.json")) as f:
        return json.load(f)


def cell(key: str) -> tuple[dict, dict]:
    entry, cfg, lowres, frames, limits = CELLS[key]
    workload = dict(name=f"tiny.{key}", config=cfg, entry=entry, frames=frames, lowres=lowres,
                    height=72, width=128, pool=2, messages=64, warmup=1, samples=2,
                    trace_seconds=0.3, limits=limits)
    return workload, config(cfg)
