"""Time K2 at videoseal_1.0's four stage shapes for checkouts of the
repository in turns, on one card.

    python -m videoseal_tpu_torch.kernels.k2_turns ROOT_A ROOT_B [--order ABBA]

Each turn runs in a process of its own that imports ``videoseal_tpu_torch``
from its checkout (the kernels built in that checkout at its first turn and
reused at a later one), times ``convnext_block_fused`` on 32 bf16 frames at
each of 64x64x96, 32x32x192, 16x16x384 and 8x8x768 (CUDA events, 10 calls
after a warm-up, three times) on blocks made from the same seed, and prints
one JSON line: the checkout, each stage's times and the 18 blocks of one
32-frame chunk (3, 3, 9 and 3 blocks a stage, each at its stage's least
time). The parent's code and the change's compare only within one such call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

STAGES = [(64, 64, 96), (32, 32, 192), (16, 16, 384), (8, 8, 768)]
DEPTHS = (3, 3, 9, 3)

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from videoseal_tpu_torch.kernels import convnext_block as cb
from videoseal_tpu_torch.models.videoseal import init_weights
from videoseal_tpu_torch.modules.convnext import ConvNeXtBlock
from videoseal_tpu_torch.utils.timing import cuda_ms
stages, depths = json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {"root": sys.argv[1], "stages": {}, "chunk_ms": 0.0}
dev = torch.device("cuda", 0)
for i, (h, w, c) in enumerate(stages):
    g = torch.Generator().manual_seed(i)
    blk = ConvNeXtBlock(c)
    init_weights(blk, g)
    with torch.no_grad():
        for t in (blk.grn.gamma, blk.grn.beta, blk.norm.bias):
            t.normal_(0.0, 0.3, generator=g)
    p = cb.kernel_params(blk.to(dev, torch.bfloat16))
    x = torch.randn((32, h, w, c), generator=g).to(dev, torch.bfloat16)
    ms = [cuda_ms(lambda: cb.convnext_block_fused(x, p), reps=10) for _ in range(3)]
    out["stages"][f"32x{h}x{w}x{c}"] = ms
    out["chunk_ms"] += depths[i] * min(ms)
print(json.dumps(out))
"""


def run_turn(root: str) -> dict:
    """One turn: K2 timed in a process importing the port from `root`."""
    res = subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(root),
                          json.dumps(STAGES), json.dumps(DEPTHS)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"K2 turn in {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2, help="checkouts A and B")
    ap.add_argument("--order", default="ABBA", help="the turns, as letters A and B")
    args = ap.parse_args(argv)
    turns = []
    for letter in args.order:
        rec = run_turn(args.roots["AB".index(letter)]) | {"turn": letter}
        print(json.dumps(rec), flush=True)
        turns.append(rec)
    return turns


if __name__ == "__main__":
    main()
