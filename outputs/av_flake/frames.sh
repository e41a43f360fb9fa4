#!/bin/bash
# frames_probe.py N times, each in a fresh process: one JSON line a run (the
# pre-encode frames' and the decoded files' distance between the two
# packages, and the encoder against itself). Run from the repository's root:
#
#   outputs/av_flake/frames.sh [N=20] > outputs/av_flake/frames_log.txt
set -u
N=${1:-20}
for i in $(seq 1 "$N"); do
    echo "$i $(JAX_PLATFORMS=cpu python outputs/av_flake/frames_probe.py 2>/dev/null | tail -n 1)"
done
