#!/bin/bash
# tests/test_torch_audio_av.py::test_embed_av_matches_jax, N times at each of
# two checkouts, alternately, each time in a fresh pytest process: the
# checkout to compare against (a directory made with `git archive`) and the
# working tree. One line per run: the round, the tree, passed or failed,
# and the failing assertion's message. Run from the repository's root:
#
#   outputs/av_flake/run.sh <other checkout> [N=10] > outputs/av_flake/log.txt
set -u
OTHER=$1
N=${2:-10}
T=tests/test_torch_audio_av.py::test_embed_av_matches_jax
for i in $(seq 1 "$N"); do
    for tree in "$OTHER" .; do
        label=$([ "$tree" = . ] && echo working_tree || echo other)
        out=$(cd "$tree" && JAX_PLATFORMS=cpu python -m pytest "$T" -q -p no:cacheprovider 2>&1)
        if echo "$out" | grep -q "1 passed"; then
            echo "$i $label passed"
        else
            echo "$i $label failed: $(echo "$out" | grep -m1 -E '^E +(Assertion|assert)')"
        fi
    done
done
