"""BENCHMARK.json and the files the harness finds by name."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.manifest()


def test_names_and_units():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


def test_cells_name_their_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = harness.load_workload(w["name"])
        assert cell["config"] == w["config"] and cell["entry"] == w["traffic"]
        assert w["config"] in configs
        with open(os.path.join(harness.ROOT, configs[w["config"]]["file"])) as f:
            assert json.load(f)["name"] == w["config"]
        tm = harness.traffic(cell["entry"])
        for fn in ("inputs", "call", "finish", "keep", "ref_key", "reference", "as_kept",
                   "compare", "flops"):
            assert callable(getattr(tm, fn))
        assert cell["why"] == w["why"]


def test_metrics_have_readers_and_their_cells_report_what_they_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        names = [m["name"] for m in harness.metrics_of(cell, SPEC["end_to_end"])]
        assert "setup_s" in names and len(names) >= 2
        assert harness.metrics_of(cell, SPEC["per_layer"])


def test_a_new_cell_is_found_by_name(tmp_path):
    """A workload file dropped into a copy of benchmark/workloads/ is found
    by its name with no code edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = copy / "benchmark" / "workloads" / "vs1.scored.planar1080.c128.json"
    cell = dict(json.loads(src.read_text()), frames=32, why="a cell added as data alone")
    (src.parent / "vs1.scored.planar1080.c32.json").write_text(json.dumps(cell))
    code = ("from benchmark import harness; w = harness.load_workload('vs1.scored.planar1080.c32'); "
            "print(w['frames'], harness.traffic(w['entry']).__name__, harness.BENCH_DIR)")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                         check=True).stdout.split()
    assert out == ["32", "benchmark.traffic.embed_detect_planar", str(copy / "benchmark")]


def _cli(cwd) -> subprocess.CompletedProcess:
    cmd = SPEC["command"] + ["--workload", SPEC["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
                             "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_a_card():
    out = _cli(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
