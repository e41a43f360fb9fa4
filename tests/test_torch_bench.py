"""The port's scorer, ``python -m videoseal_tpu_torch.bench``, on the CPU
at a small size on a tiny card file: its JSON line has root bench.py's
keys (read from bench.py's source) less ``vs_baseline``, with bench.py's
types; it draws bench.py's frames; it times one warm-up call and then
``repeats`` windows of max(runs, 4) calls; without a card it raises unless
--device cpu is given.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from torch_port import tiny_card

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--frames", "2", "--height", "64", "--width", "96",
         "--runs", "1", "--repeats", "2"]


@pytest.fixture(scope="module")
def card_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("card") / "tiny.json")
    with open(path, "w") as f:
        json.dump(tiny_card(img_size=128), f)     # 128: the fused detect input's multiple
    return path


def _bench_keys() -> tuple[set, set]:
    """(the keys of root bench.py's result dict literal, the string
    constants its source names)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    keys, consts = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == "result" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            consts.add(node.value)
    return keys, consts


def _check_types(line: dict, repeats: int) -> None:
    assert isinstance(line["metric"], str) and isinstance(line["unit"], str)
    assert isinstance(line["value"], float) and line["value"] > 0
    assert isinstance(line["spread_pct"], float) and line["spread_pct"] >= 0
    runs = line["runs"]
    assert isinstance(runs, list) and len(runs) == repeats
    assert all(isinstance(r, float) for r in runs) and runs == sorted(runs)


@pytest.mark.parametrize("lowres", [1, 0])
def test_planar_line(card_file, capsys, lowres):
    from videoseal_tpu_torch import bench
    line = bench.main(SMALL + ["--card", card_file, "--lowres_attenuation", str(lowres)])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    keys, consts = _bench_keys()
    mode, other = (("lowres_attenuation", "fullres_jnd") if lowres
                   else ("fullres_jnd", "lowres_attenuation"))
    want = (keys - {"vs_baseline"}) | {"mode", f"{other}_fps", f"{other}_runs"}
    assert "vs_baseline" in keys and {mode, f"{other}_fps", "_runs"} <= consts
    assert set(line) == want
    assert line["metric"] == "64p_frames_per_sec_embed_extract"
    assert line["unit"] == "frames/sec/chip" and line["mode"] == mode
    _check_types(line, 2)
    assert isinstance(line[f"{other}_fps"], float)
    assert len(line[f"{other}_runs"]) == 2


@pytest.mark.parametrize("extra", [["--layout", "nhwc"], ["--frame_dtype", "float32"],
                                   ["--layout", "nhwc", "--lowres_attenuation", "0"]])
def test_nhwc_line(card_file, extra):
    """NHWC u8 and float frames: embed then detect, no second mode."""
    from videoseal_tpu_torch import bench
    line = bench.main(SMALL + ["--card", card_file] + extra)
    keys, _ = _bench_keys()
    assert set(line) == keys - {"vs_baseline"}
    _check_types(line, 2)


def test_frames_are_bench_pys(card_file):
    """The planar buffer and the NHWC frames are the ones root bench.py
    draws from numpy.random.default_rng(0), in the JAX package's layout."""
    from videoseal_tpu.kernels.fused_planar import C0, R0, planar_shape
    from videoseal_tpu_torch import bench
    args = bench.get_parser().parse_args(SMALL)
    rng = np.random.default_rng(0)
    buf = np.zeros(planar_shape(2, 64, 96), np.uint8)
    buf[:, :, R0:R0 + 64, C0:C0 + 96] = rng.integers(0, 256, (2, 3, 64, 96), np.uint8)
    got = bench._frames(args, True, torch.device("cpu"), np.random.default_rng(0))
    np.testing.assert_array_equal(got.numpy(), buf)
    want = np.random.default_rng(0).integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    got = bench._frames(args, False, torch.device("cpu"), np.random.default_rng(0))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("runs,repeats", [(1, 3), (5, 2), (7, 1)])
def test_measure_counts_calls(runs, repeats):
    """One warm-up call, then `repeats` windows of max(runs, 4) calls; the
    median of the sorted repeats is the value."""
    from videoseal_tpu_torch import bench
    calls = []
    fps, fpss, spread = bench.measure(lambda: calls.append(1), 8, runs, repeats,
                                      torch.device("cpu"))
    assert len(calls) == 1 + repeats * max(runs, 4)
    assert len(fpss) == repeats and fps == fpss[len(fpss) // 2] and spread >= 0


def test_default_device_is_the_card(card_file, monkeypatch):
    from videoseal_tpu_torch import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--card", card_file, "--frames", "2"])
    assert bench.get_parser().parse_args([]).device == "cuda"


def test_flags_and_defaults_are_bench_pys():
    """Root bench.py's flags with its defaults, and --device."""
    from videoseal_tpu_torch import bench
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    want = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            want[node.args[0].value.lstrip("-")] = (
                ast.literal_eval(kw["default"]) if "default" in kw else None)
    got = vars(bench.get_parser().parse_args([]))
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want


def test_trace_dir(card_file, tmp_path):
    from videoseal_tpu_torch import bench
    bench.main(SMALL + ["--card", card_file, "--layout", "nhwc", "--trace_dir",
                        str(tmp_path / "trace")])
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
