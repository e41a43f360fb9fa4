"""The port's five layout probes (``kernels/conv_probe.py``,
``evals/{resize,dw_mxu,planar,r4}_probe.py``) on the CPU, against the JAX
package's probes and against each other.

* Each formulation a probe times computes the same function as the others
  (a traffic probe aside): im2col = nine GEMMs = conv within bf16 rounding;
  the bf16 resizes within two bf16 roundings of values <= 1 of the float32
  one; the banded matmul = the diagonal conv = the depthwise conv (K8's
  plain version on the CPU) within a few bf16 ulps of each chained conv;
  ``band_matrix`` identical to JAX's; the extractor's grouped route against
  its single one.
* Each ``main(["--device", "cpu", ...])`` prints a device line, then lines
  with the JAX probe's keys (planar_probe's rs line adds "rs"), and returns
  its rows; planar_probe refuses a tile height other than the layout's.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from torch_port import tiny_card

from videoseal_tpu.evals.dw_mxu_probe import band_matrix as jax_band_matrix
from videoseal_tpu_torch.evals import dw_mxu_probe, planar_probe, r4_probe, resize_probe
from videoseal_tpu_torch.kernels import conv_probe

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -8


def _jax_keys(path: str) -> list:
    """The key sets of the json.dumps({...}) lines in a JAX probe's source."""
    with open(os.path.join(ROOT, "videoseal_tpu", path)) as f:
        src = f.read()
    return [set(re.findall(r'"(\w+)":', body))
            for body in re.findall(r"json\.dumps\(\{(.*?)\}\)", src, re.DOTALL)]


def _lines(out: str) -> list:
    return [json.loads(ln) for ln in out.strip().splitlines()]


# -- the formulations agree ------------------------------------------------------------

def test_conv_variants_agree():
    x, w = conv_probe.probe_inputs(2, 16, 32, 24, "cpu")
    outs = {v: conv_probe.variant_fn(v, x, w)().float() for v in conv_probe.VARIANTS}
    ref = outs["lax_conv"]
    assert tuple(ref.shape) == (2, 16, 16, 24)
    for v, y in outs.items():
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=0,
                                   atol=2 * BF16_ULP * float(ref.abs().max()), err_msg=v)


def test_resize_variants_agree():
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (2, 3, 48, 80), generator=g, dtype=torch.uint8)
    outs = {k: fn() for k, fn in resize_probe.variants(x, 16).items()}
    ref = outs["current_f32"]
    assert tuple(ref.shape) == (2, 16, 16, 3) and ref.dtype == torch.float32
    # the same matrices in float64 on the u8 values
    mh = resize_probe.resize_matrix(48, 16, True, torch.bfloat16).double()
    mw = resize_probe.resize_matrix(80, 16, True, torch.bfloat16).double()
    want = torch.einsum("Hh,Ww,fchw->fHWc", mh, mw, x.double() / 255.0)
    np.testing.assert_allclose(ref.numpy(), want.numpy(), atol=1e-6, rtol=0)
    for k in ("bf16_h_first", "bf16_w_first"):
        np.testing.assert_allclose(outs[k].numpy(), ref.numpy(), atol=2 * BF16_ULP, rtol=0,
                                   err_msg=k)
    i8 = outs["i8_w_first"]         # a traffic probe: its shape, not the resize's values
    assert tuple(i8.shape) == (2, 16, 16, 3) and bool(torch.isfinite(i8.float()).all())


def test_band_matrix_matches_jax():
    wt = np.random.default_rng(2).normal(0, 0.1, (6, 7, 7)).astype(np.float32)
    for w in (8, 13):
        np.testing.assert_array_equal(dw_mxu_probe.band_matrix(wt, w), jax_band_matrix(wt, w))


@pytest.mark.parametrize("stage", [1, 3])
def test_dw_forms_agree(stage):
    """Banded matmul = diagonal conv = the production tap loop (K8's plain
    version on a CPU tensor), over the stage's chain of depthwise convs."""
    c, hw, depth = dw_mxu_probe.STAGES[stage]
    inp = dw_mxu_probe.stage_inputs(c, hw, 1, np.random.default_rng(3), "cpu")
    outs = {k: fn().float() for k, fn in dw_mxu_probe.forms(inp, depth).items()}
    ref = outs["vpu"]
    # a float64 chain of the same convs: each form within a few bf16 ulps of
    # each conv's output, the roundings of `depth` chained convs
    y = inp["x"].double().permute(0, 3, 1, 2)
    wk = torch.as_tensor(inp["wt"], dtype=torch.float64)[:, None]
    for _ in range(depth):
        y = torch.nn.functional.conv2d(y, wk, padding=3, groups=c)
    y = y.permute(0, 2, 3, 1)
    tol = 4 * depth * BF16_ULP * float(y.abs().max())
    for k in ("mxu_band", "mxu_band_t", "mxu_diag"):
        got = outs[k] if outs[k].shape == ref.shape else outs[k].permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol, rtol=0, err_msg=k)
    np.testing.assert_allclose(ref.numpy(), y.numpy(), atol=tol, rtol=0)


def test_grouped_route_matches_single():
    import videoseal_tpu_torch as vt
    model = vt.VideoSeal.from_card(tiny_card(img_size=64), device="cpu").with_dtype("bfloat16")
    g = torch.Generator().manual_seed(4)
    frames = torch.rand((3, 64, 64, 3), generator=g).to(torch.bfloat16)
    multi = r4_probe.extract(model.extractor, frames, 4, 2)
    single = r4_probe.extract(model.extractor, frames, 1, 2)
    assert tuple(multi.shape) == (3, 17)
    np.testing.assert_allclose(multi.numpy(), single.numpy(), atol=1e-6, rtol=0)


# -- the entry points ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("card") / "tiny.json")
    with open(path, "w") as f:
        json.dump(tiny_card(img_size=64), f)
    return path


def test_conv_and_resize_mains(capsys):
    rows = conv_probe.main(["--device", "cpu", "--k", "1", "--batch", "1", "--hdiv", "8"])
    lines = _lines(capsys.readouterr().out)
    assert lines[0] == {"device": "cpu"} and lines[1:] == rows and len(rows) == 9
    assert all(set(r) == _jax_keys("kernels/conv_probe.py")[0] for r in rows)
    assert [r["shape"] for r in rows[::3]] == ["1x16^2x64->64", "1x32^2x16->16",
                                               "1x8^2x128->128"]
    rows = resize_probe.main(["--device", "cpu", "--k", "1", "--frames", "1", "--h", "40",
                              "--w", "64", "--s", "16"])
    lines = _lines(capsys.readouterr().out)
    assert lines[1:] == rows
    assert [r["variant"] for r in rows] == ["current_f32", "bf16_h_first", "bf16_w_first",
                                            "i8_w_first"]
    assert all(set(r) == _jax_keys("evals/resize_probe.py")[0] for r in rows)


def test_dw_mxu_main(capsys):
    rows = dw_mxu_probe.main(["--device", "cpu", "--k", "1", "--frames", "1",
                              "--stages", "2,3"])
    assert _lines(capsys.readouterr().out)[1:] == rows
    assert [(r["stage"], r["form"]) for r in rows] == [
        (s, f) for s in (2, 3) for f in ("vpu", "mxu_band", "mxu_band_t", "mxu_diag")]
    assert all(set(r) == _jax_keys("evals/dw_mxu_probe.py")[0] for r in rows)


def test_planar_main(capsys):
    with pytest.raises(ValueError, match="tile height"):
        planar_probe.main(["--device", "cpu", "--th", "64"])
    rows = planar_probe.main(["--device", "cpu", "--k", "1", "--frames", "2", "--height", "64",
                              "--width", "96", "--proc", "64", "--rs", "8,32",
                              "--lowres_stages"])
    assert _lines(capsys.readouterr().out)[1:] == rows
    th, lowres, heat, resize = _jax_keys("evals/planar_probe.py")
    assert [r["rs"] for r in rows[:2]] == [8, 32]
    assert all(set(r) == th | {"rs"} for r in rows[:2])
    assert [r["stage"] for r in rows[2:]] == ["blend_lowres", "jnd_heatmaps_procres",
                                              "resize_planar_allframes"]
    assert [set(r) for r in rows[2:]] == [lowres, heat, resize]


def test_r4_main(card_file, capsys):
    rows = r4_probe.main(["--device", "cpu", "--card", card_file, "--k", "1", "--frames", "2",
                          "--height", "64", "--width", "96"])
    assert _lines(capsys.readouterr().out)[1:] == rows
    with open(os.path.join(ROOT, "videoseal_tpu", "evals", "r4_probe.py")) as f:
        jax_stages = re.findall(r'report\("([^"]+)"', f.read())
    assert [r["stage"] for r in rows] == jax_stages
    assert all(set(r) == _jax_keys("evals/r4_probe.py")[0] for r in rows)


@pytest.mark.parametrize("probe", [conv_probe, resize_probe, dw_mxu_probe, planar_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_default_device_is_the_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        probe.main([])
