"""K5's launch geometry (kernels/fused_blend.py::k5_geometry), the pure
function of the frame shape that lays out the row-streaming kernel of
csrc/jnd_rows.cuh: each output pixel owned by exactly one block, the shared
memory within what an H100 block may use, the 16-byte paths only where the
alignment holds. The kernel itself is held against its plain version on
the card by chip_smoke.py (phase jnd); on the CPU fused_jnd_delta runs the
plain version, held against the Pallas kernel in test_torch_fused_blend.py.
Also evals/k5_order.py's CPU side: it refuses the CPU and reads nvidia-smi's
samples."""

import numpy as np
import pytest
import torch

from videoseal_tpu_torch.kernels import fused_blend as fb
from videoseal_tpu_torch.kernels import jnd_probe as jp

SHAPES = [(1080, 1920), (2160, 3840), (1078, 1922), (120, 200), (37, 200), (4, 15)]
# an H100 block's shared memory at most; the kernel's threads a block at most
SMEM_MAX, THREADS_MAX = 232448, 512
# the geometries chip_smoke.py sweeps: (output rows, columns at most)
SWEEP = [(r, b) for r in (16, 32, 64) for b in (2048, 1024)]


def _check(geo: dict, h: int, w: int, u8: bool) -> None:
    rows, band = geo["rows"], geo["band"]
    assert geo["smem"] <= SMEM_MAX
    assert band % 16 == 0 and 16 <= band <= fb.K5_MAX_BAND
    assert geo["threads"] % 32 == 0 and band // 4 <= geo["threads"] <= THREADS_MAX
    own = np.zeros((h, w), np.int32)
    for s in range(geo["strips"]):
        for b in range(geo["bands"]):
            own[s * rows:(s + 1) * rows, b * band:(b + 1) * band] += 1
    assert (own == 1).all()
    # no block without an output pixel
    assert (geo["strips"] - 1) * rows < h and (geo["bands"] - 1) * band < w
    es = 1 if u8 else 4
    assert geo["vec_frames"] == ((3 * es * w) % 16 == 0)
    assert geo["vec_planes"] == (w % 4 == 0)


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("h,w", SHAPES)
def test_k5_geometry(h, w, u8):
    _check(fb.k5_geometry(h, w, u8), h, w, u8)
    for rows, band_max in SWEEP:
        geo = fb.k5_geometry(h, w, u8, rows, band_max)
        assert geo["rows"] == rows and geo["band"] <= band_max
        _check(geo, h, w, u8)
    # a base address off 16 bytes turns its 16-byte path off
    assert not fb.k5_geometry(h, w, u8, ptrs=(8, 0, 0))["vec_frames"]
    assert not fb.k5_geometry(h, w, u8, ptrs=(0, 4, 0))["vec_planes"]
    assert not fb.k5_geometry(h, w, u8, ptrs=(0, 0, 4))["vec_planes"]
    if (h, w) in ((1080, 1920), (2160, 3840)):   # the served shapes stream in 16-byte copies
        geo = fb.k5_geometry(h, w, u8, ptrs=(256, 512, 1024))
        assert geo["vec_frames"] and geo["vec_planes"]


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
def test_k5_geometry_ragged_band_on_16_byte_path(u8):
    """chip_smoke.py's edge 20x1040: a ragged last band (528 and 512
    columns) on the 16-byte path, at the default geometry."""
    geo = fb.k5_geometry(20, 1040, u8)
    assert geo["bands"] == 2 and geo["band"] == 528 and geo["bands"] * geo["band"] > 1040
    assert geo["vec_frames"] and geo["vec_planes"]
    _check(geo, 20, 1040, u8)


@pytest.mark.parametrize("kwargs", [{"rows": 0}, {"band_max": 1000}, {"band_max": 4096},
                                    {"band_max": 0}])
def test_k5_geometry_refuses(kwargs):
    with pytest.raises(ValueError):
        fb.k5_geometry(1080, 1920, True, **kwargs)


def test_k5_split_runs_on_the_card_only():
    imgs = torch.zeros(1, 8, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError):
        jp.k5_split(imgs, torch.zeros(1, 8, 8), 0.2, "copy")
    with pytest.raises(ValueError):
        jp.k5_split(imgs, torch.zeros(1, 8, 8), 0.2, "full")


def test_k5_order_runs_on_the_card_only(monkeypatch):
    from videoseal_tpu_torch.evals import k5_order
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        k5_order.main(["--calls", "2"])


def test_k5_order_reads_nvidia_smi_samples(tmp_path):
    """k5_order's parse of nvidia-smi's CSV: units dropped, lines that are
    no sample (a refused field's message) skipped."""
    from videoseal_tpu_torch.evals import k5_order
    path = tmp_path / "smi.csv"
    path.write_text(
        "2026/10/18 13:20:00.250, 1980 MHz, 2619 MHz, 129.08 W, 41, 0x0000000000000004\n"
        'Field "clocks_event_reasons.active" is not a valid field to query.\n'
        "2026/10/18 13:20:00.300, 1935 MHz, 2619 MHz, 199.36 W, 50, 0x0000000000000000\n")
    got = k5_order._samples(str(path))
    assert [s[1:] for s in got] == [(1980.0, 2619.0, 129.08, 41.0, "0x0000000000000004"),
                                    (1935.0, 2619.0, 199.36, 50.0, "0x0000000000000000")]
    assert got[1][0] - got[0][0] == pytest.approx(0.05)
