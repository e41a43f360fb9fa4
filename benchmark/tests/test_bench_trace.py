"""The traced window's reduction on a Chrome trace written by hand: busy
time, idle gaps named by what the host was doing, and the per-layer readers
that read kernels by name."""

from __future__ import annotations

import dataclasses
import json

import pytest

from benchmark import costs, harness, trace
from benchmark.tests import tiny


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 0,
            "args": args}


@pytest.fixture()
def tr(tmp_path):
    events = [
        _ev(trace.REQUEST, "user_annotation", 0, 100), _ev(trace.REQUEST, "user_annotation", 100, 100),
        _ev(trace.REQUEST, "gpu_user_annotation", 0, 100, tid=7),
        _ev("aten::conv2d", "cpu_op", 0, 40), _ev("cudaLaunchKernel", "cuda_runtime", 5, 2),
        _ev("aten::copy_", "cpu_op", 120, 50), _ev("cudaStreamSynchronize", "cuda_runtime", 130, 30),
        _ev("sm90_xmma_fprop_implicit_gemm_bf16_cudnn", "kernel", 10, 30, tid=7),
        _ev("void (anonymous namespace)::blend_planar_kernel<true, true, 2, 3>(K1Args)", "kernel",
            60, 10, tid=7),
        _ev("void at::native::elementwise_kernel<128, 4>(int)", "kernel", 65, 20, tid=7),
        _ev("void (anonymous namespace)::cnx_pw1<S>(bf16 const*)", "kernel", 180, 10, tid=7),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 100, 5, tid=7),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(str(path))


def test_busy_and_gaps(tr):
    assert len(tr.requests) == 2 and len(tr.kernels) == 4
    assert tr.window_us() == (0, 200)
    # busy: [10, 40], [60, 85], [100, 105], [180, 190]
    assert tr.busy_us() == 30 + 25 + 5 + 10
    assert tr.idle_gaps() == [(0, 10), (40, 60), (85, 100), (105, 180), (190, 200)]
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["sm90_xmma_fprop_implicit_gemm_bf16_cudnn", pytest.approx(30e-6)]
    # each gap named by the innermost host event at its middle: 5 (the launch
    # inside conv2d), 142.5 (the sync inside copy_), 50, 92.5, 195 (none)
    assert b["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(75e-6)],
                              ["host outside any operator", pytest.approx(45e-6)],
                              ["cudaLaunchKernel", pytest.approx(10e-6)]]


def test_readers(tr):
    workload, config = tiny.cell("planar")
    run = harness.Run(workload, config["card"], harness.traffic("embed_detect_planar"),
                      spans=[(0.0, 0.01, 0.05), (0.05, 0.06, 0.1)], trace=tr)
    read = lambda m: harness.reader(m).read(run)
    assert read("launches_per_request") == 2.0
    assert read("host_syncs_per_request") == 0.5 - 1
    assert read("conv_gemm_ms") == pytest.approx(0.015)
    assert read("elementwise_ms") == pytest.approx(0.010)
    assert read("device_idle_pct") == pytest.approx(65.0)
    least = costs.bound(*costs.k1_cost(8, 72, 128, 128, True, 128))[0]
    assert read("k1_roofline") == pytest.approx(100 * least / 0.005)   # 10 us, 2 requests
    assert harness.reader("k2_roofline").read(dataclasses.replace(run, trace=None)) is None
    assert read("frames_per_s") == pytest.approx(2 * 8 / 0.1)
    assert read("host_submit_ms") == pytest.approx(10.0)
    assert read("request_p95_ms") is None      # too few requests for a tail
