"""Evaluation harnesses of the port: ``speed``, ``lowres_quality``,
``streaming_bench``, the robustness eval ``full`` with ``step_size_eval``,
the exact codec ``attacks``, ``vmaf`` and ``flops``."""
