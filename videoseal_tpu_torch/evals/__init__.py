"""Evaluation harnesses of the port: ``speed``, ``lowres_quality`` and
``streaming_bench`` (the rest wait for the attack simulator)."""
