"""The benchmark of videoseal_tpu_torch: see run.py and harness.py."""
