"""Host-side training data, counterpart of ``videoseal_tpu/data``."""
