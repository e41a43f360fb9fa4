"""Training losses, counterpart of ``videoseal_tpu/losses``."""
