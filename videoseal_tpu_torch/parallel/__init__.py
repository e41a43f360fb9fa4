"""The GAN training step, counterpart of ``videoseal_tpu/parallel``."""
