"""Walkthroughs of the image and video paths, each runnable with
``python -m videoseal_tpu_torch.examples.<name>`` (counterparts of the
repository's ``examples/``)."""
