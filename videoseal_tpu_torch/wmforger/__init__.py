"""WmForger, counterpart of ``videoseal_tpu/wmforger/``: an image preference
model (real against watermarked; a ConvNeXt extractor with nbits=0) trained
on artificial FFT watermarks with adversarial gradient-perturbation
hardening (``train.py``), and the one-shot SGD forging and removal tool
(``optimize_image.py``)."""

from .generators import (FFTWatermarkGaussian, FFTWatermarkLines,  # noqa: F401
                         FFTWatermarkWaves, build_generator)
