"""Training losses, counterpart of ``videoseal_tpu/losses``."""

from .perceptual import PerceptualLoss, build_perceptual_loss
from .videosealloss import VideoSealLoss

__all__ = ["PerceptualLoss", "VideoSealLoss", "build_perceptual_loss"]
