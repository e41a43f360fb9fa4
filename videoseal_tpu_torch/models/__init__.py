"""The models, counterpart of ``videoseal_tpu/models``."""

from .embedder import build_embedder
from .extractor import build_extractor
from .videoseal import VideoSeal

__all__ = ["VideoSeal", "build_embedder", "build_extractor"]
