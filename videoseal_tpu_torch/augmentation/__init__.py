"""The attack simulator: differentiable augmentations (``augs``), the
validation grids (``validation``), the mask samplers (``masks`` on the
device, ``masks_host`` on the host) and the training-path ``Augmenter``."""

from .augmenter import Augmenter, build_augmenter, get_dummy_augmenter  # noqa: F401
from .presets import AUGS  # noqa: F401
from .validation import get_validation_augs, get_validation_augs_subset  # noqa: F401
