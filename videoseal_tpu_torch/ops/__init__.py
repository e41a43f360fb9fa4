from .color import rgb_to_y
from .resize import resize_bilinear

__all__ = ["resize_bilinear", "rgb_to_y"]
