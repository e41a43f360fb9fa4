from .color import rgb_to_y, rgb_to_yuv, yuv_to_rgb
from .resize import resize_bilinear, resize_to

__all__ = ["resize_bilinear", "resize_to", "rgb_to_y", "rgb_to_yuv", "yuv_to_rgb"]
