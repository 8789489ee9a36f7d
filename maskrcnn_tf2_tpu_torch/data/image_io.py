"""Image files in and out as RGB uint8 arrays, through Pillow.

The JAX package reads and writes images with cv2 (``cv2.imread`` then BGR to
RGB; ``cv2.imwrite`` at a JPEG quality), which the card's machine does not
have; it has Pillow. Pillow is imported when a file is read or written, not
when this module is imported. ``imread`` applies the EXIF orientation, as
``cv2.imread`` does by default, and turns grey, palette and alpha images into
three RGB channels.
"""

from __future__ import annotations

import numpy as np


def imread(path: str) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB. Raises ``OSError`` for a file that is
    missing or not an image."""
    from PIL import Image, ImageOps

    with Image.open(path) as img:
        return np.asarray(ImageOps.exif_transpose(img).convert("RGB"), dtype=np.uint8)


def imwrite(path: str, image: np.ndarray, jpeg_quality: int = 95) -> None:
    """Write ``[H, W, 3]`` uint8 RGB; the format follows the file's suffix."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(image, dtype=np.uint8), "RGB").save(path, quality=jpeg_quality)
