"""Image files in and out as RGB uint8 arrays, through Pillow.

The JAX package reads and writes images with cv2 (``cv2.imread`` then BGR to
RGB; ``cv2.imwrite`` at a JPEG quality), which the card's machine does not
have; it has Pillow. Pillow is imported when a file is read or written, not
when this module is imported. ``imread`` applies the EXIF orientation, as
``cv2.imread`` does by default, and turns grey, palette and alpha images into
three RGB channels. 16-bit samples become 8-bit ones shifted right by 8, as
``cv2.imread(path, IMREAD_COLOR)`` makes them: Pillow's own conversion of a
16-bit grey image clips at 255 instead.
"""

from __future__ import annotations

import numpy as np


def _rawmode(tile) -> str:
    args = tile[3]
    return str(args[0] if isinstance(args, tuple) else args)


def _sixteen_bit_grey(img) -> bool:
    """Modes ``I;16*``, and ``I`` where the file holds 16-bit samples (a
    16-bit PGM, say). Read before the pixels are loaded: loading clears
    ``img.tile``."""
    if img.mode.startswith("I;16"):
        return True
    return img.mode == "I" and any(_rawmode(t).startswith("I;16") for t in img.tile)


def imread(path: str) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB. Raises ``OSError`` for a file that is
    missing or not an image."""
    from PIL import Image, ImageOps

    with Image.open(path) as img:
        sixteen = _sixteen_bit_grey(img)
        img = ImageOps.exif_transpose(img)
        if sixteen:
            grey = (np.asarray(img).astype(np.int64) >> 8).astype(np.uint8)
            return np.repeat(grey[..., None], 3, axis=-1)
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def imwrite(path: str, image: np.ndarray, jpeg_quality: int = 95) -> None:
    """Write ``[H, W, 3]`` uint8 RGB; the format follows the file's suffix."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(image, dtype=np.uint8), "RGB").save(path, quality=jpeg_quality)
