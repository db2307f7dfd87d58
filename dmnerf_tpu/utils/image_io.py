"""PNG/JPEG read and write through Pillow.

Same array semantics as the reference's imageio calls (datasets/loader_*.py,
networks/tester.py): uint8 [H, W] or [H, W, C] arrays in and out; 16-bit label maps
read as uint16; palette images are expanded to RGB (RGBA where the palette has
transparency), as imageio does.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def imread(path: str) -> np.ndarray:
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        return np.asarray(im)


def imwrite(path: str, img: np.ndarray) -> None:
    Image.fromarray(np.asarray(img)).save(path)
