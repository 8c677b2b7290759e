"""The committed JPEG frames under ``tools/fixtures/``.

The card machine has no Pillow and no JPEG encoder, so the frames that
``chip_smoke.py`` decodes there (its file-based trainer phase copies them
cyclically into an Affwild2-layout tree) are committed: ``COUNT`` 112 x
112 RGB JPEGs, quality 90, of seeded smooth images with some noise.

    python -m jmt_tpu_torch.tools.jpeg_fixtures   # writes them (Pillow)
"""
from __future__ import annotations

import os
import sys
from typing import List

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
COUNT = 8
SIZE = 112


def paths() -> List[str]:
    return [os.path.join(FIXTURES, f"frame_{i}.jpg") for i in range(COUNT)]


def image(i: int, seed: int = 0) -> np.ndarray:
    """Frame i: a seeded colour gradient with a moving blob and noise,
    (SIZE, SIZE, 3) uint8."""
    rng = np.random.default_rng([seed, i])
    y, x = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    base = rng.uniform(0, 255, 3)
    slope = rng.uniform(-120, 120, (2, 3))
    img = base + x[..., None] * slope[0] + y[..., None] * slope[1]
    cy, cx = 0.3 + 0.05 * i, 0.6 - 0.04 * i
    img += 90 * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 0.02)[..., None]
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> int:
    from PIL import Image
    os.makedirs(FIXTURES, exist_ok=True)
    for i, path in enumerate(paths()):
        Image.fromarray(image(i)).save(path, quality=90)
    print(f"wrote {COUNT} frames to {FIXTURES}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
