"""The port's PNG codec (``data/png.py``) against Pillow: every colour type
Pillow writes (gray, gray + alpha, RGB, RGBA, palette with and without
transparency), images whose rows Pillow filters with each scanline filter,
and the codec's own files read back by Pillow."""
import os

import numpy as np
import pytest
from PIL import Image

from instance_nerf_tpu_torch.data.png import read_png, write_png

SHAPES = {"L": (17, 23), "LA": (12, 13, 2), "RGB": (31, 29, 3), "RGBA": (9, 40, 4)}


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    # smooth ramps: Pillow's adaptive filter picks Sub, Up, Average, Paeth
    ramp = (np.cumsum(noise.astype(np.int64), axis=1) // 7 % 256).astype(np.uint8)
    flat = np.full(shape, 77, np.uint8)
    return noise, ramp, flat


@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_reads_what_pillow_writes_and_back(mode, tmp_path):
    path = str(tmp_path / "a.png")
    for img in _images(SHAPES[mode], 0):
        Image.fromarray(img, mode).save(path)
        np.testing.assert_array_equal(read_png(path), img)
        if mode != "LA":
            write_png(path, img)
            np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
            np.testing.assert_array_equal(read_png(path), img)


def test_palette_images(tmp_path):
    _, ramp, _ = _images((21, 19, 3), 1)
    pal = Image.fromarray(ramp).convert("P", palette=Image.ADAPTIVE, colors=40)
    path = str(tmp_path / "p.png")
    pal.save(path)
    np.testing.assert_array_equal(read_png(path), np.asarray(pal.convert("RGB")))
    pal.save(path, transparency=3)
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path).convert("RGBA")))


def test_rejects_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "x.png")
    Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 999).save(path)
    with pytest.raises(ValueError, match="8-bit"):
        read_png(path)
    with open(os.path.join(tmp_path, "y.png"), "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(os.path.join(tmp_path, "y.png"))
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, np.zeros((2, 2), np.float32))
