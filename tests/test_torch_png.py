"""The port's PNG readers, writer and bilinear resize (snerf_tpu_torch/
data/png.py) against the libraries the JAX loader reads with: imageio for
the images, cv2.imread(-1) for the 16-bit depth maps, cv2.resize.

The reader is exact: on every image and depth map of both fixtures, on
PNGs that PIL and cv2 write from seeded numpy arrays (8-bit gray,
gray+alpha, RGB, RGBA, 16-bit gray, more than one IDAT chunk), and on
PNGs encoded here from the specification with each of the five row
filters (cv2 and PIL pick filters by their own heuristics), which
imageio decodes the same. Write/read round trips are exact. resize_bilinear agrees with cv2.resize within 1e-5 on
float32 images in [0, 1] at two sizes that do not match, and returns the
input at the same size.
"""

import glob
import os
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from snerf_tpu_torch.data import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _smooth(rng, shape, dtype, hi):
  """Seeded content: gradients and noise."""
  h, w = shape[:2]
  ramp = np.add.outer(np.arange(h) * 3, np.arange(w) * 5)
  ramp = ramp.reshape(h, w, *([1] * (len(shape) - 2)))
  noise = rng.integers(0, 16, shape)
  return ((ramp + noise) % hi).astype(dtype)


def _filters(path):
  """The set of row filter types in a PNG (to show the cases cover them)."""
  with open(path, "rb") as f:
    data = f.read()
  pos, idat, hdr = 8, [], None
  while pos < len(data):
    n, t = struct.unpack(">I4s", data[pos:pos + 8])
    if t == b"IHDR":
      hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
    if t == b"IDAT":
      idat.append(data[pos + 8:pos + 8 + n])
    pos += 12 + n
  h = hdr[1]
  raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
  return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("name", ["nuscenes_realfocal", "nuscenes_tiny"])
def test_fixture_images_and_depths_exact(name):
  imgs = sorted(glob.glob(os.path.join(FIXTURES, name, "images", "*.png")))
  deps = sorted(glob.glob(os.path.join(FIXTURES, name, "depths", "*.png")))
  assert imgs and len(imgs) == len(deps)
  for f in imgs:
    got, want = png.read_png(f), np.asarray(imageio.imread(f))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
  for f in deps:
    got, want = png.read_png(f), cv2.imread(f, -1)
    assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
  # read_pngs decodes a mixed list (two kinds) in its order, the same
  for f, got in zip(imgs + deps, png.read_pngs(imgs + deps)):
    want = png.read_png(f)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,shape", [
    ("L", (37, 53)), ("LA", (37, 53, 2)), ("RGB", (37, 53, 3)),
    ("RGBA", (37, 53, 4))])
def test_pil_written_8bit(tmp_path, mode, shape):
  x = _smooth(np.random.default_rng(len(shape) * 7 + shape[-1]), shape,
              np.uint8, 256)
  path = str(tmp_path / "p.png")
  Image.fromarray(x, mode).save(path)
  got = png.read_png(path)
  assert got.dtype == np.uint8
  np.testing.assert_array_equal(got, x)


def test_cv2_written_rgb_and_16bit_gray(tmp_path):
  rng = np.random.default_rng(1)
  rgb = _smooth(rng, (41, 29, 3), np.uint8, 256)
  path = str(tmp_path / "c.png")
  cv2.imwrite(path, rgb[..., ::-1])          # cv2 writes BGR
  np.testing.assert_array_equal(png.read_png(path), rgb)
  depth = _smooth(rng, (41, 29), np.uint16, 65536) * 37
  path16 = str(tmp_path / "d.png")
  cv2.imwrite(path16, depth)
  got = png.read_png(path16)
  assert got.dtype == np.uint16
  np.testing.assert_array_equal(got, depth)


def _encode(x, depth, color, filters, interlace=0):
  """A PNG of x whose row y uses filter filters[y % len(filters)], encoded
  here from the specification (the reader only decodes); `interlace`
  only sets the header's flag."""
  h, w = x.shape[:2]
  rows = (x.astype(">u2").view(np.uint8) if depth == 16 else x).reshape(h, -1)
  rows = rows.astype(np.int64)
  bpp = rows.shape[1] // w
  out = []
  for y in range(h):
    cur = rows[y]
    prior = rows[y - 1] if y else np.zeros_like(cur)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    f = filters[y % len(filters)]
    p = left + prior - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, prior, upleft))
    pred = [0, left, prior, (left + prior) // 2, paeth][f]
    out.append(np.concatenate([[f], (cur - pred) % 256]).astype(np.uint8))
  chunk = lambda t, d: (struct.pack(">I", len(d)) + t + d
                        + struct.pack(">I", zlib.crc32(t + d)))
  return (b"\x89PNG\r\n\x1a\n"
          + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                       interlace))
          + chunk(b"IDAT", zlib.compress(np.stack(out).tobytes()))
          + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(1,), (2,), (3,), (4,), (0, 1, 2, 3, 4),
                                     (4, 3, 2, 1)])
@pytest.mark.parametrize("kind", ["rgb8", "gray16", "ga8"])
def test_every_filter_type(tmp_path, filters, kind):
  rng = np.random.default_rng(5)
  depth, color, shape, dtype, hi = {
      "rgb8": (8, 2, (19, 13, 3), np.uint8, 256),
      "gray16": (16, 0, (19, 13), np.uint16, 65536),
      "ga8": (8, 4, (19, 13, 2), np.uint8, 256)}[kind]
  x = rng.integers(0, hi, shape).astype(dtype)
  path = str(tmp_path / "f.png")
  with open(path, "wb") as f:
    f.write(_encode(x, depth, color, filters))
  assert _filters(path) == set(filters)
  np.testing.assert_array_equal(png.read_png(path), x)
  np.testing.assert_array_equal(np.asarray(imageio.imread(path)), x)


def test_multiple_idat_chunks(tmp_path):
  x = _smooth(np.random.default_rng(2), (64, 48, 3), np.uint8, 256)
  path = str(tmp_path / "multi.png")
  # PIL splits the compressed stream into IDAT chunks of ImageFile.MAXBLOCK
  from PIL import ImageFile
  old = ImageFile.MAXBLOCK
  ImageFile.MAXBLOCK = 512
  try:
    Image.fromarray(x, "RGB").save(path)
  finally:
    ImageFile.MAXBLOCK = old
  with open(path, "rb") as f:
    assert f.read().count(b"IDAT") > 1
  np.testing.assert_array_equal(png.read_png(path), x)


@pytest.mark.parametrize("shape,dtype", [((23, 31, 3), np.uint8),
                                         ((23, 31), np.uint16)])
def test_write_read_round_trip(tmp_path, shape, dtype):
  hi = 65536 if dtype == np.uint16 else 256
  x = np.random.default_rng(3).integers(0, hi, shape).astype(dtype)
  path = str(tmp_path / "w.png")
  png.write_png(path, x)
  np.testing.assert_array_equal(png.read_png(path), x)
  want = cv2.imread(path, -1)
  np.testing.assert_array_equal(want[..., ::-1] if want.ndim == 3 else want,
                                x)


def test_unsupported_inputs_raise(tmp_path):
  jpg = str(tmp_path / "x.jpg")
  cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    png.read_png(jpg)
  pal = str(tmp_path / "pal.png")
  Image.fromarray(np.zeros((8, 8), np.uint8)).convert("P").save(pal)
  with pytest.raises(NotImplementedError, match="pal.png"):
    png.read_png(pal)
  inter = str(tmp_path / "inter.png")
  with open(inter, "wb") as f:
    f.write(_encode(np.zeros((8, 8, 3), np.uint8), 8, 2, (0,), interlace=1))
  with pytest.raises(NotImplementedError, match="interlace 1"):
    png.read_png(inter)
  for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4), np.uint8),
              np.zeros((4, 4, 4), np.uint8)):
    with pytest.raises(ValueError):
      png.write_png(str(tmp_path / "f.png"), bad)


@pytest.mark.parametrize("shape", [(17, 23), (31, 7, 3)])
def test_resize_bilinear_matches_cv2(shape):
  img = np.random.default_rng(4).random(shape).astype(np.float32)
  for H, W in [(9, 40), (50, 5)]:
    got = png.resize_bilinear(img, H, W)
    want = cv2.resize(img, (W, H))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
  same = png.resize_bilinear(img, *shape[:2])
  np.testing.assert_array_equal(same, img)
  # float64 input stays float64, as the depth maps' /256.0 chain does
  d64 = img.astype(np.float64) * 100
  np.testing.assert_allclose(png.resize_bilinear(d64, 11, 13),
                             cv2.resize(d64, (13, 11)), rtol=0, atol=1e-9)
