"""PNG reading and writing with zlib and numpy only, and cv2's bilinear
resize: what the scene loader and the eval and render entry points need
of imageio and cv2, neither of which the port may assume.

`read_png` decodes non-interlaced PNGs of bit depth 8 or 16 in gray,
gray+alpha, RGB or RGBA, with all five row filters and any number of
IDAT chunks; anything else raises with the file's name. `read_pngs`
decodes a list, the images of one shape together. A JPEG raises:
the port reads PNG scenes only (ROADMAP Queue 3 records the departure
from the JAX loader, which accepts .jpg). `write_png` writes uint8 RGB and
uint16 gray with filter 0. `resize_bilinear` is the
arithmetic of `cv2.resize(img, (W, H), interpolation=INTER_LINEAR)` on
float input, `resize_bilinear_u8` on uint8 input (cv2's fixed-point
path), `resize_nearest` that of INTER_NEAREST on any input.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
  """(type, payload) of each chunk, CRCs checked."""
  pos = len(_SIGNATURE)
  while pos + 8 <= len(data):
    length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
    payload = data[pos + 8:pos + 8 + length]
    crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
    if zlib.crc32(ctype + payload) != crc or len(payload) != length:
      raise ValueError(f"{path}: corrupt PNG chunk {ctype!r}")
    yield ctype, payload
    pos += 12 + length


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
  """Undo the row filters of a batch of same-shape images. raw:
  [B, h, 1 + w * bpp] uint8 (each row's filter byte, then the row). Pixel
  (y, x) depends on its left, upper and upper-left neighbours, so the
  pixels of one anti-diagonal y + x = t of every image decode together,
  each row by its own filter. In the skewed layout s[:, y + 1, t + 2] =
  pixel (y, t - y) an anti-diagonal is one column and its neighbours are
  the two columns before it. Returns [B, h, w * bpp] uint8."""
  ftype = raw[:, :, 0].astype(np.int64)
  if ftype.max(initial=0) > 4:
    raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
  if not ftype.any():
    return raw[:, :, 1:]
  n = raw.shape[0]
  filt = raw[:, :, 1:].reshape(n, h, w, bpp).astype(np.int32)
  ys = np.arange(h)[:, None]
  xs = np.arange(h + w - 1)[None] - ys
  inside = (xs >= 0) & (xs < w)
  fs = np.where(inside[None, ..., None], filt[:, ys, np.clip(xs, 0, w - 1)],
                0)
  s = np.zeros((n, h + 1, h + w + 1, bpp), np.int32)
  f = ftype[:, :, None]
  sub, up, avg, paeth = f == 1, f == 2, f == 3, f == 4
  use_paeth = bool(paeth.any())
  for t in range(h + w - 1):
    a, b, c = s[:, 1:, t + 1], s[:, :-1, t + 1], s[:, :-1, t]
    pred = np.where(sub, a, np.where(up, b, np.where(avg, (a + b) >> 1, 0)))
    if use_paeth:
      p = a + b - c
      pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
      pred = np.where(paeth, np.where((pa <= pb) & (pa <= pc), a,
                                      np.where(pb <= pc, b, c)), pred)
    s[:, 1:, t + 2] = np.where(inside[None, :, t, None],
                               (fs[:, :, t] + pred) & 0xFF, 0)
  rec = s[:, ys + 1, np.arange(w)[None] + ys + 2]
  return rec.astype(np.uint8).reshape(n, h, w * bpp)


def _parse(path: str):
  """((h, w, bit depth, channels), the decompressed rows [h, 1 + w *
  bpp] uint8) of a PNG, the unsupported kinds raised with its name."""
  with open(path, "rb") as f:
    data = f.read()
  if data[:3] == b"\xff\xd8\xff" or path.lower().endswith((".jpg", ".jpeg")):
    raise NotImplementedError(
        f"{path}: JPEG is not supported by the port's reader, which reads "
        "PNG only (ROADMAP Queue 3: the JPEG departure)")
  if data[:8] != _SIGNATURE:
    raise ValueError(f"{path}: not a PNG file")
  header, idat = None, []
  for ctype, payload in _chunks(data, path):
    if ctype == b"IHDR":
      header = struct.unpack(">IIBBBBB", payload)
    elif ctype == b"IDAT":
      idat.append(payload)
    elif ctype == b"IEND":
      break
  if header is None or not idat:
    raise ValueError(f"{path}: PNG without IHDR or IDAT")
  w, h, depth, color, _, _, interlace = header
  if color not in _CHANNELS or depth not in (8, 16) or interlace:
    raise NotImplementedError(
        f"{path}: PNG color type {color}, bit depth {depth}, interlace "
        f"{interlace} is not supported (bit depth 8 or 16, gray, "
        "gray+alpha, RGB or RGBA, not interlaced)")
  ch = _CHANNELS[color]
  bpp = ch * depth // 8
  raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
  if raw.size != h * (1 + w * bpp):
    raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected "
                     f"{h * (1 + w * bpp)}")
  return (h, w, depth, ch), raw.reshape(h, 1 + w * bpp)


def read_pngs(paths):
  """The images at `paths` (a list, in order), as `read_png` returns
  them; the images of one shape and kind are unfiltered together."""
  parsed = [_parse(p) for p in paths]
  groups = {}
  for i, (kind, _) in enumerate(parsed):
    groups.setdefault(kind, []).append(i)
  out = [None] * len(paths)
  for (h, w, depth, ch), idx in groups.items():
    try:
      rows = _unfilter(np.stack([parsed[i][1] for i in idx]), h, w,
                       ch * depth // 8)
    except ValueError as e:
      raise ValueError(f"{[paths[i] for i in idx]}: {e}") from None
    if depth == 16:
      img = rows.reshape(len(idx), h, w * ch, 2).astype(np.uint16)
      img = (img[..., 0] << 8) | img[..., 1]
    else:
      img = rows
    img = img.reshape(len(idx), h, w, ch)
    for j, i in enumerate(idx):
      out[i] = img[j, ..., 0] if ch == 1 else img[j]
  return out


def read_png(path: str) -> np.ndarray:
  """The image at `path`: [H, W] for gray, else [H, W, C] (gray+alpha,
  RGB, RGBA, in that channel order); uint8 at bit depth 8, uint16 at 16
  (PNG's big-endian samples)."""
  return read_pngs([path])[0]


def _chunk(ctype: bytes, payload: bytes) -> bytes:
  return (struct.pack(">I", len(payload)) + ctype + payload
          + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path: str, img) -> None:
  """Write `img` as a PNG with filter 0: uint8 [H, W, 3] (RGB, eval's and
  render's images) or uint16 [H, W] (gray, render's depth maps)."""
  img = np.asarray(img)
  if img.dtype == np.uint16 and img.ndim == 2:
    depth, color = 16, 0
    rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
  elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
    depth, color = 8, 2
    rows = img.reshape(img.shape[0], -1)
  else:
    raise ValueError(f"write_png: unsupported image {img.dtype} "
                     f"{img.shape}")
  h, w = img.shape[:2]
  raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
  body = (_SIGNATURE
          + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                        0))
          + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
          + _chunk(b"IEND", b""))
  with open(path, "wb") as f:
    f.write(body)


def _axis_weights(n_in: int, n_out: int, dtype):
  """cv2's INTER_LINEAR source taps and weights along one axis: half-pixel
  centres, taps clamped to the edge with the weight moved to the edge
  pixel."""
  scale = 1.0 / (n_out / n_in)
  f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(dtype)
  s = np.floor(f).astype(np.int64)
  f = (f - s).astype(dtype)
  lo = s < 0
  f[lo], s[lo] = 0, 0
  hi = s >= n_in - 1
  f[hi], s[hi] = 0, n_in - 1
  return s, np.minimum(s + 1, n_in - 1), dtype(1) - f, f


def resize_bilinear(img, H: int, W: int) -> np.ndarray:
  """`cv2.resize(img, (W, H))` (INTER_LINEAR) for float [h, w] or
  [h, w, C] input: horizontal then vertical, weights and arithmetic in
  the input's dtype (float64 stays float64, as in cv2). The identity (a
  copy) when the size already matches."""
  img = np.asarray(img)
  if img.dtype not in (np.float32, np.float64):
    raise ValueError(f"resize_bilinear: float input only, got {img.dtype}")
  h, w = img.shape[:2]
  if (h, w) == (H, W):
    return img.copy()
  x0, x1, ax0, ax1 = _axis_weights(w, W, img.dtype.type)
  y0, y1, ay0, ay1 = _axis_weights(h, H, img.dtype.type)
  ex = (slice(None),) + (None,) * (img.ndim - 2)
  rows = img[:, x0] * ax0[ex] + img[:, x1] * ax1[ex]
  ey = (slice(None), None) + (None,) * (img.ndim - 2)
  out = rows[y0] * ay0[ey] + rows[y1] * ay1[ey]
  return out.astype(img.dtype, copy=False)


# cv2's fixed-point INTER_LINEAR: 11-bit weights (INTER_RESIZE_COEF_BITS)
_COEF_SCALE = 2048


def _axis_weights_u8(n_in: int, n_out: int):
  """`_axis_weights` in float32 (cv2 takes the fraction as a float), the
  weights rounded to 11-bit fixed point."""
  s0, s1, w0, w1 = _axis_weights(n_in, n_out, np.float32)
  scale = np.float32(_COEF_SCALE)
  return (s0, s1, np.rint(w0 * scale).astype(np.int64),
          np.rint(w1 * scale).astype(np.int64))


def resize_bilinear_u8(img, H: int, W: int) -> np.ndarray:
  """`cv2.resize(img, (W, H))` (INTER_LINEAR) for uint8 [h, w] or
  [h, w, C] input, bit for bit. An exact halving of both sides is cv2's
  2x2 area average, (a + b + c + d + 2) >> 2. Otherwise the fixed-point
  path: each row blended horizontally with 11-bit weights into integers,
  then the rows vertically as cv2's vector code does it, every product's
  operands pre-shifted: ((S0 >> 4) b0 >> 16) + ((S1 >> 4) b1 >> 16),
  rounded by + 2 >> 2 (its scalar form, (S0 b0 + S1 b1 + 2^21) >> 22,
  lands 1 off on ~10% of the pixels)."""
  img = np.asarray(img)
  if img.dtype != np.uint8:
    raise ValueError(f"resize_bilinear_u8: uint8 input only, got {img.dtype}")
  h, w = img.shape[:2]
  if (h, w) == (H, W):
    return img.copy()
  a = img.astype(np.int64)
  if (h, w) == (2 * H, 2 * W):
    return ((a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
             + 2) >> 2).astype(np.uint8)
  x0, x1, ax0, ax1 = _axis_weights_u8(w, W)
  y0, y1, ay0, ay1 = _axis_weights_u8(h, H)
  ex = (slice(None),) + (None,) * (img.ndim - 2)
  rows = a[:, x0] * ax0[ex] + a[:, x1] * ax1[ex]
  ey = (slice(None), None) + (None,) * (img.ndim - 2)
  out = ((((rows[y0] >> 4) * ay0[ey]) >> 16)
         + (((rows[y1] >> 4) * ay1[ey]) >> 16) + 2) >> 2
  return np.clip(out, 0, 255).astype(np.uint8)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
  scale = 1.0 / (n_out / n_in)
  return np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64),
                    n_in - 1)


def resize_nearest(img, H: int, W: int) -> np.ndarray:
  """`cv2.resize(img, (W, H), interpolation=INTER_NEAREST)`: output pixel
  (y, x) takes input (floor(y h / H), floor(x w / W)), no half-pixel
  centres; any dtype."""
  img = np.asarray(img)
  h, w = img.shape[:2]
  return img[_nearest_index(h, H)][:, _nearest_index(w, W)]
