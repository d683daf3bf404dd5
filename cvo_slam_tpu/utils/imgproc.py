"""Image I/O and the few image operations the pipeline needs, in NumPy and
SciPy.

The reference reads and converts its images with OpenCV. These functions
keep the semantics the pipeline depends on:

  * PNG codec: decodes 8- and 16-bit gray and RGB images (the layouts of
    RGB-D datasets) with all five scanline filters (`imread_color` returns
    BGR like cv::imread; `imread_depth` keeps 16-bit depth); encodes 8-bit
    BGR and 8/16-bit gray with filter 0.
  * `rgb2gray` and `rgb2hsv`: OpenCV's 8-bit fixed-point COLOR_RGB2GRAY /
    COLOR_RGB2HSV formulas, bit-exact. Channel 0 plays 'R', so feeding a
    BGR image reproduces the reference's channel quirk
    (pcd_generator.cpp:624-625).
  * `resize_linear` / `resize_cubic`: OpenCV's half-pixel sampling with
    replicated borders (cubic a = -0.75), in float32 arithmetic.
  * `filter2d` / `gaussian_blur`: correlation with BORDER_REFLECT_101.
  * `fast9`: the FAST-9/16 detector with OpenCV's corner score and 3x3
    non-maximum suppression, vectorised over the image.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
from scipy import ndimage

# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}          # PNG color type -> channels: gray, RGB


def _read_chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Reverse the per-scanline filters; raw is (h, 1 + w * bpp)."""
    kinds = raw[:, 0]
    filt = raw[:, 1:]
    if np.any(kinds > 4):
        raise ValueError("invalid PNG filter type")
    if np.all(kinds <= 2):
        # None / Sub / Up only: each row is one vector operation
        out = np.empty_like(filt)
        prev = np.zeros(filt.shape[1], np.uint8)
        for r in range(h):
            row = filt[r]
            if kinds[r] == 1:
                row = np.cumsum(row.reshape(w, bpp), axis=0,
                                dtype=np.uint8).reshape(-1)
            elif kinds[r] == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    # Average / Paeth predict from the left, upper and upper-left pixels:
    # sweep the anti-diagonals r + x = d, which only read earlier diagonals
    f = filt.reshape(h, w, bpp).astype(np.int32)
    x = np.zeros((h + 1, w + 1, bpp), np.int32)     # 1-pixel zero border
    kind = kinds.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a, b, ul = x[r + 1, c], x[r, c + 1], x[r, c]
        k = kind[r][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, ul)], 0)
        x[r + 1, c + 1] = (f[r, c] + pred) & 255
    return x[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def read_png(path: str) -> np.ndarray:
    """Decode a gray or RGB PNG file: (H, W) or (H, W, 3) in the file's own
    channel order; uint8 or uint16 by bit depth."""
    with open(path, "rb") as fh:
        data = fh.read()
    idat, hdr = [], None
    for kind, body in _read_chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG")
    if depth not in (8, 16) or ctype not in _CHANNELS:
        raise NotImplementedError(f"{path}: bit depth {depth}, "
                                  f"color type {ctype}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if depth == 16:
        px = px.reshape(h, w * ch, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    img = px.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def imread_color(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as cv::imread(path, IMREAD_COLOR)."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., ::-1])     # RGB -> BGR


def imread_depth(path: str) -> np.ndarray:
    """Single-channel image at its own bit depth, as cv::imread(path,
    IMREAD_ANYDEPTH) does for a gray PNG."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: expected a single-channel depth PNG")
    return img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body \
        + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Encode (H, W, 3) uint8 BGR, or (H, W) uint8/uint16 gray (scanline
    filter 0, zlib `level`)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        ctype, depth = 2, 8
        data = img[..., ::-1]
    elif img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, img.dtype.itemsize * 8
        data = img.astype(">u2") if depth == 16 else img
    else:
        raise ValueError(f"unsupported image {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    out = _PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                 ctype, 0, 0, 0)) \
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) \
        + _chunk(b"IEND", b"")
    with open(path, "wb") as fh:
        fh.write(out)


# ---------------------------------------------------------------------------
# color conversion (OpenCV 8U fixed-point formulas)
# ---------------------------------------------------------------------------

def rgb2gray(img: np.ndarray) -> np.ndarray:
    """COLOR_RGB2GRAY on uint8, OpenCV's 15-bit fixed point:
    (9798 c0 + 19235 c1 + 3735 c2 + 2^14) >> 15."""
    c = img.astype(np.int32)
    return ((c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
             + (1 << 14)) >> 15).astype(np.uint8)


_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _HSV_SHIFT) / i), 0)
        hdiv = np.where(i > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * i)), 0)
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


_SDIV, _HDIV = _hsv_tables()


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """COLOR_RGB2HSV on uint8 (H in [0, 180)), OpenCV's integer tables."""
    c = img.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    vr = np.where(v == r, -1, 0)
    vg = np.where(v == g, -1, 0)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff))
                                 + (~vg & (r - g + 4 * diff))))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# ---------------------------------------------------------------------------
# resampling and filtering
# ---------------------------------------------------------------------------

def _taps_linear(n_out: int, n_in: int):
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    t = (f - i0).astype(np.float32)
    t = np.where(i0 < 0, 0.0, t).astype(np.float32)
    idx = np.clip(np.stack([i0, i0 + 1]), 0, n_in - 1)
    return idx, np.stack([1.0 - t, t]).astype(np.float32)


def _taps_cubic(n_out: int, n_in: int, a: float = -0.75):
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    x = (f - i0).astype(np.float32)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1.0 - c0 - c1 - c2
    idx = np.clip(np.stack([i0 - 1, i0, i0 + 1, i0 + 2]), 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3]).astype(np.float32)


def _resize(img: np.ndarray, size, taps) -> np.ndarray:
    w_out, h_out = size
    src = np.asarray(img)
    acc = np.float64 if src.dtype == np.float64 else np.float32
    x = src.astype(acc)
    ix, cx = taps(w_out, src.shape[1])
    iy, cy = taps(h_out, src.shape[0])
    shape_c = (1,) * (x.ndim - 2)
    tmp = sum(x[:, ix[k]] * cx[k].reshape((1, -1) + shape_c).astype(acc)
              for k in range(len(ix)))
    out = sum(tmp[iy[k]] * cy[k].reshape((-1, 1) + shape_c).astype(acc)
              for k in range(len(iy)))
    if np.issubdtype(src.dtype, np.integer):
        info = np.iinfo(src.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(src.dtype)
    return out.astype(src.dtype)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize to size = (width, height) (cv2 INTER_LINEAR)."""
    return _resize(img, size, _taps_linear)


def resize_cubic(img: np.ndarray, size) -> np.ndarray:
    """Bicubic resize to size = (width, height) (cv2 INTER_CUBIC)."""
    return _resize(img, size, _taps_cubic)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Correlate every channel with `kernel` (anchor at its center,
    BORDER_REFLECT_101), like cv2.filter2D(img, -1, kernel)."""
    k = np.asarray(kernel, np.float64)
    x = np.asarray(img, np.float32)
    if x.ndim == 2:
        return ndimage.correlate(x, k, mode="mirror").astype(np.float32)
    return np.stack([ndimage.correlate(x[..., c], k, mode="mirror")
                     for c in range(x.shape[2])], axis=-1).astype(np.float32)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """Separable Gaussian blur (BORDER_REFLECT_101), rounded back to the
    input's integer type."""
    r = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-r * r / (2.0 * sigma * sigma))
    k /= k.sum()
    x = np.asarray(img, np.float32)
    for axis in (0, 1):
        x = ndimage.correlate1d(x, k.astype(np.float32), axis=axis,
                                mode="mirror")
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(x), info.min, info.max).astype(img.dtype)
    return x


# ---------------------------------------------------------------------------
# FAST-9/16 corners
# ---------------------------------------------------------------------------

# Bresenham circle of radius 3, clockwise from 12 o'clock (OpenCV's order)
_RING = np.array([(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1),
                  (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1),
                  (-3, 0), (-3, -1), (-2, -2), (-1, -3)])


def _arc_min9(d: np.ndarray) -> np.ndarray:
    """max over the 16 arcs of 9 contiguous ring pixels of min(d) ->
    (H', W'); d is (16, H', W')."""
    dd = np.concatenate([d, d[:8]], axis=0)               # circular wrap
    m2 = np.minimum(dd[:-1], dd[1:])                      # arcs of 2
    m4 = np.minimum(m2[:-2], m2[2:])                      # arcs of 4
    m8 = np.minimum(m4[:-4], m4[4:])                      # arcs of 8
    m9 = np.minimum(m8[:16], dd[8:24])                    # arcs of 9
    return m9.max(axis=0)


def fast_scores(img: np.ndarray) -> np.ndarray:
    """OpenCV's FAST-9 corner strength for every pixel at least 3 from the
    border (0 elsewhere), before thresholding: the largest t for which the
    pixel would still be a corner, i.e. max over the 16 nine-pixel arcs of
    the smallest |center - ring| difference of one sign."""
    I = np.asarray(img, np.int16)
    h, w = I.shape
    out = np.zeros((h, w), np.int16)
    if h < 7 or w < 7:
        return out
    c = I[3:h - 3, 3:w - 3]
    ring = np.stack([I[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx]
                     for dx, dy in _RING])
    d = c[None] - ring                                    # > 0: ring darker
    out[3:h - 3, 3:w - 3] = np.maximum(_arc_min9(d), _arc_min9(-d))
    return out


def fast9(img: np.ndarray, threshold: int, scores: np.ndarray = None):
    """FAST-9/16 corners with 3x3 non-maximum suppression, as
    cv2.FastFeatureDetector_create(threshold).detect(img).

    Returns (xy (K, 2) int, response (K,) float32) in row-major order; the
    response is OpenCV's corner score (strength - 1). `scores` may pass a
    precomputed fast_scores(img) to share it between thresholds."""
    s = fast_scores(img) if scores is None else scores
    score = np.where(s > threshold, s - 1, 0).astype(np.int16)
    h, w = score.shape
    pad = np.pad(score, 1)
    keep = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= score > pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    ys, xs = np.nonzero(keep)
    return np.stack([xs, ys], axis=1), score[ys, xs].astype(np.float32)
