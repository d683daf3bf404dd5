"""utils.imgproc against OpenCV, where OpenCV is installed: pixel-exact PNG
codec, gray and HSV, the same FAST keypoints and scores, and resampling /
filtering within one gray level (float: rounding level)."""

import os

import numpy as np
import pytest

from cvo_slam_tpu.utils import imgproc

cv2 = pytest.importorskip("cv2")


def _texture(h=120, w=160, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    tex = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.stack([tex, np.roll(tex, 3, 0), np.roll(tex, 5, 1)],
                    -1).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("level", [0, 1, 9])
def test_png_read_matches_cv2_written(tmp_path, level):
    bgr = _texture()
    depth = (np.random.default_rng(1).uniform(0.4, 6.0, (120, 160))
             * 5000).astype(np.uint16)
    flags = [cv2.IMWRITE_PNG_COMPRESSION, level]
    cv2.imwrite(str(tmp_path / "c.png"), bgr, flags)
    cv2.imwrite(str(tmp_path / "d.png"), depth, flags)
    np.testing.assert_array_equal(imgproc.imread_color(str(tmp_path / "c.png")),
                                  bgr)
    np.testing.assert_array_equal(imgproc.imread_depth(str(tmp_path / "d.png")),
                                  depth)


@pytest.mark.parametrize("kind", ["gray8", "rgba", "gray16_color"])
def test_png_read_other_layouts(tmp_path, kind):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "x.png")
    if kind == "gray8":
        img = rng.integers(0, 256, (33, 47), dtype=np.uint8)
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(imgproc.read_png(path), img)
        np.testing.assert_array_equal(imgproc.imread_color(path),
                                      cv2.imread(path))
    elif kind == "rgba":
        # layouts RGB-D datasets do not use are refused, not misread
        cv2.imwrite(path, rng.integers(0, 256, (31, 29, 4), dtype=np.uint8))
        with pytest.raises(NotImplementedError):
            imgproc.read_png(path)
    else:
        img = rng.integers(0, 65536, (20, 30), dtype=np.uint16)
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(imgproc.imread_depth(path),
                                      cv2.imread(path, cv2.IMREAD_ANYDEPTH))


def test_png_write_read_by_cv2(tmp_path):
    bgr = _texture(97, 131)
    depth = np.random.default_rng(3).integers(0, 65536, (97, 131),
                                              dtype=np.uint16)
    gray = bgr[..., 1].copy()
    for name, img, flag in (("c.png", bgr, cv2.IMREAD_COLOR),
                            ("d.png", depth, cv2.IMREAD_ANYDEPTH),
                            ("g.png", gray, cv2.IMREAD_GRAYSCALE)):
        path = str(tmp_path / name)
        imgproc.write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path, flag), img)
        np.testing.assert_array_equal(imgproc.read_png(path),
                                      img[..., ::-1] if img.ndim == 3
                                      else img)


def test_png_all_filter_types(tmp_path):
    """Scanlines with filters 0-4 (each row its own filter)."""
    import struct
    import zlib
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (10, 9, 3), dtype=np.uint8).astype(np.int32)
    bpp, h = 3, img.shape[0]
    rows, prev = [], np.zeros(9 * 3, np.int32)
    for r in range(h):
        x = img[r].reshape(-1)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        kind = r % 5
        pred = [np.zeros_like(x), a, prev, (a + prev) // 2,
                imgproc._paeth(a, prev, c)][kind]
        rows.append(bytes([kind]) + ((x - pred) & 255).astype(np.uint8)
                    .tobytes())
        prev = x
    body = struct.pack(">IIBBBBB", 9, h, 8, 2, 0, 0, 0)
    data = imgproc._PNG_SIG + imgproc._chunk(b"IHDR", body) \
        + imgproc._chunk(b"IDAT", zlib.compress(b"".join(rows))) \
        + imgproc._chunk(b"IEND", b"")
    path = str(tmp_path / "f.png")
    with open(path, "wb") as fh:
        fh.write(data)
    np.testing.assert_array_equal(imgproc.read_png(path), img)
    np.testing.assert_array_equal(imgproc.imread_color(path), cv2.imread(path))


def test_gray_and_hsv_bit_exact():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    # every (v, diff) corner of the HSV tables appears
    img[0, :, :] = np.arange(256, dtype=np.uint8)[:, None]
    img[1, :, 0] = np.arange(256, dtype=np.uint8)
    for x in (img, _texture()):
        np.testing.assert_array_equal(imgproc.rgb2gray(x),
                                      cv2.cvtColor(x, cv2.COLOR_RGB2GRAY))
        np.testing.assert_array_equal(imgproc.rgb2hsv(x),
                                      cv2.cvtColor(x, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("threshold", [7, 20])
def test_fast_matches_cv2(threshold):
    gray = cv2.cvtColor(_texture(240, 320, seed=6), cv2.COLOR_RGB2GRAY)
    xy, resp = imgproc.fast9(gray, threshold)
    kps = cv2.FastFeatureDetector_create(threshold).detect(gray)
    ref_xy = np.array([k.pt for k in kps], np.float64).astype(np.int64)
    ref_resp = np.array([k.response for k in kps], np.float32)
    order = np.lexsort((ref_xy[:, 0], ref_xy[:, 1]))       # row-major
    assert len(xy) > 100
    np.testing.assert_array_equal(xy, ref_xy[order])
    np.testing.assert_array_equal(resp, ref_resp[order])


@pytest.mark.parametrize("size", [(533, 400), (1920, 1440), (37, 23)])
def test_resize_linear_close_to_cv2(size):
    gray = cv2.cvtColor(_texture(480, 640, seed=7), cv2.COLOR_RGB2GRAY)
    got = imgproc.resize_linear(gray, size)
    ref = cv2.resize(gray, size, interpolation=cv2.INTER_LINEAR)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got.astype(int) - ref).max() <= 1
    z = np.random.default_rng(8).uniform(1, 3, (48, 64))
    np.testing.assert_allclose(
        imgproc.resize_linear(z, size),
        cv2.resize(z, size, interpolation=cv2.INTER_LINEAR), atol=1e-6)


def test_resize_cubic_close_to_cv2():
    base = np.random.default_rng(9).uniform(0, 255, (60, 80)).astype(
        np.float32)
    np.testing.assert_allclose(
        imgproc.resize_cubic(base, (640, 480)),
        cv2.resize(base, (640, 480), interpolation=cv2.INTER_CUBIC),
        atol=1e-3)


def test_filters_close_to_cv2():
    bgr = _texture(120, 160, seed=10)
    k = np.zeros((4, 4), np.float32)
    k[1, 0], k[2, 3], k[0, 2] = 1, 2, 1
    k /= k.sum()
    np.testing.assert_allclose(imgproc.filter2d(bgr.astype(np.float32), k),
                               cv2.filter2D(bgr.astype(np.float32), -1, k),
                               atol=1e-3)
    gray = bgr[..., 0].copy()
    got = imgproc.gaussian_blur(gray, 7, 2.0)
    ref = cv2.GaussianBlur(gray, (7, 7), 2,
                           borderType=cv2.BORDER_REFLECT_101)
    assert np.abs(got.astype(int) - ref).max() <= 1


def test_main_path_modules_import_without_cv2():
    """Importing the whole main path with OpenCV blocked (fresh process)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import cvo_slam_tpu.app.run_slam, cvo_slam_tpu.eval.suite\n"
            "import cvo_slam_tpu.features.orb, cvo_slam_tpu.data.synthetic\n"
            "import cvo_slam_tpu.backend.loop_closure, bench, chip_smoke\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
