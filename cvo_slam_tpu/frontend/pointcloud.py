"""RGB-D frame -> fixed-capacity semi-dense colored point cloud.

Re-expression of reference pcd_generator
(/root/reference/thirdparty/cvo/src/pcd_generator.cpp:366-656): DSO pixel
selection, depth gating, pinhole back-projection, and the 5-D feature rows
[B, G, R, dI/dx, dI/dy] of feature_type 1 (:593-615, selected at :355).

Fidelity notes:
  * the reference converts BGR-loaded images with COLOR_RGB2GRAY
    (pcd_generator.cpp:624 after cv::imread in run_SLAM.cpp:137), i.e. the
    luma weights are applied to swapped channels; callers here are expected to
    pass exactly that gray image (see data.tum.load_image).
  * valid slots are Morton-ordered (Z-order over the cloud's 3-D bounding
    box) rather than raster-ordered: the CVO pairwise Pallas kernels skip
    whole (tile, tile) blocks whose bounding boxes are farther apart than the
    kernel gate radius, and Morton order makes tiles spatially compact (the
    dense-tile analogue of the reference's nanoflann kd-tree, cvo.cpp:122-139).
    Every consumer of the cloud/pixel arrays is order-insensitive (masked
    sums; set-style pixel gating in ORB extraction). Slots beyond `count`
    are masked.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import CameraConfig, FrontendParams
from . import pyramid, selector

NUM_FEATURES = 5  # data_type.h:26


@dataclass
class PointCloudHost:
    """Fixed-capacity point cloud (host-side numpy)."""
    positions: np.ndarray   # (CAP, 3) float32
    features: np.ndarray    # (CAP, 5) float32
    mask: np.ndarray        # (CAP,) bool
    count: int
    selected_pixels: np.ndarray  # (CAP, 2) int32 (x, y); CVO_selected_points


def _morton_order(pos: np.ndarray) -> np.ndarray:
    """Permutation sorting points along a 3-D Z-order (Morton) curve.

    10 bits per axis over the point set's bounding box; ties keep input
    (raster) order via stable argsort."""
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-9)
    q = ((pos - lo) / span * 1023.0).astype(np.uint64)
    q = np.minimum(q, 1023)

    def spread(v):  # interleave: bits of v spaced 3 apart (magic-bits trick)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def create_pointcloud(bgr: np.ndarray, gray: np.ndarray, depth: np.ndarray,
                      cam: CameraConfig, fp: FrontendParams) -> PointCloudHost:
    """bgr: (H,W,3) uint8 as loaded (BGR order); gray: (H,W) uint8/float;
    depth: (H,W) uint16 raw depth."""
    h, w = gray.shape
    intensity, dxs, dys, absgrads = pyramid.make_pyramid(
        gray.astype(np.float32), fp.pyr_levels)
    status, _ = selector.make_maps(
        absgrads, dxs[0], dys[0], fp.num_want,
        initial_potential=fp.initial_potential,
        recursions_left=fp.recursions, seed=fp.random_seed)

    dep = depth.astype(np.float32)
    keep = (status != 0) & (depth != 0) & np.isfinite(dep)
    ys, xs = np.nonzero(keep)           # raster order (row-major)
    n = min(len(xs), fp.cloud_capacity)
    xs, ys = xs[:n], ys[:n]

    cap = fp.cloud_capacity
    positions = np.zeros((cap, 3), np.float32)
    features = np.zeros((cap, NUM_FEATURES), np.float32)
    mask = np.zeros(cap, bool)
    pix = np.zeros((cap, 2), np.int32)

    z = dep[ys, xs] / cam.depth_factor
    positions[:n, 0] = (xs - cam.cx) * z / cam.fx
    positions[:n, 1] = (ys - cam.cy) * z / cam.fy
    positions[:n, 2] = z

    if fp.feature_type == 0:
        # HSV + gradients normalized to ~[0,1] (pcd_generator.cpp:570-592).
        # The reference applies COLOR_RGB2HSV to the BGR-loaded image
        # (load_image :625); rgb2hsv on the BGR array reproduces the
        # channel quirk exactly.
        from ..utils.imgproc import rgb2hsv
        hsv = rgb2hsv(bgr)
        features[:n, 0] = hsv[ys, xs, 0] / 180.0
        features[:n, 1] = hsv[ys, xs, 1] / 255.0
        features[:n, 2] = hsv[ys, xs, 2] / 255.0
        features[:n, 3] = dxs[0][ys, xs] / 255.0 * 2.0
        features[:n, 4] = dys[0][ys, xs] / 255.0 * 2.0
    else:
        # raw BGR + gradients (feature_type 1, pcd_generator.cpp:593-615)
        features[:n, 0:3] = bgr[ys, xs, :].astype(np.float32)
        features[:n, 3] = dxs[0][ys, xs]
        features[:n, 4] = dys[0][ys, xs]

    mask[:n] = True
    pix[:n, 0] = xs
    pix[:n, 1] = ys
    if n > 1:
        order = _morton_order(positions[:n])
        positions[:n] = positions[order]
        features[:n] = features[order]
        pix[:n] = pix[order]
    return PointCloudHost(positions, features, mask, n, pix)
