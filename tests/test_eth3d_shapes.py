"""ETH3D-shaped coverage: non-multiple-of-32 frames, non-128-multiple caps.

The ETH3D presets are 739x458 (reference config/ETH3D_*.yaml; pcd_generator
calibration groups) — neither dimension is a multiple of 32 (selector blocks)
and natural cloud capacities like 3000 are not multiples of the kernel
blocks. These tests drive the selector -> cloud -> align stack at exactly
those shapes.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from cvo_slam_tpu.config import CAMERA_PRESETS, CvoParams, FrontendParams
from cvo_slam_tpu.cvo import engine
from cvo_slam_tpu.frontend import device as dev
from cvo_slam_tpu.frontend.pointcloud import create_pointcloud
from cvo_slam_tpu.utils import imgproc

ETH_CAM_SMALL = dataclasses.replace(
    CAMERA_PRESETS["ETH3D_1"], width=369, height=229,
    fx=363.14, fy=363.14, cx=177.32, cy=93.23)   # half-res, still ragged
ETH_FP = FrontendParams(num_want=900, cloud_capacity=1000)  # 1000 % 128 != 0


def _frame(cam, seed=11):
    rng = np.random.default_rng(seed)
    H, W = cam.height, cam.width
    tex = imgproc.resize_cubic(rng.uniform(30, 220, (H // 8 + 1, W // 8 + 1,
                                                     3)).astype(np.float32),
                               (W, H))
    bgr = np.clip(tex, 0, 255).astype(np.uint8)
    gray = imgproc.rgb2gray(bgr)
    zz = (2.0 + 0.3 * np.sin(np.linspace(0, 3, W))[None, :]
          + 0.2 * np.cos(np.linspace(0, 2, H))[:, None]).astype(np.float32)
    depth = (zz * cam.depth_factor).astype(np.uint16)
    return bgr, gray, depth


def test_host_frontend_full_eth3d_shape():
    """Full-resolution ETH3D frame (739x458) through the host selector +
    cloud builder with a non-128-multiple capacity."""
    cam = CAMERA_PRESETS["ETH3D_1"]
    fp = FrontendParams(num_want=3000, cloud_capacity=3000)
    bgr, gray, depth = _frame(cam)
    pc = create_pointcloud(bgr, gray, depth, cam, fp)
    assert 0 < pc.count <= 3000
    assert pc.positions.shape == (3000, 3)
    assert np.isfinite(pc.positions[:pc.count]).all()


def test_device_frontend_matches_host_eth3d_shape():
    bgr, gray, depth = _frame(ETH_CAM_SMALL)
    host_pc = create_pointcloud(bgr, gray, depth, ETH_CAM_SMALL, ETH_FP)
    pos, feat, mask, count, pix = dev.create_pointcloud_device(
        bgr, gray, depth, ETH_CAM_SMALL, ETH_FP)
    assert int(count) == host_pc.count
    n = host_pc.count
    hset = {tuple(r) for r in host_pc.selected_pixels[:n].tolist()}
    dset = {tuple(r) for r in np.asarray(pix)[:n].tolist()}
    assert hset == dset


def _cloud_from(pc):
    return engine.PointCloud(jnp.asarray(pc.positions),
                             jnp.asarray(pc.features),
                             jnp.asarray(pc.mask))


def test_align_xla_ragged_capacity():
    """XLA align end-to-end on ETH3D-shaped clouds (capacity 1000)."""
    bgr, gray, depth = _frame(ETH_CAM_SMALL)
    bgr2, gray2, depth2 = bgr.copy(), gray.copy(), depth.copy()
    # shift the second frame by 2 px (a small pure-translation motion)
    bgr2[:, 2:] = bgr[:, :-2]
    gray2[:, 2:] = gray[:, :-2]
    depth2[:, 2:] = depth[:, :-2]
    f = _cloud_from(create_pointcloud(bgr, gray, depth, ETH_CAM_SMALL, ETH_FP))
    m = _cloud_from(create_pointcloud(bgr2, gray2, depth2, ETH_CAM_SMALL,
                                      ETH_FP))
    p = CvoParams(max_iter=50)
    res = engine.align(f, m, np.eye(3, dtype=np.float32),
                       np.zeros(3, np.float32), np.float32(p.ell_init), p,
                       "xla")
    T = np.asarray(res.transform)
    assert np.isfinite(T).all()
    assert int(res.nnz) > 0
    # recovered motion is a small mostly-x translation
    assert abs(T[0, 3]) > 1e-4
    assert np.linalg.norm(T[:3, 3]) < 0.2
