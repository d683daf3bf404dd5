"""The tracking benchmark's point-cloud workloads (host side).

Real frontend clouds of a synthetic TUM-format scene at the shipped cloud
capacity (3072 slots, ~3000 valid points, the reference workload shape:
SURVEY.md section 6). Shared by bench.py, chip_smoke.py and
tools/measure_reference_baseline.py, so every consumer runs the same clouds.
"""

from __future__ import annotations

import numpy as np

from ..data.synthetic import _base_scene
from ..frontend.pointcloud import create_pointcloud
from ..ops import se3
from ..utils.imgproc import rgb2gray


def _view(cam, cfg, bgr0, z0, G=None):
    """The frontend cloud of the base scene seen after the rigid motion G
    (None: the base view). Every base pixel is forward-warped to its new
    position; pixels nothing lands on keep the base view's color and
    depth."""
    H, W = cam.height, cam.width
    if G is None:
        bgr, depth = bgr0, (z0 * cam.depth_factor).astype(np.uint16)
    else:
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        ys, xs = np.mgrid[0:H, 0:W]
        P0 = np.stack([(xs - cx) * z0 / fx, (ys - cy) * z0 / fy, z0],
                      -1).reshape(-1, 3)
        Pw = P0 @ G[:3, :3].T + G[:3, 3]
        u = (Pw[:, 0] / Pw[:, 2] * fx + cx).reshape(H, W)
        v = (Pw[:, 1] / Pw[:, 2] * fy + cy).reshape(H, W)
        m = (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
        bgr = np.zeros_like(bgr0)
        depth = np.zeros((H, W), np.uint16)
        ui, vi = u[m].astype(int), v[m].astype(int)
        bgr[vi, ui] = bgr0[ys[m], xs[m]]
        depth[vi, ui] = (Pw[:, 2].reshape(H, W)[m] * cam.depth_factor
                         ).astype(np.uint16)
        holes = depth == 0
        bgr[holes] = bgr0[holes]
        depth[holes] = (z0[holes] * cam.depth_factor).astype(np.uint16)
    return create_pointcloud(bgr, rgb2gray(bgr), depth, cam, cfg.frontend)


def bench_host_clouds(cam, cfg):
    """The 4 host point clouds of the bench workload (synthetic TUM scene,
    ~3000 selected points each) — shared with tools/measure_reference_baseline
    so the C++ reference-cost replica runs on the IDENTICAL clouds."""
    import jax.numpy as jnp

    bgr0, z0 = _base_scene(cam, np.random.default_rng(7))
    step = np.asarray(se3.exp_se3(jnp.asarray(
        np.array([0.004, -0.006, 0.003, 0.010, -0.006, 0.008], np.float32))),
        np.float64)
    host_clouds = []
    G = np.eye(4)
    for k in range(4):
        host_clouds.append(_view(cam, cfg, bgr0, z0, G if k else None))
        G = step @ G
    return host_clouds


def parity_host_clouds(cam, cfg, n=32):
    """Clouds along an oscillating trajectory (direction-changing per-frame
    motion, peak comparable to the headline workload's step) for the
    tracker-parity row: warm-started frames, like the real tracker. The
    oscillation matters — on a constant-velocity path the warm start equals
    the solution and align converges in ~1 iteration, overstating fps."""
    import jax.numpy as jnp

    bgr0, z0 = _base_scene(cam, np.random.default_rng(7))
    amp = np.array([0.05, -0.06, 0.03, 0.08, -0.05, 0.06], np.float32)
    host_clouds = [_view(cam, cfg, bgr0, z0)]
    for k in range(1, n):
        G = np.asarray(se3.exp_se3(jnp.asarray(
            amp * np.sin(2.0 * np.pi * k / 14.0))), np.float64)
        host_clouds.append(_view(cam, cfg, bgr0, z0, G))
    return host_clouds
