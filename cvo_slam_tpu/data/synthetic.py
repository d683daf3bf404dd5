"""Synthetic TUM-format RGB-D sequence generator (for tests + benches).

Renders a textured wavy-depth scene from a smooth SE(3) camera trajectory by
inverse reprojection from the base frame, writes PNGs + association file +
groundtruth.txt so the full CLI path runs without downloading datasets.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import CameraConfig
from ..ops import se3
from ..utils import imgproc
import jax.numpy as jnp


def _base_scene(cam: CameraConfig, rng, texture_strength: float = 1.0,
                randomize_depth: bool = False, extent: float = 1.0,
                multi_surface: bool = False):
    """texture_strength < 1 compresses contrast toward mid-gray (the paper's
    texture-less challenge mode, reference README.md:3).
    randomize_depth draws the wavy-depth frequencies/phases from rng so
    different seeds produce genuinely different geometry (distinct "places"
    for place-recognition tests).
    extent > 1 renders a world surface that many times wider/taller than one
    frustum (pixel grid extended symmetrically) so metre-scale trajectories
    keep scene overlap; the returned arrays are (H*extent, W*extent)-ish and
    anchored so the central HxW crop is the frame-0 view.
    multi_surface adds foreground slabs at distinct depths with their own
    textures — real depth discontinuities for edge-dropout noise to act on."""
    H = int(round(cam.height * extent))
    W = int(round(cam.width * extent))
    base = rng.uniform(0, 255, (max(H // 8, 2), max(W // 8, 2))
                       ).astype(np.float32)
    tex = imgproc.resize_cubic(base, (W, H))
    tex = 127.5 + texture_strength * (tex - 127.5)
    bgr = np.stack([tex,
                    127.5 + texture_strength * (np.roll(tex, 3, 0) - 127.5),
                    127.5 + texture_strength * (np.roll(tex, 5, 1) - 127.5)],
                   -1).clip(0, 255).astype(np.uint8)
    if randomize_depth:
        ax, ay = rng.uniform(1.5, 4.5) * extent, rng.uniform(1.0, 3.0) * extent
        px, py = rng.uniform(0, 2 * np.pi, 2)
        z = (2.0 + 0.5 * np.sin(np.linspace(0, ax, W) + px)[None, :]
             + 0.3 * np.cos(np.linspace(0, ay, H) + py)[:, None])
    else:
        z = (2.0 + 0.5 * np.sin(np.linspace(0, 3 * extent, W))[None, :]
             + 0.3 * np.cos(np.linspace(0, 2 * extent, H))[:, None])
    if multi_surface:
        # a handful of textured rectangular slabs floating in front of the
        # background sheet (constant-ish depth each, +-3 cm waviness)
        n_slabs = max(3, int(3 * extent * extent))
        for _ in range(n_slabs):
            sw = int(rng.uniform(0.12, 0.30) * W)
            sh = int(rng.uniform(0.12, 0.30) * H)
            x0 = int(rng.uniform(0, W - sw))
            y0 = int(rng.uniform(0, H - sh))
            zs = rng.uniform(0.9, 1.6)
            slab_tex = imgproc.resize_cubic(
                rng.uniform(0, 255, (max(sh // 6, 2), max(sw // 6, 2))
                            ).astype(np.float32), (sw, sh))
            slab_tex = 127.5 + texture_strength * (slab_tex - 127.5)
            wave = 0.03 * np.sin(np.linspace(0, 4, sw))[None, :]
            z[y0:y0 + sh, x0:x0 + sw] = zs + wave
            for c, roll in ((0, 0), (1, 2), (2, 4)):
                bgr[y0:y0 + sh, x0:x0 + sw, c] = np.clip(
                    np.roll(slab_tex, roll, axis=0), 0, 255).astype(np.uint8)
    return bgr, z.astype(np.float64)


# ---------------------------------------------------------------------------
# Kinect-style sensor model (applied per rendered frame when noise=True)
# ---------------------------------------------------------------------------

def apply_sensor_noise(bgr, depth_u16, cam: CameraConfig, rng,
                       pixel_shift=0.0,
                       depth_sigma=(0.0012, 0.0019),
                       depth_quant: float = 2.85e-5,
                       edge_dropout: float = 0.6,
                       speckle_dropout: float = 0.01,
                       rgb_sigma: float = 2.5):
    """Degrade a clean rendered RGB-D frame with a Kinect-like sensor model:

      * axial depth noise sigma(z) = a + b (z - 0.4)^2   [Nguyen et al. 2012]
      * disparity-step quantization dz = depth_quant * z^2 (structured-light
        triangulation: depth resolution degrades quadratically with range)
      * edge dropout: pixels on strong depth discontinuities lose their
        return with probability `edge_dropout` (occlusion shadows of the
        IR projector) + uniform `speckle_dropout`
      * RGB: additive Gaussian read noise (sigma in 8-bit DN) and, when
        `pixel_shift` > ~0.5 px/frame, directional motion blur of that
        length along the dominant image motion.

    Returns (bgr, depth_u16) copies; input arrays are not modified."""
    H, W = depth_u16.shape
    z = depth_u16.astype(np.float64) / cam.depth_factor
    valid = z > 0

    # axial noise + quantization
    a, b = depth_sigma
    sig = a + b * np.square(np.maximum(z - 0.4, 0.0))
    z_noisy = z + rng.normal(0.0, 1.0, z.shape) * sig
    dz = depth_quant * np.square(np.maximum(z_noisy, 0.3))
    z_noisy = np.where(dz > 0, np.round(z_noisy / np.maximum(dz, 1e-9)) * dz,
                       z_noisy)

    # edge dropout: strong depth gradient -> lost return
    gx = np.abs(np.diff(z, axis=1, prepend=z[:, :1]))
    gy = np.abs(np.diff(z, axis=0, prepend=z[:1, :]))
    edge = (np.maximum(gx, gy) > 0.04) & valid
    drop = edge & (rng.uniform(size=z.shape) < edge_dropout)
    drop |= valid & (rng.uniform(size=z.shape) < speckle_dropout)
    z_noisy = np.where(valid & ~drop, z_noisy, 0.0)
    depth_out = np.clip(z_noisy * cam.depth_factor, 0, 65535).astype(np.uint16)

    out = bgr.astype(np.float32)
    shift = float(np.hypot(pixel_shift[0], pixel_shift[1])) \
        if np.ndim(pixel_shift) else float(pixel_shift)
    if shift > 0.5:
        # directional box blur of `shift` pixels along the motion direction
        L = int(min(np.ceil(shift), 9))
        if L >= 2:
            kern = np.zeros((L, L), np.float32)
            if np.ndim(pixel_shift):
                ang = np.arctan2(pixel_shift[1], pixel_shift[0])
            else:
                ang = 0.0
            cx_, cy_ = (L - 1) / 2.0, (L - 1) / 2.0
            for t in np.linspace(-0.5, 0.5, 2 * L + 1):
                px = cx_ + t * (L - 1) * np.cos(ang)
                py = cy_ + t * (L - 1) * np.sin(ang)
                kern[int(round(py)), int(round(px))] += 1.0
            kern /= kern.sum()
            out = imgproc.filter2d(out, kern)
    if rgb_sigma > 0:
        out = out + rng.normal(0.0, rgb_sigma, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8), depth_out


def make_sequence(folder: str, cam: CameraConfig, n_frames: int = 12,
                  seed: int = 7, step_twist=None, trajectory=None,
                  texture_strength: float = 1.0, exposure_ramp: float = 0.0,
                  randomize_depth: bool = False, extent: float = 1.0,
                  multi_surface: bool = False, noise: bool = False,
                  noise_kwargs: dict | None = None):
    """Create a synthetic sequence under `folder`. Returns the ground-truth
    cam->world poses (N,4,4).

    trajectory: optional explicit list of per-frame world->cam transforms
    G_k (p_k = G_k p_0); overrides the constant step_twist walk — lets tests
    build loops that revisit the start.
    texture_strength: contrast multiplier (<1 = texture-less challenge mode).
    exposure_ramp: fractional brightness gain reached at the last frame
    (e.g. 0.6 = +60% linear over-exposure ramp, the paper's challenge mode).
    extent: world surface size in frustum widths (>1 keeps metre-scale
    trajectories inside rendered scenery).
    multi_surface: add foreground slabs (depth discontinuities).
    noise: run every written frame through apply_sensor_noise (Kinect-style
    axial sigma ~ z^2 + quantization + edge/speckle dropout + RGB read noise
    + motion blur scaled to the actual per-frame pixel motion)."""
    os.makedirs(os.path.join(folder, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(folder, "depth"), exist_ok=True)
    rng = np.random.default_rng(seed)
    bgr0, z0 = _base_scene(cam, rng, texture_strength, randomize_depth,
                           extent, multi_surface)
    H, W = cam.height, cam.width
    # frame-0 view = central HxW crop of the (possibly extended) world sheet
    off_x = (bgr0.shape[1] - W) // 2
    off_y = (bgr0.shape[0] - H) // 2
    bgr_c0 = bgr0[off_y:off_y + H, off_x:off_x + W]
    z_c0 = z0[off_y:off_y + H, off_x:off_x + W]
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy

    if step_twist is None:
        step_twist = np.array([0.004, -0.006, 0.003, 0.010, -0.006, 0.008])
    G_step = np.asarray(se3.exp_se3(jnp.asarray(step_twist, jnp.float32)),
                        np.float64)

    # Supersampled source surface (3x) for the forward splat: rapid motion
    # leaves splat holes at native resolution, and filling them from the
    # UNWARPED base frame (the round-1 recipe) feeds the tracker stale
    # no-motion pixels — corrupting exactly the fast-motion challenge modes.
    # Dense splatting closes almost all holes; the few left stay INVALID
    # (depth 0, black), which the selector/ORB gates legitimately skip.
    # extended worlds (extent > 1) use a 2x supersample: the splat cost
    # scales with the world grid (extent^2 * SS^2 * H * W points per frame)
    # and 2x is still >= 4 source points per target pixel; residual oblique-
    # angle holes stay invalid (depth 0), which the selector/ORB gates skip
    SS = 3 if extent == 1.0 else 2
    Hw, Ww = bgr0.shape[:2]
    Hs, Ws = Hw * SS, Ww * SS
    bgr_s = imgproc.resize_linear(bgr0, (Ws, Hs))
    z_s = imgproc.resize_linear(z0, (Ws, Hs))
    ys_s, xs_s = np.mgrid[0:Hs, 0:Ws]
    # native-res pixel coordinates in the FRAME-0 camera (world crop offset
    # removed, so extent > 1 sheets extend symmetrically past the frustum)
    xf = (xs_s + 0.5) / SS - 0.5 - off_x
    yf = (ys_s + 0.5) / SS - 0.5 - off_y
    P0 = np.stack([(xf - cx) * z_s / fx, (yf - cy) * z_s / fy, z_s],
                  -1).reshape(-1, 3)
    src_colors = bgr_s.reshape(-1, 3)

    assoc, gt = [], []
    G = np.eye(4)   # frame k camera pose relative to frame 0: p_k = G p_0
    G_prev = np.eye(4)
    if trajectory is not None:
        n_frames = len(trajectory)
    for k in range(n_frames):
        if trajectory is not None:
            G = np.asarray(trajectory[k], np.float64)
        ts = f"{1000.0 + 0.05 * k:.6f}"
        if k == 0 and np.allclose(G, np.eye(4)):
            bgr, depth = bgr_c0.copy(), (z_c0 * cam.depth_factor
                                         ).astype(np.uint16)
        else:
            Pw = P0 @ G[:3, :3].T + G[:3, 3]
            zw = Pw[:, 2]
            u = np.round(Pw[:, 0] / zw * fx + cx).astype(np.int64)
            v = np.round(Pw[:, 1] / zw * fy + cy).astype(np.int64)
            m = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (zw > 0.1)
            # z-ordered splat: write far-to-near so the nearest point wins
            order = np.argsort(-zw[m], kind="stable")
            ui, vi = u[m][order], v[m][order]
            bgr = np.zeros((H, W, 3), np.uint8)
            depth = np.zeros((H, W), np.uint16)
            bgr[vi, ui] = src_colors[m][order]
            depth[vi, ui] = (zw[m][order] * cam.depth_factor
                             ).astype(np.uint16)
        if exposure_ramp != 0.0 and n_frames > 1:
            gain = 1.0 + exposure_ramp * (k / (n_frames - 1))
            bgr = np.clip(bgr.astype(np.float32) * gain, 0, 255
                          ).astype(np.uint8)
        if noise:
            # apparent pixel motion of the scene center between k-1 and k
            # drives the motion-blur length/direction
            zc = float(np.median(z_c0))
            Pc = np.array([0.0, 0.0, zc])
            cur = G[:3, :3] @ Pc + G[:3, 3]
            prv = G_prev[:3, :3] @ Pc + G_prev[:3, 3]
            shift = ((cur[0] / cur[2] - prv[0] / prv[2]) * fx,
                     (cur[1] / cur[2] - prv[1] / prv[2]) * fy)
            bgr, depth = apply_sensor_noise(bgr, depth, cam, rng,
                                            pixel_shift=shift,
                                            **(noise_kwargs or {}))
        G_prev = G.copy()
        rgb_rel = f"rgb/{ts}.png"
        dep_rel = f"depth/{ts}.png"
        imgproc.write_png(os.path.join(folder, rgb_rel), bgr)
        imgproc.write_png(os.path.join(folder, dep_rel), depth)
        assoc.append(f"{ts} {rgb_rel} {ts} {dep_rel}")
        gt.append(np.linalg.inv(G))   # cam->world pose of frame k
        G = G_step @ G

    with open(os.path.join(folder, "associate.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    from .tum import write_trajectory
    write_trajectory(os.path.join(folder, "groundtruth.txt"),
                     [(f"{1000.0 + 0.05 * k:.6f}", gt[k]) for k in range(n_frames)])
    return np.array(gt)
