"""Device-side (jnp/XLA) frontend: pyramid, DSO selection, back-projection.

Device re-expression of the host frontend (pyramid.py / selector.py /
pointcloud.py, themselves re-expressions of reference pcd_generator.cpp:50-143
and PixelSelector2.cpp) so the whole per-frame pipeline can run on device and
be vmapped over frames/sequences (SURVEY.md section 7 phase 3). Semantics
match the host path operation-for-operation:

  * pyramid: 2x2 box downsample + flattened central-difference gradients
    (the reference's row-wrap quirk at columns 0/w-1 included);
  * make_hists: per-32x32-block histograms via one segment-sum, the
    computeHistQuantil walk as a cumsum threshold, 3x3 count-aware smoothing;
  * select: per-pot-block argmax hierarchy with the level-1 lock semantics
    (PixelSelector2.cpp:417-421). `pot` is a static argument — XLA block
    reductions need static tile shapes; the host-side potential-adaptation
    loop (makeMaps) calls the jitted pass per pot value it visits (the same
    values the host selector visits, so results agree);
  * the glibc-rand sub-sample pattern is precomputed host-side (bit-exact,
    selector.random_pattern) and applied on device with a cumsum rank;
  * back-projection emits the fixed-capacity Morton-ordered cloud
    (positions/features/mask + selected pixel list) entirely on device.

The host path remains the default for the streaming CLI (it overlaps device
compute via data.prefetch); this module is the batched/on-device alternative.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig, FrontendParams
from . import selector as host_selector

SETTING_GRAD_DOWNWEIGHT = host_selector.SETTING_GRAD_DOWNWEIGHT
SETTING_MIN_GRAD_HIST_CUT = host_selector.SETTING_MIN_GRAD_HIST_CUT
SETTING_MIN_GRAD_HIST_ADD = host_selector.SETTING_MIN_GRAD_HIST_ADD


# ---------------------------------------------------------------------------
# pyramid (pcd_generator.cpp:50-143)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("levels",))
def make_pyramid(gray, levels: int = 3):
    """gray (H, W) f32 -> per-level lists (intensity, dx, dy, absgrad)."""
    intensity, dxs, dys, absgrads = [], [], [], []
    cur = gray.astype(jnp.float32)
    hl, wl = gray.shape
    for lvl in range(levels):
        if lvl > 0:
            prev = intensity[lvl - 1]
            wl //= 2
            hl //= 2
            cur = 0.25 * (prev[0:2 * hl:2, 0:2 * wl:2]
                          + prev[0:2 * hl:2, 1:2 * wl:2]
                          + prev[1:2 * hl:2, 0:2 * wl:2]
                          + prev[1:2 * hl:2, 1:2 * wl:2])
        flat = cur.reshape(-1)
        n = flat.shape[0]
        dx = jnp.zeros(n, jnp.float32)
        dy = jnp.zeros(n, jnp.float32)
        dx = dx.at[wl:wl * (hl - 1)].set(
            0.5 * (flat[wl + 1: wl * (hl - 1) + 1]
                   - flat[wl - 1: wl * (hl - 1) - 1]))
        dy = dy.at[wl:wl * (hl - 1)].set(
            0.5 * (flat[2 * wl: wl * hl] - flat[0: wl * (hl - 2)]))
        ag = dx * dx + dy * dy
        intensity.append(cur)
        dxs.append(dx.reshape(hl, wl))
        dys.append(dy.reshape(hl, wl))
        absgrads.append(ag.reshape(hl, wl))
    return intensity, dxs, dys, absgrads


# ---------------------------------------------------------------------------
# make_hists (PixelSelector2.cpp:71-136)
# ---------------------------------------------------------------------------

@jax.jit
def make_hists(absgrad0):
    h, w = absgrad0.shape
    h32, w32 = h // 32, w // 32
    g = jnp.minimum(jnp.sqrt(absgrad0).astype(jnp.int32), 48)

    valid = jnp.zeros((h, w), bool).at[1:h - 1, 1:w - 1].set(True)
    gb = g[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32)
    vb = valid[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32)
    block_id = (jnp.arange(h32)[:, None, None, None] * w32
                + jnp.arange(w32)[None, None, :, None])
    keys = jnp.where(vb, block_id * 49 + gb, h32 * w32 * 49)
    hist = jnp.zeros(h32 * w32 * 49 + 1, jnp.int32).at[keys.reshape(-1)].add(1)
    hist = hist[:-1].reshape(h32, w32, 49)
    total = hist.sum(axis=-1)

    th0 = (total.astype(jnp.float32) * SETTING_MIN_GRAD_HIST_CUT
           + 0.5).astype(jnp.int64)
    cs1 = jnp.cumsum(hist, axis=-1)
    above = cs1 > th0[..., None]
    quant = jnp.where(above.any(axis=-1), jnp.argmax(above, axis=-1), 90)
    ths = (quant + SETTING_MIN_GRAD_HIST_ADD).astype(jnp.float32)

    pad = jnp.zeros((h32 + 2, w32 + 2), jnp.float32).at[1:-1, 1:-1].set(ths)
    cnt = jnp.zeros((h32 + 2, w32 + 2), jnp.float32).at[1:-1, 1:-1].set(1.0)
    ssum = jnp.zeros((h32, w32), jnp.float32)
    snum = jnp.zeros((h32, w32), jnp.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ssum = ssum + pad[1 + dy:h32 + 1 + dy, 1 + dx:w32 + 1 + dx]
            snum = snum + cnt[1 + dy:h32 + 1 + dy, 1 + dx:w32 + 1 + dx]
    sm = ssum / snum
    return sm * sm


# ---------------------------------------------------------------------------
# select (PixelSelector2.cpp:290-433) — static pot
# ---------------------------------------------------------------------------

def _block_argmax(score, valid, bs, w):
    h = score.shape[0]
    hb, wb = -(-h // bs), -(-w // bs)
    ph, pw = hb * bs, wb * bs
    sp = jnp.full((ph, pw), -jnp.inf, jnp.float32)
    sp = sp.at[:h, :w].set(jnp.where(valid, score, -jnp.inf))
    tiles = sp.reshape(hb, bs, wb, bs).transpose(0, 2, 1, 3).reshape(
        hb, wb, bs * bs)
    loc = jnp.argmax(tiles, axis=-1)
    best = jnp.take_along_axis(tiles, loc[..., None], axis=-1)[..., 0]
    has = jnp.isfinite(best)
    ly, lx = loc // bs, loc % bs
    gy = jnp.arange(hb)[:, None] * bs + ly
    gx = jnp.arange(wb)[None, :] * bs + lx
    return gy * w + gx, has


def _any_in_blocks(mask, bs):
    h, w = mask.shape
    hb, wb = -(-h // bs), -(-w // bs)
    mp = jnp.zeros((hb * bs, wb * bs), bool).at[:h, :w].set(mask)
    return mp.reshape(hb, bs, wb, bs).any(axis=(1, 3))


def _lock_after_first(pick1):
    hb, wb = pick1.shape
    hb4, wb4 = -(-hb // 2), -(-wb // 2)
    p = jnp.zeros((hb4 * 2, wb4 * 2), bool).at[:hb, :wb].set(pick1)
    g = p.reshape(hb4, 2, wb4, 2).transpose(0, 2, 1, 3).reshape(hb4, wb4, 4)
    prior = jnp.stack([jnp.zeros_like(g[..., 0]), g[..., 0],
                       g[..., 0] | g[..., 1],
                       g[..., 0] | g[..., 1] | g[..., 2]], axis=-1)
    a = (~prior).reshape(hb4, wb4, 2, 2).transpose(0, 2, 1, 3).reshape(
        hb4 * 2, wb4 * 2)
    return a[:hb, :wb]


@partial(jax.jit, static_argnames=("pot",))
def select(ag0, ag1, ag2, ths_smoothed, pot: int, th_factor=1.0):
    """One hierarchical selection pass; returns (status (h,w) uint8,
    (n2, n3, n4) int32 scalars)."""
    h, w = ag0.shape
    h1, w1 = ag1.shape
    h2, w2 = ag2.shape
    dw1 = SETTING_GRAD_DOWNWEIGHT
    dw2 = dw1 * dw1

    ys, xs = jnp.mgrid[0:h, 0:w]
    border = (xs >= 4) & (xs < w - 5) & (ys >= 4) & (ys <= h - 4)
    bx = jnp.minimum(xs >> 5, ths_smoothed.shape[1] - 1)
    by = jnp.minimum(ys >> 5, ths_smoothed.shape[0] - 1)
    pixel_th0 = ths_smoothed[by, bx] * th_factor

    sx1 = jnp.minimum((xs * 0.5 + 0.25).astype(jnp.int32), w1 - 1)
    sy1 = jnp.minimum((ys * 0.5 + 0.25).astype(jnp.int32), h1 - 1)
    sx2 = jnp.minimum((xs * 0.25 + 0.125).astype(jnp.int32), w2 - 1)
    sy2 = jnp.minimum((ys * 0.25 + 0.125).astype(jnp.int32), h2 - 1)
    ag1p = ag1[sy1, sx1]
    ag2p = ag2[sy2, sx2]

    valid0 = border & (ag0 > pixel_th0)
    valid1 = border & (ag1p > pixel_th0 * dw1)
    valid2 = border & (ag2p > pixel_th0 * dw2)

    status = jnp.zeros(h * w, jnp.uint8)

    idx0, has0 = _block_argmax(ag0, valid0, pot, w)
    pick0 = has0 & (idx0 > 0)
    status = status.at[jnp.where(pick0, idx0, 0).reshape(-1)].max(
        jnp.where(pick0, jnp.uint8(1), jnp.uint8(0)).reshape(-1))
    n2 = pick0.sum()

    any0_2 = _any_in_blocks(valid0, 2 * pot)
    idx1, has1 = _block_argmax(ag1p, valid1, 2 * pot, w)
    pick1 = has1 & ~any0_2 & (idx1 > 0)
    status = status.at[jnp.where(pick1, idx1, 0).reshape(-1)].max(
        jnp.where(pick1, jnp.uint8(2), jnp.uint8(0)).reshape(-1))
    n3 = pick1.sum()

    any0_4 = _any_in_blocks(valid0, 4 * pot)
    allowed2 = _lock_after_first(pick1)
    allowed_pix = jnp.kron(allowed2.astype(jnp.int32),
                           jnp.ones((2 * pot, 2 * pot), jnp.int32))[:h, :w] > 0
    idx2, has2 = _block_argmax(jnp.where(allowed_pix, ag2p, -jnp.inf),
                               valid2 & allowed_pix, 4 * pot, w)
    pick2 = has2 & ~any0_4 & (idx2 > 0)
    status = status.at[jnp.where(pick2, idx2, 0).reshape(-1)].max(
        jnp.where(pick2, jnp.uint8(4), jnp.uint8(0)).reshape(-1))
    n4 = pick2.sum()

    # pixel 0 is never selectable (matches the `idx > 0` guards above); the
    # scatter target 0 may have been touched by masked-out lanes via max(0)
    status = status.at[0].set(0)
    return status.reshape(h, w), (n2, n3, n4)


# ---------------------------------------------------------------------------
# makeMaps: host-side potential adaptation around the jitted passes
# ---------------------------------------------------------------------------

def make_maps(absgrads, num_want: int, initial_potential: int = 3,
              recursions_left: int = 1, th_factor: float = 1.0,
              seed: int = 3141592):
    """Device-path makeMaps. Control flow (tiny scalars) on host; all pixel
    work jitted. Returns (status device array, num_selected int)."""
    ths = make_hists(absgrads[0])
    h, w = absgrads[0].shape
    pot = initial_potential
    while True:
        status, (n2, n3, n4) = select(absgrads[0], absgrads[1], absgrads[2],
                                      ths, pot, th_factor)
        num_have = float(int(n2) + int(n3) + int(n4))
        quotia = num_want / max(num_have, 1e-9)
        K = num_have * (pot + 1) * (pot + 1)
        ideal = int(np.sqrt(np.float32(K / num_want)) - 1)
        ideal = max(ideal, 1)
        if recursions_left > 0 and quotia > 1.25 and pot > 1:
            pot = min(ideal, pot - 1)
            recursions_left -= 1
            continue
        if recursions_left > 0 and quotia < 0.25:
            pot = max(ideal, pot + 1)
            recursions_left -= 1
            continue
        break

    num_have_sub = int(num_have)
    if quotia < 0.95:
        pattern = jnp.asarray(host_selector.random_pattern(w, h, seed))
        char_th = np.uint8(int(255.0 * quotia) & 0xFF)
        status, dropped = _subsample(status, pattern, char_th)
        num_have_sub -= int(dropped)
    return status, num_have_sub


@jax.jit
def _subsample(status, pattern, char_th):
    """Reference random sub-sample: the k-th selected pixel (raster order) is
    dropped iff pattern[k] > char_th (PixelSelector2.cpp:271-283)."""
    flat = status.reshape(-1)
    sel = flat > 0
    rank = jnp.cumsum(sel) - 1
    drop = sel & (pattern[jnp.clip(rank, 0, pattern.size - 1)] > char_th)
    return (jnp.where(drop, 0, flat).reshape(status.shape),
            drop.sum())


# ---------------------------------------------------------------------------
# back-projection into the fixed-capacity Morton-ordered cloud
# ---------------------------------------------------------------------------

def _hsv8(img):
    """OpenCV 8U RGB2HSV semantics on the channels as given (the reference
    feeds a BGR-loaded image to COLOR_RGB2HSV — load_image,
    pcd_generator.cpp:625 — so channel 0 plays 'R'). Float re-derivation of
    cv2's fixed-point tables; matches cv2 to within 1 quantum."""
    f = img.astype(jnp.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    diff = v - mn
    safe = jnp.where(diff > 0, diff, 1.0)
    h_deg = jnp.where(
        diff <= 0, 0.0,
        jnp.where(v == r, 60.0 * (g - b) / safe,
                  jnp.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                            240.0 + 60.0 * (r - g) / safe)))
    h_deg = jnp.where(h_deg < 0, h_deg + 360.0, h_deg)
    H = jnp.round(h_deg / 2.0)
    H = jnp.where(H >= 180.0, H - 180.0, H)   # 8U hue range is [0,180)
    S = jnp.where(v > 0, jnp.round(255.0 * diff / jnp.where(v > 0, v, 1.0)),
                  0.0)
    return jnp.stack([H, S, v], axis=-1)


@partial(jax.jit, static_argnames=("cap", "feature_type"))
def _build_cloud(status, depth, bgr, dx0, dy0, fx, fy, cx, cy, depth_factor,
                 cap: int, feature_type: int = 1):
    h, w = status.shape
    dep = depth.astype(jnp.float32)
    keep = (status != 0) & (depth != 0) & jnp.isfinite(dep)
    flat_keep = keep.reshape(-1)
    # raster-order compaction into cap slots (order matches np.nonzero)
    rank = jnp.cumsum(flat_keep) - 1
    ok = flat_keep & (rank < cap)
    slot = jnp.where(ok, rank, cap)                 # cap = spill bin

    ys, xs = jnp.mgrid[0:h, 0:w]
    z = dep / depth_factor
    px = (xs - cx) * z / fx
    py = (ys - cy) * z / fy

    def scat(vals, width):
        out = jnp.zeros((cap + 1, width), jnp.float32)
        return out.at[slot.reshape(-1)].set(
            vals.reshape(-1, width).astype(jnp.float32))[:cap]

    positions = scat(jnp.stack([px, py, z], -1), 3)
    if feature_type == 0:
        color = _hsv8(bgr) / jnp.asarray([180.0, 255.0, 255.0], jnp.float32)
        gscale = 2.0 / 255.0
    else:
        color = bgr.astype(jnp.float32)
        gscale = 1.0
    features = scat(jnp.concatenate(
        [color, gscale * dx0.reshape(h, w, 1),
         gscale * dy0.reshape(h, w, 1)], axis=-1), 5)
    pix = jnp.zeros((cap + 1, 2), jnp.int32).at[slot.reshape(-1)].set(
        jnp.stack([xs, ys], -1).reshape(-1, 2))[:cap]
    count = jnp.minimum(flat_keep.sum(), cap)
    mask = jnp.arange(cap) < count

    order = _morton_order_device(positions, mask)
    return (positions[order], features[order], mask, count, pix[order])


@jax.jit
def _morton_order_device(pos, mask):
    """Device Morton sort (mirrors pointcloud._morton_order; invalid slots
    sort last via a code past every valid 30-bit key)."""
    big = jnp.uint32(1) << jnp.uint32(31)
    lo = jnp.min(jnp.where(mask[:, None], pos, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(mask[:, None], pos, -jnp.inf), axis=0)
    span = jnp.maximum(hi - lo, 1e-9)
    q = jnp.clip(((pos - lo) / span * 1023.0), 0, 1023).astype(jnp.uint32)

    def spread(v):
        v = (v | (v << 16)) & jnp.uint32(0x030000FF)
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << jnp.uint32(1)) \
        | (spread(q[:, 2]) << jnp.uint32(2))
    code = jnp.where(mask, code, big)
    return jnp.argsort(code, stable=True)


def create_pointcloud_device(bgr, gray, depth, cam: CameraConfig,
                             fp: FrontendParams):
    """Device-path create_pointcloud: returns (positions, features, mask,
    count, selected_pixels) as device arrays (fixed capacity fp.cloud_capacity).

    Matches frontend.pointcloud.create_pointcloud up to Morton tie-breaking
    and f32 rounding of the gradient thresholds."""
    gray = jnp.asarray(gray, jnp.float32)
    _, dxs, dys, absgrads = make_pyramid(gray, fp.pyr_levels)
    status, _ = make_maps(absgrads, fp.num_want,
                          initial_potential=fp.initial_potential,
                          recursions_left=fp.recursions,
                          th_factor=1.0, seed=fp.random_seed)
    return _build_cloud(status, jnp.asarray(depth), jnp.asarray(bgr),
                        dxs[0], dys[0], cam.fx, cam.fy, cam.cx, cam.cy,
                        cam.depth_factor, fp.cloud_capacity, fp.feature_type)
