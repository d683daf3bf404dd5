"""Adaptive-ell CVO registration (the reference's `adaptive_cvo` variant).

Re-expression of /root/reference/thirdparty/cvo/src/adaptive_cvo.cpp —
a variant the reference ships but does NOT build (its CMake targets are
commented out, thirdparty/cvo/CMakeLists.txt:78-101). Instead of the fixed
iteration-indexed ell anneal of the main engine (cvo.cpp:810-812), the
kernel length-scale follows a data-driven gradient step each iteration
(adaptive_cvo.cpp:537-545):

    ell <- ell + dl_step * dl
    if ell >= ell_max: ell = 0.7 * ell_max; ell_max = 0.7 * ell_max
    ell = max(ell, ell_min)

where dl is the derivative of the kernel-correlation objective w.r.t. ell,
accumulated over the self- and cross-kernels (adaptive_cvo.cpp:167-271):

    dl = (1/ell^3) * [ sum_ij Axx_ij |x_i-x_j|^2 + sum_ij Ayy_ij |y_i-y_j|^2
                       - 2 sum_ij Axy_ij |x_i-y_j|^2 ]
         / (nnz(Axx) + nnz(Ayy) - 2 nnz(Axy))

Deviation (documented): the reference's TBB loop never fills
`sum_diff_yy_2` for rows i < num_fixed (adaptive_cvo.cpp:214-222 computes
diff_yy but not its squared norm), so most Ayy terms silently contribute
zero there; since the component is not part of the reference's active
build, this module implements the mathematically intended reduction.

Design notes: |x_i-x_j|^2 and |y_i-y_j|^2 are invariant under the rigid
update, so both self-distance matrices (geometric + color) are computed
ONCE per alignment and carried as while_loop constants; each iteration
re-kernels them with the current ell via elementwise ops only (no matmuls)
— the per-iteration matmul work stays that of the standard align.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..config import CvoParams
from ..ops import cubic, pairwise, se3
from .engine import AlignResult, PointCloud


@dataclass(frozen=True)
class AdaptiveParams:
    """adaptive_cvo.cpp:25-31 defaults."""
    ell_init: float = 0.1
    ell_min: float = 0.0391
    ell_max: float = 0.15
    dl_step: float = 0.3


def _self_d2(pos, feat, mask):
    """Rigid-invariant self squared distances (geometric + color) with the
    validity mask folded in as +inf (fails every gate)."""
    d2 = pairwise._pairwise_sq_dists(pos, pos)
    d2c = pairwise._pairwise_sq_dists(feat, feat)
    valid = mask[:, None] & mask[None, :]
    inf = jnp.float32(jnp.inf)
    return jnp.where(valid, d2, inf), jnp.where(valid, d2c, inf)


def _kernel_stats_from_d2(d2, d2c, ell, p: CvoParams):
    """sum(A * d2) and nnz for a kernel evaluated on precomputed distance
    matrices (the se_kernel gates + sparsification of adaptive_cvo.cpp:
    134-142, reduced per :222-231)."""
    ggate = d2 < pairwise.d2_threshold(ell, p)
    cgate = d2c < jnp.float32(pairwise.d2_color_threshold(p))
    k = (p.sigma * p.sigma) * jnp.exp(
        jnp.maximum(-d2 / (2.0 * ell * ell), -20.0))
    ck = (p.c_sigma * p.c_sigma) * jnp.exp(
        jnp.maximum(-d2c / (2.0 * p.c_ell * p.c_ell), -20.0))
    a = ck * k
    keep = ggate & cgate & (a > p.sp_thres)
    A = jnp.where(keep, a, 0.0)
    return jnp.sum(A * jnp.where(keep, d2, 0.0)), jnp.sum(keep)


@partial(jax.jit, static_argnames=("p", "ap"))
def adaptive_align(fixed: PointCloud, moving: PointCloud, R0, T0,
                   p: CvoParams, ap: AdaptiveParams = AdaptiveParams()
                   ) -> AlignResult:
    """RKHS-SE(3) registration with the adaptive ell schedule
    (adaptive_cvo.cpp:446-569). Same flow/step-size/stopping machinery as
    engine.align; ell starts from ap.ell_init every call (the adaptive
    variant resets it, adaptive_cvo.cpp:476-478 — no carry-over quirk)."""
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    y0, fy, my = moving.positions, moving.features, moving.mask

    ckg = pairwise.color_kernel_gated(fx, fy, mx, my, p)
    center, U = pairwise.step_moment_basis(x, mx)
    # rigid-invariant self-distance matrices: loop constants
    d2_xx, d2c_xx = _self_d2(x, fx, mx)
    d2_yy, d2c_yy = _self_d2(y0, fy, my)

    def body(carry):
        k_it, R, T, ell, ell_max, done, iters, nnz = carry
        Rt = R.T
        Tt = -(Rt @ T)
        y = y0 @ R + Tt[None, :]
        omega, v, nnz_xy, B, C, D, E = pairwise.flow_and_step_moments(
            x, y, ckg, U, center, ell, p)
        # dl (adaptive_cvo.cpp:222-271): self terms from the precomputed
        # distance matrices, cross term from the current pair set
        A_xy, keep_xy = pairwise.cvo_kernel_from_color(x, y, ckg, ell, p)
        d2_xy = pairwise._pairwise_sq_dists(x, y)
        sum_xy = jnp.sum(A_xy * jnp.where(keep_xy, d2_xy, 0.0))
        sum_xx, nnz_xx = _kernel_stats_from_d2(d2_xx, d2c_xx, ell, p)
        sum_yy, nnz_yy = _kernel_stats_from_d2(d2_yy, d2c_yy, ell, p)
        denom = (nnz_xx + nnz_yy - 2 * nnz_xy).astype(jnp.float32)
        ell3 = ell * ell * ell
        dl = (sum_xx + sum_yy - 2.0 * sum_xy) / (
            ell3 * jnp.where(denom == 0, 1.0, denom))

        step = cubic.min_positive_root_or(4.0 * E, 3.0 * D, 2.0 * C, B,
                                          p.min_step, p.max_step)
        active = ~done
        stop1 = active & (jnp.linalg.norm(omega) < p.eps) \
            & (jnp.linalg.norm(v) < p.eps)
        do_update = active & (~stop1)
        dtrans = se3.exp_sek3(jnp.concatenate([omega, v]), step)
        dR = dtrans[:3, :3]
        dT = dtrans[:3, 3]
        T_new = jnp.where(do_update, R @ dT + T, T)
        R_new = jnp.where(do_update, R @ dR, R)
        stop2 = do_update & (se3.dist_se3(dR, dT) < p.eps_2)

        done_new = done | stop1 | stop2
        iters_new = jnp.where(active & (stop1 | stop2), k_it, iters)
        # ell update (adaptive_cvo.cpp:537-545)
        ell_up = ell + jnp.float32(ap.dl_step) * dl
        shrink = ell_up >= ell_max
        ell_max_new = jnp.where(shrink, ell_max * 0.7, ell_max)
        ell_up = jnp.where(shrink, ell_max * 0.7, ell_up)
        ell_up = jnp.maximum(ell_up, jnp.float32(ap.ell_min))
        keep_state = active & (~stop1) & (~stop2)
        ell_new = jnp.where(keep_state, ell_up, ell)
        ell_max_out = jnp.where(keep_state, ell_max_new, ell_max)
        nnz_new = jnp.where(active, nnz_xy, nnz)
        return (k_it + 1, R_new, T_new, ell_new, ell_max_out, done_new,
                iters_new, nnz_new)

    def cond(carry):
        k_it, _, _, _, _, done, _, _ = carry
        return (k_it < p.max_iter) & (~done)

    init = (jnp.array(0), jnp.asarray(R0, jnp.float32),
            jnp.asarray(T0, jnp.float32), jnp.float32(ap.ell_init),
            jnp.float32(ap.ell_max), jnp.array(False),
            jnp.array(p.max_iter), jnp.array(0))
    _, R, T, ell, _, _, iters, nnz = jax.lax.while_loop(cond, body, init)
    transform = se3.make_pose(R.T, -(R.T @ T))
    return AlignResult(R, T, transform, ell, iters, nnz)
