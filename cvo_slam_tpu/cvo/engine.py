"""CVO registration engine: jitted align loop + host-side state machine.

JAX re-expression of the reference `cvo::cvo` class
(/root/reference/thirdparty/cvo/src/cvo.cpp, include/cvo.hpp:82-282):

  * `align` (cvo.cpp:763-821) is a `lax.while_loop` carrying (R, T, ell, k)
    with both stopping rules (flow norms < eps at :782; se3 distance < eps_2
    at :804) and the exact ell anneal schedule (:810-812). ell is *not* reset
    between alignments (cvo.cpp:383) — it lives in CvoState and carries over,
    reproducing the reference quirk where the first <=3 iterations of every
    alignment reuse the previous alignment's final ell.
  * the kd-tree + sparse-matrix kernel passes are dense masked matmul ops
    (ops.pairwise); reductions are deterministic.
  * `compute_innerproduct` / `compute_innerproduct_lc` (cvo.cpp:475-561) and
    the eigenvalue-floored Hessian (se3_Hessian, cvo.cpp:620-759) are jitted
    wholesale.

Host-side `Cvo` mirrors the reference state plumbing: fixed/moving/previous
clouds, update_fixed_pcd (:578), update_previous_pcd (:584), reset_keyframe
(:591-604), reset_transform (:606-609), reset_initial (:611-618).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CvoParams
from ..ops import cubic, pairwise, se3
from ..frontend.pointcloud import PointCloudHost


BACKENDS = ("xla", "pallas")


def default_backend() -> str:
    """Implementation of the align loop's moment pass: 'pallas' (the fused
    Triton kernel, cvo.moment_kernel) on a GPU, 'xla'
    (pairwise.flow_and_step_moments) elsewhere. The kernel has no CPU
    lowering, so it is never chosen there.

    CVO_SLAM_BACKEND=xla|pallas overrides the choice on a GPU."""
    import os
    on_gpu = jax.default_backend() == "gpu"
    env = os.environ.get("CVO_SLAM_BACKEND", "")
    if env:
        if env not in BACKENDS:
            raise ValueError(f"CVO_SLAM_BACKEND={env!r}: expected one of "
                             f"{BACKENDS}")
        if env == "pallas" and not on_gpu:
            raise ValueError("CVO_SLAM_BACKEND=pallas needs a GPU")
        return env
    return "pallas" if on_gpu else "xla"


def start_host_transfer(tree):
    """Begin async device->host copies for every array leaf of `tree`.

    Copies started with `copy_to_host_async()` overlap each other and later
    device work, so a later `jax.device_get` finds the bytes on the host.
    Call this on a dispatched result whenever more work happens before the
    fetch (the speculative frame pipeline, the bench schedule)."""
    def _start(x):
        start = getattr(x, "copy_to_host_async", None)
        if start is not None:
            start()
    jax.tree.map(_start, tree)
    return tree


class PointCloud(NamedTuple):
    """Device-side fixed-capacity point cloud."""
    positions: jnp.ndarray  # (CAP, 3) f32
    features: jnp.ndarray   # (CAP, 5) f32
    mask: jnp.ndarray       # (CAP,) bool

    @staticmethod
    def from_host(pc: PointCloudHost) -> "PointCloud":
        return PointCloud(jnp.asarray(pc.positions),
                          jnp.asarray(pc.features), jnp.asarray(pc.mask))


class AlignResult(NamedTuple):
    R: jnp.ndarray          # (3,3) internal state (transform = [R^T | -R^T T])
    T: jnp.ndarray          # (3,)
    transform: jnp.ndarray  # (4,4) the registration output
    ell: jnp.ndarray        # annealed length-scale after the loop
    iters: jnp.ndarray      # iteration count at break (MAX_ITER if exhausted)
    nnz: jnp.ndarray        # A_nonzero of the last flow evaluation


@partial(jax.jit, static_argnames=("p", "backend"))
def align(fixed: PointCloud, moving: PointCloud, R0, T0, ell0,
          p: CvoParams, backend: str = "xla") -> AlignResult:
    """RKHS-SE(3) gradient-flow registration (cvo.cpp:763-821).

    backend: 'xla' (pairwise.flow_and_step_moments) or 'pallas' (the fused
    moment kernel, cvo.moment_kernel; GPU only) for the per-iteration moment
    pass. Both share the epilogue pairwise.flow_and_step_from_moments."""
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    y0, fy, my = moving.positions, moving.features, moving.mask
    if backend == "pallas":
        # the kernel recomputes the color kernel from the 5-wide features
        # each iteration; only the fixed cloud's packed inputs and moment
        # basis are loop constants (only the moving cloud's positions change
        # per iteration, cvo.cpp:336)
        from . import moment_kernel
        packed_fixed = moment_kernel.pack_fixed(x, fx, mx)
    else:
        # the color kernel + gate depend only on features/masks — invariant
        # across align iterations (only positions transform, cvo.cpp:336).
        # Compute once, carry as a loop constant: the per-iteration pairwise
        # work drops to the geometric half. Likewise the fixed cloud never
        # moves, so its centered moment basis (35 monomials) is a loop
        # constant too.
        ck_gated = pairwise.color_kernel_gated(fx, fy, mx, my, p)
        center, U = pairwise.step_moment_basis(x, mx)

    def body(carry):
        k, R, T, ell, done, iters, nnz = carry
        # update_tf (:106-110): transform = [R^T | -R^T T]; transform_pcd (:336)
        Rt = R.T
        Tt = -(Rt @ T)
        y = y0 @ R + Tt[None, :]          # y0 @ (R^T)^T
        if backend == "pallas":
            omega, v, nnz_k, B, C, D, E = moment_kernel.flow_and_step(
                packed_fixed, y, fy, my, ell, p)
        else:
            # moment-form pass: flow + all four step coefficients from ONE
            # A^T @ U matmul (pairwise.flow_and_step_moments)
            omega, v, nnz_k, B, C, D, E = pairwise.flow_and_step_moments(
                x, y, ck_gated, U, center, ell, p)
        step = cubic.min_positive_root_or(4.0 * E, 3.0 * D, 2.0 * C, B,
                                          p.min_step, p.max_step)
        # NOTE: every state update is gated on `active = ~done` so that under
        # vmap (batched multi-sequence alignment, where the while_loop keeps
        # running until ALL batch elements converge) already-converged
        # elements stay frozen. Solo semantics are unchanged (the loop exits
        # on done anyway).
        active = ~done
        # stop 1: flow norms below eps (:782) — break before the pose update
        stop1 = active & (jnp.linalg.norm(omega) < p.eps) \
            & (jnp.linalg.norm(v) < p.eps)
        do_update = active & (~stop1)

        dtrans = se3.exp_sek3(jnp.concatenate([omega, v]), step)
        dR = dtrans[:3, :3]
        dT = dtrans[:3, 3]
        T_new = jnp.where(do_update, R @ dT + T, T)
        R_new = jnp.where(do_update, R @ dR, R)
        # stop 2: se3 distance of the increment below eps_2 (:804)
        stop2 = do_update & (se3.dist_se3(dR, dT) < p.eps_2)

        done_new = done | stop1 | stop2
        iters_new = jnp.where(active & (stop1 | stop2), k, iters)
        # ell anneal (:810-812) — skipped on break (it follows the break)
        ell_ann = jnp.where(k > p.ell_anneal_iters[0], p.ell_anneal_values[0], ell)
        ell_ann = jnp.where(k > p.ell_anneal_iters[1], p.ell_anneal_values[1], ell_ann)
        ell_ann = jnp.where(k > p.ell_anneal_iters[2], p.ell_anneal_values[2], ell_ann)
        ell_new = jnp.where(active & (~stop1) & (~stop2), ell_ann, ell)
        nnz_new = jnp.where(active, nnz_k, nnz)
        return (k + 1, R_new, T_new, ell_new, done_new, iters_new, nnz_new)

    def cond(carry):
        k, _, _, _, done, _, _ = carry
        return (k < p.max_iter) & (~done)

    init = (jnp.array(0), jnp.asarray(R0, jnp.float32),
            jnp.asarray(T0, jnp.float32), jnp.asarray(ell0, jnp.float32),
            jnp.array(False), jnp.array(p.max_iter), jnp.array(0))
    k, R, T, ell, done, iters, nnz = jax.lax.while_loop(cond, body, init)
    transform = se3.make_pose(R.T, -(R.T @ T))   # final update_tf (:817)
    return AlignResult(R, T, transform, ell, iters, nnz)


# ---------------------------------------------------------------------------
# Hessian post-processing (cvo.cpp:726-755)
# ---------------------------------------------------------------------------

def hessian_postprocess(H_raw, inliers, p: CvoParams):
    """Scale by -1/1e5 then iteratively shift the spectrum until
    min |eigenvalue| >= 1 (cvo.cpp:726-754); identity when no inliers.

    Eigenvalues come from the fixed-sweep Jacobi solver (ops.jacobi), a
    fixed number of small elementwise sweeps that stay inside the fused
    innerproduct program instead of a generic eigvalsh call."""
    from ..ops.jacobi import eigvalsh_jacobi
    H = H_raw * p.hessian_scale
    lam = eigvalsh_jacobi(H)

    def body(carry):
        lam, total = carry
        idx = jnp.argmin(jnp.abs(lam))
        lam_min = lam[idx]
        shift = 1.0 - lam_min
        return lam + shift, total + shift

    def cond(carry):
        lam, _ = carry
        return jnp.abs(lam[jnp.argmin(jnp.abs(lam))]) < p.hessian_min_abs_eig

    # the shift loop converges in a handful of steps; guard with a cap by
    # folding the count into the carry
    def body_capped(carry):
        lam, total, n = carry
        lam2, total2 = body((lam, total))
        return lam2, total2, n + 1

    def cond_capped(carry):
        lam, total, n = carry
        return cond((lam, total)) & (n < 64)

    _, total_shift, _ = jax.lax.while_loop(
        cond_capped, body_capped, (lam, jnp.array(0.0, H.dtype), jnp.array(0)))
    H = H + total_shift * jnp.eye(6, dtype=H.dtype)
    return jnp.where(inliers > 0, H, jnp.eye(6, dtype=H.dtype))


@partial(jax.jit, static_argnames=("p",))
def compute_innerproduct(fixed: PointCloud, moving: PointCloud, tran, ell,
                         p: CvoParams):
    """Reference compute_innerproduct (cvo.cpp:475-503): inner products
    before/after registration, self-norms, cos angle, and the post-Hessian.

    Returns a dict of scalars plus the (6,6) post_hessian."""
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    y, fy, my = moving.positions, moving.features, moving.mask
    yt = se3.transform_points(tran, y)
    # fused suite: shared feature matmul + shared post-gate products (the
    # separate-call formulation issues ~2x the large kernels)
    (pre_v, pre_n, post_v, post_n, fixed_v, fixed_n, moving_v, moving_n,
     G, inliers) = pairwise.ip_suite(x, fx, mx, y, fy, my, yt, ell, p)
    H_raw = pairwise.assemble_hessian(G, ell)
    cos_angle = post_v / (jnp.sqrt(fixed_v) * jnp.sqrt(moving_v))
    post_hessian = hessian_postprocess(H_raw, inliers, p)
    return dict(inn_pre=pre_v, inn_pre_num=pre_n, inn_post=post_v,
                inn_post_num=post_n, inn_fixed=fixed_v, inn_moving=moving_v,
                cos_angle=cos_angle, post_hessian=post_hessian,
                inliers=inliers)


@partial(jax.jit, static_argnames=("p", "backend"))
def align_and_innerproduct(fixed: PointCloud, moving: PointCloud, R0, T0,
                           ell0, p: CvoParams, backend: str = "xla"):
    """One dispatch for the tracker's per-instance frame work: align followed
    by compute_innerproduct on the result (local_tracker.cpp runs these
    back-to-back for each cvo instance). Fusing them halves both the dispatch
    count and the blocking host transfers per tracked frame (2 instead of
    4)."""
    res = align(fixed, moving, R0, T0, ell0, p, backend)
    ip = compute_innerproduct(fixed, moving, res.transform, res.ell, p)
    return res, ip


@partial(jax.jit, static_argnames=("p", "backend"))
def frame_step(prev: PointCloud, kf: PointCloud, cur: PointCloud,
               R_odo0, T_odo0, ell_odo0, kf_transform, ell_kf0,
               p: CvoParams, backend: str = "xla"):
    """The ENTIRE device work of one tracked frame in ONE dispatch:

      1. odometry align + innerproduct (prev -> cur),
      2. the keyframe warm start on device (reset_initial, cvo.cpp:611-618:
         R,T <- (kf_transform @ T_odo)^-1, here the closed-form rigid inverse
         [R^T | -R^T t] instead of a general 4x4 inverse),
      3. keyframe align + innerproduct (kf -> cur).

    local_tracker.cpp issues these as four calls with host logic between;
    fusing them means one dispatch and one blocking transfer per frame.

    The only semantic delta vs the host-sequenced path: the warm-start
    product/inverse is computed in f32 on device instead of f64 on host
    (~1e-7 perturbation of an initial guess that align then iterates on).

    Returns (res_odo, ip_odo, res_kf, ip_kf, guess)."""
    res1 = align(prev, cur, R_odo0, T_odo0, ell_odo0, p, backend)
    ip1 = compute_innerproduct(prev, cur, res1.transform, res1.ell, p)
    guess = jnp.asarray(kf_transform, jnp.float32) @ res1.transform
    Rk0 = guess[:3, :3].T
    Tk0 = -(Rk0 @ guess[:3, 3])
    res2 = align(kf, cur, Rk0, Tk0, ell_kf0, p, backend)
    ip2 = compute_innerproduct(kf, cur, res2.transform, res2.ell, p)
    return res1, ip1, res2, ip2, guess


@partial(jax.jit, static_argnames=("p",))
def compute_innerproduct_lc(fixed: PointCloud, moving: PointCloud,
                            prior_tran, lc_prior_tran, lc_prior_tran_2,
                            lc_tran, ell, p: CvoParams):
    """Reference compute_innerproduct_lc (cvo.cpp:505-561): inner products of
    the moving cloud under four transforms against the fixed cloud, plus the
    post-Hessian (with inlier counts) for the CVO result and the second
    (pnpransac) prior."""
    x, fx, mx = fixed.positions, fixed.features, fixed.mask
    y, fy, my = moving.positions, moving.features, moving.mask

    y_prior = se3.transform_points(prior_tran, y)
    y_lcp = se3.transform_points(lc_prior_tran, y)
    y_lcp2 = se3.transform_points(lc_prior_tran_2, y)
    y_lc = se3.transform_points(lc_tran, y)
    # fused suite with the feature matmul shared by all six pair sets
    (prior_v, lcp_v, pre_v, post_v, fixed_v, moving_v, G, inliers_svd,
     inliers_pnp) = pairwise.ip_suite_lc(x, fx, mx, y, fy, my, y_prior,
                                         y_lcp, y_lcp2, y_lc, ell, p)
    H_raw = pairwise.assemble_hessian(G, ell)
    cos_angle = post_v / (jnp.sqrt(fixed_v) * jnp.sqrt(moving_v))
    post_hessian = hessian_postprocess(H_raw, inliers_svd, p)
    return dict(inn_prior=prior_v, inn_lc_prior=lcp_v, inn_lc_pre=pre_v,
                inn_lc_post=post_v, inn_fixed=fixed_v, inn_moving=moving_v,
                cos_angle=cos_angle, post_hessian=post_hessian,
                inliers_svd=inliers_svd, inliers_pnpransac=inliers_pnp)


@partial(jax.jit, static_argnames=("p", "backend"))
def lc_verify_batch(fixed: PointCloud, movings: PointCloud, R0, T0, ell0,
                    priors, lc_priors, p: CvoParams, backend: str = "xla"):
    """ALL loop-closure candidate verifications of one detection round in
    ONE vmapped dispatch.

    The reference runs a fresh `cvo::cvo` per candidate sequentially
    (keyframe_graph.cpp:693-714: reset_initial(lc_prior) -> set_pcd(ref) ->
    match_keyframe(cand) -> compute_innerproduct_lc); here the <=10
    candidates share the fixed reference cloud (broadcast) and the batched
    align while_loop runs until every lane converges (per-lane state is
    frozen on convergence, so each lane's result equals its solo run —
    the same mechanism the lockstep multi-sequence tracker relies on).
    Sequential per-candidate dispatches pay ~2 device round-trips each;
    this is one dispatch + one blocking transfer per round.

    movings/R0/T0/ell0/priors/lc_priors carry a leading candidate axis;
    the pnpransac prior is identity for every candidate (never assigned in
    the reference's active code)."""
    eye4 = jnp.eye(4, dtype=jnp.float32)

    def one(moving, R0_i, T0_i, ell0_i, prior, lc_prior):
        res = align(fixed, moving, R0_i, T0_i, ell0_i, p, backend)
        lc = compute_innerproduct_lc(fixed, moving, prior, lc_prior, eye4,
                                     res.transform, res.ell, p)
        return res, lc

    return jax.vmap(one)(movings, R0, T0, ell0, priors, lc_priors)


# ---------------------------------------------------------------------------
# host-side state machine (mirrors cvo::cvo state plumbing)
# ---------------------------------------------------------------------------

@dataclass
class Cvo:
    """One CVO instance (the reference keeps two: odometry + keyframe,
    local_tracker.cpp:48-49)."""

    params: CvoParams
    fixed: Optional[PointCloud] = None
    moving: Optional[PointCloud] = None
    previous: Optional[PointCloud] = None
    fixed_pixels: Optional[np.ndarray] = None   # CVO-selected pixels of fixed
    moving_pixels: Optional[np.ndarray] = None
    previous_pixels: Optional[np.ndarray] = None
    init: bool = False
    first_frame: bool = True
    pre_pc_init: bool = False
    R: np.ndarray = None
    T: np.ndarray = None
    transform: np.ndarray = None   # (4,4) float64 host copy of the output
    ell: float = None
    iters: int = 0
    nnz: int = 0
    backend: str = "auto"

    def __post_init__(self):
        if self.backend == "auto":
            self.backend = default_backend()
        self.R = np.eye(3, dtype=np.float32)
        self.T = np.zeros(3, dtype=np.float32)
        self.transform = np.eye(4, dtype=np.float64)
        self.ell = self.params.ell_init

    # -- set_pcd (cvo.cpp:345-386): first call seeds fixed; later calls set
    #    moving. Clouds are produced once by the frontend and shared.
    def set_pcd(self, cloud: PointCloud, pixels: np.ndarray):
        if not self.init:
            self.fixed = cloud
            self.fixed_pixels = pixels
            self.init = True
            return False
        self.moving = cloud
        self.moving_pixels = pixels
        return True

    def start_ell(self) -> float:
        """ell the next alignment starts from: ell_init under the ell_reset
        policy (coarse-to-fine every alignment), else the carried state
        (reference quirk, cvo.cpp:383)."""
        return self.params.ell_init if self.params.ell_reset else self.ell

    def _align(self):
        res = align(self.fixed, self.moving, self.R, self.T,
                    np.float32(self.start_ell()), self.params, self.backend)
        # one batched host transfer for all six outputs (separate np.asarray
        # calls are six blocking readbacks)
        return self._apply_align(*jax.device_get(tuple(res)))

    def _apply_align(self, R, T, transform, ell, iters, nnz):
        """Write back one alignment's host outputs (split from _align so a
        lockstep batch executor can run N alignments in one dispatch and
        apply each result to its own Cvo — parallel.multi_sequence)."""
        self.R = np.asarray(R)
        self.T = np.asarray(T)
        self.transform = np.asarray(transform, np.float64)
        self.ell = float(ell)
        self.iters = int(iters)
        self.nnz = int(nnz)
        return self.transform

    def match_odometry(self, cloud: PointCloud, pixels: np.ndarray):
        """cvo.cpp:461-473."""
        assert self.init, "cvo not initialized"
        self.set_pcd(cloud, pixels)
        return self._align()

    match_keyframe = match_odometry   # cvo.cpp:563-576 (same body)

    def _align_with_innerproduct(self):
        """Fused align + innerproduct: one dispatch, ONE blocking transfer.
        Returns (transform, ip dict)."""
        res, ip = align_and_innerproduct(self.fixed, self.moving, self.R,
                                         self.T, np.float32(self.start_ell()),
                                         self.params, self.backend)
        host_res, host_ip = jax.device_get((tuple(res), ip))
        return self._apply_align(*host_res), host_ip

    def compute_innerproduct(self, tran: np.ndarray):
        out = compute_innerproduct(self.fixed, self.moving,
                                   jnp.asarray(tran, jnp.float32),
                                   np.float32(self.ell), self.params)
        # ONE batched transfer for the whole dict (per-key np.asarray would
        # be ~9 blocking readbacks)
        return jax.device_get(out)

    def compute_innerproduct_lc(self, prior, lc_prior, lc_prior_2, lc_tran):
        out = compute_innerproduct_lc(
            self.fixed, self.moving,
            jnp.asarray(prior, jnp.float32), jnp.asarray(lc_prior, jnp.float32),
            jnp.asarray(lc_prior_2, jnp.float32), jnp.asarray(lc_tran, jnp.float32),
            np.float32(self.ell), self.params)
        return jax.device_get(out)

    # -- state plumbing (cvo.cpp:578-618)
    def update_fixed_pcd(self):
        self.fixed, self.fixed_pixels = self.moving, self.moving_pixels
        self.moving, self.moving_pixels = None, None

    def update_previous_pcd(self):
        self.previous, self.previous_pixels = self.moving, self.moving_pixels
        self.moving, self.moving_pixels = None, None
        self.pre_pc_init = True

    def reset_keyframe(self, odometry: np.ndarray):
        if not self.pre_pc_init:
            self.fixed, self.fixed_pixels = self.moving, self.moving_pixels
            self.moving, self.moving_pixels = None, None
        else:
            self.fixed, self.fixed_pixels = self.previous, self.previous_pixels
            self.update_previous_pcd()
        self.reset_transform(odometry)

    def reset_transform(self, odometry: np.ndarray):
        self.transform = np.asarray(odometry, np.float64).copy()

    def reset_initial(self, odometry: np.ndarray):
        """Warm start (cvo.cpp:611-618): R,T <- (transform @ odometry)^-1;
        returns the initial guess transform @ odometry."""
        guess = self.transform @ np.asarray(odometry, np.float64)
        inv = np.linalg.inv(guess)
        self.R = inv[:3, :3].astype(np.float32)
        self.T = inv[:3, 3].astype(np.float32)
        return guess
