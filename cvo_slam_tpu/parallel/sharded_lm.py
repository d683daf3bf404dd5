"""Multi-device sharded pose-graph LM (edge-sharded normal equations).

Multi-device scale-out of backend.lm (SURVEY.md section 5.8): edges are sharded
across a device mesh axis; each device linearizes its edge shard and builds
partial dense normal equations; H and b are `psum`-reduced over the mesh
(riding ICI), and the damped solve runs replicated. This is the reduced-
camera-system pattern: landmark blocks (when BA lands) are marginalized
locally and only 6x6 pose blocks cross devices.

The reference has no distributed backend at all (SURVEY.md section 2.4) — this
is a new capability, validated against the single-device solver on CPU meshes
(tests/test_sharded_lm.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..backend import lm
from ..ops import se3


def _partial_normal_equations(E, ei, ej, Z, omega, emask, free, delta):
    """Dense (6V,6V) H and (6V,) b from THIS shard's edges (no pinning)."""
    V = E.shape[0]
    Zinv = se3.inv_pose(Z)
    err_T = Zinv @ E[ei] @ se3.inv_pose(E[ej])
    e = se3.log_se3(err_T)
    Jl_inv = se3.left_jacobian_inv_se3(e)
    Ji = Jl_inv @ se3.adjoint_se3(Zinv)
    Jj = -Jl_inv @ se3.adjoint_se3(err_T)
    chi2 = jnp.einsum("mi,mij,mj->m", e, omega, e)
    use = delta > 0.0
    d2 = jnp.where(use, delta * delta, 1.0)
    w = jnp.where(use, 1.0 / (1.0 + chi2 / d2), 1.0)
    rchi2 = jnp.where(use, d2 * jnp.log1p(chi2 / d2), chi2)
    w = jnp.where(emask, w, 0.0)

    WOm = w[:, None, None] * omega
    JiW = jnp.einsum("mki,mkl->mil", Ji, WOm)
    JjW = jnp.einsum("mki,mkl->mil", Jj, WOm)
    H = jnp.zeros((V, V, 6, 6), E.dtype)
    H = H.at[ei, ei].add(JiW @ Ji)
    H = H.at[ei, ej].add(JiW @ Jj)
    H = H.at[ej, ei].add(jnp.swapaxes(JiW @ Jj, -1, -2))
    H = H.at[ej, ej].add(JjW @ Jj)
    b = jnp.zeros((V, 6), E.dtype)
    b = b.at[ei].add(-(JiW @ e[..., None])[..., 0])
    b = b.at[ej].add(-(JjW @ e[..., None])[..., 0])
    chi2_tot = jnp.sum(jnp.where(emask, rchi2, 0.0))
    return H, b, chi2_tot


def _chi2_shard(E, ei, ej, Z, omega, emask, delta):
    Zinv = se3.inv_pose(Z)
    e = se3.log_se3(Zinv @ E[ei] @ se3.inv_pose(E[ej]))
    chi2 = jnp.einsum("mi,mij,mj->m", e, omega, e)
    use = delta > 0.0
    d2 = jnp.where(use, delta * delta, 1.0)
    rchi2 = jnp.where(use, d2 * jnp.log1p(chi2 / d2), chi2)
    return jnp.sum(jnp.where(emask, rchi2, 0.0))


def optimize_sharded(g: lm.PoseGraph, mesh: Mesh, iterations: int,
                     robust_delta: float = 0.0, axis: str = "dp",
                     solver: str = "dense"):
    """Edge-sharded LM over `mesh`. Semantics match backend.lm.optimize."""
    return make_sharded_optimizer(g, mesh, iterations, robust_delta,
                                  axis, solver)(g.E)


def make_sharded_optimizer(g: lm.PoseGraph, mesh: Mesh, iterations: int,
                           robust_delta: float = 0.0, axis: str = "dp",
                           solver: str = "dense"):
    """Build a reusable jitted optimizer E0 -> (E_opt, chi2) for this graph
    topology/mesh (compile once, call many times — used by the scaling
    harness, eval.scaling). Semantics match backend.lm.optimize (same
    damping schedule); edges are padded with masked entries so the shard
    count divides the edge count.

    solver='dense': psum the full (V,V,6,6) normal equations and solve the
    damped (6V)^2 system replicated — right for small graphs (windowed BA
    scale, mirroring g2o's dense solve in local_map.cpp:85-92).

    solver='pcg': the per-shard H never leaves its device — the normal-
    equation matvec is applied shard-locally and only the (V,6) product is
    psummed per CG iteration (SURVEY section 5.8's distributed-PCG
    prescription for the large-graph regime). Block-Jacobi preconditioner
    from the psummed 6x6 diagonal. Equality vs dense is tested in
    tests/test_sharded_lm.py."""
    n_dev = mesh.shape[axis]
    M = g.ei.shape[0]
    pad = (-M) % n_dev
    ei = jnp.pad(g.ei, (0, pad))
    ej = jnp.pad(g.ej, (0, pad))
    Z = jnp.concatenate([g.Z, jnp.tile(jnp.eye(4, dtype=g.Z.dtype),
                                       (pad, 1, 1))]) if pad else g.Z
    om = jnp.concatenate([g.omega, jnp.tile(jnp.eye(6, dtype=g.omega.dtype),
                                            (pad, 1, 1))]) if pad else g.omega
    emask = jnp.pad(g.emask, (0, pad))

    V = g.E.shape[0]
    free = (g.vmask & (~g.fixed)).astype(g.E.dtype)
    delta = jnp.asarray(robust_delta, g.E.dtype)

    espec = P(axis)
    rep = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(rep, espec, espec, espec, espec, espec),
             out_specs=rep)
    def normal_eq(E, ei_s, ej_s, Z_s, om_s, em_s):
        H, b, chi2 = _partial_normal_equations(E, ei_s, ej_s, Z_s, om_s, em_s,
                                               free, delta)
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)
        chi2 = jax.lax.psum(chi2, axis)
        return H, b, chi2

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(rep, espec, espec, espec, espec, espec),
             out_specs=rep)
    def total_chi2(E, ei_s, ej_s, Z_s, om_s, em_s):
        return jax.lax.psum(_chi2_shard(E, ei_s, ej_s, Z_s, om_s, em_s, delta),
                            axis)

    # pcg mode: the shard-local H stays on its device (out_specs sharded);
    # matvec psums only the (V,6) product
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(rep, espec, espec, espec, espec, espec),
             out_specs=(P(axis), rep, rep, rep))
    def normal_eq_local(E, ei_s, ej_s, Z_s, om_s, em_s):
        H, b, chi2 = _partial_normal_equations(E, ei_s, ej_s, Z_s, om_s, em_s,
                                               free, delta)
        # ONE fused psum for (b, H-diag, chi2) instead of three separate
        # collectives per outer iteration
        b, diag, chi2 = jax.lax.psum(
            (b, jnp.einsum("vvab->vab", H), chi2), axis)
        return H[None], b, diag, chi2

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(axis), rep),
             out_specs=rep)
    def H_matvec(Hs, x):
        return jax.lax.psum(jnp.einsum("vuab,ub->va", Hs[0], x), axis)

    fm = free

    @jax.jit
    def run(E0):
        def pin(Hblk, b):
            Hblk = Hblk * fm[:, None, None, None] * fm[None, :, None, None]
            Hblk = Hblk.at[jnp.arange(V), jnp.arange(V)].add(
                (1.0 - fm)[:, None, None] * jnp.eye(6, dtype=E0.dtype))
            b = b * fm[:, None]
            return (Hblk.transpose(0, 2, 1, 3).reshape(V * 6, V * 6),
                    b.reshape(-1))

        def outer_body(carry):
            E, lam, ni, conv = carry
            Hb, bb, chi2 = normal_eq(E, ei, ej, Z, om, emask)
            H, b = pin(Hb, bb)
            lam = jnp.where(lam < 0, 1e-5 * jnp.max(jnp.diagonal(H)), lam)

            def trial(c2, _):
                E_cur, lam, ni, done, chi2_cur = c2
                dx = jnp.nan_to_num(jnp.linalg.solve(
                    H + lam * jnp.eye(V * 6, dtype=H.dtype), b))
                E_try = se3.exp_se3(dx.reshape(V, 6) * fm[:, None]) @ E
                chi2_new = total_chi2(E_try, ei, ej, Z, om, emask)
                rho = (chi2 - chi2_new) / (dx @ (lam * dx + b) + 1e-3)
                accept = (rho > 0) & jnp.isfinite(chi2_new) & (~done)
                lam_next = jnp.where(done, lam, jnp.where(
                    accept, lam * jnp.maximum(1 / 3, 1 - (2 * rho - 1) ** 3),
                    lam * ni))
                ni_next = jnp.where(done, ni, jnp.where(accept, 2.0, ni * 2.0))
                return (jnp.where(accept, E_try, E_cur), lam_next, ni_next,
                        done | accept,
                        jnp.where(accept, chi2_new, chi2_cur)), None

            (E_new, lam, ni, accepted, chi2_after), _ = jax.lax.scan(
                trial, (E, lam, ni, jnp.array(False), chi2), None, length=10)
            # convergence early-exit (same rule as backend.lm); all inputs
            # psummed/replicated, so every device takes the same branch
            conv = (~accepted) | (chi2 - chi2_after <= 1e-9 * chi2)
            return (E_new, lam, ni, conv)

        def outer(carry, _):
            return jax.lax.cond(carry[3], lambda c: c, outer_body,
                                carry), None

        (E_opt, _, _, _), _ = jax.lax.scan(
            outer, (E0, jnp.array(-1.0, E0.dtype), jnp.array(2.0, E0.dtype),
                    jnp.array(False)),
            None, length=iterations)
        return E_opt, total_chi2(E_opt, ei, ej, Z, om, emask)

    eye6 = jnp.eye(6, dtype=g.E.dtype)

    @jax.jit
    def run_pcg(E0):
        def pcg_solve(Hs, diag, b, lam, x0):
            """Matrix-free damped solve on the free subspace; one (V,6)
            psum per CG iteration (inside H_matvec). x0 warm-starts from
            the previous outer iteration's accepted step — near
            convergence successive LM steps are similar, cutting CG
            iterations (and their collectives) per solve."""
            def matvec(xv):
                xt = xv * fm[:, None]
                Sx = H_matvec(Hs, xt) + lam * xt
                return Sx * fm[:, None] + xv * (1.0 - fm)[:, None]

            Dv = diag + lam * eye6[None]
            Dv = jnp.where(fm[:, None, None] > 0, Dv, eye6[None])
            Dinv = jnp.nan_to_num(jnp.linalg.inv(Dv))

            def prec(r):
                return jnp.einsum("vab,vb->va", Dinv, r)

            tol2 = jnp.asarray(1e-10, b.dtype) * jnp.maximum(
                jnp.sum(b * b), 1e-30)
            x0 = jnp.nan_to_num(x0) * fm[:, None]
            r0 = b - matvec(x0) * fm[:, None]
            z0 = prec(r0)

            def cg_cond(c):
                k, _, r, _, _, _ = c
                return (k < 6 * V) & (jnp.sum(r * r) > tol2)

            def cg_body(c):
                k, xv, r, z, pv, rz = c
                Ap = matvec(pv)
                alpha = rz / jnp.maximum(jnp.sum(pv * Ap), 1e-30)
                xv = xv + alpha * pv
                r = r - alpha * Ap
                z = prec(r)
                rz_new = jnp.sum(r * z)
                beta = rz_new / jnp.maximum(rz, 1e-30)
                return (k + 1, xv, r, z, z + beta * pv, rz_new)

            _, xv, _, _, _, _ = jax.lax.while_loop(
                cg_cond, cg_body,
                (jnp.array(0), x0, r0, z0, z0, jnp.sum(r0 * z0)))
            return jnp.nan_to_num(xv) * fm[:, None]

        def outer_body(carry):
            E, lam, ni, dx_prev, conv = carry
            Hs, b, diag, chi2 = normal_eq_local(E, ei, ej, Z, om, emask)
            b = b * fm[:, None]
            # pinned-diagonal lambda init (fixed/masked rows read 1.0),
            # matching the dense path / backend.lm exactly so the damping
            # trajectories coincide from iteration 0
            diag_pinned = jnp.einsum("vaa->va", diag) \
                * fm[:, None] + (1.0 - fm)[:, None]
            lam = jnp.where(lam < 0, 1e-5 * jnp.max(diag_pinned), lam)

            def trial_body(c2):
                E_cur, lam, ni, done, dxp, chi2_cur = c2
                dx = pcg_solve(Hs, diag, b, lam, dxp)
                E_try = se3.exp_se3(dx) @ E
                chi2_new = total_chi2(E_try, ei, ej, Z, om, emask)
                rho = (chi2 - chi2_new) / (jnp.sum(dx * (lam * dx + b))
                                           + 1e-3)
                accept = (rho > 0) & jnp.isfinite(chi2_new)
                lam_n = jnp.where(
                    accept, lam * jnp.maximum(1 / 3, 1 - (2 * rho - 1) ** 3),
                    lam * ni)
                ni_n = jnp.where(accept, 2.0, ni * 2.0)
                return (jnp.where(accept, E_try, E_cur), lam_n, ni_n, accept,
                        jnp.where(accept, dx, dxp),
                        jnp.where(accept, chi2_new, chi2_cur))

            def trial(c2, _):
                # `done` is replicated (derived from psummed scalars), so
                # every device takes the same branch and skipping the
                # collectives inside is legal (bit-exact: the skipped body
                # changed nothing)
                return jax.lax.cond(c2[3], lambda c: c, trial_body, c2), None

            (E_new, lam, ni, accepted, dx_new, chi2_after), _ = jax.lax.scan(
                trial, (E, lam, ni, jnp.array(False), dx_prev, chi2), None,
                length=10)
            conv = (~accepted) | (chi2 - chi2_after <= 1e-9 * chi2)
            return (E_new, lam, ni, dx_new, conv)

        def outer(carry, _):
            # convergence early-exit: conv is replicated, so the skipped
            # collectives are skipped on every device alike
            return jax.lax.cond(carry[4], lambda c: c, outer_body,
                                carry), None

        (E_opt, _, _, _, _), _ = jax.lax.scan(
            outer, (E0, jnp.array(-1.0, E0.dtype), jnp.array(2.0, E0.dtype),
                    jnp.zeros((V, 6), E0.dtype), jnp.array(False)),
            None, length=iterations)
        return E_opt, total_chi2(E_opt, ei, ej, Z, om, emask)

    return run_pcg if solver == "pcg" else run
