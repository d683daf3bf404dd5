"""Plain float64 NumPy reference of one align iteration's pairwise pass.

The literal per-pair formulation of se_kernel + compute_flow +
compute_step_size (cvo.cpp:122-334), vectorised over row chunks and
independent of ops.pairwise and cvo.moment_kernel: distances are direct
coordinate differences in float64, and each Taylor coefficient is summed pair
by pair, not through moments. Used as the golden of the parity checks at the
real cloud capacity (tests and chip_smoke.py).

Besides the values it returns each quantity's absolute-term scale (the sum
of |term| over the pairs that enter it). A float32 sum of many terms of
both signs is accurate relative to that scale, not relative to its own
value, so tolerances are stated against it.
"""

from __future__ import annotations

import numpy as np

from ..config import CvoParams

_MONO = [()] + [(i,) for i in range(3)] \
    + [(i, j) for i in range(3) for j in range(i, 3)] \
    + [(i, j, k) for i in range(3) for j in range(i, 3) for k in range(j, 3)] \
    + [(i, j, k, l) for i in range(3) for j in range(i, 3)
       for k in range(j, 3) for l in range(k, 3)]


def kernel_matrix(x, y, fx, fy, mx, my, ell, p: CvoParams, rows=None):
    """Gated joint kernel A (cvo.cpp:122-184) in float64 for the fixed rows
    `rows` (default all) against every moving point."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    fx = np.asarray(fx, np.float64)
    fy = np.asarray(fy, np.float64)
    if rows is not None:
        x, fx, mx = x[rows], fx[rows], np.asarray(mx)[rows]
    d2 = np.sum((x[:, None, :] - y[None, :, :]) ** 2, axis=-1)
    d2c = np.sum((fx[:, None, :] - fy[None, :, :]) ** 2, axis=-1)
    d2t = -2.0 * ell * ell * np.log(p.sp_thres / (p.sigma * p.sigma))
    d2ct = -2.0 * p.c_ell * p.c_ell * np.log(p.sp_thres
                                             / (p.c_sigma * p.c_sigma))
    gate = (d2 < d2t) & (d2c < d2ct) & np.asarray(mx)[:, None] \
        & np.asarray(my)[None, :]
    a = (p.sigma * p.sigma * np.exp(-d2 / (2.0 * ell * ell))
         * p.c_sigma * p.c_sigma * np.exp(-d2c / (2.0 * p.c_ell * p.c_ell)))
    keep = gate & (a > p.sp_thres)
    return np.where(keep, a, 0.0), keep


def moment_matrix(x, y, fx, fy, mx, my, ell, p: CvoParams, U=None,
                  chunk=512):
    """(Mom (M, 35), |Mom| scale (M, 35), nnz): the moment matrix of the
    fused pass, Mom[j, a] = sum_i A_ij U_ia, and the sum of |A_ij U_ia| it
    is accurate against. U defaults to the monomials of xt = x - masked
    centroid up to degree 4; pass the basis under test to compare the
    contraction alone."""
    x = np.asarray(x, np.float64)
    if U is None:
        w = np.asarray(mx, np.float64)
        c = (x * w[:, None]).sum(0) / max(w.sum(), 1.0)
        xt = x - c
        U = np.stack([np.prod(xt[:, list(m)], axis=1) if m
                      else np.ones(len(x)) for m in _MONO], axis=1)
    U = np.asarray(U, np.float64)
    M = np.asarray(y).shape[0]
    mom = np.zeros((M, len(_MONO)))
    scale = np.zeros((M, len(_MONO)))
    nnz = 0
    for r0 in range(0, x.shape[0], chunk):
        rows = slice(r0, r0 + chunk)
        A, keep = kernel_matrix(x, y, fx, fy, mx, my, ell, p, rows)
        mom += A.T @ U[rows]
        scale += A.T @ np.abs(U[rows])
        nnz += int(keep.sum())
    return mom, scale, nnz


def flow_and_step(x, y, fx, fy, mx, my, ell, p: CvoParams, chunk=256):
    """Literal per-pair compute_flow + compute_step_size (cvo.cpp:187-334) in
    float64. Returns {name: (value, scale)} for omega, v, B, C, D, E, plus
    'nnz'. The step coefficients use this function's own omega and v."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    blocks = [(r0, kernel_matrix(x, y, fx, fy, mx, my, ell, p,
                                 slice(r0, r0 + chunk)))
              for r0 in range(0, x.shape[0], chunk)]
    omega = np.zeros(3)
    v = np.zeros(3)
    s_omega = np.zeros(3)
    s_v = np.zeros(3)
    nnz = 0
    for r0, (A, keep) in blocks:
        xs = x[r0:r0 + chunk]
        diff = y[None, :, :] - xs[:, None, :]               # y_j - x_i
        # x_i x y_j = (x_i - y_j) x y_j: the locally small form
        cr = np.cross(-diff, np.broadcast_to(y[None], diff.shape))
        omega += np.einsum("ij,ijk->k", A, cr)
        v += np.einsum("ij,ijk->k", A, diff)
        s_omega += np.einsum("ij,ijk->k", A, np.abs(cr))
        s_v += np.einsum("ij,ijk->k", A, np.abs(diff))
        nnz += int(keep.sum())
    omega /= p.c
    v /= p.d
    s_omega /= p.c
    s_v /= p.d

    oh = np.array([[0.0, -omega[2], omega[1]],
                   [omega[2], 0.0, -omega[0]],
                   [-omega[1], omega[0], 0.0]])
    xiz = y @ oh.T + v
    xi2z = y @ (oh @ oh).T + oh @ v
    xi3z = y @ (oh @ oh @ oh).T + oh @ oh @ v
    xi4z = y @ (oh @ oh @ oh @ oh).T + oh @ oh @ oh @ v
    normxiz2 = np.sum(xiz * xiz, axis=1)
    xiz_dot_xi2z = -np.sum(xiz * xi2z, axis=1)
    epsil_const = np.sum(xi2z * xi2z, axis=1) + 2.0 * np.sum(xiz * xi3z, 1)
    tc = 1.0 / (2.0 * ell * ell)
    coef = np.zeros(4)
    scale = np.zeros(4)
    for r0, (A, _) in blocks:
        d = x[r0:r0 + chunk][:, None, :] - y[None, :, :]    # x_i - y_j
        beta = -2.0 * tc * np.einsum("ijk,jk->ij", d, xiz)
        gamma = -tc * (normxiz2[None] + 2.0 * np.einsum("ijk,jk->ij", d,
                                                        xi2z))
        delta = 2.0 * tc * (xiz_dot_xi2z[None]
                            - np.einsum("ijk,jk->ij", d, xi3z))
        epsil = -tc * (epsil_const[None] + 2.0 * np.einsum("ijk,jk->ij", d,
                                                           xi4z))
        terms = (beta,
                 gamma + beta * beta / 2.0,
                 delta + beta * gamma + beta ** 3 / 6.0,
                 epsil + beta * delta + 0.5 * beta * beta * gamma
                 + 0.5 * gamma * gamma + beta ** 4 / 24.0)
        for k, t in enumerate(terms):
            coef[k] += np.sum(A * t)
            scale[k] += np.sum(A * np.abs(t))
    out = dict(omega=(omega, s_omega), v=(v, s_v), nnz=nnz)
    for k, name in enumerate("BCDE"):
        out[name] = (coef[k], scale[k])
    return out
