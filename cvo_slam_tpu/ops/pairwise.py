"""Dense masked pairwise CVO math (reference-fidelity jnp implementation).

Dense re-expression of the reference CVO hot loops
(/root/reference/thirdparty/cvo/src/cvo.cpp): the kd-tree radius search +
sparse triplet matrix (se_kernel, cvo.cpp:122-184) becomes a dense masked
N x M kernel computed from matmuls; the mutex-guarded reductions
(compute_flow :187-236, compute_step_size :239-334, function_inner_product
:388-459, se3_Hessian :620-759) become deterministic tree reductions.

The 6x6 RKHS Hessian is evaluated through a single 13x13 weighted bilinear
moment form G = U_a^T (W) U_b with U = [1, p, vec(p p^T)] — two matmuls —
and assembled from G by exact polynomial index algebra (see _HESSIAN_POLYS).
This is the same math as the per-pair block accumulation of cvo.cpp:648-713,
reorganized as matrix products.

All functions take fixed-capacity point clouds with validity masks; invalid
slots contribute exactly zero.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CvoParams


# ---------------------------------------------------------------------------
# thresholds (cvo.cpp:125-126, :395-396, :626-627)
# ---------------------------------------------------------------------------

def d2_threshold(ell, p: CvoParams):
    """Geometric squared-distance cutoff: -2 l^2 log(sp_thres / sigma^2)."""
    return -2.0 * ell * ell * jnp.log(p.sp_thres / (p.sigma * p.sigma))


def d2_color_threshold(p: CvoParams):
    """Color squared-distance cutoff: -2 c_ell^2 log(sp_thres / c_sigma^2)."""
    return -2.0 * p.c_ell * p.c_ell * np.log(p.sp_thres / (p.c_sigma * p.c_sigma))


def _pairwise_sq_dists(x, y):
    """(N,D),(M,D) -> (N,M) squared distances from direct coordinate
    differences (XLA fuses the broadcast, square and sum into one pass).

    Not the matmul identity |x|^2 + |y|^2 - 2 x.y: for points metres from
    the origin it cancels to ~5e-7 m^2 absolute error, a 3e-4 relative error
    of the kernel value at ell = 0.03, enough to flip gates and let two
    runs that differ only in summation order drift apart."""
    diff = x[:, None, :] - y[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def _pair_mask_and_kernels(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """Shared gate: geometric + color thresholds + validity.

    Returns (gate_mask, k, ck, d2, d2c) where k/ck are the geometric/color
    kernel values (cvo.cpp:172-174)."""
    d2 = _pairwise_sq_dists(x, y)
    d2c = _pairwise_sq_dists(fx, fy)
    gate = (d2 < d2_threshold(ell, p)) & (d2c < d2_color_threshold(p))
    gate = gate & mx[:, None] & my[None, :]
    # exponent clamps are exact for every pair passing the gates (the gate
    # thresholds bound the exponents at ~-5)
    k = (p.sigma * p.sigma) * jnp.exp(
        jnp.maximum(-d2 / (2.0 * ell * ell), -20.0))
    ck = (p.c_sigma * p.c_sigma) * jnp.exp(
        jnp.maximum(-d2c / (2.0 * p.c_ell * p.c_ell), -20.0))
    return gate, k, ck, d2, d2c


# ---------------------------------------------------------------------------
# se_kernel + compute_flow (cvo.cpp:122-236)
# ---------------------------------------------------------------------------

def cvo_kernel(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """Masked joint kernel A (N,M). Entries pass the geometric/color gates and
    the sparsification test a > sp_thres (cvo.cpp:175); zero elsewhere."""
    gate, k, ck, _, _ = _pair_mask_and_kernels(x, y, fx, fy, mx, my, ell, p)
    a = ck * k
    keep = gate & (a > p.sp_thres)
    return jnp.where(keep, a, 0.0), keep


def color_kernel_gated(fx, fy, mx, my, p: CvoParams):
    """Color kernel with its gate + validity masks folded in (zero where the
    color gate or a mask fails). Features do not change during an alignment
    (only positions transform, cvo.cpp:336-341), so align computes this ONCE
    and carries it across the while_loop — the per-iteration cost drops to
    the geometric half."""
    d2c = _pairwise_sq_dists(fx, fy)
    cgate = (d2c < d2_color_threshold(p)) & mx[:, None] & my[None, :]
    ck = (p.c_sigma * p.c_sigma) * jnp.exp(
        jnp.maximum(-d2c / (2.0 * p.c_ell * p.c_ell), -20.0))
    return jnp.where(cgate, ck, 0.0)


def cvo_kernel_from_color(x, y, ckg, ell, p: CvoParams):
    """cvo_kernel with the color factor precomputed by color_kernel_gated.
    Identical output: ckg==0 encodes a failed color gate/mask, which zeroes
    a and therefore fails the a > sp_thres test exactly as before."""
    d2 = _pairwise_sq_dists(x, y)
    ggate = d2 < d2_threshold(ell, p)
    k = (p.sigma * p.sigma) * jnp.exp(
        jnp.maximum(-d2 / (2.0 * ell * ell), -20.0))
    a = ckg * k
    keep = ggate & (a > p.sp_thres)
    return jnp.where(keep, a, 0.0), keep


def flow(x, y, fx, fy, mx, my, ell, p: CvoParams):
    """omega, v of the RKHS gradient flow (compute_flow, cvo.cpp:187-236):

      omega = (1/c) sum_ij A_ij (x_i x y_j) = (1/c) sum_i x_i x (A y)_i
      v     = (1/d) sum_ij A_ij (y_j - x_i)

    Returns (omega, v, A, nnz)."""
    A, keep = cvo_kernel(x, y, fx, fy, mx, my, ell, p)
    return _flow_from_A(x, y, A, keep, p)


def flow_from_color(x, y, ckg, ell, p: CvoParams):
    """flow with the iteration-invariant color kernel precomputed
    (color_kernel_gated); bitwise-identical results."""
    A, keep = cvo_kernel_from_color(x, y, ckg, ell, p)
    return _flow_from_A(x, y, A, keep, p)


def _flow_from_A(x, y, A, keep, p: CvoParams):
    m = A @ y                      # (N,3) row-wise weighted moving moments
    s = jnp.sum(A, axis=1)         # (N,) row sums
    # conditioning: accumulate the locally-small d_i = sum_j A_ij (y_j - x_i)
    # and take omega = sum x_i x d_i (exact: x x x = 0). The raw
    # sum cross(x, m) cancels catastrophically in f32 when clouds sit metres
    # from the origin (matches the Pallas kernels' formulation).
    d = m - s[:, None] * x
    omega = jnp.sum(jnp.cross(x, d), axis=0) / p.c
    v = jnp.sum(d, axis=0) / p.d
    nnz = jnp.sum(keep)
    return omega, v, A, nnz


# ---------------------------------------------------------------------------
# compute_step_size quartic coefficients (cvo.cpp:239-315)
# ---------------------------------------------------------------------------

def step_coeffs(x, y, A, omega, v, ell):
    """Taylor coefficients B,C,D,E of the 4th-order step-size expansion.

    Per-pair scalars (cvo.cpp:282-306) with j the moving index:
      beta  = -2 tc * xiz_j . (x_i - y_j)
      gamma = -tc * (|xiz_j|^2 + 2 xi2z_j . (x_i - y_j))
      delta = 2 tc * (-xiz_j . xi2z_j - xi3z_j . (x_i - y_j))
      epsil = -tc * (|xi2z_j|^2 + 2 xiz_j.xi3z_j + 2 xi4z_j . (x_i - y_j))
    with tc = 1/(2 l^2). The x_i-dependence enters through four (N,M)
    matmuls X @ xi{1..4}z^T; the rest are per-j scalars."""
    oh = jnp.zeros((3, 3), A.dtype)
    oh = oh.at[0, 1].set(-omega[2]).at[0, 2].set(omega[1])
    oh = oh.at[1, 0].set(omega[2]).at[1, 2].set(-omega[0])
    oh = oh.at[2, 0].set(-omega[1]).at[2, 1].set(omega[0])
    oh2 = oh @ oh
    oh3 = oh2 @ oh
    oh4 = oh3 @ oh

    # row j of y @ oh.T is (skew(omega) @ y_j)^T = omega x y_j
    xiz = y @ oh.T + v[None, :]
    xi2z = y @ oh2.T + (oh @ v)[None, :]
    xi3z = y @ oh3.T + (oh2 @ v)[None, :]
    xi4z = y @ oh4.T + (oh3 @ v)[None, :]

    normxiz2 = jnp.sum(xiz * xiz, axis=1)
    xiz_dot_xi2z = -jnp.sum(xiz * xi2z, axis=1)
    epsil_const = jnp.sum(xi2z * xi2z, axis=1) + 2.0 * jnp.sum(xiz * xi3z, axis=1)

    tc = 1.0 / (2.0 * ell * ell)
    # xi{k}z_j . (x_i - y_j) = (X @ xi{k}z^T)_ij - (xi{k}z_j . y_j)
    d1 = x @ xiz.T - jnp.sum(xiz * y, axis=1)[None, :]
    d2 = x @ xi2z.T - jnp.sum(xi2z * y, axis=1)[None, :]
    d3 = x @ xi3z.T - jnp.sum(xi3z * y, axis=1)[None, :]
    d4 = x @ xi4z.T - jnp.sum(xi4z * y, axis=1)[None, :]

    beta = -2.0 * tc * d1
    gamma = -tc * (normxiz2[None, :] + 2.0 * d2)
    delta = 2.0 * tc * (xiz_dot_xi2z[None, :] - d3)
    epsil = -tc * (epsil_const[None, :] + 2.0 * d4)

    B = jnp.sum(A * beta)
    C = jnp.sum(A * (gamma + beta * beta / 2.0))
    D = jnp.sum(A * (delta + beta * gamma + beta ** 3 / 6.0))
    E = jnp.sum(A * (epsil + beta * delta + 0.5 * beta * beta * gamma
                     + 0.5 * gamma * gamma + beta ** 4 / 24.0))
    return B, C, D, E


# ---------------------------------------------------------------------------
# fused flow + step coefficients in moment form (the XLA hot path)
# ---------------------------------------------------------------------------
# Per-pair, every step-size Taylor factor is affine in x_i (cvo.cpp:282-306):
#   beta  = b0_j + b_j . x_i,   gamma = g0_j + g_j . x_i,   etc.
# so each of B, C, D, E = sum_ij A_ij P(x_i; j) with P of degree <= 4 in x_i,
# i.e. a linear functional of the 35 moments  Mom_j = sum_i A_ij xt_i^alpha
# (xt = x - centroid, |alpha| <= 4) — ONE (M,N)x(N,35) matmul. The flow
# reduction (omega, v) falls out of the degree-<=1 columns of the same
# matmul. Compared to the per-pair formulation this removes every (N,M)
# temporary except A itself (the old path materialized 8+: four x @ xi{k}z^T
# products and the beta/gamma/delta/epsil combinations), cutting the
# HBM-bound per-iteration cost of the align loop by ~2-3x.
#
# Centering x around its masked centroid keeps the expansion conditioned:
# the monomial contributions cancel down to locally-small per-pair values
# (|x_i - y_j| <= gate radius ~ 2.6 ell), so the amplification is
# (scene_extent / gate_radius)^degree from a ~1-2 m extent rather than from
# a ~3-4 m camera-frame offset. Accuracy vs the f64 per-pair golden is
# verified across the full ell anneal schedule in tests/test_pairwise.py.

# all monomial index tuples over {0,1,2} with degree <= 4, grouped by degree
_MONOMIALS = [()]
_MONOMIALS += [(i,) for i in range(3)]
_MONOMIALS += [(i, j) for i in range(3) for j in range(i, 3)]
_MONOMIALS += [(i, j, k) for i in range(3) for j in range(i, 3)
               for k in range(j, 3)]
_MONOMIALS += [(i, j, k, l) for i in range(3) for j in range(i, 3)
               for k in range(j, 3) for l in range(k, 3)]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}
assert len(_MONOMIALS) == 35


def step_moment_basis(x, mask):
    """Precompute (centroid, U) for flow_and_step_moments.

    U is (N, 35): all monomials of xt = x - centroid up to degree 4. x is
    the FIXED cloud of an alignment — it never changes across iterations
    (only the moving cloud transforms, cvo.cpp:336-341) — so this is
    evaluated once per align and carried as a loop constant."""
    w = mask.astype(x.dtype)
    c = jnp.sum(x * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    xt = x - c
    cols = [jnp.ones(x.shape[0], x.dtype)]
    for mono in _MONOMIALS[1:]:
        col = xt[:, mono[0]]
        for idx in mono[1:]:
            col = col * xt[:, idx]
        cols.append(col)
    return c, jnp.stack(cols, axis=1)


def _poly_mul(p1, p2):
    """Multiply polynomials-in-xt with (M,)-array coefficients, keyed by
    sorted monomial index tuples."""
    out = {}
    for k1, v1 in p1.items():
        for k2, v2 in p2.items():
            k = tuple(sorted(k1 + k2))
            out[k] = out.get(k, 0.0) + v1 * v2
    return out


def _poly_addmul(acc, poly, scale=1.0):
    for k, v in poly.items():
        acc[k] = acc.get(k, 0.0) + scale * v
    return acc


def _affine(const, vec):
    """Affine per-j polynomial const_j + vec_j . xt: {(): (M,), (i,): (M,)}."""
    return {(): const, (0,): vec[:, 0], (1,): vec[:, 1], (2,): vec[:, 2]}


def flow_and_step_moments(x, y, ckg, U, center, ell, p: CvoParams):
    """Fused compute_flow + compute_step_size coefficients (cvo.cpp:187-334)
    via the moment form. Returns (omega, v, nnz, B, C, D, E) — identical
    semantics to flow_from_color + step_coeffs, reorganized so the only
    (N, M)-sized values are the kernel matrix A and its two dot-products.

    x/U/center come from the fixed cloud (step_moment_basis); y is the
    transformed moving cloud of the current iteration; ckg the precomputed
    gated color kernel (color_kernel_gated)."""
    A, keep = cvo_kernel_from_color(x, y, ckg, ell, p)
    # Mom[j, a] = sum_i A_ij xt_i^alpha  — one (M,N)x(N,35) matmul
    Mom = jax.lax.dot_general(A, U, (((0,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST)
    nnz = jnp.sum(keep)
    return flow_and_step_from_moments(Mom, y, center, ell, nnz, p)


def flow_and_step_from_moments(Mom, y, center, ell, nnz, p: CvoParams):
    """Epilogue of the moment-form pass: (omega, v, B..E) from the moment
    matrix Mom (M, 35). Split out so the fused moment kernel
    (cvo.moment_kernel, which produces Mom without writing the pairwise
    stage to device memory) shares the exact same algebra as the XLA path.
    All work here is O(M)-sized — no (N, M) temporaries."""
    # ---- flow (cvo.cpp:222-223) from the degree-<=1 columns -------------
    M0 = Mom[:, 0]
    M1 = Mom[:, 1:4]
    dy = y - center
    # D_j = sum_i A_ij (x_i - y_j): locally small (gate radius ~2.6 ell)
    Dj = M1 - dy * M0[:, None]
    # v = (1/d) sum_ij A (y_j - x_i) = -(1/d) sum_j D_j
    v = -jnp.sum(Dj, axis=0) / p.d
    # omega: x_i x y_j = (x_i - y_j) x y_j, so sum_ij A (x x y) = sum_j D_j x y_j
    omega = jnp.sum(jnp.cross(Dj, y), axis=0) / p.c

    # ---- step coefficients (cvo.cpp:239-315) ----------------------------
    oh = jnp.zeros((3, 3), Mom.dtype)
    oh = oh.at[0, 1].set(-omega[2]).at[0, 2].set(omega[1])
    oh = oh.at[1, 0].set(omega[2]).at[1, 2].set(-omega[0])
    oh = oh.at[2, 0].set(-omega[1]).at[2, 1].set(omega[0])
    oh2 = oh @ oh
    oh3 = oh2 @ oh
    oh4 = oh3 @ oh
    xiz = y @ oh.T + v[None, :]
    xi2z = y @ oh2.T + (oh @ v)[None, :]
    xi3z = y @ oh3.T + (oh2 @ v)[None, :]
    xi4z = y @ oh4.T + (oh3 @ v)[None, :]

    tc = 1.0 / (2.0 * ell * ell)
    two_tc = 2.0 * tc

    def ddot(u):
        return jnp.sum(u * dy, axis=1)          # u_j . (y_j - center)

    normxiz2 = jnp.sum(xiz * xiz, axis=1)
    xiz_dot_xi2z = jnp.sum(xiz * xi2z, axis=1)
    epsil_const = jnp.sum(xi2z * xi2z, axis=1) + 2.0 * jnp.sum(xiz * xi3z,
                                                               axis=1)
    # beta  = -2tc xiz.(x - y)  = (2tc xiz.dy) + (-2tc xiz).xt
    beta = _affine(two_tc * ddot(xiz), -two_tc * xiz)
    gamma = _affine(-tc * normxiz2 + two_tc * ddot(xi2z), -two_tc * xi2z)
    delta = _affine(-two_tc * xiz_dot_xi2z + two_tc * ddot(xi3z),
                    -two_tc * xi3z)
    epsil = _affine(-tc * epsil_const + two_tc * ddot(xi4z), -two_tc * xi4z)

    b2 = _poly_mul(beta, beta)
    bg = _poly_mul(beta, gamma)
    # PB = beta;  PC = gamma + beta^2/2;  PD = delta + beta*gamma + beta^3/6
    # PE = epsil + beta*delta + beta^2 gamma/2 + gamma^2/2 + beta^4/24
    PB = dict(beta)
    PC = _poly_addmul(dict(gamma), b2, 0.5)
    PD = _poly_addmul(_poly_addmul(dict(delta), bg),
                      _poly_mul(b2, beta), 1.0 / 6.0)
    PE = _poly_addmul(_poly_addmul(dict(epsil), _poly_mul(beta, delta)),
                      _poly_mul(b2, gamma), 0.5)
    PE = _poly_addmul(PE, _poly_mul(gamma, gamma), 0.5)
    PE = _poly_addmul(PE, _poly_mul(b2, b2), 1.0 / 24.0)

    def contract(poly):
        return sum(jnp.vdot(coef, Mom[:, _MONO_INDEX[k]])
                   for k, coef in poly.items())

    return omega, v, nnz, contract(PB), contract(PC), contract(PD), \
        contract(PE)

def inner_product(xa, fa, ma, xb, fb, mb, ell, p: CvoParams):
    """RKHS inner product <f_a, f_b>: sum of joint kernel values over pairs
    passing the geometric+color gates (no sp_thres gate here — cvo.cpp:428-447).
    Returns (value, num) with num >= 1 (cvo.cpp:455-456)."""
    gate, k, ck, _, _ = _pair_mask_and_kernels(xa, xb, fa, fb, ma, mb, ell, p)
    a = jnp.where(gate, ck * k, 0.0)
    value = jnp.sum(a)
    num = jnp.sum(gate).astype(a.dtype)
    num = jnp.where(num == 0, 1.0, num)
    return value, num


# ---------------------------------------------------------------------------
# se3_Hessian via 13x13 weighted moments (cvo.cpp:620-759)
# ---------------------------------------------------------------------------
# Polynomial index algebra: each 6x6 Hessian entry is
#     H[r,c] = il2 * ( il2 * <hi_poly> + <lo_poly> )
# where <P> = sum_ij w_ij P(a_i, b_j), w_ij = k_ij * (f_a.f_b)_ij * gate_ij,
# il2 = 1/l^2, and each poly is degree <=2 in a and <=2 in b — i.e. a linear
# functional of the moment matrix G = U_a^T W U_b with U = [1, p, vec(pp^T)].


class _Poly:
    """Tiny polynomial in a0..a2, b0..b2 (degree <=2 per side)."""

    def __init__(self, terms=None):
        self.terms = dict(terms or {})  # {(a_idx_tuple, b_idx_tuple): coef}

    @staticmethod
    def const(c=1.0):
        return _Poly({((), ()): float(c)})

    @staticmethod
    def a(i):
        return _Poly({((i,), ()): 1.0})

    @staticmethod
    def b(i):
        return _Poly({((), (i,)): 1.0})

    def __add__(self, o):
        t = dict(self.terms)
        for k, v in o.terms.items():
            t[k] = t.get(k, 0.0) + v
        return _Poly(t)

    def __sub__(self, o):
        return self + (o * -1.0)

    def __mul__(self, o):
        if isinstance(o, (int, float)):
            return _Poly({k: v * o for k, v in self.terms.items()})
        t = {}
        for (a1, b1), c1 in self.terms.items():
            for (a2, b2), c2 in o.terms.items():
                ka = tuple(sorted(a1 + a2))
                kb = tuple(sorted(b1 + b2))
                assert len(ka) <= 2 and len(kb) <= 2, "degree overflow"
                t[(ka, kb)] = t.get((ka, kb), 0.0) + c1 * c2
        return _Poly(t)

    __rmul__ = __mul__


def _u_index(idx):
    """Map a monomial index tuple to the row of U = [1, p0..p2, vec(pp^T)]."""
    if len(idx) == 0:
        return (0,)
    if len(idx) == 1:
        return (1 + idx[0],)
    p, q = idx
    return (4 + 3 * p + q,)


@lru_cache(maxsize=1)
def _hessian_polys():
    """Build the (hi, lo) polynomial pair for each of the 36 Hessian entries,
    mirroring the block formulas of cvo.cpp:666-704."""
    a = [_Poly.a(i) for i in range(3)]
    b = [_Poly.b(i) for i in range(3)]
    zero = _Poly()
    cross = [a[1] * b[2] - a[2] * b[1],
             a[2] * b[0] - a[0] * b[2],
             a[0] * b[1] - a[1] * b[0]]
    diff = [b[i] - a[i] for i in range(3)]
    one = _Poly.const(1.0)

    # Block A (cvo.cpp:666-675)
    A_ = [[None] * 3 for _ in range(3)]
    dots = [a[1] * b[1] + a[2] * b[2],
            a[0] * b[0] + a[2] * b[2],
            a[0] * b[0] + a[1] * b[1]]
    for i in range(3):
        A_[i][i] = (cross[i] * cross[i], zero - dots[i])
    for i, j in ((0, 1), (0, 2), (1, 2)):
        lo = 0.5 * (a[i] * b[j] + a[j] * b[i])
        A_[i][j] = A_[j][i] = (cross[i] * cross[j], lo)

    # Block C (cvo.cpp:677-688): C[r][c]
    C_ = [[None] * 3 for _ in range(3)]
    for i in range(3):
        C_[i][i] = (cross[i] * diff[i], zero)
    C_[1][0] = (diff[1] * cross[0], a[2] * one)
    C_[2][0] = (diff[2] * cross[0], zero - a[1])
    C_[0][1] = (diff[0] * cross[1], zero - a[2])
    C_[2][1] = (diff[2] * cross[1], a[0] * one)
    C_[0][2] = (diff[0] * cross[2], a[1] * one)
    C_[1][2] = (diff[1] * cross[2], zero - a[0])

    # Block D (cvo.cpp:690-697)
    D_ = [[None] * 3 for _ in range(3)]
    for i in range(3):
        D_[i][i] = (diff[i] * diff[i], zero - one)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        D_[i][j] = D_[j][i] = (diff[i] * diff[j], zero)

    # Assemble 6x6: [[A, C^T], [C, D]] (cvo.cpp:699-704)
    H = [[None] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            H[i][j] = A_[i][j]
            H[i][3 + j] = C_[j][i]      # C^T
            H[3 + i][j] = C_[i][j]
            H[3 + i][3 + j] = D_[i][j]

    # Flatten each entry into (rows, cols, coefs) against the 13x13 G.
    def compile_poly(poly):
        rows, cols, coefs = [], [], []
        for (ia, ib), c in poly.terms.items():
            if c == 0.0:
                continue
            rows.append(_u_index(ia)[0])
            cols.append(_u_index(ib)[0])
            coefs.append(c)
        return (np.array(rows, np.int32), np.array(cols, np.int32),
                np.array(coefs, np.float32))

    return [[(compile_poly(H[r][c][0]), compile_poly(H[r][c][1]))
             for c in range(6)] for r in range(6)]


def lift_u(pts):
    """(N,3) -> (N,13) moment features U = [1, p, vec(p p^T)]."""
    n = pts.shape[0]
    ones = jnp.ones((n, 1), pts.dtype)
    outer = (pts[:, :, None] * pts[:, None, :]).reshape(n, 9)
    return jnp.concatenate([ones, pts, outer], axis=1)


def assemble_hessian(G, ell):
    """6x6 Hessian from the 13x13 moment matrix G (exact index algebra)."""
    il2 = 1.0 / (ell * ell)
    polys = _hessian_polys()
    rows = []
    for r in range(6):
        row = []
        for c in range(6):
            (hr, hc, hco), (lr, lc, lco) = polys[r][c]
            hi = jnp.sum(G[hr, hc] * hco) if len(hco) else 0.0
            lo = jnp.sum(G[lr, lc] * lco) if len(lco) else 0.0
            row.append(il2 * (il2 * hi + lo))
        rows.append(jnp.stack(row))
    return jnp.stack(rows)


def hessian_moments(xa, fa, ma, xb, fb, mb, ell, p: CvoParams):
    """Weighted moment matrix G (13,13) and inlier count for se3_Hessian.

    Pair weight w = k * (f_a . f_b) over pairs passing the geometric+color
    gates (cvo.cpp:648-662); cloud_a is the transformed moving cloud, cloud_b
    the fixed cloud (cvo.cpp:500, :555)."""
    gate, k, _, _, _ = _pair_mask_and_kernels(xa, xb, fa, fb, ma, mb, ell, p)
    cdot = fa @ fb.T
    W = jnp.where(gate, k * cdot, 0.0)
    Ua = lift_u(xa)
    Ub = lift_u(xb)
    G = Ua.T @ (W @ Ub)
    inliers = jnp.sum(gate)
    return G, inliers


def se3_hessian_raw(xa, fa, ma, xb, fb, mb, ell, p: CvoParams):
    """Unscaled 6x6 Hessian sum (before the -1/1e5 scaling and eigenvalue
    floor of cvo.cpp:726-754, which live in engine.hessian_postprocess)."""
    G, inliers = hessian_moments(xa, fa, ma, xb, fb, mb, ell, p)
    return assemble_hessian(G, ell), inliers


# ---------------------------------------------------------------------------
# fused inner-product suite (compute_innerproduct, cvo.cpp:475-503)
# ---------------------------------------------------------------------------

def _self_ip(x, f, m, ell, d2ct, p: CvoParams):
    """inner_product(x, x) with the feature/geometry dots batched by the
    caller-shared helpers; returns (value, num>=1)."""
    d2 = _pairwise_sq_dists(x, x)
    d2c = _pairwise_sq_dists(f, f)
    gate = (d2 < d2_threshold(ell, p)) & (d2c < d2ct) & m[:, None] & m[None, :]
    k = (p.sigma * p.sigma) * jnp.exp(
        jnp.maximum(-d2 / (2.0 * ell * ell), -20.0))
    ck = (p.c_sigma * p.c_sigma) * jnp.exp(
        jnp.maximum(-d2c / (2.0 * p.c_ell * p.c_ell), -20.0))
    value = jnp.sum(jnp.where(gate, ck * k, 0.0))
    num = jnp.sum(gate).astype(value.dtype)
    return value, jnp.where(num == 0, 1.0, num)


def ip_suite(x, fx, mx, y, fy, my, yt, ell, p: CvoParams):
    """Everything compute_innerproduct needs, with the shared pairwise
    subexpressions computed ONCE (the separate-call formulation recomputes
    the same feature matmul five times):

      * fy @ fx^T serves the color distance of the pre AND post inner
        products AND the Hessian pair weight cdot (cvo.cpp:652);
      * the geometric distances of the post inner product and the Hessian
        gate are the same d2(yt, x) matrix (cvo.cpp:485 vs :500).

    Returns (pre_v, pre_n, post_v, post_n, fixed_v, fixed_n, moving_v,
    moving_n, G, inliers) — the same tuple as the Pallas ip_suite kernel.
    Semantics identical to four inner_product calls + hessian_moments:
    same gates, same kernel formulas, same reduction structure.

    The exponent clamp is exact for every gated pair (the gate thresholds
    bound the joint exponent at ~-5, see _pair_mask_and_kernels)."""
    d2t = d2_threshold(ell, p)
    d2ct = jnp.float32(d2_color_threshold(p))
    mpair = mx[None, :] & my[:, None]            # (M, N): rows moving
    s2 = p.sigma * p.sigma
    cs2 = p.c_sigma * p.c_sigma

    # ---- shared feature products (one matmul serves pre/post/Hessian) ----
    cdot = fy @ fx.T                              # (M, N)
    fyy = jnp.sum(fy * fy, axis=-1)
    fxx = jnp.sum(fx * fx, axis=-1)
    d2c = jnp.maximum(fyy[:, None] + fxx[None, :] - 2.0 * cdot, 0.0)
    cgate = (d2c < d2ct) & mpair
    ck = cs2 * jnp.exp(jnp.maximum(-d2c / (2.0 * p.c_ell * p.c_ell), -20.0))

    # ---- pre: moving vs fixed at the identity (cvo.cpp:481) --------------
    d2_pre = _pairwise_sq_dists(y, x)
    gate_pre = (d2_pre < d2t) & cgate
    k_pre = s2 * jnp.exp(jnp.maximum(-d2_pre / (2.0 * ell * ell), -20.0))
    pre_v = jnp.sum(jnp.where(gate_pre, ck * k_pre, 0.0))
    pre_n = jnp.sum(gate_pre).astype(pre_v.dtype)
    pre_n = jnp.where(pre_n == 0, 1.0, pre_n)

    # ---- post: transformed moving vs fixed; the SAME d2/gate/k also feed
    #      the Hessian (cvo.cpp:485 and :500 use identical pair sets) ------
    d2_post = _pairwise_sq_dists(yt, x)
    gate_post = (d2_post < d2t) & cgate
    k_post = s2 * jnp.exp(jnp.maximum(-d2_post / (2.0 * ell * ell), -20.0))
    post_v = jnp.sum(jnp.where(gate_post, ck * k_post, 0.0))
    post_n = jnp.sum(gate_post).astype(post_v.dtype)
    post_n = jnp.where(post_n == 0, 1.0, post_n)

    # ---- self norms (cvo.cpp:488-489) ------------------------------------
    fixed_v, fixed_n = _self_ip(x, fx, mx, ell, d2ct, p)
    moving_v, moving_n = _self_ip(y, fy, my, ell, d2ct, p)

    # ---- Hessian moments: weight w = k * (f_a . f_b) over the post gate --
    W = jnp.where(gate_post, k_post * cdot, 0.0)
    G = lift_u(yt).T @ (W @ lift_u(x))
    inliers = jnp.sum(gate_post)
    return (pre_v, pre_n, post_v, post_n, fixed_v, fixed_n,
            moving_v, moving_n, G, inliers)


def ip_suite_lc(x, fx, mx, y, fy, my, y_prior, y_lcp, y_lcp2, y_lc, ell,
                p: CvoParams):
    """Everything compute_innerproduct_lc needs (cvo.cpp:505-561): inner
    products of the moving cloud under four transforms against the fixed
    cloud, self norms, the Hessian moments for the CVO posterior (y_lc) and
    the gated-pair count for the pnpransac prior (y_lcp2) — with the single
    feature matmul shared by all six pair sets. Semantics identical to six
    inner_product calls + two hessian_moments calls (the reference discards
    the second Hessian and keeps only its inlier count, see
    engine.compute_innerproduct_lc).

    Returns (prior_v, lcp_v, pre_v, post_v, fixed_v, moving_v, G,
    inliers_svd, inliers_pnp)."""
    d2t = d2_threshold(ell, p)
    d2ct = jnp.float32(d2_color_threshold(p))
    mpair = mx[None, :] & my[:, None]
    s2 = p.sigma * p.sigma
    cs2 = p.c_sigma * p.c_sigma

    cdot = fy @ fx.T
    fyy = jnp.sum(fy * fy, axis=-1)
    fxx = jnp.sum(fx * fx, axis=-1)
    d2c = jnp.maximum(fyy[:, None] + fxx[None, :] - 2.0 * cdot, 0.0)
    cgate = (d2c < d2ct) & mpair
    ck = cs2 * jnp.exp(jnp.maximum(-d2c / (2.0 * p.c_ell * p.c_ell), -20.0))

    def one(yk):
        d2 = _pairwise_sq_dists(yk, x)
        gate = (d2 < d2t) & cgate
        k = s2 * jnp.exp(jnp.maximum(-d2 / (2.0 * ell * ell), -20.0))
        return gate, k

    gate_prior, k_prior = one(y_prior)
    prior_v = jnp.sum(jnp.where(gate_prior, ck * k_prior, 0.0))
    gate_lcp, k_lcp = one(y_lcp)
    lcp_v = jnp.sum(jnp.where(gate_lcp, ck * k_lcp, 0.0))
    gate_pre, k_pre = one(y)
    pre_v = jnp.sum(jnp.where(gate_pre, ck * k_pre, 0.0))
    gate_post, k_post = one(y_lc)
    post_v = jnp.sum(jnp.where(gate_post, ck * k_post, 0.0))

    fixed_v, _ = _self_ip(x, fx, mx, ell, d2ct, p)
    moving_v, _ = _self_ip(y, fy, my, ell, d2ct, p)

    W = jnp.where(gate_post, k_post * cdot, 0.0)
    G = lift_u(y_lc).T @ (W @ lift_u(x))
    inliers_svd = jnp.sum(gate_post)
    gate_pnp, _ = one(y_lcp2)
    inliers_pnp = jnp.sum(gate_pnp)
    return (prior_v, lcp_v, pre_v, post_v, fixed_v, moving_v, G,
            inliers_svd, inliers_pnp)
