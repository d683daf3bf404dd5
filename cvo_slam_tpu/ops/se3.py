"""SE(3)/SO(3) Lie-group math in JAX.

JAX re-expression of the reference Lie-group layer
(/root/reference/thirdparty/cvo/src/LieGroup.cpp:20-199 and the closed-form
inverse left Jacobian of /root/reference/src/vertex_and_edge.cpp:88-243).

Conventions (matching the reference):
  * twist vectors are ordered [omega(3), v(3)] — rotation first.
  * poses are 4x4 homogeneous matrices.
  * small-angle switch at TOLERANCE=1e-6 (LieGroup.cpp:18) selecting the
    identity/first-order branch, exactly like the reference (no Taylor series).

All functions are jit/vmap friendly: branches are computed with safe
denominators and selected with jnp.where.
"""

from __future__ import annotations

import jax.numpy as jnp

TOL = 1e-6


def skew(v):
    """3-vector -> skew-symmetric matrix (LieGroup.cpp:20-27)."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
        jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
        jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
    ], axis=-2)


def unskew(M):
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _theta(w):
    return jnp.sqrt(jnp.maximum(jnp.sum(w * w, axis=-1), 0.0))


def exp_so3(w):
    """Rodrigues formula (LieGroup.cpp:148-157)."""
    theta = _theta(w)
    safe = theta >= TOL
    t = jnp.where(safe, theta, 1.0)
    A = skew(w)
    A2 = A @ A
    I = jnp.eye(3, dtype=w.dtype)
    R = I + (jnp.sin(t) / t)[..., None, None] * A \
        + ((1.0 - jnp.cos(t)) / (t * t))[..., None, None] * A2
    return jnp.where(safe[..., None, None], R, jnp.broadcast_to(I, R.shape))


def log_so3(R):
    """Matrix log on SO(3) (LieGroup.cpp:120-126), with acos clamped."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip(0.5 * (tr - 1.0), -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    safe = theta >= TOL
    t = jnp.where(safe, theta, 1.0)
    st = jnp.where(safe, jnp.sin(t), 1.0)
    W = (t / (2.0 * st))[..., None, None] * (R - jnp.swapaxes(R, -1, -2))
    w = unskew(W)
    return jnp.where(safe[..., None], w, jnp.zeros_like(w))


def left_jacobian_so3(w):
    """J_l (LieGroup.cpp:49-59)."""
    theta = _theta(w)
    safe = theta >= TOL
    t = jnp.where(safe, theta, 1.0)
    A = skew(w)
    A2 = A @ A
    I = jnp.eye(3, dtype=w.dtype)
    J = I + ((1.0 - jnp.cos(t)) / (t * t))[..., None, None] * A \
        + ((t - jnp.sin(t)) / (t ** 3))[..., None, None] * A2
    return jnp.where(safe[..., None, None], J, jnp.broadcast_to(I, J.shape))


def left_jacobian_inv_so3(w):
    """J_l^{-1} (LieGroup.cpp:61-69)."""
    theta = _theta(w)
    safe = theta >= TOL
    t = jnp.where(safe, theta, 1.0)
    A = skew(w)
    A2 = A @ A
    I = jnp.eye(3, dtype=w.dtype)
    coef = 1.0 / (t * t) - (1.0 + jnp.cos(t)) / (2.0 * t * jnp.sin(t))
    J = I - 0.5 * A + coef[..., None, None] * A2
    return jnp.where(safe[..., None, None], J, jnp.broadcast_to(I, J.shape))


def exp_se3(xi):
    """SE(3) exponential, xi=[w,v] (LieGroup.cpp:139-146)."""
    w, v = xi[..., :3], xi[..., 3:6]
    R = exp_so3(w)
    t = (left_jacobian_so3(w) @ v[..., None])[..., 0]
    return make_pose(R, t)


def exp_se3_np(xi):
    """Pure-NumPy float64 SE(3) exponential for HOST-side solvers (the
    loop-closure pose-only LM runs on the host; a jnp exp_se3 there costs a
    full device round-trip per LM step — and
    f64 matches the reference's double-precision g2o::SE3Quat::exp more
    closely than the f32 device path)."""
    import numpy as _np
    xi = _np.asarray(xi, _np.float64)
    w, v = xi[:3], xi[3:6]
    theta = float(_np.linalg.norm(w))
    A = _np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                   [-w[1], w[0], 0.0]])
    I = _np.eye(3)
    if theta < 1e-7:
        R = I + A
        J = I + 0.5 * A
    else:
        A2 = A @ A
        R = I + (_np.sin(theta) / theta) * A \
            + ((1.0 - _np.cos(theta)) / theta ** 2) * A2
        J = I + ((1.0 - _np.cos(theta)) / theta ** 2) * A \
            + ((theta - _np.sin(theta)) / theta ** 3) * A2
    T = _np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = J @ v
    return T


def log_se3(T):
    """SE(3) log returning [w, v] (LieGroup.cpp:128-136)."""
    w = log_so3(T[..., :3, :3])
    v = (left_jacobian_inv_so3(w) @ T[..., :3, 3:4])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


def exp_sek3(xi, dt):
    """Scaled exponential Exp_SEK3(v, dt) used by the align loop
    (LieGroup.cpp:159-186, K=1). Returns a 4x4 transform."""
    w, v = xi[..., :3], xi[..., 3:6]
    theta = _theta(w)
    safe = theta >= TOL
    t = jnp.where(safe, theta, 1.0)
    A = skew(w)
    A2 = A @ A
    I = jnp.eye(3, dtype=xi.dtype)
    st = jnp.sin(dt * t)
    ct = jnp.cos(dt * t)
    one_m_ct_t2 = (1.0 - ct) / (t * t)
    R = I + (st / t)[..., None, None] * A + one_m_ct_t2[..., None, None] * A2
    Jl = dt * I + one_m_ct_t2[..., None, None] * A \
        + ((dt * t - st) / (t ** 3))[..., None, None] * A2
    R = jnp.where(safe[..., None, None], R, jnp.broadcast_to(I, R.shape))
    Jl = jnp.where(safe[..., None, None], Jl, jnp.broadcast_to(dt * I, Jl.shape))
    tvec = (Jl @ v[..., None])[..., 0]
    return make_pose(R, tvec)


def adjoint_se3(T):
    """Adjoint for the [w, v] ordering (LieGroup.cpp:188-199, K=1):
    [[R, 0], [skew(t) R, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Z = jnp.zeros_like(R)
    top = jnp.concatenate([R, Z], axis=-1)
    bot = jnp.concatenate([skew(t) @ R, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def left_jacobian_inv_se3(xi):
    """Closed-form inverse left Jacobian of SE(3) for [phi, rho] ordering,
    exactly as the reference edge linearization (vertex_and_edge.cpp:118-171):

      theta > 1e-3:  [[Jinv, 0], [-Jinv Q Jinv, Jinv]]
      else:          [[I, 0], [-0.5 skew(rho), I]]
    """
    phi, rho = xi[..., :3], xi[..., 3:6]
    theta = _theta(phi)
    safe = theta > 1e-3
    t = jnp.where(safe, theta, 1.0)

    P = skew(phi)
    Rh = skew(rho)
    P2 = P @ P
    I = jnp.eye(3, dtype=xi.dtype)

    coef = 1.0 / (t * t) - (1.0 + jnp.cos(t)) / (2.0 * t * jnp.sin(t))
    Jinv = I - 0.5 * P + coef[..., None, None] * P2

    t2, t3 = t * t, t ** 3
    t4, t5 = t ** 4, t ** 5
    st, ct = jnp.sin(t), jnp.cos(t)
    Q = (0.5 * Rh
         + ((t - st) / t3)[..., None, None] * (P @ Rh + Rh @ P + P @ Rh @ P)
         + ((t2 + 2.0 * ct - 2.0) / (2.0 * t4))[..., None, None]
         * (P2 @ Rh + Rh @ P2 - 3.0 * P @ Rh @ P)
         + ((2.0 * t - 3.0 * st + t * ct) / (2.0 * t5))[..., None, None]
         * (P @ Rh @ P2 + P2 @ Rh @ P))

    big_block = -Jinv @ Q @ Jinv
    small_block = -0.5 * Rh

    Jinv = jnp.where(safe[..., None, None], Jinv, jnp.broadcast_to(I, Jinv.shape))
    lower = jnp.where(safe[..., None, None], big_block, small_block)

    Z = jnp.zeros_like(Jinv)
    top = jnp.concatenate([Jinv, Z], axis=-1)
    bot = jnp.concatenate([lower, Jinv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def make_pose(R, t):
    """Assemble a (...,4,4) pose from (...,3,3) and (...,3)."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def inv_pose(T):
    """Fast SE(3) inverse."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_pose(Rt, -(Rt @ t[..., None])[..., 0])


def dist_se3(R, t):
    """Frobenius norm of the 4x4 matrix log (cvo.cpp:94-104).

    The matrix log of [[R, t], [0, 1]] is [[skew(w), u], [0, 0]] with
    w = Log(R), u = J_l(w)^{-1} t, so the Frobenius norm equals
    sqrt(2 |w|^2 + |u|^2) — note the factor 2 from the skew block.
    """
    w = log_so3(R)
    u = (left_jacobian_inv_so3(w) @ t[..., None])[..., 0]
    return jnp.sqrt(2.0 * jnp.sum(w * w, axis=-1) + jnp.sum(u * u, axis=-1))


def transform_points(T, pts):
    """Apply (...,4,4) pose to (...,N,3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]
