"""Smallest-positive-real-root cubic solver for the CVO step size.

The reference solves the quartic-energy derivative 4E s^3 + 3D s^2 + 2C s + B
via a companion-matrix eigensolve and picks the smallest positive real root
(cvo.cpp:76-92, 317-333). A nonsymmetric eigensolve inside the jitted align
loop would be a host-style LAPACK call, so we use the closed-form
(trig/Cardano) cubic solution instead — branch-free and jit/vmap friendly.
Semantics preserved:

  * only real roots count (discriminant decides, like imag()==0 in Eigen);
  * no positive real root -> min_step (cvo.cpp:330);
  * result clamped to max_step=0.8 (cvo.cpp:333);
  * degenerate leading coefficient -> min_step (the reference divides by
    coef(0); a zero there poisons the eigensolve and falls through to
    min_step).
"""

from __future__ import annotations

import jax.numpy as jnp

_BIG = jnp.inf


def cubic_roots_real(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d, returned as a length-3 vector
    where non-real (or invalid) slots are +inf."""
    dt = jnp.result_type(a, jnp.float32)
    a = jnp.asarray(a, dt)
    safe_a = jnp.where(jnp.abs(a) > 0.0, a, 1.0)
    p = b / safe_a
    q = c / safe_a
    r = d / safe_a

    # depressed cubic t^3 + pt*t + qt, x = t - p/3
    pt = q - p * p / 3.0
    qt = 2.0 * p ** 3 / 27.0 - p * q / 3.0 + r

    disc = (qt / 2.0) ** 2 + (pt / 3.0) ** 3

    # --- one-real-root branch (disc > 0): Cardano
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_single = jnp.cbrt(-qt / 2.0 + sq) + jnp.cbrt(-qt / 2.0 - sq)

    # --- three-real-roots branch (disc <= 0): trigonometric
    m = jnp.maximum(-pt / 3.0, 1e-30)
    sm = jnp.sqrt(m)
    cos_arg = jnp.clip(3.0 * qt / (2.0 * pt * sm + 1e-300), -1.0, 1.0)
    # guard pt -> 0 (triple root): cos_arg irrelevant, sm -> 0 gives t=0
    pt_safe = jnp.where(jnp.abs(pt) > 1e-30, pt, -3.0 * m)
    cos_arg = jnp.clip(3.0 * qt / (2.0 * pt_safe * sm), -1.0, 1.0)
    ang = jnp.arccos(cos_arg) / 3.0
    ks = jnp.arange(3, dtype=dt)
    t_trig = 2.0 * sm * jnp.cos(ang - 2.0 * jnp.pi * ks / 3.0)

    three_real = disc <= 0.0
    roots = jnp.where(
        three_real,
        t_trig - p / 3.0,
        jnp.stack([t_single - p / 3.0, _BIG, _BIG]),
    )
    roots = jnp.where(jnp.abs(a) > 0.0, roots, _BIG)
    return roots


def min_positive_root_or(a, b, c, d, fallback, clamp):
    """Smallest strictly-positive real root of the cubic; ``fallback`` if none;
    clamped from above at ``clamp`` (cvo.cpp:324-333)."""
    roots = cubic_roots_real(a, b, c, d)
    pos = jnp.where(roots > 0.0, roots, _BIG)
    best = jnp.min(pos)
    step = jnp.where(jnp.isfinite(best), best, fallback)
    return jnp.minimum(step, clamp)
