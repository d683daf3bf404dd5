"""The fused moment kernel (cvo.moment_kernel) in Pallas interpret mode,
against the XLA moment pass and the float64 per-pair reference.

Tolerances: the kernel takes direct coordinate differences where the XLA
path uses the matmul identity, so gates exactly at a threshold may flip
(nnz within 0.1%, at least one pair). Against the float64 reference each
quantity is held to a fraction of its absolute-term scale (the sum of
|term| over the gated pairs, ops.reference): omega, v, B and C to 1e-4;
D and E to 1e-3, because the shared moment epilogue expands them in
centred monomials up to degree 4, which amplifies float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine, moment_kernel as mk
from cvo_slam_tpu.ops import pairwise, reference
from tests.test_pairwise import make_clouds

P = CvoParams()
NAMES = ("omega", "v", "nnz", "B", "C", "D", "E")


def _clouds(seed, n, m, cap, off=(0.8, -0.5, 3.0)):
    """Test clouds moved ~3 m from the origin, like a camera frame."""
    x, fx, mx, y, fy, my = make_clouds(seed, n, m, cap=cap)
    off = np.asarray(off, np.float32)
    x = np.where(mx[:, None], x + off, x)
    y = np.where(my[:, None], y + off, y)
    return tuple(jnp.asarray(a) for a in (x, fx, mx, y, fy, my))


def _kernel_out(x, fx, mx, y, fy, my, ell):
    pf = mk.pack_fixed(x, fx, mx)
    return mk.flow_and_step(pf, y, fy, my, jnp.float32(ell), P,
                            interpret=True)


def _xla_out(x, fx, mx, y, fy, my, ell):
    ck = pairwise.color_kernel_gated(fx, fy, mx, my, P)
    center, U = pairwise.step_moment_basis(x, mx)
    return pairwise.flow_and_step_moments(x, y, ck, U, center,
                                          jnp.float32(ell), P)


def _nnz_close(a, b):
    assert abs(int(a) - int(b)) <= max(1, int(1e-3 * int(b))), (a, b)


@pytest.mark.parametrize("cap", [200, 256])
@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_kernel_matches_reference(ell, cap):
    """cap 200 is not a multiple of the kernel's blocks (padded inside)."""
    x, fx, mx, y, fy, my = _clouds(4, 180, 170, cap)
    got = dict(zip(NAMES, _kernel_out(x, fx, mx, y, fy, my, ell)))
    xla = dict(zip(NAMES, _xla_out(x, fx, mx, y, fy, my, ell)))
    gold = reference.flow_and_step(x, y, fx, fy, mx, my, ell, P)
    _nnz_close(got["nnz"], gold["nnz"])
    _nnz_close(got["nnz"], xla["nnz"])
    assert gold["nnz"] > 0
    for name, tol in (("omega", 1e-4), ("v", 1e-4), ("B", 1e-4),
                      ("C", 1e-4), ("D", 1e-3), ("E", 1e-3)):
        val, scale = gold[name]
        err = np.abs(np.asarray(got[name], np.float64) - val)
        assert np.all(err <= tol * scale + 1e-12), (name, err, scale)


@pytest.mark.parametrize("ell", [0.15, 0.06])
def test_kernel_moments_match_reference(ell):
    """The kernel's own output: the moment matrix, against float64 sums over
    the same basis."""
    x, fx, mx, y, fy, my = _clouds(5, 190, 200, 200)
    pf = mk.pack_fixed(x, fx, mx)
    Mom, nnz = mk.moments(pf, y, fy, my, jnp.float32(ell), P,
                          interpret=True)
    _, U = pairwise.step_moment_basis(x, mx)
    ref, scale, ref_nnz = reference.moment_matrix(
        x, y, fx, fy, mx, my, ell, P, U=np.asarray(U))
    assert Mom.shape == (200, 35)
    _nnz_close(nnz, ref_nnz)
    err = np.abs(np.asarray(Mom, np.float64) - ref)
    assert np.all(err <= 1e-4 * scale + 1e-12)


@pytest.mark.parametrize("which", ["both", "fixed", "moving"])
def test_kernel_masked_clouds(which):
    """Empty clouds contribute nothing: zero moments, zero pairs, zero flow
    and finite step coefficients."""
    x, fx, mx, y, fy, my = _clouds(6, 120, 110, 128)
    if which in ("both", "fixed"):
        mx = jnp.zeros_like(mx)
    if which in ("both", "moving"):
        my = jnp.zeros_like(my)
    pf = mk.pack_fixed(x, fx, mx)
    Mom, nnz = mk.moments(pf, y, fy, my, jnp.float32(0.1), P, interpret=True)
    assert int(nnz) == 0
    assert not np.any(np.asarray(Mom))
    out = mk.flow_and_step(pf, y, fy, my, jnp.float32(0.1), P,
                           interpret=True)
    for name, val in zip(NAMES, out):
        assert np.all(np.isfinite(np.asarray(val))), name
    assert not np.any(np.asarray(out[0])) and not np.any(np.asarray(out[1]))


def test_kernel_under_vmap():
    """Batched over moving clouds (the loop-closure verification and the
    multi-sequence tracker vmap the align loop): each lane equals its solo
    run."""
    x, fx, mx, y1, fy1, my1 = _clouds(7, 150, 140, 160)
    _, _, _, y2, fy2, my2 = _clouds(8, 150, 130, 160)
    pf = mk.pack_fixed(x, fx, mx)
    ell = jnp.float32(0.12)

    def one(y, fy, my):
        return mk.moments(pf, y, fy, my, ell, P, interpret=True)

    Mb, nb = jax.vmap(one)(jnp.stack([y1, y2]), jnp.stack([fy1, fy2]),
                           jnp.stack([my1, my2]))
    for k, (y, fy, my) in enumerate(((y1, fy1, my1), (y2, fy2, my2))):
        Ms, ns = one(y, fy, my)
        np.testing.assert_allclose(np.asarray(Mb[k]), np.asarray(Ms),
                                   rtol=1e-6, atol=1e-9)
        assert int(nb[k]) == int(ns)


def test_tiling_choice_and_padding():
    """Block choice by capacity, and the padded layout of pack_fixed."""
    assert mk.choose_tiling(3072) == mk.DEFAULT
    assert mk.choose_tiling(3072).splits == 8
    assert mk.choose_tiling(200).splits == 4
    assert mk.choose_tiling(16).splits == 1
    t = mk.choose_tiling(200)
    assert mk.padded_sizes(200, 200, t) == (256, 224)
    assert mk.padded_sizes(3072, 3072, mk.DEFAULT) == (3072, 3072)
    x, fx, mx, *_ = _clouds(9, 150, 10, 200)
    center, xf, m, u, tt = mk.pack_fixed(x, fx, mx)
    assert tt == t
    assert xf.shape == (8, 256) and m.shape == (256,)
    assert u.shape == (256, mk.U_WIDTH)
    np.testing.assert_array_equal(np.asarray(xf[:3, :200]),
                                  np.asarray(x).T)
    np.testing.assert_array_equal(np.asarray(xf[3:, :200]),
                                  np.asarray(fx).T)
    assert not np.any(np.asarray(m[200:])) and not np.any(np.asarray(u[200:]))
    assert not np.any(np.asarray(u[:, 35:]))


def test_padding_does_not_change_moments():
    """A cloud and the same cloud with extra masked slots give the same
    moments (padded slots contribute exactly zero; the centroid of the
    moment basis is summed over another length, hence the rounding-level
    tolerance)."""
    x, fx, mx, y, fy, my = _clouds(10, 150, 140, 200)

    def pad(a, n):
        return jnp.pad(a, [(0, n)] + [(0, 0)] * (a.ndim - 1))

    ell = jnp.float32(0.1)
    pf = mk.pack_fixed(x, fx, mx, mk.choose_tiling(256))
    M1, n1 = mk.moments(pf, y, fy, my, ell, P, interpret=True)
    pf2 = mk.pack_fixed(pad(x, 56), pad(fx, 56), pad(mx, 56))
    M2, n2 = mk.moments(pf2, pad(y, 56), pad(fy, 56), pad(my, 56), ell, P,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(M2[:200]), np.asarray(M1),
                               rtol=1e-5, atol=1e-8)
    assert not np.any(np.asarray(M2[200:]))
    assert int(n1) == int(n2)


def test_align_with_kernel_matches_xla(monkeypatch):
    """engine.align wired to the kernel (interpret mode forced here; the
    engine itself never selects it on CPU) registers like the XLA path."""
    orig = mk.pl.pallas_call
    monkeypatch.setattr(mk.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    x, fx, mx, _, _, _ = _clouds(11, 120, 10, 128)
    R = np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        [[0.0, -0.01, 0.004], [0.01, 0.0, -0.006], [-0.004, 0.006, 0.0]])))
    y = jnp.asarray(np.asarray(x) @ R.T + np.float32([0.01, -0.005, 0.008]))
    fixed = engine.PointCloud(x, fx, mx)
    moving = engine.PointCloud(y, fx, mx)
    eye, zero = jnp.eye(3), jnp.zeros(3)
    ell = jnp.float32(P.ell_init)
    a = engine.align(fixed, moving, eye, zero, ell, P, "pallas")
    b = engine.align(fixed, moving, eye, zero, ell, P, "xla")
    np.testing.assert_allclose(np.asarray(a.transform),
                               np.asarray(b.transform), atol=1e-4)
    assert 0 < int(a.iters) <= P.max_iter


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [200, 3072])
def test_compiled_kernel_on_gpu(gpu, cap):
    """The Triton-compiled kernel (no interpret mode) against the same
    kernel interpreted on the CPU and against the float64 reference."""
    x, fx, mx, y, fy, my = _clouds(12, cap - 7, cap - 20, cap)
    ell = jnp.float32(0.1)
    put = lambda a: jax.device_put(a, gpu)
    pf = mk.pack_fixed(*map(put, (x, fx, mx)))
    Mg, ng = jax.device_get(jax.jit(
        lambda y_, fy_, my_: mk.moments(pf, y_, fy_, my_, ell, P))(
            put(y), put(fy), put(my)))
    _, U = pairwise.step_moment_basis(x, mx)
    ref, scale, ref_nnz = reference.moment_matrix(
        x, y, fx, fy, mx, my, 0.1, P, U=np.asarray(U))
    _nnz_close(ng, ref_nnz)
    assert np.all(np.abs(Mg - ref) <= 1e-4 * scale + 1e-12)
