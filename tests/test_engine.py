"""CVO engine: synthetic registration recovers known motion; state machine
semantics (ell carry-over, warm starts, reset plumbing)."""

import numpy as np
import pytest
import jax.numpy as jnp

from cvo_slam_tpu.config import CvoParams
from cvo_slam_tpu.cvo import engine
from cvo_slam_tpu.ops import se3

P = CvoParams()
CAP = 512


def structured_cloud(seed, n=400):
    """Spatially smooth cloud with correlated colors (registration needs
    structure, not white noise)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-0.6, 0.6, (10, 10, 3))
    import scipy.ndimage as ndi
    pts = rng.uniform(0, 9, (n, 2))
    z = 1.5 + 0.3 * np.sin(pts[:, 0]) + 0.2 * np.cos(1.3 * pts[:, 1])
    x = (pts[:, 0] - 4.5) * 0.1 * z
    y = (pts[:, 1] - 4.5) * 0.1 * z
    pos = np.stack([x, y, z], 1).astype(np.float32)
    feat = np.zeros((n, 5), np.float32)
    feat[:, 0] = 128 + 100 * np.sin(3 * pts[:, 0])
    feat[:, 1] = 128 + 100 * np.cos(2 * pts[:, 1])
    feat[:, 2] = 128 + 80 * np.sin(pts[:, 0] + pts[:, 1])
    feat[:, 3] = 20 * np.cos(4 * pts[:, 0])
    feat[:, 4] = 20 * np.sin(4 * pts[:, 1])
    cap_pos = np.zeros((CAP, 3), np.float32)
    cap_feat = np.zeros((CAP, 5), np.float32)
    mask = np.zeros(CAP, bool)
    cap_pos[:n] = pos
    cap_feat[:n] = feat
    mask[:n] = True
    return engine.PointCloud(jnp.asarray(cap_pos), jnp.asarray(cap_feat),
                             jnp.asarray(mask))


@pytest.mark.parametrize("seed", [0, 1])
def test_align_recovers_motion(seed):
    fixed = structured_cloud(seed)
    xi = np.array([0.02, -0.015, 0.01, 0.03, -0.02, 0.025], np.float32)
    G = np.asarray(se3.exp_se3(jnp.asarray(xi)), np.float64)
    moved = engine.PointCloud(
        jnp.asarray((np.asarray(fixed.positions) @ G[:3, :3].T
                     + G[:3, 3]).astype(np.float32) * np.asarray(
            fixed.mask)[:, None]),
        fixed.features, fixed.mask)
    res = engine.align(fixed, moved, jnp.eye(3), jnp.zeros(3),
                       jnp.float32(P.ell_init), P)
    # align maps moved points onto fixed: transform ~= G^{-1}
    est = np.asarray(se3.log_se3(jnp.asarray(
        np.linalg.inv(np.asarray(res.transform, np.float64)), jnp.float32)))
    np.testing.assert_allclose(est, xi, atol=5e-3)
    assert int(res.iters) < P.max_iter


def test_ell_carry_over():
    """The annealed ell persists across alignments (cvo.cpp:383 quirk)."""
    c = engine.Cvo(P, backend="xla")
    fixed = structured_cloud(2)
    moved = structured_cloud(2)
    c.set_pcd(fixed, None)
    c.match_odometry(moved, None)
    assert c.iters >= 0
    if c.iters > 19:
        assert c.ell == pytest.approx(0.03)
    # a second alignment starts from the carried ell, not ell_init
    ell_before = c.ell
    c.update_fixed_pcd()
    c.match_odometry(structured_cloud(3), None)
    assert c.ell <= max(ell_before, 0.10) + 1e-9


def test_reset_initial_and_transform_roundtrip():
    c = engine.Cvo(P, backend="xla")
    odo = np.asarray(se3.exp_se3(jnp.asarray(
        np.array([0.01, 0.02, -0.01, 0.05, 0.0, 0.02], np.float32))),
        np.float64)
    c.reset_transform(np.eye(4))
    guess = c.reset_initial(odo)
    np.testing.assert_allclose(guess, odo, atol=1e-12)
    inv = np.linalg.inv(guess)
    np.testing.assert_allclose(c.R, inv[:3, :3], atol=1e-6)
    np.testing.assert_allclose(c.T, inv[:3, 3], atol=1e-6)


def test_default_backend_selection(monkeypatch):
    """The fused moment kernel is the GPU default and is never chosen on
    CPU (it has no CPU lowering); the env override offers only xla/pallas
    and refuses the kernel off the GPU."""
    from cvo_slam_tpu.cvo.engine import default_backend
    monkeypatch.delenv("CVO_SLAM_BACKEND", raising=False)
    assert default_backend() == "xla"   # tests force the cpu platform
    monkeypatch.setenv("CVO_SLAM_BACKEND", "xla")
    assert default_backend() == "xla"
    for bad in ("pallas", "pallas_mom", "pallas_iter", "megakernel"):
        monkeypatch.setenv("CVO_SLAM_BACKEND", bad)
        with pytest.raises(ValueError):
            default_backend()
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("CVO_SLAM_BACKEND", raising=False)
    assert default_backend() == "pallas"
    monkeypatch.setenv("CVO_SLAM_BACKEND", "xla")
    assert default_backend() == "xla"
