"""ATE/RPE evaluation harness: alignment invariance, exact-zero cases,
known-perturbation recovery."""

import numpy as np
import pytest

from cvo_slam_tpu.eval import ate as ev


def _quat_from_R(R):
    qw = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    qx = (R[2, 1] - R[1, 2]) / (4 * qw)
    qy = (R[0, 2] - R[2, 0]) / (4 * qw)
    qz = (R[1, 0] - R[0, 1]) / (4 * qw)
    return np.array([qx, qy, qz, qw])


def _traj(n=50, seed=0):
    rng = np.random.default_rng(seed)
    poses = {}
    T = np.eye(4)
    for i in range(n):
        w = rng.normal(0, 0.02, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        dR = np.eye(3) + np.sinc(th / np.pi) * K \
            + ((1 - np.cos(th)) / max(th * th, 1e-12)) * (K @ K)
        d = np.eye(4)
        d[:3, :3] = dR
        d[:3, 3] = rng.normal(0, 0.05, 3)
        T = T @ d
        poses[float(i)] = T.copy()
    return poses


def _write(path, poses):
    with open(path, "w") as f:
        for ts, T in sorted(poses.items()):
            q = _quat_from_R(T[:3, :3])
            t = T[:3, 3]
            f.write(f"{ts} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")


def test_ate_zero_on_rigidly_transformed_copy(tmp_path):
    gt = _traj()
    # estimate = gt in a different world frame: ATE must align it out
    W = np.eye(4)
    W[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    W[:3, 3] = [5.0, -2.0, 1.0]
    est = {ts: W @ T for ts, T in gt.items()}
    out = ev.ate_rmse(gt, est)
    assert out["pairs"] == len(gt)
    assert out["ate_rmse"] < 1e-9
    r = ev.rpe(gt, est)
    assert r["rpe_trans_rmse"] < 1e-9
    assert r["rpe_rot_rmse_deg"] < 1e-6


def test_ate_known_perturbation():
    gt = _traj()
    rng = np.random.default_rng(1)
    est = {}
    sigma = 0.03
    for ts, T in gt.items():
        E = T.copy()
        E[:3, 3] += rng.normal(0, sigma, 3)
        est[ts] = E
    out = ev.ate_rmse(gt, est)
    expected = sigma * np.sqrt(3)
    assert 0.5 * expected < out["ate_rmse"] < 1.5 * expected


def test_association_tolerance():
    gt = _traj()
    est = {ts + 0.009: T for ts, T in gt.items()}   # within 0.02 tolerance
    assert ev.ate_rmse(gt, est)["pairs"] == len(gt)
    est2 = {ts + 0.5: T for ts, T in gt.items()}    # outside tolerance
    with pytest.raises(ValueError):
        ev.ate_rmse(gt, est2)


def test_cli_round_trip(tmp_path, capsys):
    gt = _traj(20)
    _write(tmp_path / "gt.txt", gt)
    _write(tmp_path / "est.txt", gt)
    ev.main([str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")])
    import json
    out = json.loads(capsys.readouterr().out)
    assert out["ate_rmse"] < 1e-6
    assert out["intervals"] == 19


@pytest.mark.slow
def test_quality_regression_thresholds(tmp_path):
    """CI-style end-to-end quality gate on a challenge-mode sequence: 60
    frames of fast rotation + exposure ramp through the FULL pipeline must
    stay under an ATE threshold that tracks the recorded RESULTS.md
    numbers."""
    from cvo_slam_tpu.config import CameraConfig, FrontendParams, SlamConfig
    from cvo_slam_tpu.data import synthetic, tum
    from cvo_slam_tpu.app.run_slam import run
    import os

    cam = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                       depth_factor=5000.0, width=160, height=120)
    cfg = SlamConfig.default_shipped().replace(
        frontend=FrontendParams(num_want=600, cloud_capacity=768),
        FinalOptimizationIterations=50)
    from cvo_slam_tpu.eval.suite import oscillating_trajectory
    folder = str(tmp_path)
    synthetic.make_sequence(
        folder, cam, n_frames=60,
        trajectory=oscillating_trajectory(
            60, np.array([0.13, 0.10, -0.06, 0.10, -0.06, 0.08])),
        exposure_ramp=0.6)
    run(folder, "associate.txt", cam, cfg)

    gt_ts, gt = tum.read_trajectory(os.path.join(folder, "groundtruth.txt"))
    # tightened in round 3 (recorded ATEs are 0.002-0.006 since the
    # moment-form flow conditioning; 0.01 leaves ~2x headroom)
    for fname, thresh in (("Tracking_trajectory.txt", 0.01),
                          ("SLAM_trajectory.txt", 0.01)):
        ts, poses = tum.read_trajectory(os.path.join(folder, fname))
        rmse = tum.ate_rmse(gt_ts, gt, ts, poses)
        assert rmse < thresh, f"{fname}: ATE {rmse} >= {thresh}"


@pytest.mark.slow
def test_quality_regression_low_texture(tmp_path):
    """End-to-end gate on the weakest challenge mode (low texture was the
    one ungated mode, tracking ATE ~10x the others): 60
    frames at 25% contrast through the full pipeline. Thresholds track the
    recorded RESULTS.md low_texture numbers with ~2x headroom."""
    from cvo_slam_tpu.config import CameraConfig, FrontendParams, SlamConfig
    from cvo_slam_tpu.data import synthetic, tum
    from cvo_slam_tpu.app.run_slam import run
    import os

    cam = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                       depth_factor=5000.0, width=160, height=120)
    cfg = SlamConfig.default_shipped().replace(
        frontend=FrontendParams(num_want=600, cloud_capacity=768),
        FinalOptimizationIterations=50)
    from cvo_slam_tpu.eval.suite import oscillating_trajectory
    folder = str(tmp_path)
    synthetic.make_sequence(
        folder, cam, n_frames=60,
        trajectory=oscillating_trajectory(
            60, np.array([0.06, -0.05, 0.04, 0.08, -0.05, 0.06])),
        texture_strength=0.25)
    run(folder, "associate.txt", cam, cfg)

    gt_ts, gt = tum.read_trajectory(os.path.join(folder, "groundtruth.txt"))
    for fname, thresh in (("Tracking_trajectory.txt", 0.06),
                          ("SLAM_trajectory.txt", 0.06)):
        ts, poses = tum.read_trajectory(os.path.join(folder, fname))
        rmse = tum.ate_rmse(gt_ts, gt, ts, poses)
        assert rmse < thresh, f"{fname}: ATE {rmse} >= {thresh}"


@pytest.mark.slow
def test_quality_regression_noisy_loop(tmp_path):
    """End-to-end gate on the sensor-realism mode: a
    loop circuit over a multi-surface scene with the Kinect noise model
    (axial sigma ~ z^2, disparity quantization, edge/speckle dropout, RGB
    read noise) through the full pipeline. Thresholds track the recorded
    RESULTS noisy_loop numbers with >=2x headroom (full-res recorded:
    tracking 0.0022 / SLAM 0.0014 at 640x480; at this reduced test
    resolution the selector sees ~1/16 the pixels, so the bound is
    proportionally looser)."""
    from cvo_slam_tpu.config import CameraConfig, FrontendParams, SlamConfig
    from cvo_slam_tpu.data import synthetic, tum
    from cvo_slam_tpu.app.run_slam import run
    from cvo_slam_tpu.eval.suite import loop_trajectory
    import os

    cam = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                       depth_factor=5000.0, width=160, height=120)
    cfg = SlamConfig.default_shipped().replace(
        frontend=FrontendParams(num_want=600, cloud_capacity=768),
        FinalOptimizationIterations=50)
    folder = str(tmp_path)
    synthetic.make_sequence(folder, cam, n_frames=60,
                            trajectory=loop_trajectory(60),
                            multi_surface=True, noise=True)
    run(folder, "associate.txt", cam, cfg)

    gt_ts, gt = tum.read_trajectory(os.path.join(folder, "groundtruth.txt"))
    for fname, thresh in (("Tracking_trajectory.txt", 0.03),
                          ("SLAM_trajectory.txt", 0.03)):
        ts, poses = tum.read_trajectory(os.path.join(folder, fname))
        rmse = tum.ate_rmse(gt_ts, gt, ts, poses)
        assert rmse < thresh, f"{fname}: ATE {rmse} >= {thresh}"
