"""End-to-end pipeline tests on a synthetic TUM-format sequence.

Small frames (160x120) keep CPU cost down; the full 640x480 path is exercised
by bench.py and the verify drive."""

import os

import numpy as np
import pytest

from cvo_slam_tpu.config import CameraConfig, SlamConfig
from cvo_slam_tpu.data import synthetic, tum

from cvo_slam_tpu.config import FrontendParams

CAM = CameraConfig(fx=130.0, fy=130.0, cx=80.0, cy=60.0, depth_factor=5000.0,
                   width=160, height=120)
# small frames -> small fixed capacity keeps the dense pairwise ops cheap
SMALL_FRONTEND = FrontendParams(num_want=600, cloud_capacity=768)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("seq"))
    gt = synthetic.make_sequence(folder, CAM, n_frames=8)
    return folder, gt


def _run(folder, cfg, n):
    from cvo_slam_tpu.app.run_slam import build_tracker
    tracker = build_tracker(CAM, cfg)
    tracker.init()
    records = tum.load_association(os.path.join(folder, "associate.txt"))[:n]
    rows = []
    for i, rec in enumerate(records):
        img = tum.load_image(folder, rec)
        if i == len(records) - 1:
            tracker.force_keyframe()
        pose = tracker.update(img)
        rows.append((img.timestamp, pose))
    return tracker, rows


def test_tracking_only(seq):
    folder, gt = seq
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True,
                                              frontend=SMALL_FRONTEND)
    tracker, rows = _run(folder, cfg, 8)
    est = np.array([p for _, p in rows])
    err = np.linalg.norm(est[:, :3, 3] - gt[:8, :3, 3], axis=1)
    assert err.max() < 0.05, err


def test_full_pipeline_posegraph_backend(seq, tmp_path):
    """Pose-graph backend WITHOUT the sparse-feature layer (no ORB / LC):
    keyframe chaining + final BA alone must reproduce the trajectory and the
    loop-closure dump must stay empty. (The full-featured backend DOES close
    loops even on this short overlapping sequence — covered by
    test_loop_closure / test_place_recognition.)"""
    folder, gt = seq
    cfg = SlamConfig.default_shipped().replace(FinalOptimizationIterations=20,
                                              frontend=SMALL_FRONTEND)
    from cvo_slam_tpu.backend.keyframe_graph import KeyframeGraph
    from cvo_slam_tpu.tracking.keyframe_tracker import KeyframeTracker

    def _run_posegraph_only(folder, cfg, n):
        graph = KeyframeGraph(CAM, cfg)   # no loop detector, no windowed BA
        tracker = KeyframeTracker(CAM, cfg, graph=graph)
        tracker.init()
        records = tum.load_association(
            os.path.join(folder, "associate.txt"))[:n]
        rows = []
        for i, rec in enumerate(records):
            img = tum.load_image(folder, rec)
            if i == len(records) - 1:
                tracker.force_keyframe()
            rows.append((img.timestamp, tracker.update(img)))
        return tracker, rows

    tracker, rows = _run_posegraph_only(folder, cfg, 8)
    # backend received the maps and chained keyframes
    kfs = tracker.graph.keyframes()
    assert len(kfs) >= 2
    # SLAM trajectory written and roughly consistent with ground truth
    slam_path = str(tmp_path / "SLAM_trajectory.txt")
    lc_path = str(tmp_path / "loop_closure.txt")
    tracker.write_slam_trajectory_and_loop_closure(slam_path, lc_path)
    ts, poses = tum.read_trajectory(slam_path)
    assert len(ts) >= len(kfs)
    gt_ts = [f"{1000.0 + 0.05 * k:.6f}" for k in range(8)]
    rmse = tum.ate_rmse(gt_ts, gt[:8], ts, poses)
    assert rmse < 0.05, rmse
    # no loop closures without the feature layer
    assert open(lc_path).read().strip() == ""


def test_keyframe_policy_bounds_map_size(seq):
    folder, gt = seq
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True,
                                              Max_KF_interval=3,
                                              frontend=SMALL_FRONTEND)
    tracker, rows = _run(folder, cfg, 8)
    # with Max_KF_interval=3 the tracker must have cut at least one map
    assert tracker.lt.next_kf_id >= 3


def test_speculative_executor_matches_unpipelined(seq, monkeypatch):
    """A run with one-frame lookahead (stage_next -> SpeculativeExecutor
    dispatching frame i+1 before frame i's readback) must match the
    unpipelined run pose-for-pose: a VALID speculation is the same compiled
    program fed the same values, and an invalid one is discarded."""
    from cvo_slam_tpu.app.run_slam import build_tracker
    monkeypatch.setenv("CVO_SLAM_SPECULATE", "1")  # speculation is
    # accelerator-default-only; force it on for this CPU equality test
    folder, gt = seq
    cfg = SlamConfig.default_shipped().replace(OnlyTracking=True,
                                               frontend=SMALL_FRONTEND)
    records = tum.load_association(os.path.join(folder, "associate.txt"))[:8]
    images = [tum.load_image(folder, r) for r in records]

    def run(pipelined):
        tracker = build_tracker(CAM, cfg)
        tracker.init()
        poses = []
        for i, img in enumerate(images):
            if i == len(images) - 1:
                tracker.force_keyframe()
            nxt = images[i + 1] if pipelined and i + 1 < len(images) else None
            poses.append(tracker.update(img, next_frame=nxt))
        return np.array(poses), tracker

    plain, _ = run(False)
    piped, _ = run(True)
    np.testing.assert_array_equal(plain, piped)
    # engagement check: the lookahead must actually have been consumed at
    # least once (a never-valid speculation would make this test vacuous)
    tracker2 = build_tracker(CAM, cfg)
    tracker2.init()
    used = {"n": 0}
    ex = tracker2.lt.executor
    orig_valid = ex._speculation_valid

    def counting_valid(*a, **k):
        ok = orig_valid(*a, **k)
        used["n"] += int(ok)
        return ok

    ex._speculation_valid = counting_valid
    for i, img in enumerate(images[:6]):
        nxt = images[i + 1] if i + 1 < len(images) else None
        tracker2.update(img, next_frame=nxt)
    assert used["n"] >= 1, "speculation never engaged"


def test_run_slam_without_opencv(tmp_path, monkeypatch):
    """The main path (PNG IO, gray/HSV, ORB, loop closure, BA) runs with
    OpenCV blocked: `import cv2` raises inside this run."""
    import sys
    from cvo_slam_tpu.app.run_slam import run
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    folder = str(tmp_path)
    gt = synthetic.make_sequence(folder, CAM, n_frames=8)
    cfg = SlamConfig.default_shipped().replace(
        FinalOptimizationIterations=20, Max_KF_interval=3,
        frontend=SMALL_FRONTEND)
    stats = run(folder, "associate.txt", CAM, cfg)
    assert stats["frames"] == 8
    ts, poses = tum.read_trajectory(os.path.join(folder,
                                                 "SLAM_trajectory.txt"))
    gt_ts = [f"{1000.0 + 0.05 * k:.6f}" for k in range(8)]
    assert tum.ate_rmse(gt_ts, gt, ts, poses) < 0.05


def test_build_tracker_requires_feature_layer(monkeypatch):
    """A missing sparse-feature layer is an error, not a silent run without
    loop closure and BA."""
    import sys
    from cvo_slam_tpu.app.run_slam import build_tracker
    monkeypatch.setitem(sys.modules, "cvo_slam_tpu.features.orb", None)
    cfg = SlamConfig.default_shipped().replace(frontend=SMALL_FRONTEND)
    with pytest.raises(ImportError):
        build_tracker(CAM, cfg)


def test_background_warmup_surfaces_failure():
    """A failing warmup is logged and raised again when the run checks it."""
    from cvo_slam_tpu.app.run_slam import BackgroundWarmup
    ok = BackgroundWarmup(lambda: None)
    ok.check(timeout=30)

    def boom():
        raise ValueError("compile failed")

    bad = BackgroundWarmup(boom)
    with pytest.raises(RuntimeError) as info:
        bad.check(timeout=30)
    assert isinstance(info.value.__cause__, ValueError)


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero without a GPU and prints no result."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
