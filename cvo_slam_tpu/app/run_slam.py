"""CLI entry point: run CVO-SLAM on a TUM-format sequence.

Re-expression of reference run_SLAM (/root/reference/src/run_SLAM.cpp): loads
the association file, streams frames through the KeyframeTracker, writes
Tracking_trajectory.txt per frame (run_SLAM.cpp:83-86) and, unless
OnlyTracking, SLAM_trajectory.txt + loop_closure.txt at the end (:91-98).
Per-frame metrics go to metrics.jsonl (structured replacement for the
reference's stdout narration + hardcoded /home/xi side files).

Usage:
  python -m cvo_slam_tpu.app.run_slam --folder <seq_dir> \
      [--association associate.txt] [--camera TUM1] [--config config.txt] \
      [--only-tracking] [--max-frames N]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time

from ..config import CAMERA_PRESETS, SlamConfig, parse_config_txt
from ..data import tum
from ..tracking.keyframe_tracker import KeyframeTracker

log = logging.getLogger(__name__)


def _make_mesh(mesh_devices: int):
    """Build a 1-axis jax.sharding.Mesh over the first `mesh_devices`
    devices (SURVEY 5.8 mesh-mode). Errors out clearly when the runtime has
    fewer devices — on a single-chip host run with JAX_PLATFORMS=cpu and
    --mesh N (the CLI raises jax_num_cpu_devices accordingly)."""
    import jax
    import numpy as np
    devs = jax.devices()
    if len(devs) < mesh_devices:
        raise RuntimeError(
            f"--mesh {mesh_devices} needs {mesh_devices} devices but the "
            f"runtime has {len(devs)} ({devs[0].platform}); run on a "
            f"multi-GPU host, or force a virtual CPU mesh with --platform "
            f"cpu")
    from jax.sharding import Mesh
    return Mesh(np.array(devs[:mesh_devices]), ("dp",))


class BackgroundWarmup:
    """Runs `fn` on a daemon thread. A failure is logged when it happens and
    raised again by `check()`, which the run calls when it ends."""

    def __init__(self, fn):
        self.error = None
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        name="jit-warmup", daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — re-raised by check()
            log.exception("background warmup failed")
            self.error = exc

    def check(self, timeout: float = 600.0):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("background warmup did not finish")
        if self.error is not None:
            raise RuntimeError("background warmup failed") from self.error


def build_tracker(cam, cfg, verbose=False, vocabulary_path="",
                  mesh_devices: int = 0):
    if cfg.OnlyTracking:
        return KeyframeTracker(cam, cfg, graph=None, verbose=verbose)
    from ..backend.keyframe_graph import KeyframeGraph
    mesh = _make_mesh(mesh_devices) if mesh_devices else None
    from ..features.orb import keyframe_feature_hook
    from ..backend.loop_closure import make_loop_detector
    from ..backend.ba import make_windowed_ba
    feature_hook = keyframe_feature_hook(cam, cfg, vocabulary_path)
    loop_detector = make_loop_detector(
        cam, cfg, vocabulary=getattr(feature_hook, "voc", None))
    windowed_ba = make_windowed_ba(cam, cfg, mesh=mesh)
    graph = KeyframeGraph(cam, cfg, loop_detector=loop_detector,
                          windowed_ba=windowed_ba,
                          log=print if verbose else None, mesh=mesh)
    # pre-compile the keyframe-event executables (LC verification buckets,
    # windowed-BA size classes) on a background thread: the first keyframe
    # events then find warm executables instead of paying the compile
    # inline. The jit cache is process-wide and thread-safe; if an event
    # fires before warmup finishes it simply blocks on the same compile it
    # would have started itself.
    def _warm():
        if loop_detector is not None:
            loop_detector.warmup()
        if windowed_ba is not None and mesh is None:
            windowed_ba.warmup()   # mesh mode uses the sharded solver
        if mesh is None:
            graph.warmup()         # final BA + frame-list bridging

    # warm only where it pays: on an accelerator the compiles run on host
    # threads while the device tracks; on CPU they would take cores from
    # tracking. CVO_SLAM_WARMUP=0/1 overrides.
    import os
    env = os.environ.get("CVO_SLAM_WARMUP", "")
    import jax
    warmup = BackgroundWarmup(_warm) if env == "1" or (
        env != "0" and jax.default_backend() != "cpu") else None
    if cfg.UseMultiThreading:
        # working replacement for the reference's broken TBB pipeline
        # (keyframe_graph.cpp:2091-2095): backend consumes completed local
        # maps on a worker thread; writers flush the queue first
        from ..parallel.async_backend import AsyncKeyframeGraph
        graph = AsyncKeyframeGraph(graph)
    tracker = KeyframeTracker(cam, cfg, graph=graph,
                              keyframe_feature_hook=feature_hook,
                              verbose=verbose)
    tracker.warmup = warmup
    return tracker


def run(folder: str, association: str, cam_name, cfg: SlamConfig,
        max_frames: int = 0, verbose: bool = False, profile_dir: str = "",
        vocabulary_path: str = "", mesh_devices: int = 0):
    """cam_name: a preset key (e.g. "TUM1") or a CameraConfig instance."""
    from ..config import CameraConfig
    from ..utils.compcache import enable_persistent_cache
    enable_persistent_cache()
    cam = (cam_name if isinstance(cam_name, CameraConfig)
           else CAMERA_PRESETS[cam_name])
    records = tum.load_association(os.path.join(folder, association))
    if max_frames:
        records = records[:max_frames]

    tracker = build_tracker(cam, cfg, verbose, vocabulary_path, mesh_devices)
    tracker.init()

    if profile_dir:
        # JAX profiler traces (SURVEY 5.1): view with xprof/tensorboard
        import jax
        jax.profiler.start_trace(profile_dir)

    traj_path = os.path.join(folder, "Tracking_trajectory.txt")
    metrics_path = os.path.join(folder, "metrics.jsonl")
    t_start = time.perf_counter()
    from ..data.prefetch import FramePrefetcher
    frames = FramePrefetcher(folder, records, cam, cfg.frontend)
    update_total_s = 0.0
    with open(traj_path, "w") as traj, open(metrics_path, "w") as mf:
        it = iter(frames)
        image = next(it, None)
        i = -1
        while image is not None:
            i += 1
            # one-frame lookahead: staging the next frame lets the tracker
            # dispatch its device work speculatively before this frame's
            # blocking readback (SpeculativeExecutor)
            nxt = next(it, None)
            if i == len(records) - 1:
                tracker.force_keyframe()
            t0 = time.perf_counter()
            pose = tracker.update(image, next_frame=nxt)
            dt = time.perf_counter() - t0
            update_total_s += dt
            traj.write(tum.pose_to_tum_line(image.timestamp, pose) + "\n")
            lc_num = 0 if tracker.graph is None else tracker.graph.lc_num
            mf.write(json.dumps({
                "frame": i, "timestamp": image.timestamp, "t_frame_s": dt,
                "lc_num": lc_num,
                **{k: (float(v) if isinstance(v, float) else int(v))
                   for k, v in tracker.lt.metrics.items()}}) + "\n")
            if verbose:
                print(f"frame {i + 1}/{len(records)} {dt * 1e3:.1f} ms")
            image = nxt
    wall = time.perf_counter() - t_start
    if profile_dir:
        import jax
        jax.profiler.stop_trace()

    warmup = getattr(tracker, "warmup", None)
    if warmup is not None:
        warmup.check()
    if not cfg.OnlyTracking:
        tracker.write_slam_trajectory_and_loop_closure(
            os.path.join(folder, "SLAM_trajectory.txt"),
            os.path.join(folder, "loop_closure.txt"))
    stats = dict(frames=len(records), wall_s=wall,
                 fps=len(records) / wall if wall > 0 else 0.0,
                 # wall accounting: update_total_s = every tracker.update
                 # call (tracked frames AND inline keyframe events); the
                 # difference to wall_s is frame IO/prefetch stalls +
                 # startup + writers
                 update_total_s=round(update_total_s, 2))
    # keyframe-path cost breakdown (ms per keyframe, mean/max per stage):
    # the per-frame tracking bench does not cover insert/LC/BA work
    graph = tracker.graph
    stage_rows = getattr(graph, "stage_ms", None) or \
        getattr(getattr(graph, "inner", None), "stage_ms", None)
    if stage_rows:
        keys = sorted({k for row in stage_rows for k in row})
        # mean over the events where the stage actually ran (a stage like
        # loop_detect fires on a subset of keyframes; dividing by all rows
        # understated the per-event cost ~4x in the r5 records)
        stats["keyframe_path_ms"] = {
            k: dict(mean=round(sum(r.get(k, 0.0) for r in stage_rows)
                               / max(sum(1 for r in stage_rows if k in r), 1),
                    2),
                    max=round(max(r.get(k, 0.0) for r in stage_rows), 2),
                    n=sum(1 for r in stage_rows if k in r),
                    total_s=round(sum(r.get(k, 0.0)
                                      for r in stage_rows) / 1e3, 2))
            for k in keys}
        stats["keyframes"] = len(stage_rows)
        stats["keyframe_path_total_s"] = round(
            sum(v for r in stage_rows for v in r.values()) / 1e3, 2)
    lc_rows = getattr(graph, "lc_stage_ms", None) or \
        getattr(getattr(graph, "inner", None), "lc_stage_ms", None)
    if lc_rows:
        keys = sorted({k for row in lc_rows for k in row})
        stats["lc_stage_ms"] = {
            k: dict(mean=round(sum(r.get(k, 0.0) for r in lc_rows)
                               / len(lc_rows), 2),
                    max=round(max(r.get(k, 0.0) for r in lc_rows), 2))
            for k in keys}
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--folder", required=True)
    ap.add_argument("--association", default="associate.txt")
    ap.add_argument("--camera", default="TUM1", choices=sorted(CAMERA_PRESETS))
    ap.add_argument("--config", default=None,
                    help="reference-style config.txt (default: shipped values)")
    ap.add_argument("--only-tracking", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--profile-dir", default="",
                    help="write a JAX profiler trace here (xprof format)")
    ap.add_argument("--vocabulary", default="",
                    help="DBoW2 ORBvoc.txt path (default: online-grown "
                         "vocabulary, see features.bow.GrowingVocabulary)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the global backend (windowed + final BA) on "
                         "an N-device jax.sharding.Mesh with the "
                         "distributed solvers (SURVEY 5.8)")
    ap.add_argument("--platform", default="",
                    help="force a JAX platform (e.g. cpu); with --mesh N "
                         "this also raises the virtual CPU device count "
                         "to N")
    args = ap.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
        if args.platform == "cpu" and args.mesh > 1:
            jax.config.update("jax_num_cpu_devices", args.mesh)

    cfg = (parse_config_txt(args.config) if args.config
           else SlamConfig.default_shipped())
    if args.only_tracking:
        cfg = cfg.replace(OnlyTracking=True)
    stats = run(args.folder, args.association, args.camera, cfg,
                args.max_frames, args.verbose, args.profile_dir,
                args.vocabulary, mesh_devices=args.mesh)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
