"""Benchmark: CVO-SLAM tracking throughput on one GPU.

Measures the per-frame device work of the tracking pipeline — two CVO
registrations (odometry + keyframe) each followed by the inner-product /
Hessian pass, one fused `engine.frame_step` dispatch per frame — on real
point clouds produced by the frontend from a synthetic TUM-format scene
(capacity 3072, ~3000 valid points: eval.workload).

Two schedules:
  * tracker-parity (the headline): warm-started frames on an oscillating
    trajectory with the keyframe re-seated every 6 frames — the schedule
    run_slam's tracker issues;
  * identity-start: every alignment starts at the identity (the workload
    the C++ reference replica of REF_BASELINE.json runs).

Frames are dispatched two deep with asynchronous host copies, as the
tracker's speculative executor does; a frame's time is the interval between
completed fetches. Reports the median and the spread (min, p90, max).

Runs on a GPU only: it exits non-zero on any other platform. Prints the
card's name and power limit on stderr and ONE JSON line on stdout.

Usage:  python bench.py
"""

import collections
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _spread(times_s):
    ms = np.asarray(times_s) * 1e3
    return dict(median=float(np.median(ms)), min=float(ms.min()),
                p90=float(np.percentile(ms, 90)), max=float(ms.max()),
                n=int(ms.size))


def _pipelined(dispatch, n_frames, depth=2):
    """Dispatch frames `depth` ahead; returns (per-frame seconds, outputs)."""
    import jax
    from cvo_slam_tpu.cvo import engine
    pending = collections.deque()
    times, outs = [], []
    t_prev = time.perf_counter()
    for i in range(n_frames + depth):
        if i < n_frames:
            pending.append(engine.start_host_transfer(dispatch(i)))
        if len(pending) > depth or (i >= n_frames and pending):
            outs.append(jax.device_get(pending.popleft()))
            t_now = time.perf_counter()
            times.append(t_now - t_prev)
            t_prev = t_now
    return times, outs


def measure():
    from cvo_slam_tpu.utils.gpu import (device_summary, name_and_power_limit,
                                        require_gpu)
    require_gpu()
    from cvo_slam_tpu.utils.compcache import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp
    from cvo_slam_tpu.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu.cvo import engine
    from cvo_slam_tpu.eval.workload import bench_host_clouds, \
        parity_host_clouds

    card = name_and_power_limit()
    log(f"card: {card}")
    cam = CAMERA_PRESETS["TUM1"]
    cfg = SlamConfig.default_shipped()
    p = cfg.cvo
    backend = engine.default_backend()
    eye3, zero3, eye4 = jnp.eye(3), jnp.zeros(3), jnp.eye(4)
    ell = jnp.float32(p.ell_init)

    # identity-start schedule
    clouds = [engine.PointCloud.from_host(pc)
              for pc in bench_host_clouds(cam, cfg)]

    def ident(i):
        a, b, c = clouds[i % 2], clouds[1 + i % 2], clouds[2 + i % 2]
        return engine.frame_step(b, a, c, eye3, zero3, ell, eye4, ell, p,
                                 backend)

    t0 = time.perf_counter()
    _pipelined(ident, 1)
    log(f"compile + first frame: {time.perf_counter() - t0:.1f} s")
    times_i, outs_i = _pipelined(ident, 100)
    iters_i = [int(o[0].iters) + int(o[2].iters) for o in outs_i]

    # tracker-parity schedule: odometry warm-started from the previous
    # frame's device result, keyframe transform chained, keyframe re-seated
    # every 6 frames (an oscillating trajectory: on a constant-velocity path
    # the warm start equals the solution and align converges at once)
    pclouds = [engine.PointCloud.from_host(pc)
               for pc in parity_host_clouds(cam, cfg)]
    state = dict(R=eye3, T=zero3, ell=ell, ell_kf=ell, T1=eye4, kfT=eye4,
                 kf=0)

    def parity(i):
        if i > 0 and i % 6 == 0:
            state["kf"], state["kfT"] = i, state["T1"]
        out = engine.frame_step(
            pclouds[i], pclouds[state["kf"]], pclouds[i + 1], state["R"],
            state["T"], state["ell"], state["kfT"], state["ell_kf"], p,
            backend)
        res1, _, res2, _, _ = out
        state["R"], state["T"] = res1.R, res1.T
        if not p.ell_reset:
            state["ell"], state["ell_kf"] = res1.ell, res2.ell
        state["T1"], state["kfT"] = res1.transform, res2.transform
        return out

    _pipelined(parity, 2)          # compile the warm-started shapes
    state.update(R=eye3, T=zero3, ell=ell, ell_kf=ell, T1=eye4, kfT=eye4,
                 kf=0)
    times_p, outs_p = _pipelined(parity, len(pclouds) - 1)
    iters_p = [int(o[0].iters) + int(o[2].iters) for o in outs_p]

    sp_p, sp_i = _spread(times_p), _spread(times_i)
    out = {
        "metric": "tracking_frames_per_s",
        "value": 1e3 / sp_p["median"],
        "unit": "frames/s",
        "schedule": "tracker-parity",
        "device": device_summary(),
        "card": card,
        "backend": backend,
        "ms_per_frame": sp_p,
        "align_iters_per_frame": float(np.mean(iters_p)),
        "identity_start": dict(fps=1e3 / sp_i["median"], ms_per_frame=sp_i,
                               align_iters_per_frame=float(np.mean(iters_i))),
    }
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "REF_BASELINE.json")
    if os.path.exists(ref_path):
        with open(ref_path) as f:
            ref = json.load(f)
        out["identity_start"]["vs_reference_replica"] = \
            out["identity_start"]["fps"] / ref["fps"]
        out["reference_replica"] = dict(
            fps=ref["fps"], threads=ref.get("threads"),
            source="REF_BASELINE.json (tools/measure_reference_baseline.py,"
                   " CPU)")
    log(f"tracker-parity {out['value']:.2f} fps "
        f"(median {sp_p['median']:.2f} ms/frame); identity-start "
        f"{out['identity_start']['fps']:.2f} fps on {card}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    measure()
