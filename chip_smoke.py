"""Smoke test of the whole system on one GPU (or, with --four-cards, of the
multi-device path on four).

Phases (one process; any failure exits non-zero before the result line):
  1. device: platform, device kind and count as JAX reports them, and the
     card's name and power limit from nvidia-smi. Without a GPU the script
     exits non-zero at once; it never falls back to the CPU.
  2. parity and timing on the benchmark clouds (3072 slots):
       * the align loop's moment pass on the card against the float64
         per-pair reference (ops.reference) across the ell anneal schedule;
       * one engine.frame_step on the GPU against the same call on the CPU;
       * the moment pass of the fused kernel against the XLA path, per
         iteration and in warm frame_step frames/s.
  3. the main path: the loop_120 sequence at TUM1 640x480 through
     eval.suite.run_sequence -> app.run_slam.run (tracking, ORB/BoW loop
     closure, windowed BA, final BA), timed cold (compiles included).
  4. --four-cards only, instead of 2 and 3: the mesh path of
     `run_slam --mesh 4` (windowed BA with landmarks and the final BA on the
     sharded solvers) against the single-device run of the same sequence,
     and parallel.batch.make_sharded_align on 4 cards against solo aligns.

The last line of stdout is {"ok": true, "device": {...}}.

Usage:  python chip_smoke.py [--four-cards]
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

# Tolerances of the parity checks, each against the float64 reference.
# A float32 sum of many terms of both signs is accurate relative to the sum
# of |term| (its scale), not to its own value, so every bound is a fraction
# of that scale (ops.reference).
TOL_MOMENTS = 1e-4    # the kernel's own output, Mom[j, a] = sum_i A_ij U_ia
TOL_FLOW = 1e-4       # omega, v and step coefficients B, C
# D and E come from the shared moment epilogue, which expands the quartic
# in centred monomials up to degree 4 and amplifies float32 rounding by
# (cloud extent / gate radius)^degree; they are checked at ell_init only
# and reported at the finer ells.
TOL_DE = 1e-3
TOL_NNZ = 1e-3        # gated pair count: gates at a threshold may flip
# frame_step transforms, GPU against CPU, after FIXED_ITERS iterations per
# alignment. Each iteration's step size solves a cubic whose top
# coefficients D and E come from the epilogue above (TOL_DE), so rounding-
# level differences of one iteration grow along the flow integration: the
# kernel and the XLA path on one CPU differ by up to 6.5e-4 after 25
# iterations. 1e-3 (1 mm, 1 mrad) stays far below the 0.01 m ATE gate.
TOL_TRANSFORM = 1e-3
FIXED_ITERS = 60
# mesh against single-device SLAM trajectory, in metres: the sharded BA
# solvers sum in another order, and their LM accept/reject steps,
# convergence exit and outlier-pruning passes are discrete, so the two runs
# can stop at different iterates (positions 2.0e-3 apart, ATE 2e-5 apart,
# measured on 4 virtual CPU devices). Positions within 5 mm, and the mesh
# run's ATE within 1 mm of the single-device run's.
TOL_MESH_POSITION = 5e-3
TOL_MESH_ATE = 1e-3


def log(*a):
    print(*a, flush=True)


class Failed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failed(what)


def phase_device():
    from cvo_slam_tpu.utils.gpu import (device_summary, name_and_power_limit,
                                        require_gpu)
    require_gpu()
    dev = device_summary()
    card = name_and_power_limit()
    log(f"[device] platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    log(card)
    return dev, card


def _bench_clouds():
    from cvo_slam_tpu.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu.eval.workload import bench_host_clouds
    cfg = SlamConfig.default_shipped()
    return cfg, bench_host_clouds(CAMERA_PRESETS["TUM1"], cfg)


@contextlib.contextmanager
def _interpreted_kernel():
    """Run the moment kernel through the Pallas interpreter while active:
    the CPU side of the GPU-vs-CPU frame_step comparison."""
    from cvo_slam_tpu.cvo import moment_kernel as mk
    compiled = mk.pl.pallas_call
    mk.pl.pallas_call = lambda *a, **k: compiled(*a, **{**k,
                                                        "interpret": True})
    try:
        yield
    finally:
        mk.pl.pallas_call = compiled


def phase_parity(card):
    import jax
    import jax.numpy as jnp
    from cvo_slam_tpu.cvo import engine, moment_kernel as mk
    from cvo_slam_tpu.ops import pairwise, reference

    cfg, host = _bench_clouds()
    p = cfg.cvo
    clouds = [engine.PointCloud.from_host(pc) for pc in host]
    x, fx, mx = clouds[0]
    y, fy, my = clouds[1]
    hx = [np.asarray(a) for a in (x, fx, mx, y, fy, my)]
    backend = engine.default_backend()
    log(f"[parity] backend={backend} capacity={x.shape[0]} "
        f"valid={[int(pc.mask.sum()) for pc in host]}")
    check(backend == "pallas", f"GPU default backend is {backend}")

    pf = mk.pack_fixed(x, fx, mx)
    center, U = pairwise.step_moment_basis(x, mx)
    kernel_moments = jax.jit(lambda yy, e: mk.moments(pf, yy, fy, my, e, p))
    kernel_step = jax.jit(lambda yy, e: mk.flow_and_step(pf, yy, fy, my, e,
                                                         p))
    ells = (p.ell_init,) + tuple(p.ell_anneal_values)
    for ell in ells:
        e = jnp.float32(ell)
        Mom, nnz = jax.device_get(kernel_moments(y, e))
        gold_mom, scale, gold_nnz = reference.moment_matrix(
            hx[0], hx[3], hx[1], hx[4], hx[2], hx[5], ell, p,
            U=np.asarray(U))
        err_mom = float(np.max(np.abs(Mom - gold_mom)
                               / np.maximum(scale, 1e-30)))
        out = dict(zip(("omega", "v", "nnz", "B", "C", "D", "E"),
                       jax.device_get(kernel_step(y, e))))
        gold = reference.flow_and_step(hx[0], hx[3], hx[1], hx[4], hx[2],
                                       hx[5], ell, p)
        errs = {}
        for name in ("omega", "v", "B", "C", "D", "E"):
            val, sc = gold[name]
            errs[name] = float(np.max(np.abs(np.asarray(out[name], np.float64)
                                             - val) / np.maximum(sc, 1e-30)))
        d_nnz = abs(int(nnz) - gold_nnz) / max(gold_nnz, 1)
        log(f"[parity] ell={ell}: nnz {int(nnz)} (reference {gold_nnz}); "
            f"error/scale Mom {err_mom:.2e} "
            + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        check(err_mom <= TOL_MOMENTS, f"moments at ell={ell}: {err_mom}")
        check(d_nnz <= TOL_NNZ, f"nnz at ell={ell}: {int(nnz)} vs {gold_nnz}")
        for name in ("omega", "v", "B", "C"):
            check(errs[name] <= TOL_FLOW, f"{name} at ell={ell}: "
                  f"{errs[name]}")
        if ell == p.ell_init:
            for name in ("D", "E"):
                check(errs[name] <= TOL_DE, f"{name} at ell={ell}: "
                      f"{errs[name]}")

    # one frame_step on the GPU against the same call on the CPU, for each
    # backend: 'xla' compiled on both; the kernel compiled for the GPU and
    # interpreted on the CPU (the CPU has no lowering for it). The stopping
    # thresholds are zeroed so both sides run exactly FIXED_ITERS iterations
    # per alignment: with the thresholds on, a rounding-level difference
    # moves the stop by a few iterations and the transforms then differ by
    # the solver's own tolerance (3e-4 measured for 'xla' on an H100), which
    # would hide the arithmetic this check compares.
    eye3, zero3, eye4 = jnp.eye(3), jnp.zeros(3), jnp.eye(4)
    ell0 = jnp.float32(p.ell_init)
    p_fixed = dataclasses.replace(p, eps=0.0, eps_2=0.0,
                                  max_iter=FIXED_ITERS)

    def frame(cs, bk, params=p):
        return engine.frame_step(cs[0], cs[1], cs[2], eye3, zero3, ell0, eye4,
                                 ell0, params, bk)

    cpu = jax.devices("cpu")[0]
    ccl = [engine.PointCloud(*(jax.device_put(np.asarray(a), cpu)
                               for a in c)) for c in clouds]
    for bk in ("xla", backend):
        g = jax.device_get(frame(clouds, bk, p_fixed))
        # a fresh trace for the CPU call, so that it neither reuses the
        # GPU's traced kernel nor leaves its interpreted one behind
        jax.clear_caches()
        with jax.default_device(cpu), _interpreted_kernel():
            c = jax.device_get(frame(ccl, bk, p_fixed))
        jax.clear_caches()
        for k, name in ((0, "odometry"), (2, "keyframe")):
            d = float(np.max(np.abs(g[k].transform - c[k].transform)))
            log(f"[parity] frame_step[{bk}] {name} transform GPU vs CPU: max "
                f"|diff| {d:.2e} (iters GPU {int(g[k].iters)}, CPU "
                f"{int(c[k].iters)})")
            check(d <= TOL_TRANSFORM, f"frame_step[{bk}] {name} transform "
                  f"{d}")

    # timing: the moment pass alone, 50 chained iterations in one program
    K = 50

    def chained(step):
        def run(y0, e):
            def body(_, carry):
                yy, acc = carry
                B = step(yy, e)[3]
                return yy + 1e-12 * B, acc + B
            return jax.lax.fori_loop(0, K, body, (y0, jnp.float32(0)))
        return jax.jit(run)

    ckg = pairwise.color_kernel_gated(fx, fy, mx, my, p)
    steps = {
        "xla": lambda yy, e: pairwise.flow_and_step_moments(
            x, yy, ckg, U, center, e, p),
        "pallas": lambda yy, e: mk.flow_and_step(pf, yy, fy, my, e, p),
    }
    timing = {}
    for order in ("xla", "pallas", "pallas", "xla"):
        f = chained(steps[order])
        jax.block_until_ready(f(y, ell0))
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            jax.block_until_ready(f(y, ell0))
            ts.append(time.perf_counter() - t0)
        fs = []
        jax.block_until_ready(frame(clouds, order))
        for i in range(30):
            cs = [clouds[i % 2], clouds[1 + i % 2], clouds[2 + i % 2]]
            t0 = time.perf_counter()
            jax.block_until_ready(frame(cs, order))
            fs.append(time.perf_counter() - t0)
        timing.setdefault(order, []).append(
            (float(np.median(ts)) / K * 1e3, float(np.median(fs)) * 1e3))
    for bk, rows in timing.items():
        log(f"[timing] {bk}: moment pass "
            + ", ".join(f"{r[0]:.4f}" for r in rows) + " ms/iter; warm "
            "frame_step " + ", ".join(f"{r[1]:.2f}" for r in rows)
            + " ms/frame (" + ", ".join(f"{1e3 / r[1]:.2f}" for r in rows)
            + f" frames/s) on {card}")


def phase_main_path(card):
    from cvo_slam_tpu.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu.eval import suite

    cam = CAMERA_PRESETS["TUM1"]
    cfg = SlamConfig.default_shipped()
    spec = suite._catalog()["loop_120"]
    n = spec["n_frames"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = suite.run_sequence("loop_120", os.path.join(tmp, "loop_120"),
                                 cam, cfg, n, spec["kwargs"](n))
        total = time.perf_counter() - t0
    trk = res["tracking"]["ate_rmse"]
    slam = res["slam"]["ate_rmse"]
    log(f"[main] loop_120 {cam.width}x{cam.height} capacity "
        f"{cfg.frontend.cloud_capacity}: {res['frames']} frames, run_slam "
        f"wall {res['wall_s']} s, {res['fps']} frames/s, cold (compiles "
        f"included), generation + run {total:.1f} s, on {card}")
    log(f"[main] loop closures {res['loop_closures']}, keyframes "
        f"{res.get('keyframes')}, ATE tracking {trk:.6f} m, SLAM {slam:.6f} m")
    log(f"[main] keyframe_path_ms {json.dumps(res.get('keyframe_path_ms'))}")
    check(res["loop_closures"] >= 1, "no loop closure")
    check(slam <= trk, f"SLAM ATE {slam} > tracking ATE {trk}")
    check(trk < 0.01 and slam < 0.01, f"ATE tracking {trk}, SLAM {slam}")


def _mesh_run(folder, cam, cfg, mesh_devices):
    from cvo_slam_tpu.app.run_slam import build_tracker
    from cvo_slam_tpu.data import tum
    tracker = build_tracker(cam, cfg, mesh_devices=mesh_devices)
    tracker.init()
    records = tum.load_association(os.path.join(folder, "associate.txt"))
    for i, rec in enumerate(records):
        if i == len(records) - 1:
            tracker.force_keyframe()
        tracker.update(tum.load_image(folder, rec))
    if tracker.warmup is not None:
        tracker.warmup.check()
    out = os.path.join(folder, f"slam_{mesh_devices}.txt")
    tracker.write_slam_trajectory_and_loop_closure(
        out, os.path.join(folder, f"lc_{mesh_devices}.txt"))
    return tracker, tum.read_trajectory(out)


def phase_four_cards(card):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from cvo_slam_tpu.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu.cvo import engine
    from cvo_slam_tpu.data import synthetic, tum
    from cvo_slam_tpu.eval.suite import loop_trajectory
    from cvo_slam_tpu.parallel import batch

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices")
    cam = CAMERA_PRESETS["TUM1"]
    cfg = SlamConfig.default_shipped().replace(
        Max_KF_interval=3, Min_KF_interval=0, FinalOptimizationIterations=30,
        LC_MinMatch=10)
    n = 24
    with tempfile.TemporaryDirectory() as tmp:
        gt = synthetic.make_sequence(tmp, cam, trajectory=loop_trajectory(n))
        solo, (ts_s, poses_s) = _mesh_run(tmp, cam, cfg, 0)
        mesh, (ts_m, poses_m) = _mesh_run(tmp, cam, cfg, 4)
    gt_ts = [f"{1000.0 + 0.05 * k:.6f}" for k in range(n)]
    ate_s = tum.ate_rmse(gt_ts, gt, ts_s, poses_s)
    ate_m = tum.ate_rmse(gt_ts, gt, ts_m, poses_m)
    g_s, g_m = solo.graph, mesh.graph
    n_lm = len(getattr(g_m, "map_points", {}) or {})
    wba = sum("windowed_ba" in r for r in g_m.stage_ms)
    dpos = float(np.max(np.abs(np.asarray(poses_s)[:, :3, 3]
                               - np.asarray(poses_m)[:, :3, 3])))
    log(f"[mesh] run_slam --mesh 4: {len(ts_m)} poses, loop closures solo "
        f"{g_s.lc_num} / mesh {g_m.lc_num}, windowed BA events {wba}, "
        f"landmarks {n_lm}; SLAM ATE solo {ate_s:.6f} m, mesh {ate_m:.6f} m; "
        f"max |position diff| mesh vs solo {dpos:.2e} m on {card}")
    check(ts_s == ts_m, "trajectory timestamps differ")
    # the sharded windowed BA moves poses by float reduction order, which
    # can flip a loop-closure candidate sitting at its accept threshold, so
    # the counts are reported and both runs must close loops
    check(g_s.lc_num >= 1 and g_m.lc_num >= 1, "no loop closure")
    check(wba >= 1, "no windowed BA event on the mesh")
    check(n_lm > 0, "windowed BA ran without landmarks")
    check(abs(ate_m - ate_s) <= TOL_MESH_ATE, f"SLAM ATE solo {ate_s}, "
          f"mesh {ate_m}")
    check(dpos <= TOL_MESH_POSITION, f"mesh vs solo positions {dpos}")

    # fixed iteration count, as in the GPU-vs-CPU frame_step comparison
    cfg0 = SlamConfig.default_shipped()
    p_fixed = dataclasses.replace(cfg0.cvo, eps=0.0, eps_2=0.0,
                                  max_iter=FIXED_ITERS)
    _, host = _bench_clouds()
    cl = [engine.PointCloud.from_host(pc) for pc in host]
    fixed = [cl[0], cl[1], cl[2], cl[0]]
    moving = [cl[1], cl[2], cl[3], cl[2]]
    stack = lambda cs: tuple(jnp.stack(a) for a in zip(*cs))
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("dp",))
    fn = batch.make_sharded_align(mesh4, p_fixed)
    ell = jnp.full(4, p_fixed.ell_init, jnp.float32)
    res = jax.device_get(fn(stack(fixed), stack(moving),
                            jnp.tile(jnp.eye(3), (4, 1, 1)),
                            jnp.zeros((4, 3)), ell))
    worst = 0.0
    for i in range(4):
        solo_r = jax.device_get(engine.align(
            fixed[i], moving[i], jnp.eye(3), jnp.zeros(3), ell[i], p_fixed,
            engine.default_backend()))
        worst = max(worst, float(np.max(np.abs(res.transform[i]
                                               - solo_r.transform))))
    log(f"[mesh] make_sharded_align on 4 cards vs solo: max |transform "
        f"diff| {worst:.2e}")
    check(worst <= TOL_TRANSFORM, f"sharded align vs solo {worst}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax
    # the CPU backend is needed beside the GPU for the frame_step comparison
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    from cvo_slam_tpu.utils.compcache import enable_persistent_cache
    enable_persistent_cache()

    dev, card = phase_device()
    try:
        if args.four_cards:
            phase_four_cards(card)
        else:
            phase_parity(card)
            phase_main_path(card)
    except Failed as exc:
        log(f"FAILED: {exc}")
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
