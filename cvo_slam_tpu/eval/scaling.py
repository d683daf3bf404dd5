"""Scaling harness: sharded LM / Schur-BA throughput + equality vs 1 device.

Measures the distributed solvers (parallel.sharded_lm / sharded_ba — the
SURVEY section 5.8 capability; the reference has no distributed backend at
all) at 1/2/4/8 mesh devices:

  * LM outer-iterations/s on a synthetic pose graph (steady-state, compile
    excluded via a reusable compiled optimizer);
  * sharded-vs-single-device result deltas (max |E| difference, chi2 rel
    delta) — the correctness half of the artifact;
  * scaling efficiency normalized to the 1-device mesh time.

On a multi-GPU host the mesh devices are physical cards and the psum rides
NVLink; on a CPU the mesh is XLA_FLAGS=--xla_force_host_platform_
device_count virtual CPU devices sharing the host's cores, so wall-clock
efficiency is bounded by core count — the JSON records host_cpus so readers
can interpret the numbers. The collective structure measured (per-shard
linearization + psum-reduced normal equations) is identical on real meshes.

CLI:
  python -m cvo_slam_tpu.eval.scaling --out SCALING.json
      [--poses 48] [--landmarks 96] [--iters 10] [--repeats 3]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _force_cpu_mesh(n: int = 8):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={n}"
                               ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


def chain_pose_graph(rng, n, noise=0.02, lc_every=8, extra_random_edges=0):
    """Chain of n poses with odometry edges + periodic loop edges (+ optional
    random pair edges so per-shard linearization dominates the replicated
    solve — the regime where edge sharding pays off)."""
    import jax.numpy as jnp
    from ..backend import lm
    from ..ops import se3

    twists = rng.normal(0, 0.1, (n - 1, 6)).astype(np.float32)
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(n - 1):
        poses.append(poses[-1] @ np.asarray(
            se3.exp_se3(jnp.asarray(twists[k]))))
    poses = np.array(poses)
    E_true = np.array([np.linalg.inv(p) for p in poses], np.float32)

    ei, ej, Z = [], [], []

    def add_edge(i, j, noisy):
        ei.append(i)
        ej.append(j)
        Zk = E_true[i] @ poses[j]
        if noisy:
            Zk = np.asarray(se3.exp_se3(jnp.asarray(
                rng.normal(0, noise, 6).astype(np.float32)))) @ Zk
        Z.append(Zk)

    for k in range(n - 1):
        add_edge(k, k + 1, noise > 0)
    for k in range(0, n - lc_every, lc_every):
        add_edge(k, k + lc_every, False)
    for _ in range(extra_random_edges):
        i, j = rng.choice(n, 2, replace=False)
        add_edge(int(min(i, j)), int(max(i, j)), noise > 0)

    m = len(ei)
    E0 = E_true.copy()
    E0[1:] = np.asarray(se3.exp_se3(jnp.asarray(
        rng.normal(0, 0.02, (n - 1, 6)).astype(np.float32)))) @ E0[1:]
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return lm.PoseGraph(
        E=jnp.asarray(E0), vmask=jnp.ones(n, bool), fixed=jnp.asarray(fixed),
        ei=jnp.asarray(np.array(ei, np.int32)),
        ej=jnp.asarray(np.array(ej, np.int32)),
        Z=jnp.asarray(np.array(Z, np.float32)),
        omega=jnp.asarray(np.tile(np.eye(6, dtype=np.float32) * 50.0,
                                  (m, 1, 1))),
        emask=jnp.ones(m, bool))


def _time_steady(fn, repeats):
    import jax
    out = fn()                      # compile + warmup
    jax.block_until_ready(out)
    # best-of-N: this container's 2 shared cores make mean wall-clock rows
    # noisy (background churn lands on arbitrary repeats); the minimum is
    # the standard steady-state estimator on a shared host
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def bench_lm(n_poses, iters, repeats, devices):
    import jax
    from jax.sharding import Mesh
    from ..backend import lm
    from ..parallel import sharded_lm

    rng = np.random.default_rng(0)
    # edge-heavy graph: the sharded part (per-edge linearization) dominates
    # the replicated (V*6)^2 solve, as in real large pose graphs
    g = chain_pose_graph(rng, n_poses, extra_random_edges=24 * n_poses)
    t1, (E1, c1) = _time_steady(
        lambda: lm.optimize(g, iters, robust_delta=2.0), repeats)
    E1 = np.asarray(E1)
    ncpu = os.cpu_count()
    rows = []
    base = {}
    for n_dev in devices:
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
        for solver in ("dense", "pcg"):
            run = sharded_lm.make_sharded_optimizer(g, mesh, iters,
                                                    robust_delta=2.0,
                                                    solver=solver)
            t, (E2, c2) = _time_steady(lambda: run(g.E), repeats)
            if solver not in base:
                base[solver] = t
            rows.append(dict(
                devices=n_dev,
                solver=solver,
                iters_per_s=round(iters / t, 2),
                ms_per_call=round(t * 1e3, 2),
                efficiency_vs_1dev=round(base[solver] / t, 3),
                # on virtual devices the host core count caps achievable
                # efficiency at host_cpus/n_dev; real chips have no such cap
                core_bound_ceiling=round(min(1.0, ncpu / n_dev), 3),
                max_abs_pose_delta=float(np.max(np.abs(np.asarray(E2) - E1))),
                chi2_rel_delta=float(abs(float(c2) - float(c1))
                                     / max(abs(float(c1)), 1e-12)),
            ))
    return dict(problem=dict(poses=n_poses, edges=int(g.ei.shape[0]),
                             lm_iterations=iters),
                single_device_ms=round(t1 * 1e3, 2), shards=rows)


def bench_ba(n_poses, n_lm, iters, repeats, devices):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from ..backend import ba
    from ..parallel import sharded_ba
    from ..ops import se3

    rng = np.random.default_rng(1)
    K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]], np.float32)
    # arc of poses observing a landmark field (mirrors tests/test_ba.py)
    poses = [np.eye(4)]
    step = np.asarray(se3.exp_se3(jnp.asarray(np.array(
        [0.01, -0.02, 0.005, 0.15, 0.02, 0.01], np.float32))), np.float64)
    for _ in range(n_poses - 1):
        poses.append(poses[-1] @ step)
    poses = np.array(poses)
    E_true = np.array([np.linalg.inv(p) for p in poses], np.float32)
    lms = rng.uniform([-2, -1.5, 3.0], [2, 1.5, 5.0], (n_lm, 3)
                      ).astype(np.float32)
    p_kf, p_lm, p_meas = [], [], []
    for li in range(n_lm):
        for vi in range(n_poses):
            Pc = E_true[vi, :3, :3] @ lms[li] + E_true[vi, :3, 3]
            if Pc[2] <= 0.1:
                continue
            uv = K @ Pc
            u, v = uv[0] / uv[2], uv[1] / uv[2]
            if not (0 <= u < 320 and 0 <= v < 240):
                continue
            p_kf.append(vi)
            p_lm.append(li)
            p_meas.append((u, v))
    m = len(p_kf)
    p_kf = np.array(p_kf, np.int32)
    p_lm = np.array(p_lm, np.int32)
    p_meas = np.array(p_meas, np.float32)
    p_w = np.ones(m, np.float32)
    p_mask = np.ones(m, bool)
    ei = np.arange(n_poses - 1, dtype=np.int32)
    ej = ei + 1
    Z = np.array([E_true[k] @ poses[k + 1] for k in range(n_poses - 1)],
                 np.float32)
    om = np.tile(np.eye(6, dtype=np.float32) * 100.0, (n_poses - 1, 1, 1))
    pemask = np.ones(n_poses - 1, bool)
    L0 = lms + rng.normal(0, 0.05, (n_lm, 3)).astype(np.float32)
    lm_mask = np.ones(n_lm, bool)
    E0 = E_true.copy()
    E0[1:] = np.asarray(se3.exp_se3(jnp.asarray(
        rng.normal(0, 0.01, (n_poses - 1, 6)).astype(np.float32)))) @ E0[1:]
    free = np.ones(n_poses, bool)
    free[0] = False

    Kj = jnp.asarray(K)
    t1, (E1, L1) = _time_steady(
        lambda: ba.optimize_ba(jnp.asarray(E0), jnp.asarray(L0),
                               jnp.asarray(free), jnp.asarray(lm_mask),
                               jnp.asarray(ei), jnp.asarray(ej),
                               jnp.asarray(Z), jnp.asarray(om),
                               jnp.asarray(pemask), jnp.asarray(p_kf),
                               jnp.asarray(p_lm), jnp.asarray(p_meas),
                               jnp.asarray(p_w), jnp.asarray(p_mask),
                               Kj, iters, 2.0), repeats)
    E1 = np.asarray(E1)
    rows = []
    base = {}
    for n_dev in devices:
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
        sharded, _, per_dev = sharded_ba.shard_ba_problem(
            n_dev, L0, lm_mask, p_kf, p_lm, p_meas, p_w, p_mask,
            ei, ej, Z, om, pemask)
        E0j = jnp.asarray(E0)
        for solver in ("dense", "pcg"):
            run, args = sharded_ba.make_ba_optimizer(
                E0, free, sharded, Kj, iters, 2.0, mesh, solver=solver)
            t, (E2, _) = _time_steady(lambda: run(E0j, *args), repeats)
            if solver not in base:
                base[solver] = t
            rows.append(dict(
                devices=n_dev,
                solver=solver,
                iters_per_s=round(iters / t, 2),
                ms_per_call=round(t * 1e3, 2),
                efficiency_vs_1dev=round(base[solver] / t, 3),
                core_bound_ceiling=round(min(1.0, os.cpu_count() / n_dev), 3),
                max_abs_pose_delta=float(np.max(np.abs(np.asarray(E2) - E1))),
            ))
    return dict(problem=dict(poses=n_poses, landmarks=n_lm,
                             projection_edges=m, lm_iterations=iters),
                single_device_ms=round(t1 * 1e3, 2), shards=rows)


def run_harness(out_path, poses=48, landmarks=96, iters=10, repeats=3,
                devices=(1, 2, 4, 8)):
    _force_cpu_mesh(max(devices))
    import jax
    payload = dict(
        platform=jax.default_backend(),
        mesh="virtual CPU devices (xla_force_host_platform_device_count)",
        host_cpus=os.cpu_count(),
        note=("wall-clock efficiency on virtual devices is bounded by "
              "host_cpus; collective structure (per-shard linearization + "
              "psum-assembled normal equations) matches real device meshes"),
        lm=bench_lm(poses, iters, repeats, devices),
        # the distributed Schur BA exists for the LARGE-graph regime; a
        # 12-pose/96-landmark toy (round 4) became overhead-bound once the
        # convergence early-exit halved per-call time, so the efficiency
        # rows measured fixed costs rather than scaling
        ba=bench_ba(min(poses, 24), landmarks, iters, repeats, devices),
    )
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload["lm"]["shards"]))
    print(json.dumps(payload["ba"]["shards"]))
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="SCALING.json")
    ap.add_argument("--poses", type=int, default=48)
    ap.add_argument("--landmarks", type=int, default=96)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    run_harness(args.out, args.poses, args.landmarks, args.iters,
                args.repeats)


if __name__ == "__main__":
    main()
