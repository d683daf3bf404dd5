"""Measure the reference's per-frame CVO cost on this host (BENCH anchor).

Builds the exact bench workload clouds
(cvo_slam_tpu.eval.workload.bench_host_clouds), exports them to a binary
file, compiles and runs the C++ replica
(cvo_slam_tpu/native/ref_cvo_baseline.cpp — the reference's kd-tree +
triplet + quartic + per-pair-Hessian cost structure, biased in the
reference's favor), and writes REF_BASELINE.json at the repo root, which
bench.py then uses as vs_baseline.

Also cross-checks the replica's convergence against the JAX engine on the
same clouds (align iteration counts and the recovered transform must agree)
so the measured cost corresponds to the same amount of optimization work.

Usage:  python tools/measure_reference_baseline.py [--frames 20]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SRC = os.path.join(ROOT, "cvo_slam_tpu", "native", "ref_cvo_baseline.cpp")


def export_clouds(host_clouds, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(host_clouds)))
        for pc in host_clouds:
            n = int(pc.count)
            f.write(struct.pack("<i", n))
            f.write(np.ascontiguousarray(
                pc.positions[:n], np.float32).tobytes())
            f.write(np.ascontiguousarray(
                pc.features[:n], np.float32).tobytes())
    return path


def compile_replica(out_bin):
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-o", out_bin, SRC]
    subprocess.run(cmd, check=True)
    return out_bin


def cross_check(host_clouds):
    """The replica must do the same optimization work as the engine: compare
    align iterations + transform on the odometry pair."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from cvo_slam_tpu.config import SlamConfig
    from cvo_slam_tpu.cvo import engine
    import jax.numpy as jnp
    p = SlamConfig.default_shipped().cvo
    prev = engine.PointCloud.from_host(host_clouds[1])
    cur = engine.PointCloud.from_host(host_clouds[2])
    res = engine.align(prev, cur, jnp.eye(3), jnp.zeros(3),
                       jnp.float32(p.ell_init), p, "xla")
    return int(res.iters), np.asarray(res.transform)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--threads", type=int, default=0,
                    help="OMP threads (default: all cores)")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from cvo_slam_tpu.config import CAMERA_PRESETS, SlamConfig
    from cvo_slam_tpu.eval.workload import bench_host_clouds
    cam = CAMERA_PRESETS["TUM1"]
    cfg = SlamConfig.default_shipped()
    print("building bench clouds ...", flush=True)
    host_clouds = bench_host_clouds(cam, cfg)

    with tempfile.TemporaryDirectory() as d:
        bin_path = os.path.join(d, "ref_baseline")
        data_path = os.path.join(d, "clouds.bin")
        export_clouds(host_clouds, data_path)
        print("compiling C++ replica ...", flush=True)
        compile_replica(bin_path)
        env = dict(os.environ)
        if args.threads:
            env["OMP_NUM_THREADS"] = str(args.threads)
        print("running ...", flush=True)
        out = subprocess.run([bin_path, data_path, str(args.frames)],
                             capture_output=True, text=True, env=env,
                             check=True)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        env1 = dict(env, OMP_NUM_THREADS="1")
        out1 = subprocess.run([bin_path, data_path, str(args.frames)],
                              capture_output=True, text=True, env=env1,
                              check=True)
        rec1 = json.loads(out1.stdout.strip().splitlines()[-1])
        rec["fps_1thread"] = rec1["fps"]
        rec["ms_per_frame_1thread"] = rec1["value"]

    print("cross-checking optimization work vs the JAX engine ...",
          flush=True)
    eng_iters, eng_T = cross_check(host_clouds)
    rec["engine_align_iters_odometry"] = eng_iters
    rec["engine_transform_translation"] = [float(v) for v in eng_T[:3, 3]]
    rec["note"] = ("C++ replica of the reference per-frame CVO cost "
                   "(2 aligns + 2 innerproduct/Hessian suites, kd-tree per "
                   "iteration); all discretionary choices favor the "
                   "reference. See cvo_slam_tpu/native/ref_cvo_baseline.cpp")
    import platform
    rec["host"] = dict(machine=platform.machine(),
                       cpu_count=os.cpu_count())
    path = os.path.join(ROOT, "REF_BASELINE.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
