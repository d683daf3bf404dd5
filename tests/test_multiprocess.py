"""Genuinely multi-process mesh execution.

Spawns 2 coordinated `jax.distributed` CPU processes (2 virtual devices
each -> one 4-device global mesh with a real process boundary) running the
sharded-LM optimizer, and checks both processes agree with each other and
with the same problem solved single-process on a local 4-device mesh.

The reference has no distributed execution at all (SURVEY.md section 2.4);
this exercises the multi-host code path (global arrays, collectives across
process boundaries) that a multi-host deployment uses.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_lm_matches_single_process():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(pid), "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = {}
    for out, p in zip(outs, procs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        m = re.search(r"RESULT pid=(\d+) chi2=(\S+) esum=(\S+)", out)
        assert m, f"no RESULT line:\n{out[-3000:]}"
        results[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    assert set(results) == {0, 1}
    # both processes computed the same replicated optimum
    assert results[0] == results[1]

    # single-process 4-virtual-device run of the SAME problem
    from cvo_slam_tpu.backend import lm  # noqa: F401 (jax configured by conftest)
    import jax
    from jax.sharding import Mesh
    from cvo_slam_tpu.eval.scaling import chain_pose_graph
    from cvo_slam_tpu.parallel import sharded_lm

    rng = np.random.default_rng(0)
    g = chain_pose_graph(rng, 16, extra_random_edges=32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    E_opt, chi2 = sharded_lm.make_sharded_optimizer(
        g, mesh, iterations=5, robust_delta=2.0)(g.E)
    chi2_sp = float(chi2)
    esum_sp = float(np.abs(np.asarray(E_opt)).sum())
    chi2_mp, esum_mp = results[0]
    assert abs(chi2_mp - chi2_sp) <= 1e-4 * max(abs(chi2_sp), 1.0)
    assert abs(esum_mp - esum_sp) <= 1e-4 * max(abs(esum_sp), 1.0)
