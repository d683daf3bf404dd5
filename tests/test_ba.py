"""Bundle adjustment: single-device Schur LM + sharded equivalence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from cvo_slam_tpu.backend import ba
from cvo_slam_tpu.ops import se3
from cvo_slam_tpu.parallel import sharded_ba

K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]], np.float32)


def make_problem(seed=0, n_pose=6, n_lm=40, noise_lm=0.05, noise_pose=0.01,
                 cap_lm=None):
    rng = np.random.default_rng(seed)
    # poses on a gentle arc looking at a landmark field at z~4
    poses = [np.eye(4)]
    step = np.asarray(se3.exp_se3(jnp.asarray(
        np.array([0.01, -0.02, 0.005, 0.15, 0.02, 0.01], np.float32))),
        np.float64)
    for _ in range(n_pose - 1):
        poses.append(poses[-1] @ step)
    poses = np.array(poses)
    E_true = np.array([np.linalg.inv(p) for p in poses], np.float32)
    lms = rng.uniform([-2, -1.5, 3.0], [2, 1.5, 5.0], (n_lm, 3)).astype(np.float32)

    p_kf, p_lm, p_meas, p_w = [], [], [], []
    for li in range(n_lm):
        for vi in range(n_pose):
            P = E_true[vi, :3, :3] @ lms[li] + E_true[vi, :3, 3]
            if P[2] <= 0.1:
                continue
            uv = K @ P
            u, v = uv[0] / uv[2], uv[1] / uv[2]
            if not (0 <= u < 320 and 0 <= v < 240):
                continue
            p_kf.append(vi)
            p_lm.append(li)
            p_meas.append((u, v))
            p_w.append(1.0)
    m = len(p_kf)

    # relative-pose edges along the chain (true measurements)
    ei = np.arange(n_pose - 1, dtype=np.int32)
    ej = ei + 1
    Z = np.array([E_true[k] @ poses[k + 1] for k in range(n_pose - 1)],
                 np.float32)
    om = np.tile(np.eye(6, dtype=np.float32) * 100.0, (n_pose - 1, 1, 1))

    cap_lm = cap_lm or n_lm
    L0 = np.zeros((cap_lm, 3), np.float32)
    L0[:n_lm] = lms + rng.normal(0, noise_lm, (n_lm, 3))
    lm_mask = np.arange(cap_lm) < n_lm
    E0 = E_true.copy()
    for v in range(1, n_pose):
        pert = np.asarray(se3.exp_se3(jnp.asarray(
            rng.normal(0, noise_pose, 6).astype(np.float32))))
        E0[v] = pert @ E0[v]
    free = np.ones(n_pose, bool)
    free[0] = False
    args = dict(E0=jnp.asarray(E0), L0=jnp.asarray(L0),
                free_pose=jnp.asarray(free), lm_mask=jnp.asarray(lm_mask),
                ei=jnp.asarray(ei), ej=jnp.asarray(ej), Z=jnp.asarray(Z),
                omega=jnp.asarray(om),
                pemask=jnp.ones(n_pose - 1, bool),
                p_kf=jnp.asarray(p_kf, jnp.int32),
                p_lm=jnp.asarray(p_lm, jnp.int32),
                p_meas=jnp.asarray(np.array(p_meas, np.float32)),
                p_w=jnp.asarray(p_w, jnp.float32),
                p_mask=jnp.ones(m, bool))
    return args, E_true, lms


def test_ba_converges_to_truth():
    args, E_true, lms = make_problem()
    E_opt, L_opt = ba.optimize_ba(
        args["E0"], args["L0"], args["free_pose"], args["lm_mask"],
        args["ei"], args["ej"], args["Z"], args["omega"], args["pemask"],
        args["p_kf"], args["p_lm"], args["p_meas"], args["p_w"],
        args["p_mask"], jnp.asarray(K), 15, 0.0)
    np.testing.assert_allclose(np.asarray(E_opt), E_true, atol=2e-3)
    # landmark depth is weakly constrained on a narrow-baseline arc; check
    # reprojection is driven to ~zero and positions are in the ballpark
    from cvo_slam_tpu.backend.ba import _proj_terms
    err2 = _proj_terms(E_opt, L_opt, args["p_kf"], args["p_lm"],
                       args["p_meas"], args["p_w"], args["p_mask"],
                       jnp.asarray(K))[4]
    assert float(jnp.sum(err2)) < 1e-3
    np.testing.assert_allclose(np.asarray(L_opt)[:len(lms)], lms, atol=0.15)


def test_sharded_ba_matches_single_device():
    args, E_true, lms = make_problem(seed=1)
    E1, L1 = ba.optimize_ba(
        args["E0"], args["L0"], args["free_pose"], args["lm_mask"],
        args["ei"], args["ej"], args["Z"], args["omega"], args["pemask"],
        args["p_kf"], args["p_lm"], args["p_meas"], args["p_w"],
        args["p_mask"], jnp.asarray(K), 10, 2.0)

    n_dev = 4
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    sharded, slot, per_dev = sharded_ba.shard_ba_problem(
        n_dev, np.asarray(args["L0"]), np.asarray(args["lm_mask"]),
        np.asarray(args["p_kf"]), np.asarray(args["p_lm"]),
        np.asarray(args["p_meas"]), np.asarray(args["p_w"]),
        np.asarray(args["p_mask"]), np.asarray(args["ei"]),
        np.asarray(args["ej"]), np.asarray(args["Z"]),
        np.asarray(args["omega"]), np.asarray(args["pemask"]))
    E2, L2s = sharded_ba.optimize_ba_sharded(
        np.asarray(args["E0"]), np.asarray(args["free_pose"]), sharded,
        jnp.asarray(K), 10, 2.0, mesh)
    np.testing.assert_allclose(np.asarray(E1), np.asarray(E2),
                               rtol=1e-3, atol=1e-4)
    # sharded landmarks back in input order, compared
    L2 = np.asarray(L2s).reshape(-1, 3)[slot]
    np.testing.assert_allclose(np.asarray(L1), L2, rtol=1e-3, atol=1e-3)


def test_sharded_ba_uneven_landmarks_matches_single_device():
    """10 landmarks on 4 devices (not a multiple of the device count): every
    device block is padded on its own, so each projection edge points at its
    own landmark and the sharded solve matches the single-device one."""
    args, E_true, lms = make_problem(seed=5, n_lm=10)
    inputs = [np.asarray(args[k]) for k in (
        "L0", "lm_mask", "p_kf", "p_lm", "p_meas", "p_w", "p_mask", "ei",
        "ej", "Z", "omega", "pemask")]
    sharded, slot, per_dev = sharded_ba.shard_ba_problem(4, *inputs)
    assert per_dev == 3 and sorted(slot) == sorted(set(slot))
    table = sharded["L"].reshape(-1, 3)
    np.testing.assert_array_equal(table[slot], inputs[0])
    assert sharded["lm_mask"].reshape(-1).sum() == 10
    # every edge's local index points at its landmark in its owner's block
    for d in range(4):
        k = sharded["p_mask"][d]
        assert np.all((sharded["p_lm"][d][k] >= 0)
                      & (sharded["p_lm"][d][k] < per_dev))
    E1, L1 = ba.optimize_ba(
        args["E0"], args["L0"], args["free_pose"], args["lm_mask"],
        args["ei"], args["ej"], args["Z"], args["omega"], args["pemask"],
        args["p_kf"], args["p_lm"], args["p_meas"], args["p_w"],
        args["p_mask"], jnp.asarray(K), 10, 2.0)
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    E2, L2s = sharded_ba.optimize_ba_sharded(
        np.asarray(args["E0"]), np.asarray(args["free_pose"]), sharded,
        jnp.asarray(K), 10, 2.0, mesh)
    np.testing.assert_allclose(np.asarray(E1), np.asarray(E2),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(L1),
                               np.asarray(L2s).reshape(-1, 3)[slot],
                               rtol=1e-3, atol=1e-3)


def test_sharded_ba_pcg_matches_dense():
    """The matrix-free distributed-PCG Schur solve (SURVEY section 5.8's
    large-graph prescription) must reproduce the dense replicated solve:
    same LM trajectory, same optimum, at 1 and 4 shards."""
    args, E_true, lms = make_problem(seed=2)
    shard_inputs = (
        np.asarray(args["L0"]), np.asarray(args["lm_mask"]),
        np.asarray(args["p_kf"]), np.asarray(args["p_lm"]),
        np.asarray(args["p_meas"]), np.asarray(args["p_w"]),
        np.asarray(args["p_mask"]), np.asarray(args["ei"]),
        np.asarray(args["ej"]), np.asarray(args["Z"]),
        np.asarray(args["omega"]), np.asarray(args["pemask"]))

    results = {}
    for n_dev in (1, 4):
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
        sharded, slot, per_dev = sharded_ba.shard_ba_problem(
            n_dev, *shard_inputs)
        for solver in ("dense", "pcg"):
            E, Ls = sharded_ba.optimize_ba_sharded(
                np.asarray(args["E0"]), np.asarray(args["free_pose"]),
                sharded, jnp.asarray(K), 10, 2.0, mesh, solver=solver)
            L = np.asarray(Ls).reshape(-1, 3)[slot]
            results[(n_dev, solver)] = (np.asarray(E), L)

    for n_dev in (1, 4):
        Ed, Ld = results[(n_dev, "dense")]
        Ep, Lp = results[(n_dev, "pcg")]
        np.testing.assert_allclose(Ed, Ep, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(Ld, Lp, rtol=1e-3, atol=1e-3)


def test_ba_pcg_matches_dense_single_device():
    """Single-device matrix-free PCG Schur solve (optimize_ba solver='pcg',
    used for large windowed-BA classes) must track the dense path."""
    args, E_true, lms = make_problem(seed=3)
    common = (args["E0"], args["L0"], args["free_pose"], args["lm_mask"],
              args["ei"], args["ej"], args["Z"], args["omega"],
              args["pemask"], args["p_kf"], args["p_lm"], args["p_meas"],
              args["p_w"], args["p_mask"], jnp.asarray(K))
    Ed, Ld = ba.optimize_ba(*common, 10, 2.0, solver="dense")
    Ep, Lp = ba.optimize_ba(*common, 10, 2.0, solver="pcg")
    np.testing.assert_allclose(np.asarray(Ed), np.asarray(Ep),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Ld), np.asarray(Lp),
                               rtol=1e-3, atol=1e-3)
