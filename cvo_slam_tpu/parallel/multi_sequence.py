"""Multi-sequence lockstep tracking (data parallelism over sequences).

New capability vs the reference (strictly single-sequence): S sequences are
tracked in lockstep through the SAME KeyframeTracker/LocalTracker state
machine as solo runs — full local maps, keyframe policy, and (optionally)
per-sequence backend graphs with loop closure and BA — while the heavy device
math is batched: the trackers' per-frame logic is written as generators that
yield align / inner-product requests (tracking.local_tracker's request
protocol), and this module services all same-kind requests of a round in ONE
vmapped device dispatch, shardable over a "dp" device mesh.

This replaces the round-1 design where MultiSequenceTracker carried its own
reduced re-implementation of the accept/warm-start logic (a divergence
risk): there is now exactly one state machine, and a
lockstep run equals S solo runs pose-for-pose (tests/test_multi_sequence.py).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig, SlamConfig
from ..cvo import engine
from ..data.tum import ImagePair


@partial(jax.jit, static_argnames=("p", "backend"))
def _batched_align(fixed, moving, R0, T0, ell0, p, backend):
    return jax.vmap(lambda f, m, R, T, e:
                    engine.align(f, m, R, T, e, p, backend))(
        fixed, moving, R0, T0, ell0)


@partial(jax.jit, static_argnames=("p",))
def _batched_ip(fixed, moving, tran, ell, p):
    return jax.vmap(lambda f, m, t, e:
                    engine.compute_innerproduct(f, m, t, e, p))(
        fixed, moving, tran, ell)


@partial(jax.jit, static_argnames=("p", "backend"))
def _batched_align_ip(fixed, moving, R0, T0, ell0, p, backend):
    return jax.vmap(lambda f, m, R, T, e:
                    engine.align_and_innerproduct(f, m, R, T, e, p, backend))(
        fixed, moving, R0, T0, ell0)


@partial(jax.jit, static_argnames=("p", "backend"))
def _batched_frame(prev, kf, cur, R0, T0, ell_odo, kf_tr, ell_kf, p, backend):
    return jax.vmap(lambda pr, k, c, R, T, eo, kt, ek:
                    engine.frame_step(pr, k, c, R, T, eo, kt, ek, p, backend))(
        prev, kf, cur, R0, T0, ell_odo, kf_tr, ell_kf)


def _stack(clouds: List[engine.PointCloud]) -> engine.PointCloud:
    return engine.PointCloud(
        jnp.stack([c.positions for c in clouds]),
        jnp.stack([c.features for c in clouds]),
        jnp.stack([c.mask for c in clouds]))


class _BatchExecutor:
    """Service one round of same-kind requests in a single device dispatch."""

    def __init__(self, params, backend: str):
        self.params = params
        self.backend = backend

    def run_align(self, reqs):
        """reqs: [("align", cvo, cloud, pixels), ...] -> [transform, ...]."""
        cvos = []
        for _, cvo, cloud, pixels in reqs:
            ready = cvo.set_pcd(cloud, pixels)
            assert ready, "cvo not initialized"
            cvos.append(cvo)
        fixed = _stack([c.fixed for c in cvos])
        moving = _stack([c.moving for c in cvos])
        R0 = jnp.asarray(np.stack([c.R for c in cvos]))
        T0 = jnp.asarray(np.stack([c.T for c in cvos]))
        ell0 = jnp.asarray(np.array([c.start_ell() for c in cvos], np.float32))
        res = _batched_align(fixed, moving, R0, T0, ell0, self.params,
                             self.backend)
        R, T, transform, ell, iters, nnz = jax.device_get(tuple(res))
        return [cvo._apply_align(R[j], T[j], transform[j], ell[j], iters[j],
                                 nnz[j])
                for j, cvo in enumerate(cvos)]

    def run_align_ip(self, reqs):
        """reqs: [("align_ip", cvo, cloud, pixels), ...] ->
        [(transform, ip dict), ...] — fused, one dispatch, one transfer."""
        cvos = []
        for _, cvo, cloud, pixels in reqs:
            ready = cvo.set_pcd(cloud, pixels)
            assert ready, "cvo not initialized"
            cvos.append(cvo)
        fixed = _stack([c.fixed for c in cvos])
        moving = _stack([c.moving for c in cvos])
        R0 = jnp.asarray(np.stack([c.R for c in cvos]))
        T0 = jnp.asarray(np.stack([c.T for c in cvos]))
        ell0 = jnp.asarray(np.array([c.start_ell() for c in cvos], np.float32))
        res, ip = _batched_align_ip(fixed, moving, R0, T0, ell0, self.params,
                                    self.backend)
        (R, T, transform, ell, iters, nnz), ip_host = jax.device_get(
            (tuple(res), {k: v for k, v in ip.items()}))
        out = []
        for j, cvo in enumerate(cvos):
            tr = cvo._apply_align(R[j], T[j], transform[j], ell[j], iters[j],
                                  nnz[j])
            out.append((tr, {k: v[j] for k, v in ip_host.items()}))
        return out

    def run_frame(self, reqs):
        """reqs: [("frame", odo_cvo, kf_cvo, cloud, pixels), ...] ->
        [(T_odo, ip_odo, T_kf, ip_kf), ...] — the whole frame for every
        sequence in ONE batched dispatch (engine.frame_step under vmap)."""
        odos, kfcs = [], []
        for _, odo, kfc, cloud, pixels in reqs:
            ready = odo.set_pcd(cloud, pixels)
            assert ready, "cvo not initialized"
            ready = kfc.set_pcd(cloud, pixels)
            assert ready, "cvo not initialized"
            odos.append(odo)
            kfcs.append(kfc)
        prev = _stack([c.fixed for c in odos])
        kf = _stack([c.fixed for c in kfcs])
        cur = _stack([c.moving for c in odos])
        R0 = jnp.asarray(np.stack([c.R for c in odos]))
        T0 = jnp.asarray(np.stack([c.T for c in odos]))
        ell_o = jnp.asarray(np.array([c.start_ell() for c in odos], np.float32))
        ktr = jnp.asarray(np.stack([c.transform for c in kfcs]
                                   ).astype(np.float32))
        ell_k = jnp.asarray(np.array([c.start_ell() for c in kfcs], np.float32))
        res1, ip1, res2, ip2, _ = _batched_frame(
            prev, kf, cur, R0, T0, ell_o, ktr, ell_k, self.params,
            self.backend)
        h1, hip1, h2, hip2 = jax.device_get(
            (tuple(res1), ip1, tuple(res2), ip2))
        out = []
        for j, (odo, kfc) in enumerate(zip(odos, kfcs)):
            T1 = odo._apply_align(*(a[j] for a in h1))
            T2 = kfc._apply_align(*(a[j] for a in h2))
            out.append((T1, {k: v[j] for k, v in hip1.items()},
                        T2, {k: v[j] for k, v in hip2.items()}))
        return out

    def run_ip(self, reqs):
        """reqs: [("ip", cvo, tran), ...] -> [ip dict, ...]."""
        cvos = [r[1] for r in reqs]
        fixed = _stack([c.fixed for c in cvos])
        moving = _stack([c.moving for c in cvos])
        tran = jnp.asarray(np.stack([np.asarray(r[2], np.float32)
                                     for r in reqs]))
        # NOTE: the ip pass uses the CURRENT (post-align, annealed) ell —
        # same as the solo Cvo.compute_innerproduct — not the align start
        ell = jnp.asarray(np.array([c.ell for c in cvos], np.float32))
        out = _batched_ip(fixed, moving, tran, ell, self.params)
        host = {k: np.asarray(v) for k, v in out.items()}
        return [{k: v[j] for k, v in host.items()} for j in range(len(cvos))]


class MultiSequenceTracker:
    """S KeyframeTrackers advanced in lockstep with batched device math.

    only_tracking is controlled by cfg.OnlyTracking exactly as in solo runs;
    with a backend, each sequence gets its own full KeyframeGraph (features,
    loop closure, windowed/final BA)."""

    def __init__(self, cam: CameraConfig, cfg: SlamConfig, n_seq: int,
                 backend: str = "auto"):
        from ..app.run_slam import build_tracker
        self.cam = cam
        self.cfg = cfg
        self.n = n_seq
        self.backend = engine.default_backend() if backend == "auto" \
            else backend
        self.trackers = []
        for _ in range(n_seq):
            t = build_tracker(cam, cfg)
            t.init()
            # solo fallbacks inside the trackers should use the same backend
            t.lt.cvo_odometry.backend = self.backend
            t.lt.cvo_keyframe.backend = self.backend
            self.trackers.append(t)
        self._exec = _BatchExecutor(cfg.cvo, self.backend)

    def force_keyframe(self):
        for t in self.trackers:
            t.force_keyframe()

    # ------------------------------------------------------------------
    def update(self, images: List[ImagePair]) -> List[np.ndarray]:
        """Advance all sequences by one frame; returns per-sequence poses."""
        assert len(images) == self.n
        gens = [t.update_steps(img) for t, img in zip(self.trackers, images)]
        poses: List = [None] * self.n
        pending: List = [None] * self.n

        def advance(i, send_val, first=False):
            try:
                pending[i] = gens[i].send(None if first else send_val)
            except StopIteration as e:
                poses[i] = e.value
                pending[i] = None

        for i in range(self.n):
            advance(i, None, first=True)

        while any(p is not None for p in pending):
            # batch every same-kind request currently pending; sequences at
            # a different phase (e.g. bootstrap) simply wait for their kind's
            # round — lockstep is the common case, mixed phases stay correct
            for kind, runner in (("frame", self._exec.run_frame),
                                 ("align_ip", self._exec.run_align_ip),
                                 ("align", self._exec.run_align),
                                 ("ip", self._exec.run_ip)):
                idxs = [i for i, r in enumerate(pending)
                        if r is not None and r[0] == kind]
                if not idxs:
                    continue
                results = runner([pending[i] for i in idxs])
                for i, res in zip(idxs, results):
                    advance(i, res)
        return poses
