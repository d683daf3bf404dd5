"""Loop-closure detection: BoW top-10 candidates -> ORB/RANSAC prior -> CVO
verification.

Re-expression of reference detectLoopClousure_top10
(/root/reference/src/keyframe_graph.cpp:601-746): score the new keyframe
against every earlier keyframe except the last two, visit the 10 best; for
each candidate run the ORB matcher's RANSAC pipeline for an initial transform,
re-register with a FRESH CVO instance seeded with that prior
(reset_initial(lc_prior) -> set_pcd(ref cloud) -> match_keyframe(cand cloud))
and accept iff the CVO posterior inner product exceeds the pre/prior/lc-prior
inner products and cos_angle >= 0.1 (:703-714). Accepted edges go into the
global graph with the eigenvalue-floored Hessian as information.

Host/device restructuring: the reference's fully sequential
per-candidate pipeline becomes a host/device PIPELINE — the descriptor
matching for all candidates is dispatched to the device up front
(features.matcher.dispatch_match_bow), and each candidate's CVO
re-registration (engine.lc_verify_batch, one lane) is dispatched the moment
its host RANSAC finishes, so the device verifies candidate k while the host
runs RANSAC for candidate k+1; async copies land before the fetch phase
blocks. Host phases (matcher RANSAC with its landmark side effects, accept
tests, edge insertion) keep the reference's sequential order and semantics.

Reference quirks kept: the pnpransac prior transform is never assigned in the
active code (uninitialized in C++); we pass identity. The per-round
covisibility state feeds GetBestCovisibleKeyframeList at the end.
"""

from __future__ import annotations

import threading

import numpy as np

from ..config import CameraConfig, SlamConfig
from ..cvo import engine
from ..features.bow import Vocabulary
from ..features.matcher import Matcher
from ..tracking.types import Keyframe, TrackingResult

# candidate-count buckets for the batched verification dispatch (top-10 BoW
# candidates, keyframe_graph.cpp:622) — bounds distinct compiled shapes
_LC_BUCKETS = (1, 2, 4, 10)


def _bucket(n: int) -> int:
    for b in _LC_BUCKETS:
        if n <= b:
            return b
    return _LC_BUCKETS[-1]


def _verify_dispatch(reference: Keyframe, cand_kf, prior, lc_prior, params,
                     backend: str):
    """Dispatch ONE candidate's CVO re-registration + innerproduct_lc and
    start its async device->host copies; returns the future tree. Called
    right after the candidate's host RANSAC so the device verifies candidate
    k while the host runs RANSAC for candidate k+1 (a batched dispatch after
    the loop would serialize the whole host phase before any device
    work)."""
    import jax.numpy as jnp

    inv = np.linalg.inv(np.asarray(lc_prior, np.float64))
    c = cand_kf.cloud
    movings = engine.PointCloud(c.positions[None], c.features[None],
                                c.mask[None])
    res, lc = engine.lc_verify_batch(
        reference.cloud, movings,
        jnp.asarray(inv[:3, :3], jnp.float32)[None],
        jnp.asarray(inv[:3, 3], jnp.float32)[None],
        jnp.full(1, params.ell_init, jnp.float32),
        jnp.asarray(prior, jnp.float32)[None],
        jnp.asarray(lc_prior, jnp.float32)[None],
        params, backend)
    return engine.start_host_transfer((tuple(res), lc))


def _verify_fetch(fut):
    """Blocking fetch of a _verify_dispatch future ->
    (transform f64, lc dict of host scalars)."""
    import jax
    host_res, host_lc = jax.device_get(fut)
    T = np.asarray(host_res[2], np.float64)[0]   # AlignResult.transform
    return T, {k: v[0] for k, v in host_lc.items()}


def make_loop_detector(cam: CameraConfig, cfg: SlamConfig, vocabulary=None):
    matcher = Matcher(cam, cfg, scale_factor=cam.orb_scale_factor,
                      n_levels=cam.orb_n_levels)
    backend = engine.default_backend()
    refresh_thread = [None]

    def _refresh_stale(keyframes):
        """Re-transform BoW vectors built under an older vocabulary (the
        growing vocabulary retrains as the map expands; see features.bow).
        O(total descriptors) once per retrain."""
        if vocabulary is None:
            return
        ver = getattr(vocabulary, "version", 0)
        for kf in keyframes:
            if kf.descriptors is not None and len(kf.descriptors) \
                    and getattr(kf, "bow_version", 0) != ver:
                kf.bow_vec, kf.feat_vec = vocabulary.transform(
                    kf.descriptors, levelsup=4)
                kf.bow_version = ver

    def prefetch(graph):
        """Start the post-retrain BoW refresh on a worker thread. Called by
        KeyframeGraph at the top of a keyframe event so the O(keyframes)
        host re-transform overlaps the device-side local-map optimize
        instead of stalling the loop-closure round."""
        if vocabulary is None or refresh_thread[0] is not None:
            return
        kfs = list(graph.keyframes())
        ver = getattr(vocabulary, "version", 0)
        if not any(kf.descriptors is not None and len(kf.descriptors)
                   and getattr(kf, "bow_version", 0) != ver for kf in kfs):
            return
        t = threading.Thread(target=_refresh_stale, args=(kfs,), daemon=True)
        t.start()
        refresh_thread[0] = t

    def warmup(buckets=(1,)):
        """Pre-compile the LC-verification executable(s) on dummy all-masked
        clouds (meant for the startup background thread, app.run_slam).
        The live detector dispatches per candidate (bucket 1, overlapped
        with the host RANSAC); pass other bucket sizes to pre-compile the
        vmapped batch path too. Dummy clouds converge in one align
        iteration, so execution cost is negligible — only the
        compile/cache-load matters."""
        import jax
        import jax.numpy as jnp
        # warm the device descriptor-match kernel at the typical padded
        # shape (the ORB budget rounds up to the same 512 multiple for
        # every keyframe) — its first execution otherwise stalls the first
        # LC round
        if jax.default_backend() != "cpu":
            from ..features import matcher as matcher_mod
            n_feat = cam.orb_n_features
            dummy = Keyframe(id=-1, timestamp="", pose=np.eye(4))
            dummy.descriptors = np.zeros((n_feat, 32), np.uint8)
            dummy.kp_angle = np.zeros(n_feat)
            dummy.feat_vec = {0: list(range(n_feat))}
            fut = matcher_mod.dispatch_match_bow(dummy, dummy, force=True)
            if fut is not None:
                matcher_mod.fetch_match_bow(fut, dummy, dummy,
                                            cfg.LC_MatchThreshold)
        cap_pts = cfg.frontend.cloud_capacity
        fixed = engine.PointCloud(
            jnp.zeros((cap_pts, 3), jnp.float32),
            jnp.zeros((cap_pts, 5), jnp.float32),
            jnp.zeros(cap_pts, bool))
        eye = np.eye(4, dtype=np.float32)
        for b in (buckets or _LC_BUCKETS):
            movings = engine.PointCloud(
                jnp.zeros((b, cap_pts, 3), jnp.float32),
                jnp.zeros((b, cap_pts, 5), jnp.float32),
                jnp.zeros((b, cap_pts), bool))
            engine.lc_verify_batch(
                fixed, movings,
                jnp.tile(jnp.eye(3, dtype=jnp.float32), (b, 1, 1)),
                jnp.zeros((b, 3), jnp.float32),
                jnp.full(b, cfg.cvo.ell_init, jnp.float32),
                jnp.tile(jnp.asarray(eye), (b, 1, 1)),
                jnp.tile(jnp.asarray(eye), (b, 1, 1)),
                cfg.cvo, backend)

    def detect(graph, reference: Keyframe):
        import time as _time
        # lazily attach shared state to the graph
        if not hasattr(graph, "matcher"):
            graph.matcher = matcher
        if not hasattr(graph, "next_mappoint_id"):
            graph.next_mappoint_id = [1]   # odd ids (keyframe_graph.cpp:94)

        keyframes = graph.keyframes()
        new_lc = 0
        farthest = reference.id
        if len(keyframes) <= 2 or reference.bow_vec is None:
            return 0, farthest

        # sub-stage costs in ms, recorded next to the keyframe stage rows
        # (refresh = BoW re-transform join; score = BoW scoring; ransac =
        # host ORB matching + RANSAC + landmark bookkeeping; verify = the
        # batched device dispatch + blocking fetch)
        sub = getattr(graph, "lc_stage_ms", None)
        if sub is None:
            sub = graph.lc_stage_ms = []
        row = {}
        sub.append(row)
        t0 = _time.perf_counter()

        if refresh_thread[0] is not None:
            refresh_thread[0].join()
            refresh_thread[0] = None
        _refresh_stale(keyframes)   # no-op when prefetch already ran
        t1 = _time.perf_counter()
        row["refresh"] = (t1 - t0) * 1e3

        matcher.reset_round()
        scored = []
        for i in range(len(keyframes) - 2):
            cand = keyframes[i]
            if cand.bow_vec is None:
                continue
            s = Vocabulary.score(reference.bow_vec, cand.bow_vec)
            scored.append((s, i))
        scored.sort(reverse=True)
        t2 = _time.perf_counter()
        row["score"] = (t2 - t1) * 1e3

        # phase 1 (host, overlapped with device): ORB matching + RANSAC
        # prior per candidate in BoW-score order (landmark/covisibility side
        # effects are sequential in the reference,
        # keyframe_graph.cpp:628-684); each passing candidate's CVO
        # verification is DISPATCHED immediately, so the device registers
        # candidate k while the host runs RANSAC for candidate k+1, and the
        # async copies land before the fetch phase blocks
        top = [(s, keyframes[i]) for s, i in scored[:10]]
        # dispatch ALL candidates' descriptor matching to the device up
        # front (pure computation, ~1 ms each on-device vs ~100 ms host
        # numpy per 5000x5000 bucket); fetched in order below
        from ..features import matcher as matcher_mod
        match_futs = [matcher_mod.dispatch_match_bow(reference, cand)
                      for _, cand in top]
        cands = []
        for (s, cand), mfut in zip(top, match_futs):
            graph.log(f"Checking keyframe {cand.id} with BoW score {s:.4f}")
            pairs = None
            if mfut is not None:
                pairs = matcher_mod.fetch_match_bow(
                    mfut, reference, cand, cfg.LC_MatchThreshold)
            ok, matches, T_cr = matcher.get_initial_transformation(
                reference, cand, graph.map_points, graph.next_mappoint_id,
                pairs=pairs)
            if not ok:
                continue
            prior = np.linalg.inv(reference.pose) @ cand.pose
            lc_prior = np.asarray(T_cr, np.float64)
            fut = _verify_dispatch(reference, cand, prior, lc_prior,
                                   cfg.cvo, backend)
            cands.append((cand, float(s), matches, lc_prior, prior, fut))
        t3 = _time.perf_counter()
        row["ransac"] = (t3 - t2) * 1e3

        # phase 2 (device fetch): blocking collection of the dispatched
        # verifications, in candidate order
        verified = [_verify_fetch(c[5]) for c in cands]
        cands = [c[:5] for c in cands]
        row["verify"] = (_time.perf_counter() - t3) * 1e3
        row["n_cands"] = len(cands)

        # phase 3 (host): accept tests + edge insertion in candidate order
        # (keyframe_graph.cpp:703-746)
        for (cand, s, matches, lc_prior, prior), (T, lc) in zip(cands,
                                                                verified):
            result = TrackingResult()
            result.score = s
            result.matches = matches
            result.lc_prior = lc_prior
            result.lc_prior_pnpransac = np.eye(4)
            result.transform = T
            result.inn_prior = float(lc["inn_prior"])
            result.inn_lc_prior = float(lc["inn_lc_prior"])
            result.inn_pre = float(lc["inn_lc_pre"])
            result.inn_post = float(lc["inn_lc_post"])
            result.inn_fixed_pcd = float(lc["inn_fixed"])
            result.inn_moving_pcd = float(lc["inn_moving"])
            result.cos_angle = float(lc["cos_angle"])
            result.inliers_svd = int(lc["inliers_svd"])
            result.inliers_pnpransac = int(lc["inliers_pnpransac"])
            result.post_hessian = np.asarray(lc["post_hessian"], np.float64)
            result.information = result.post_hessian.copy()

            if (result.inn_post <= result.inn_pre
                    or result.inn_post <= result.inn_lc_prior
                    or result.inn_post <= result.inn_prior
                    or result.cos_angle < 0.1):
                graph.log("Final transformation: Reject (inner products)")
                continue
            graph.log(f"Accept loop-closure between keyframe {reference.id} "
                      f"and {cand.id}")
            if cand.id < farthest:
                farthest = cand.id
            graph.insert_loop_closure(reference, cand, result)
            new_lc += 1

        matcher.best_covisible(reference)
        return new_lc, farthest

    detect.prefetch = prefetch
    detect.warmup = warmup
    return detect
