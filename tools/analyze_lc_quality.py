"""Correlate loop-closure edge QUALITY (measurement error vs ground truth)
with the acceptance diagnostics (inner-product margin, cos_angle, matches)
— the evidence base for the fast_rotation information-scaling fix.

Usage: python tools/analyze_lc_quality.py <seq_folder> [...]
Each folder needs loop_closure.txt, groundtruth.txt.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy.spatial.transform import Rotation


def load_gt(folder):
    gt = {}
    with open(os.path.join(folder, "groundtruth.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.split()
            if len(v) < 8:
                continue
            t = np.array([float(x) for x in v[1:4]])
            q = np.array([float(x) for x in v[4:8]])
            P = np.eye(4)
            P[:3, :3] = Rotation.from_quat(q).as_matrix()
            P[:3, 3] = t
            gt[v[0]] = P
    return gt


def main():
    for folder in sys.argv[1:]:
        gt = load_gt(folder)
        path = os.path.join(folder, "loop_closure.txt")
        if not os.path.exists(path):
            print(f"{folder}: no loop_closure.txt")
            continue
        rows = []
        with open(path) as f:
            for line in f:
                v = line.split()
                if len(v) < 62:
                    continue
                ts_i, ts_j = v[2], v[3]
                meas = np.array([float(x) for x in v[4:11]])
                Z = np.eye(4)
                Z[:3, :3] = Rotation.from_quat(meas[3:]).as_matrix()
                Z[:3, 3] = meas[:3]
                score = float(v[47])
                matches = float(v[48])
                inn_prior, inn_lc_prior, inn_post = (float(v[49]),
                                                     float(v[50]),
                                                     float(v[51]))
                cos_angle = float(v[61])
                # ground-truth edge error: e = log(Z^-1 P_i^-1 P_j)
                def key(ts):
                    if ts in gt:
                        return ts
                    # nearest timestamp
                    tsf = float(ts)
                    return min(gt, key=lambda k: abs(float(k) - tsf))
                Pi, Pj = gt[key(ts_i)], gt[key(ts_j)]
                Err = np.linalg.inv(Z) @ np.linalg.inv(Pi) @ Pj
                rot_err = np.linalg.norm(
                    Rotation.from_matrix(Err[:3, :3]).as_rotvec())
                trans_err = np.linalg.norm(Err[:3, 3])
                margin = inn_post / max(inn_prior, inn_lc_prior, 1e-12)
                rows.append((trans_err, rot_err, margin, cos_angle,
                             matches, score))
        rows.sort(reverse=True)
        print(f"\n== {folder}: {len(rows)} LC edges "
              f"(sorted by translation error vs GT)")
        print(f"{'trans_err':>10} {'rot_err':>9} {'margin':>8} "
              f"{'cos_ang':>8} {'matches':>8} {'score':>7}")
        for r in rows[:15]:
            print(f"{r[0]:10.4f} {r[1]:9.4f} {r[2]:8.3f} {r[3]:8.3f} "
                  f"{r[4]:8.0f} {r[5]:7.3f}")
        te = np.array([r[0] for r in rows])
        mg = np.array([r[2] for r in rows])
        ca = np.array([r[3] for r in rows])
        mt = np.array([r[4] for r in rows])
        if len(rows) > 3:
            print(f"corr(trans_err, margin)  = {np.corrcoef(te, mg)[0,1]:+.3f}")
            print(f"corr(trans_err, cos_ang) = {np.corrcoef(te, ca)[0,1]:+.3f}")
            print(f"corr(trans_err, matches) = {np.corrcoef(te, mt)[0,1]:+.3f}")
            print(f"median trans_err {np.median(te):.4f}  "
                  f"p90 {np.percentile(te, 90):.4f}  max {te.max():.4f}")


if __name__ == "__main__":
    main()
