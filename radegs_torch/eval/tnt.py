"""Tanks & Temples F-score evaluation (the eval_tnt/ toolbox protocol).

The port's own copy of ``radegs_tpu/eval/tnt.py``, numpy + scipy as
there, so ``radegs_torch`` imports nothing of the JAX package. The official
pipeline (eval_tnt/run.py: 58-120): camera-trajectory alignment (Umeyama
similarity), uniform + voxel downsampling, point-to-point ICP refinement
(registration.py:134-201), polygon-volume cropping, and EvaluateHisto
precision/recall/F1 at the per-scene tau (evaluation.py:60-171,
config.py:33-41). ``evaluate_tnt(stats=)`` also records the seconds of its
stages.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
from scipy.spatial import cKDTree

# per-scene distance thresholds tau (eval_tnt/config.py:33-41)
SCENE_TAU = {
    "Barn": 0.01, "Caterpillar": 0.005, "Church": 0.025, "Courthouse": 0.025,
    "Ignatius": 0.003, "Meetingroom": 0.01, "Truck": 0.005,
}


def read_trajectory_log(path):
    """Read a TNT .log camera trajectory -> (N,4,4) c2w (trajectory_io.py)."""
    mats = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        rows = [list(map(float, lines[i + 1 + k].split())) for k in range(4)]
        mats.append(np.array(rows))
        i += 5
    return np.stack(mats)


def umeyama(src, dst, with_scale=True):
    """Least-squares similarity transform src -> dst: returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


MAX_POINT_NUMBER = int(4e6)  # registration.py:42


def icp_point_to_point(src, dst, init=np.eye(4), max_iter=20, thresh=0.05,
                       with_scale=True):
    """Point-to-point ICP (the role of open3d registration_icp with
    TransformationEstimationPointToPoint(with_scaling=True),
    registration.py:158-201). Convergence mirrors ICPConvergenceCriteria
    (relative fitness/rmse 1e-6)."""
    tree = cKDTree(dst)
    T = init.copy()
    prev_rmse = None
    for _ in range(max_iter):
        cur = src @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(cur, workers=-1, distance_upper_bound=thresh)
        ok = np.isfinite(d)
        if ok.sum() < 10:
            break
        s, R, t = umeyama(cur[ok], dst[idx[ok]], with_scale=with_scale)
        dT = np.eye(4)
        dT[:3, :3], dT[:3, 3] = s * R, t
        T = dT @ T
        rmse = float(np.sqrt((d[ok] ** 2).mean()))
        if prev_rmse is not None and abs(prev_rmse - rmse) < 1e-6 * max(prev_rmse, 1e-12):
            break
        prev_rmse = rmse
    return T


def uniform_downsample(points, max_points=MAX_POINT_NUMBER):
    """open3d uniform_down_sample equivalent (registration.py:126-131):
    every k-th point with k = round(n / max)."""
    n = len(points)
    if n <= max_points:
        return points
    k = int(round(n / float(max_points)))
    return points[::k]


def registration_two_stage(est, gt, init_T, crop_json, dTau):
    """The official three-call refinement (eval_tnt/run.py:158-162):

      r2 = vol-downsampled ICP  (voxel dTau,   threshold dTau*80, 20 iters)
      r3 = vol-downsampled ICP  (voxel dTau/2, threshold dTau*20, 20 iters)
      r  = uniform-downsampled ICP (threshold 2*dTau, 20 iters)

    Each stage crops both clouds to the scene volume first
    (registration.py:115-132). Returns the refinement transform to apply
    after ``init_T``.
    """
    def cropped(pts, T=None):
        p = pts if T is None else pts @ T[:3, :3].T + T[:3, 3]
        return crop_polygon_volume(p, crop_json) if crop_json else p

    gt_vox1 = voxel_downsample(cropped(gt), dTau)
    gt_vox2 = voxel_downsample(cropped(gt), dTau / 2.0)
    gt_unif = uniform_downsample(cropped(gt))

    T = np.eye(4)

    # stage 1: coarse voxel ICP
    s = voxel_downsample(cropped(est, init_T), dTau)
    T = icp_point_to_point(s, gt_vox1, max_iter=20, thresh=dTau * 80) @ T
    # stage 2: fine voxel ICP
    s = voxel_downsample(cropped(est, T @ init_T), dTau / 2.0)
    T = icp_point_to_point(s, gt_vox2, max_iter=20, thresh=dTau * 20) @ T
    # stage 3: uniform-downsample ICP
    s = uniform_downsample(cropped(est, T @ init_T))
    T = icp_point_to_point(s, gt_unif, max_iter=20, thresh=2 * dTau) @ T
    return T


def align_trajectories(est_c2w, gt_c2w):
    """Similarity transform mapping estimated camera centers onto GT
    (registration.py:66-111 trajectory alignment)."""
    c_est = est_c2w[:, :3, 3]
    c_gt = gt_c2w[:, :3, 3]
    n = min(len(c_est), len(c_gt))
    s, R, t = umeyama(c_est[:n], c_gt[:n], with_scale=True)
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def crop_polygon_volume(points, crop_json):
    """Open3D SelectionPolygonVolume crop (.json with orthogonal_axis "Z",
    axis_min/max, bounding_polygon)."""
    with open(crop_json) as f:
        vol = json.load(f)
    poly = np.asarray(vol["bounding_polygon"])[:, :2]
    zmin, zmax = vol["axis_min"], vol["axis_max"]
    ok_z = (points[:, 2] >= zmin) & (points[:, 2] <= zmax)
    # even-odd ray casting in the XY plane
    x, y = points[:, 0], points[:, 1]
    inside = np.zeros(len(points), bool)
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        cond = ((y1 > y) != (y2 > y)) & (
            x < (x2 - x1) * (y - y1) / (y2 - y1 + 1e-30) + x1
        )
        inside ^= cond
    return points[inside & ok_z]


def voxel_downsample(points, voxel):
    """Mean-of-voxel downsampling (open3d voxel_down_sample equivalent)."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv, points)
    return sums / counts[:, None]


def evaluate_histo(est, gt, tau, plot_stretch=5):
    """EvaluateHisto core (evaluation.py:60-216): precision/recall/F at tau,
    distance quantiles, and the cumulative precision/recall histogram curves
    (get_f1_score_histo2: bins = arange(0, tau*plot_stretch, tau/100))."""
    d_e2g, _ = cKDTree(gt).query(est, workers=-1)
    d_g2e, _ = cKDTree(est).query(gt, workers=-1)
    precision = float((d_e2g < tau).mean())
    recall = float((d_g2e < tau).mean())
    fscore = 2 * precision * recall / max(precision + recall, 1e-12)
    bins = np.arange(0, tau * plot_stretch, tau / 100)
    hist_s, edges_source = np.histogram(d_e2g, bins)
    cum_source = np.cumsum(hist_s).astype(float) / len(d_e2g)
    hist_t, edges_target = np.histogram(d_g2e, bins)
    cum_target = np.cumsum(hist_t).astype(float) / len(d_g2e)
    return {
        "precision": precision,
        "recall": recall,
        "f1": fscore,
        "mean_e2g": float(d_e2g.mean()),
        "mean_g2e": float(d_g2e.mean()),
        "median_e2g": float(np.median(d_e2g)),
        "median_g2e": float(np.median(d_g2e)),
        "edges_source": edges_source,
        "cum_source": cum_source,
        "edges_target": edges_target,
        "cum_target": cum_target,
    }


def plot_pr_curves(scene, result, out_dir, plot_stretch=5):
    """PR-curve figure matching eval_tnt/plot.py:40-107 (precision red,
    recall blue, tau dashed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tau = result["tau"]
    f = plt.figure()
    ax = plt.subplot(111)
    ax.plot(result["edges_source"][1:], result["cum_source"] * 100, c="red",
            label="precision", linewidth=2.0)
    ax.plot(result["edges_target"][1:], result["cum_target"] * 100, c="blue",
            label="recall", linewidth=2.0)
    ax.grid(True)
    plt.title(f"Precision and Recall: {scene}, {result['f1'] * 100:02.2f} f-score")
    plt.axvline(x=tau, c="black", ls="dashed", linewidth=2.0)
    plt.ylabel("# of points (%)", fontsize=15)
    plt.xlabel("Meters", fontsize=15)
    plt.axis([0, tau * plot_stretch, 0, 100])
    ax.legend(loc="lower right")
    name = os.path.join(out_dir, "PR_{0}_@d_th_0_{1}.png".format(scene, "%04d" % (tau * 10000)))
    f.savefig(name, format="png", bbox_inches="tight")
    plt.close(f)
    return name


def evaluate_tnt(scene_name, est_points, gt_points, est_traj=None, gt_traj=None,
                 crop_json=None, tau=None, icp_refine=True, out_dir=None,
                 plot_stretch=5, stats=None):
    """Full protocol (eval_tnt/run.py:58-192): trajectory alignment, the
    official three-stage ICP refinement (coarse voxel -> fine voxel ->
    uniform, run.py:158-162), crop, voxel-downsample both clouds at tau/2
    (run.py:181), EvaluateHisto at tau with cumulative PR curves + plots.
    ``stats``: a dict that receives the host seconds of the registration
    (``registration_s``), the crop and downsample (``downsample_s``) and
    the KD-tree queries of EvaluateHisto (``histo_s``), and the transform
    applied to the estimate (``transform``)."""
    tau = tau if tau is not None else SCENE_TAU.get(scene_name, 0.01)
    stats = {} if stats is None else stats

    t0 = time.perf_counter()
    T = np.eye(4)
    if est_traj is not None and gt_traj is not None:
        T = align_trajectories(est_traj, gt_traj)
    if icp_refine:
        T = registration_two_stage(est_points, gt_points, T, crop_json, tau) @ T
    t1 = time.perf_counter()
    est = est_points @ T[:3, :3].T + T[:3, 3]
    if crop_json is not None:
        est = crop_polygon_volume(est, crop_json)
        gt_points = crop_polygon_volume(gt_points, crop_json)
    # EvaluateHisto downsamples BOTH clouds at tau/2 (run.py:181)
    est = voxel_downsample(est, tau / 2.0)
    gt_d = voxel_downsample(gt_points, tau / 2.0)
    t2 = time.perf_counter()
    histo = evaluate_histo(est, gt_d, tau, plot_stretch)
    stats.update(registration_s=t1 - t0, downsample_s=t2 - t1,
                 histo_s=time.perf_counter() - t2, transform=T)
    result = {"scene": scene_name, "tau": tau, **histo}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # the reference's txt dumps (evaluation.py:155-160)
        np.savetxt(os.path.join(out_dir, f"{scene_name}.recall.txt"), histo["cum_target"])
        np.savetxt(os.path.join(out_dir, f"{scene_name}.precision.txt"), histo["cum_source"])
        np.savetxt(
            os.path.join(out_dir, f"{scene_name}.prf_tau_plotstr.txt"),
            np.array([histo["precision"], histo["recall"], histo["f1"], tau, plot_stretch]),
        )
        try:
            plot_pr_curves(scene_name, result, out_dir, plot_stretch)
        except Exception as e:  # matplotlib optional
            print(f"[eval_tnt] PR plot skipped: {e}")
        scalars = {k: v for k, v in result.items() if not isinstance(v, np.ndarray)}
        with open(os.path.join(out_dir, f"{scene_name}_results.json"), "w") as f:
            json.dump(scalars, f, indent=2)
    return result
