"""The comparison that decides a run's ``correct``.

Each compared job is judged after the window by the plain reference
(``reference/``), on the job's own JPEG files and the scene's ground truth,
never on anything the program derived:

* ``kp_off``: front end (Harris, NMS, top-k, subpixel, pyramid). The share
  of the endpoints of the program's kept matches that are no keypoint of
  the reference's (none within ``POS_TOL_PX``).
* ``match_off``: descriptors and ratio test. The share of the program's
  kept matches that the reference's ratio test does not make between the
  same two keypoints.
* ``epi_bad``: the F-RANSAC filter. The share of the kept matches of the
  filtered pairs farther than ``EPI_PX`` from the ground truth's epipolar
  lines.
* ``rot_deg``: pose geometry. The worst rotation error of a camera
  against the ground truth, relative to the first image's camera.
* ``ate_rel``: camera centres against the ground truth after a similarity
  alignment, over the ground truth's extent.
* ``reproj_med_px`` (and the mean, ``reproj_px``): triangulation and BA.
  The returned map's reprojection error, recomputed from its poses,
  points, observations and K: the median observation's, and the mean.
* ``image1_med_px`` (incremental engine): the bootstrap's points projected
  through the first image's camera, which bundle adjustment never sees,
  against the pair (1, 2) matches they were triangulated from: the median.
  A wrong second camera, or points that BA slid along its rays, lands them
  off those pixels.
* ``behind_share``: the share of the map's observations whose point lies
  behind the camera that observes it (the decomposition that cheirality
  rejects reprojects as well as the right one).

A cell's ``limits`` name the numbers it compares. A run's number is the
worst over its compared jobs; a job that failed (raised, or registered
fewer cameras than its images call for) makes the run incorrect by itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from portbench.reference import frontend as ref_front
from portbench.reference import geometry as ref_geo

POS_TOL_PX = 0.01     # a kept match's endpoint is the reference's keypoint within this
EPI_PX = 2.0          # a kept match farther from the true epipolar line is an outlier


def _nearest(tree_xy: np.ndarray, q: np.ndarray):
    """(distance, index) of each query's nearest point of ``tree_xy``."""
    from scipy.spatial import cKDTree

    if len(tree_xy) == 0:
        return np.full(len(q), np.inf), np.zeros(len(q), np.int64)
    d, i = cKDTree(tree_xy).query(q)
    return d, i


def front_counts(ref_xy, ref_mask, ref_matches, kept) -> Dict[str, float]:
    """Counts behind ``kp_off`` and ``match_off``. ``kept``
    maps a pair (i, j) of 1-based image ids to the (p1, p2) endpoints of the
    program's kept matches."""
    ends = ends_off = n_kept = kept_off = 0
    for (i, j), (p1, p2) in kept.items():
        valid_i, valid_j = np.nonzero(ref_mask[i - 1])[0], np.nonzero(ref_mask[j - 1])[0]
        d1, a = _nearest(ref_xy[i - 1][valid_i], p1)
        d2, b = _nearest(ref_xy[j - 1][valid_j], p2)
        on1, on2 = d1 <= POS_TOL_PX, d2 <= POS_TOL_PX
        a = valid_i[a] if len(valid_i) else a
        b = valid_j[b] if len(valid_j) else b
        nn, ok = ref_matches[(i, j)]
        made = on1 & on2 & ok[a] & (nn[a] == b)
        ends += 2 * len(p1)
        ends_off += int(np.sum(~on1) + np.sum(~on2))
        n_kept += len(p1)
        kept_off += int(np.sum(~made))
    return dict(ends=ends, ends_off=ends_off, kept=n_kept, kept_off=kept_off)


def program_matches(pair_geometry) -> Dict:
    """The (p1, p2) endpoints of the program's kept matches of each pair (i < j)."""
    out = {}
    for (i, j), pg in pair_geometry.items():
        if i < j:
            m = np.asarray(pg.mask, bool)
            out[(i, j)] = (np.asarray(pg.p1, np.float64)[m], np.asarray(pg.p2, np.float64)[m])
    return out


def share(num: int, den: int) -> float:
    return float(num) / den if den else 0.0


def reprojection_px(rec) -> np.ndarray:
    """Every observation's reprojection error in the returned map."""
    frames, tracks, xy = rec.observations
    return ref_geo.reprojection_px([rv for rv, _ in rec.poses], [t for _, t in rec.poses],
                                   rec.Ks, rec.points, frames, tracks, xy)


def bootstrap_matches(rec):
    """(track ids, image-1 pixels) of the incremental engine's bootstrap:
    its tracks come first in the map, each first seen in image 2 (the BA's
    camera 0) at the image-2 end of a pair (1, 2) match, in the match
    table's order."""
    frames, tracks, xy = rec.observations
    n = 0
    while n < len(tracks) and tracks[n] == n and frames[n] == 0:
        n += 1
    pg = rec.pair_geometry.get((1, 2))
    if pg is None or n == 0:
        return np.zeros(0, np.int64), np.zeros((0, 2))
    rows = np.nonzero(np.asarray(pg.mask, bool))[0]
    p1, p2 = np.asarray(pg.p1, np.float64), np.asarray(pg.p2, np.float64)
    ids, xy1, r = [], [], 0
    for k in range(n):
        while r < len(rows) and not np.array_equal(p2[rows[r]], xy[k]):
            r += 1
        if r == len(rows):
            break
        ids.append(k)
        xy1.append(p1[rows[r]])
        r += 1
    return np.asarray(ids, np.int64), np.asarray(xy1, np.float64).reshape(-1, 2)


def geometry_numbers(rec, scene, filtered_pairs, incremental: bool) -> Dict[str, float]:
    """``epi_bad``, ``rot_deg``, ``ate_rel``, the reprojection numbers and
    ``behind_share`` of one job's returned reconstruction against its
    scene's ground truth."""
    gt = scene.poses
    K = scene.K
    bad = total = 0
    for (i, j) in filtered_pairs:
        pg = rec.pair_geometry[(i, j)]
        m = np.asarray(pg.mask, bool)
        if not m.any():
            continue
        F = ref_geo.fundamental(K, K, *gt[i - 1], *gt[j - 1])
        d = ref_geo.epipolar_px(F, np.asarray(pg.p1)[m], np.asarray(pg.p2)[m])
        bad += int(np.sum(d > EPI_PX))
        total += len(d)
    est = [(ref_geo.rodrigues(rv), np.asarray(t, np.float64)) for rv, t in rec.poses]
    first = rec.first_image - 1
    if first:   # the engine's cameras start after the first image: its camera is the world's
        est = [(np.eye(3), np.zeros(3))] + est
        first = 0
    rot, ate_rel = ref_geo.pose_errors(est, gt[first:first + len(est)])
    err = reprojection_px(rec)
    frames, tracks, _ = rec.observations
    depth = ref_geo.depths([rv for rv, _ in rec.poses], [t for _, t in rec.poses], rec.points,
                           frames, tracks)
    out = dict(epi_bad=share(bad, total), rot_deg=rot, ate_rel=ate_rel,
               reproj_px=float(err.mean()) if len(err) else float("nan"),
               reproj_med_px=float(np.median(err)) if len(err) else float("nan"),
               behind_share=share(int(np.sum(depth <= 0)), len(depth)))
    if incremental:
        ids, xy1 = bootstrap_matches(rec)
        e1 = ref_geo.first_camera_px(K, np.asarray(rec.points)[ids], xy1)
        out["image1_med_px"] = float(np.median(e1)) if len(e1) else float("nan")
    return out


def judge_job(rec, scene, cfg: dict, device) -> Dict[str, float]:
    """Every compared number of one completed job."""
    pairs = sorted(k for k in rec.pair_geometry if k[0] < k[1])
    files = scene.files
    ex, ratio = cfg["extractor"], cfg["matcher"]["ratio_threshold"]
    xy, mask, matches = ref_front.run_front(files, ex, pairs, ratio, device, tf32=False)
    c = front_counts(xy, mask, matches, program_matches(rec.pair_geometry))
    out = dict(kp_off=share(c["ends_off"], c["ends"]), match_off=share(c["kept_off"], c["kept"]))
    incremental = cfg["engine"] == "SfmEngine"
    filtered = [k for k in pairs if not incremental or k != (1, 2)]
    out.update(geometry_numbers(rec, scene, filtered, incremental))
    return out


def sample_jobs(n_done: int, cap: int, seed: int) -> List[int]:
    """The completed jobs compared: all of them up to ``cap``, else ``cap``
    of them drawn from the seed, the first job always among them."""
    if n_done <= cap:
        return list(range(n_done))
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 4])
    rest = rng.choice(np.arange(1, n_done), size=cap - 1, replace=False)
    return sorted([0, *rest.tolist()])


def verdict(per_job: List[Dict[str, float]], limits: Dict[str, Optional[float]],
            failed: int) -> (bool, Dict[str, dict]):
    """(correct, {name: {"value", "limit"}}): each number the worst over the
    compared jobs, against its limit; no failed job, no missing number."""
    table, ok = {}, failed == 0 and len(per_job) > 0
    for name, limit in limits.items():
        vals = [j[name] for j in per_job if name in j]
        value = max(vals) if vals else None
        passed = value is not None and limit is not None and np.isfinite(value) and value <= limit
        ok = ok and bool(passed)
        table[name] = {"value": value, "limit": limit}
    table["failed_jobs"] = {"value": failed, "limit": 0}
    return ok, table
