"""Two-view reconstruction: the minimum end-to-end slice (BASELINE config 1)
(counterpart of ``sfmfromscratch_tpu/pipeline/two_view.py``).

One call: images -> features -> ratio matches -> essential-matrix RANSAC ->
triangulation -> Gauss-Newton refinement -> (R, t, points, diagnostics).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sfmfromscratch_tpu_torch.config import ExtractorConfig, MatcherConfig, RansacConfig
from sfmfromscratch_tpu_torch.geometry.camera import projection_matrix, two_view_reprojection_error
from sfmfromscratch_tpu_torch.geometry.ransac import ransac_essential_pose
from sfmfromscratch_tpu_torch.geometry.triangulation import refine_points_gn, triangulate_dlt
from sfmfromscratch_tpu_torch.pipeline.frontend import FeatureRunner, matches_to_coords
from sfmfromscratch_tpu_torch.utils.device import resolve_device
from sfmfromscratch_tpu_torch.utils.precision import f32_precision


class TwoViewResult(NamedTuple):
    R: torch.Tensor             # (3, 3) relative rotation (cam1 -> cam2)
    t: torch.Tensor             # (3,) unit translation
    points: torch.Tensor        # (M, 3) triangulated points (masked)
    mask: torch.Tensor          # (M,) valid triangulated inliers
    p1: torch.Tensor            # (M, 2)
    p2: torch.Tensor            # (M, 2)
    num_inliers: torch.Tensor
    mean_reproj_error: torch.Tensor


def reconstruct_two_view(
    im1,
    im2,
    K: np.ndarray,
    extractor: Optional[ExtractorConfig] = None,
    matcher: Optional[MatcherConfig] = None,
    ransac: Optional[RansacConfig] = None,
    scale_factor: float = 1.0,
    seed: int = 5,
    device=None,
) -> TwoViewResult:
    """Full two-view pipeline on one image pair (paths or arrays).

    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU. RANSAC samples come from a
    ``torch.Generator`` seeded with ``seed`` on that device.
    """
    dev = resolve_device(device)
    ecfg = extractor or ExtractorConfig()
    mcfg = matcher or MatcherConfig(ratio_threshold=0.85)
    rcfg = ransac or RansacConfig()

    fr = FeatureRunner.run(im1, im2, ecfg, mcfg, scale_factor=scale_factor, device=dev)
    p1, p2, mask = matches_to_coords(fr.matches, fr.features1, fr.features2,
                                     mcfg.max_matches)
    Kt = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with f32_precision():
        pose = ransac_essential_pose(
            gen, p1, p2, Kt, Kt, mask,
            num_hypotheses=rcfg.num_iterations(),
            threshold=rcfg.epipolar_threshold,
            min_cheirality_frac=0.75,
        )
        P1 = projection_matrix(torch.eye(3, device=dev), torch.zeros(3, device=dev), Kt)
        P2 = projection_matrix(pose.R, pose.t, Kt)
        X = triangulate_dlt(p1, p2, P1, P2)
        X = refine_points_gn(X, p1, p2, P1, P2, mask=pose.inliers, num_iters=8)
        err = two_view_reprojection_error(X, p1, p2, P1, P2, mask=pose.inliers)
    return TwoViewResult(
        R=pose.R, t=pose.t, points=X, mask=pose.inliers, p1=p1, p2=p2,
        num_inliers=pose.num_inliers, mean_reproj_error=err,
    )
