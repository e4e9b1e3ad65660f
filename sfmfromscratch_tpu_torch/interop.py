"""State that crosses between the JAX package and the port.

The engine has no learned weights; what crosses is configuration and
intermediate state: features, matches, pair geometry, bundle-adjustment
problems, and an engine's map and poses. Nothing here imports JAX: the JAX
side's configs arrive as ``dataclasses.asdict(...)`` dicts and its arrays
as anything ``np.asarray`` accepts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from sfmfromscratch_tpu_torch.config import (
    BundleAdjustConfig,
    ExtractorConfig,
    MatcherConfig,
    PipelineConfig,
    RansacConfig,
)
from sfmfromscratch_tpu_torch.ba.problem import BAProblem
from sfmfromscratch_tpu_torch.types import Features, Keypoints, MatchResult, PairGeometry

_CONFIGS = (ExtractorConfig, MatcherConfig, RansacConfig, BundleAdjustConfig, PipelineConfig)


def config_from_dict(d: dict):
    """The port's config whose field names are exactly the keys of ``d``
    (``dataclasses.asdict`` of any JAX config); nested configs too."""
    keys = set(d)
    for cls in _CONFIGS:
        fields = {f.name: f for f in dataclasses.fields(cls)}
        if set(fields) == keys:
            kwargs = {k: config_from_dict(v) if isinstance(v, dict) else v for k, v in d.items()}
            return cls(**kwargs)
    raise ValueError(f"no config has exactly the fields {sorted(keys)}")


def _t(a: Any, dtype: torch.dtype, device) -> torch.Tensor:
    # np.array copies: arrays that JAX hands over are read-only.
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def keypoints_from_numpy(kp, device="cpu") -> Keypoints:
    """Any object with the fields of ``Keypoints`` -> port ``Keypoints``."""
    return Keypoints(
        x=_t(kp.x, torch.int32, device), y=_t(kp.y, torch.int32, device),
        score=_t(kp.score, torch.float32, device), mask=_t(kp.mask, torch.bool, device),
        xf=_t(kp.xf, torch.float32, device), yf=_t(kp.yf, torch.float32, device),
    )


def features_from_numpy(f, device="cpu") -> Features:
    """Any object with the fields of ``Features`` -> port ``Features``."""
    return Features(keypoints=keypoints_from_numpy(f.keypoints, device),
                    descriptors=_t(f.descriptors, torch.float32, device))


def match_result_from_numpy(m, device="cpu") -> MatchResult:
    """Any object with the fields of ``MatchResult`` -> port ``MatchResult``."""
    return MatchResult(indices=_t(m.indices, torch.int32, device),
                       confidence=_t(m.confidence, torch.float32, device),
                       mask=_t(m.mask, torch.bool, device))


def pair_geometry_from_numpy(pg, device="cpu") -> PairGeometry:
    """Any object with the fields of ``PairGeometry`` -> port ``PairGeometry``
    of tensors."""
    return PairGeometry(
        p1=_t(pg.p1, torch.float32, device), p2=_t(pg.p2, torch.float32, device),
        idx1=_t(pg.idx1, torch.int32, device), idx2=_t(pg.idx2, torch.int32, device),
        mask=_t(pg.mask, torch.bool, device),
        K1=_t(pg.K1, torch.float32, device), K2=_t(pg.K2, torch.float32, device),
    )


def ba_problem_from_numpy(p, device="cpu") -> BAProblem:
    """Any object with the fields of ``BAProblem`` (the JAX one, padded or
    not) -> port ``BAProblem``; indices become int64."""
    return BAProblem(
        cam_params=_t(p.cam_params, torch.float32, device),
        points=_t(p.points, torch.float32, device),
        K=_t(p.K, torch.float32, device),
        obs_cam=_t(p.obs_cam, torch.int64, device),
        obs_pt=_t(p.obs_pt, torch.int64, device),
        obs_xy=_t(p.obs_xy, torch.float32, device),
        obs_w=_t(p.obs_w, torch.float32, device),
        cam_fixed=_t(p.cam_fixed, torch.bool, device),
        pt_fixed=None if getattr(p, "pt_fixed", None) is None else _t(p.pt_fixed, torch.bool, device),
    )


def import_engine_state(engine, source) -> None:
    """Copy a JAX engine's reconstruction (``source``: its ``map``,
    ``global_poses``, ``global_K`` and ``pair_geometry``) into the port's
    ``engine``, e.g. to run the port's bundle adjustment on the JAX front's
    result."""
    from sfmfromscratch_tpu_torch.pipeline.tracks import MapStore

    engine.map = MapStore.from_arrays(source.map.points(), *source.map.observations())
    engine.global_poses = [(np.array(rv, np.float64), np.array(t, np.float64))
                           for rv, t in source.global_poses]
    engine.global_K = [np.array(K, np.float64) for K in source.global_K]
    engine.pair_geometry = {k: PairGeometry(*(np.array(v) for v in pg))
                            for k, pg in source.pair_geometry.items()}


# The global engine's view-graph state, stage by stage: the edges with their
# relative poses and weights, inlier sets and stashed homography runner-ups;
# the averaged rotations and centres; the tracks' observation lists.
_GLOBAL_STATE = ("_edges", "_edge_R", "_edge_t", "_edge_w", "_edge_inl", "_edge_alt",
                 "R_cams", "c_cams", "_num_points", "_obs_cam", "_obs_kp", "_obs_pt",
                 "_obs_xy", "_kp_xy")


def _copy_host(v):
    if isinstance(v, dict):
        return {k: _copy_host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_copy_host(x) for x in v)
    if v is None or isinstance(v, (int, float)):
        return v
    return np.array(v)


def import_global_state(engine, source) -> None:
    """Copy a JAX ``GlobalSfmEngine``'s intermediate state into the port's
    ``engine``: its ``pair_geometry``, and every view-graph attribute the
    source has reached (edges and relative poses, edge weights and inlier
    masks, averaged rotations and centres, track observations), as numpy
    copies, so a test can run one of the port's stages on the JAX input."""
    engine.pair_geometry = {k: PairGeometry(*(np.array(v) for v in pg))
                            for k, pg in source.pair_geometry.items()}
    for name in _GLOBAL_STATE:
        if getattr(source, name, None) is not None:
            v = getattr(source, name)
            setattr(engine, name, list(v) if name == "_edges" else _copy_host(v))


def to_numpy(nt: NamedTuple):
    """A NamedTuple of tensors (nested allowed) -> the same type with numpy
    leaves."""
    return type(nt)(*(
        to_numpy(v) if isinstance(v, tuple) else v.detach().cpu().numpy() for v in nt
    ))
