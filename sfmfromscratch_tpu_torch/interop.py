"""State that crosses between the JAX package and the port.

The two-view path has no learned weights; what crosses is configuration and
intermediate state. Nothing here imports JAX: the JAX side's configs arrive
as ``dataclasses.asdict(...)`` dicts and its arrays as anything
``np.asarray`` accepts.
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
from sfmfromscratch_tpu_torch.types import Features, Keypoints, MatchResult

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


def to_numpy(nt: NamedTuple):
    """A NamedTuple of tensors (nested allowed) -> the same type with numpy
    leaves."""
    return type(nt)(*(
        to_numpy(v) if isinstance(v, tuple) else v.detach().cpu().numpy() for v in nt
    ))
