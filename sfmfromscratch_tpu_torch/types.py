"""Fixed-capacity masked containers as NamedTuples of tensors
(counterparts of ``sfmfromscratch_tpu/types.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Keypoints(NamedTuple):
    """Detected interest points, capacity-K with validity mask."""

    x: torch.Tensor       # (K,) int32 pixel column (level-0 coords)
    y: torch.Tensor       # (K,) int32 pixel row
    score: torch.Tensor   # (K,) float32 detector response
    mask: torch.Tensor    # (K,) bool
    xf: torch.Tensor      # (K,) float32 subpixel-refined column
    yf: torch.Tensor      # (K,) float32 subpixel-refined row

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]


class Features(NamedTuple):
    """Keypoints plus their descriptors."""

    keypoints: Keypoints
    descriptors: torch.Tensor  # (K, 128) float32


class MatchResult(NamedTuple):
    """Fixed-capacity matches, best-first. ``indices[:, 0]`` indexes
    features1, ``indices[:, 1]`` features2."""

    indices: torch.Tensor      # (M, 2) int32
    confidence: torch.Tensor   # (M,) float32 NN distance ratio
    mask: torch.Tensor         # (M,) bool


class PairGeometry(NamedTuple):
    """Per-image-pair matched pixel coordinates and intrinsics, keeping the
    keypoint indices that link tracks across pairs. The engine keeps numpy
    arrays here (its host record); ``interop.pair_geometry_from_numpy``
    makes tensors."""

    p1: torch.Tensor        # (M, 2) float32 pixel coords in image 1
    p2: torch.Tensor        # (M, 2) float32 pixel coords in image 2
    idx1: torch.Tensor      # (M,) int32 keypoint index in image 1
    idx2: torch.Tensor      # (M,) int32 keypoint index in image 2
    mask: torch.Tensor      # (M,) bool
    K1: torch.Tensor        # (3, 3)
    K2: torch.Tensor        # (3, 3)
