"""Feature frontend: scale/rotation-invariant RootSIFT over an image pyramid,
plus the two-image ``FeatureRunner`` (counterpart of
``sfmfromscratch_tpu/pipeline/frontend.py``).

Harris responses go through the Harris kernel's wrapper and the matcher core
through the matcher kernel's wrapper, so on the card both CUDA kernels run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sfmfromscratch_tpu_torch.config import ExtractorConfig, MatcherConfig
from sfmfromscratch_tpu_torch.ops.harris import detect_harris_keypoints
from sfmfromscratch_tpu_torch.ops.image import build_pyramid, resize_bilinear, rgb_to_gray
from sfmfromscratch_tpu_torch.ops.matcher import match_ratio_test
from sfmfromscratch_tpu_torch.ops.sift import sift_descriptors
from sfmfromscratch_tpu_torch.types import Features, Keypoints, MatchResult
from sfmfromscratch_tpu_torch.utils.device import resolve_device


def extract_features_single_scale(
    image_bw: torch.Tensor,
    cfg: ExtractorConfig,
    k: Optional[int] = None,
    feature_width: Optional[int] = None,
    rotation_invariant: bool = False,
) -> Features:
    """NaiveSIFT-equivalent: Harris + RootSIFT at one scale
    (reference NaiveSIFT.py:9-213)."""
    k = k or cfg.num_interest_points
    fw = feature_width or cfg.feature_width
    kps = detect_harris_keypoints(
        image_bw, k=k, feature_width=fw, nms_ksize=cfg.ksize,
        gaussian_size=cfg.gaussian_size, sigma=cfg.sigma, alpha=cfg.alpha,
    )
    desc = sift_descriptors(
        image_bw, kps.x, kps.y, kps.mask, feature_width=fw,
        rotation_invariant=rotation_invariant,
    )
    return Features(keypoints=kps, descriptors=desc)


def extract_features(image_bw: torch.Tensor, cfg: ExtractorConfig) -> Features:
    """ScaleRotInvSIFT-equivalent: per-pyramid-level Harris + rotation-invariant
    RootSIFT, keypoint coordinates rescaled to level-0 pixels
    (reference ScaleRotInvSIFT.py:89-107). Capacity is
    ``(k // levels) * levels`` slots. A (B, H, W) stack gives Features with a
    leading image axis, and the Harris kernel runs once per level for the
    whole stack."""
    levels = build_pyramid(image_bw, cfg.pyramid_level, cfg.pyramid_scale_factor)
    per_level_k = int(cfg.num_interest_points / cfg.pyramid_level)
    min_fw = 3

    xs, ys, xfs, yfs, scores, masks, descs = [], [], [], [], [], [], []
    for level, img in enumerate(levels):
        scale = cfg.pyramid_scale_factor ** level
        fw = max(int(cfg.feature_width / scale), min_fw)
        feats = extract_features_single_scale(
            img, cfg, k=per_level_k, feature_width=fw, rotation_invariant=True
        )
        kp = feats.keypoints
        # float32 product truncated toward zero, as XLA's f32 -> int32 cast.
        xs.append((kp.x.float() * scale).to(torch.int32))
        ys.append((kp.y.float() * scale).to(torch.int32))
        xfs.append(kp.xf * scale)
        yfs.append(kp.yf * scale)
        scores.append(kp.score)
        masks.append(kp.mask)
        descs.append(feats.descriptors)

    kps = Keypoints(
        x=torch.cat(xs, -1), y=torch.cat(ys, -1), score=torch.cat(scores, -1),
        mask=torch.cat(masks, -1), xf=torch.cat(xfs, -1), yf=torch.cat(yfs, -1),
    )
    return Features(keypoints=kps, descriptors=torch.cat(descs, -2))


def extract_features_batch(images_bw: torch.Tensor, cfg: ExtractorConfig) -> Features:
    """(B, H, W) images -> Features with a leading batch axis, each image's
    features equal to ``extract_features`` of that image alone. The JAX
    package's chunks and power-of-two buckets exist for XLA's compile cache
    only; here the whole stack is one batch."""
    if images_bw.dim() != 3:
        raise ValueError(f"expected a (B, H, W) stack, got shape {tuple(images_bw.shape)}")
    return extract_features(images_bw, cfg)


def preprocess_image(
    img: Union[np.ndarray, torch.Tensor], scale_factor: float, device=None
) -> torch.Tensor:
    """Host decode output -> scaled grayscale float32 tensor on ``device``
    (reference Runner.py:33-46: load, resize by scale_factor, rgb2gray)."""
    arr = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device)
    if arr.dim() == 3:
        arr = rgb_to_gray(arr)
    if scale_factor != 1.0:
        h, w = arr.shape
        arr = resize_bilinear(arr, (int(h * scale_factor), int(w * scale_factor)))
    return arr


def preprocess_image_batch(imgs: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Batched ``preprocess_image``: (B, H, W[, 3]) stacked decodes -> (B, h, w)
    grayscale. uint8 input becomes [0, 1] as ``x * float32(1/255)``, the
    canonical form of the JAX package (``frontend.py:158-166``), which is
    bit-identical between host numpy and the device."""
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) * np.float32(1.0 / 255.0)
    else:
        imgs = imgs.to(torch.float32)
    if imgs.dim() == 4:
        imgs = rgb_to_gray(imgs)
    if scale_factor != 1.0:
        h, w = imgs.shape[1], imgs.shape[2]
        imgs = resize_bilinear(imgs, (int(h * scale_factor), int(w * scale_factor)))
    return imgs


@dataclasses.dataclass
class FeatureRunner:
    """Two-view feature pipeline: load -> resize -> gray -> extract -> match
    (reference Runner.py:22-115), on decoded arrays or file paths."""

    features1: Features
    features2: Features
    matches: MatchResult
    image1_bw: torch.Tensor
    image2_bw: torch.Tensor

    @classmethod
    def run(
        cls,
        im1,
        im2,
        cfg: ExtractorConfig,
        matcher_cfg: MatcherConfig = MatcherConfig(),
        scale_factor: float = 0.5,
        device=None,
    ) -> "FeatureRunner":
        """``device=None`` runs on the CUDA card and raises without one."""
        from sfmfromscratch_tpu_torch.io.images import load_image

        dev = resolve_device(device)
        if isinstance(im1, str):
            im1 = load_image(im1)
        if isinstance(im2, str):
            im2 = load_image(im2)
        g1 = preprocess_image(im1, scale_factor, dev)
        g2 = preprocess_image(im2, scale_factor, dev)
        f1 = extract_features(g1, cfg)
        f2 = extract_features(g2, cfg)
        matches = match_ratio_test(
            f1.descriptors, f2.descriptors, f1.keypoints.mask, f2.keypoints.mask,
            ratio_threshold=matcher_cfg.ratio_threshold,
            max_matches=matcher_cfg.max_matches,
        )
        return cls(features1=f1, features2=f2, matches=matches, image1_bw=g1, image2_bw=g2)


def matches_to_coords(
    matches: MatchResult, f1: Features, f2: Features, num_matches: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-``num_matches`` match indices -> (p1, p2, mask) integer-pixel
    coordinates as float32 (reference Runner.py:423-434)."""
    idx = matches.indices[:num_matches].long()
    m = matches.mask[:num_matches]
    kp1, kp2 = f1.keypoints, f2.keypoints
    p1 = torch.stack([kp1.x[idx[:, 0]].float(), kp1.y[idx[:, 0]].float()], dim=-1)
    p2 = torch.stack([kp2.x[idx[:, 1]].float(), kp2.y[idx[:, 1]].float()], dim=-1)
    return p1, p2, m
