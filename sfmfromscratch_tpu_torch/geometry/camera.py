"""Camera models: intrinsics, projection, reprojection metrics
(counterpart of ``sfmfromscratch_tpu/geometry/camera.py``).

EXIF decoding is host-side numpy/PIL (PIL imported inside the function);
everything numeric is torch and batched.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np
import torch

from sfmfromscratch_tpu_torch.ops.lie import so3_exp
from sfmfromscratch_tpu_torch.utils.precision import mm_f32


class SensorType(enum.Enum):
    """Physical camera sensor formats (reference SFM.py:10-19)."""

    MEDIUM_FORMAT = 1
    FULL_FRAME = 2
    CROP_FRAME = 3
    MICRO_FOUR_THIRD = 4
    ONE_INCH = 5
    SMARTPHONE = 6


# (width_mm, height_mm) per sensor format (reference SFM.py:344-364).
SENSOR_DIMS_MM = {
    SensorType.MEDIUM_FORMAT: (53.0, 40.20),
    SensorType.FULL_FRAME: (35.0, 24.0),
    SensorType.CROP_FRAME: (23.6, 15.60),
    SensorType.MICRO_FOUR_THIRD: (17.0, 13.0),
    SensorType.ONE_INCH: (12.80, 9.60),
    SensorType.SMARTPHONE: (6.17, 4.55),
}


def focal_length_from_exif(exif_data) -> Optional[float]:
    """Focal length in mm from an EXIF tag dict (rational tuple or float
    form; reference SFM.py:326-342), or None without a FocalLength tag."""
    from PIL.ExifTags import TAGS

    for tag_id, value in exif_data.items():
        if TAGS.get(tag_id, tag_id) == "FocalLength":
            return value[0] / value[1] if isinstance(value, tuple) else float(value)
    return None


def intrinsics_from_exif(image_path: str, sensor_type: SensorType) -> np.ndarray:
    """3x3 intrinsic matrix K from a photo's EXIF focal length and the
    physical sensor size (reference SFM.py:311-374). Raises without EXIF."""
    from PIL import Image

    with Image.open(image_path) as image:
        width, height = image.size
        exif_data = image._getexif()

    if not exif_data:
        raise ValueError(f"No EXIF data in {image_path}; cannot derive intrinsics")

    focal_length = focal_length_from_exif(exif_data)
    if focal_length is None:
        raise ValueError(f"No EXIF focal length in {image_path}; cannot derive intrinsics")

    sensor_w, sensor_h = SENSOR_DIMS_MM[sensor_type]
    fx = focal_length * width / sensor_w
    fy = focal_length * height / sensor_h
    return np.array(
        [[fx, 0.0, width / 2.0], [0.0, fy, height / 2.0], [0.0, 0.0, 1.0]], dtype=np.float64
    )


@mm_f32
def projection_matrix(R: torch.Tensor, t: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """P = K [R | t] for (..., 3, 3) R, (..., 3) t, (..., 3, 3) K."""
    return K @ torch.cat([R, t[..., :, None]], dim=-1)


def _dehomogenize(pix: torch.Tensor) -> torch.Tensor:
    z = pix[..., 2:3]
    return pix[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)


@mm_f32
def project_points(
    points_3d: torch.Tensor, rvec: torch.Tensor, t: torch.Tensor, K: torch.Tensor
) -> torch.Tensor:
    """Project (..., N, 3) world points through camera (rvec axis-angle, t, K)
    (reference SFM.py:384-392)."""
    R = so3_exp(rvec)
    cam = points_3d @ R.transpose(-1, -2) + t[..., None, :]
    return _dehomogenize(cam @ K.transpose(-1, -2))


@mm_f32
def project_homogeneous(points_3d: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Project (..., N, 3) points with a (..., 3, 4) projection matrix."""
    Xh = torch.cat([points_3d, torch.ones_like(points_3d[..., :1])], dim=-1)
    return _dehomogenize(Xh @ P.transpose(-1, -2))


@mm_f32
def reprojection_errors(
    points_3d: torch.Tensor,
    points_2d: torch.Tensor,
    rvec: torch.Tensor,
    t: torch.Tensor,
    K: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point pixel errors and their masked mean (reference SFM.py:394-402)."""
    proj = project_points(points_3d, rvec, t, K)
    err = torch.linalg.norm(proj - points_2d, dim=-1)
    if mask is None:
        return err, torch.mean(err)
    m = mask.to(err.dtype)
    return err, torch.sum(err * m) / torch.clamp_min(torch.sum(m), 1.0)


@mm_f32
def two_view_reprojection_error(
    p3d: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    P1: torch.Tensor,
    P2: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean of the per-point average error across the two views
    (reference Util.py:65-82)."""
    e1 = torch.linalg.norm(project_homogeneous(p3d, P1) - p1, dim=-1)
    e2 = torch.linalg.norm(project_homogeneous(p3d, P2) - p2, dim=-1)
    per_point = 0.5 * (e1 + e2)
    if mask is None:
        return torch.mean(per_point)
    m = mask.to(per_point.dtype)
    return torch.sum(per_point * m) / torch.clamp_min(torch.sum(m), 1.0)
