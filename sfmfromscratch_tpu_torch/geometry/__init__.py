from sfmfromscratch_tpu_torch.geometry.camera import (
    SensorType,
    intrinsics_from_exif,
    projection_matrix,
    project_points,
    reprojection_errors,
)
from sfmfromscratch_tpu_torch.geometry.epipolar import (
    hartley_normalize,
    eight_point_fundamental,
    epipolar_distances,
    essential_from_fundamental,
)
from sfmfromscratch_tpu_torch.geometry.triangulation import (
    triangulate_dlt,
    triangulate_normalized,
    refine_points_gn,
    two_view_depths,
)
