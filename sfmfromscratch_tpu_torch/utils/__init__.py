from sfmfromscratch_tpu_torch.utils.metrics import (
    MetricsLogger,
    absolute_trajectory_error,
    umeyama_alignment,
)
