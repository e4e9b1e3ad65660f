"""sfmfromscratch_tpu_torch — the PyTorch/CUDA port of ``sfmfromscratch_tpu``.

Module paths and function names follow the JAX package, so each function has
a counterpart at the same place there. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package becomes a hand-written CUDA C++ kernel for
Hopper (``csrc/``, built by ``ops/cuda/build.py`` at first use) whose wrapper
launches it for CUDA tensors and runs its plain PyTorch version for CPU
tensors.

Ported: the two-view reconstruction path
(``pipeline/two_view.py::reconstruct_two_view``), both engines
(``pipeline/incremental.py::SfmEngine``, ``pipeline/global_sfm.py``) with
their options, the device mesh on ``torch.distributed`` (``parallel/``),
the reference's class API (``compat.py``), the viewer and overlays
(``viz/``), the C++ host components (``native/``, built with g++ at first
use) and the modules they reach. The top-level names are the JAX
package's; its XLA compile-cache set-up has no counterpart (the CUDA
kernels' source-keyed build cache is ``ops/cuda/build.py``).
The package imports neither ``jax`` nor ``sfmfromscratch_tpu``.
"""

from sfmfromscratch_tpu_torch.geometry.camera import (
    SensorType,
    intrinsics_from_exif,
    projection_matrix,
    project_points,
)
from sfmfromscratch_tpu_torch.config import (
    ExtractorConfig,
    MatcherConfig,
    PipelineConfig,
    RansacConfig,
)

__version__ = "0.1.0"
