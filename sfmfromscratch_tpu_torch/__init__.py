"""sfmfromscratch_tpu_torch — the PyTorch/CUDA port of ``sfmfromscratch_tpu``.

Module paths and function names follow the JAX package, so each function has
a counterpart at the same place there. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package becomes a hand-written CUDA C++ kernel for
Hopper (``csrc/``, built by ``ops/cuda/build.py`` at first use) whose wrapper
launches it for CUDA tensors and runs its plain PyTorch version for CPU
tensors.

Ported so far: the two-view reconstruction path
(``pipeline/two_view.py::reconstruct_two_view``), both engines
(``pipeline/incremental.py::SfmEngine``, ``pipeline/global_sfm.py``) with
their options, the device mesh on ``torch.distributed`` (``parallel/``),
and the modules they reach.
The package imports neither ``jax`` nor ``sfmfromscratch_tpu``.
"""
