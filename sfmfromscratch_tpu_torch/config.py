"""Dataclass configuration (copy of ``sfmfromscratch_tpu/config.py``).

The port keeps its own copy: it imports nothing from the JAX package, not even
its pure-Python modules. Field names and defaults are identical, so
``interop.config_from_dict(dataclasses.asdict(jax_cfg))`` rebuilds any of them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    """Feature-extraction knobs (reference: NaiveSIFT.py:35-39, ScaleRotInvSIFT.py:12-13,
    FeatureExtractor.py:11)."""

    num_interest_points: int = 2500
    ksize: int = 7               # Harris NMS max-pool window
    gaussian_size: int = 7       # second-moment smoothing kernel size
    sigma: float = 5.0
    alpha: float = 0.05
    feature_width: int = 16
    pyramid_level: int = 4
    pyramid_scale_factor: float = 2.0

    @staticmethod
    def from_params_dict(params: dict) -> "ExtractorConfig":
        """Accept the reference's ``extractor_params`` dict verbatim."""
        fields = {f.name for f in dataclasses.fields(ExtractorConfig)}
        return ExtractorConfig(**{k: v for k, v in params.items() if k in fields})

    def to_params_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """NN-ratio matcher knobs (reference: NNRatioFeatureMatcher.py:5, main.py:30)."""

    ratio_threshold: float = 0.8
    max_matches: int = 2500      # fixed output capacity (masked)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Robust-estimation knobs (reference: SFM.py:38,126,184-187; Runner.py:170)."""

    prob_success: float = 0.98
    sample_size: int = 8
    ind_prob_correct: float = 0.4
    epipolar_threshold: float = 1.0
    pnp_reproj_threshold: float = 8.0
    max_iterations: Optional[int] = None  # None => derived from the probabilities
    pnp_solver: str = "p3p"
    pnp_max_iterations: Optional[int] = None
    adaptive: bool = True
    stage_size: int = 512

    def num_iterations(self) -> int:
        if self.max_iterations is not None:
            return self.max_iterations
        n = math.log(1.0 - self.prob_success) / math.log(
            1.0 - self.ind_prob_correct ** self.sample_size
        )
        return int(n)

    def max_hypotheses(self) -> int:
        """``num_iterations()`` rounded up to a whole number of adaptive stages."""
        n = self.num_iterations()
        s = self.stage_size
        return ((n + s - 1) // s) * s

    def pnp_num_iterations(self) -> int:
        """Hypothesis count for the PnP stage (floor of 512 for P3P)."""
        if self.pnp_max_iterations is not None:
            return self.pnp_max_iterations
        if self.pnp_solver == "p3p":
            n = math.log(1.0 - self.prob_success) / math.log(
                1.0 - self.ind_prob_correct ** 3
            )
            return max(512, int(n))
        return self.num_iterations()


@dataclasses.dataclass(frozen=True)
class BundleAdjustConfig:
    """LM + Schur bundle-adjustment knobs (replaces scipy trf at reference SFM.py:421-429)."""

    max_lm_iters: int = 30
    init_damping: float = 1e-3
    damping_up: float = 4.0
    damping_down: float = 0.5
    ftol: float = 1e-2
    huber_delta: float = 0.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end incremental-SfM knobs (reference: Runner.py:129-131, main.py:29-30)."""

    extractor: ExtractorConfig = ExtractorConfig()
    matcher: MatcherConfig = MatcherConfig(ratio_threshold=0.85)
    ransac: RansacConfig = RansacConfig()
    ba: BundleAdjustConfig = BundleAdjustConfig()
    scale_factor: float = 0.5
    dist_threshold: float = 5.0
    max_points: int = 200_000
    seed: int = 5
