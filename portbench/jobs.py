"""One reconstruction job through the program's public entry, and the
closed loop of the measured window.

A job constructs the configuration's engine on a scene's directory of JPEG
files, as users call it (``auto_run`` on, nothing saved), and waits for the
device. What the comparison needs afterwards is kept on the host: the
returned pair geometry, map, poses and K, the stage spans and the filter's
hypothesis counts; the engine and its device state are dropped.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from portbench.scenes.pool import job_seed


@dataclasses.dataclass
class JobRecord:
    index: int
    scene: int
    seed: int
    views: int
    start: float
    end: float
    error: Optional[str] = None
    cameras: int = 0
    want_cameras: int = 0
    stage_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    hyps: Optional[np.ndarray] = None
    pair_geometry: Optional[dict] = None
    map: object = None
    poses: Optional[list] = None
    Ks: Optional[list] = None
    first_image: int = 1          # the image of the first returned camera

    @property
    def failed(self) -> bool:
        return self.error is not None or self.cameras < self.want_cameras

    @property
    def observations(self):
        return self.map.observations()

    @property
    def points(self):
        return self.map.points()


def engine_class(name: str):
    if name == "SfmEngine":
        from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

        return SfmEngine
    if name == "GlobalSfmEngine":
        from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine

        return GlobalSfmEngine
    raise ValueError(f"unknown engine {name!r}")


def pipeline_config(cfg: dict, seed: int):
    """The program's ``PipelineConfig`` of a configuration file."""
    from sfmfromscratch_tpu_torch.config import (
        BundleAdjustConfig,
        ExtractorConfig,
        MatcherConfig,
        PipelineConfig,
        RansacConfig,
    )

    return PipelineConfig(
        extractor=ExtractorConfig(**cfg["extractor"]), matcher=MatcherConfig(**cfg["matcher"]),
        ransac=RansacConfig(**cfg["ransac"]), ba=BundleAdjustConfig(**cfg["ba"]),
        scale_factor=float(cfg["scale_factor"]), seed=int(seed))


def engine_args(cfg: dict, scene) -> dict:
    """The keywords with which a job builds the configuration's engine on
    ``scene``, past the directory, the image count and the config: the
    scene's K (``single_K``), or, where the configuration names
    ``intrinsics``, no K and the sensor, so that the engine takes K from
    each file's EXIF focal length; then the configuration's
    ``engine_kwargs``."""
    intr = cfg.get("intrinsics")
    if intr is None:
        kw = dict(single_K=scene.K)
    else:
        from sfmfromscratch_tpu_torch.geometry.camera import SensorType

        kw = dict(single_K=None, camera_sensor=SensorType[intr["camera_sensor"]])
    kw.update(cfg.get("engine_kwargs", {}))
    return kw


def want_cameras(cfg: dict, views: int) -> int:
    """Cameras a job of ``views`` images must register: every image in the
    global engine, every image after the first (the world's) in the
    incremental one."""
    return views if cfg["engine"] == "GlobalSfmEngine" else views - 1


def run_job(index: int, scene_index: int, scene, cfg: dict, run_seed: int, device,
            sync) -> JobRecord:
    """Run one job; an exception is the job's failure, not the harness's."""
    seed = job_seed(run_seed, index)
    views = len(scene.files)
    engine = engine_class(cfg["engine"])
    rec = JobRecord(index=index, scene=scene_index, seed=seed, views=views, start=0.0, end=0.0,
                    want_cameras=want_cameras(cfg, views),
                    first_image=1 if cfg["engine"] == "GlobalSfmEngine" else 2)
    rec.start = time.perf_counter()
    try:
        eng = engine(scene.dir, views, config=pipeline_config(cfg, seed), model_name=None,
                     device=device, **engine_args(cfg, scene))
        sync()
        rec.end = time.perf_counter()
        rec.stage_times = dict(eng.stage_times)
        rec.hyps = None if eng.filter_hyps_used is None else np.asarray(eng.filter_hyps_used)
        rec.pair_geometry = dict(eng.pair_geometry)
        rec.map = eng.map
        rec.poses = list(eng.global_poses)
        rec.Ks = list(eng.global_K)
        rec.cameras = len(rec.poses)
        del eng
    except Exception:  # a job that raises is a failed job; the run goes on
        sync()
        rec.end = time.perf_counter()
        rec.error = traceback.format_exc(limit=4)[-1500:]
    return rec


def window(pool, cfg: dict, run_seed: int, seconds: float, device, sync,
           trace_after=None) -> List[JobRecord]:
    """The closed loop: jobs back to back over the pool in order, the next
    one starting while less than ``seconds`` have passed since the first
    started; every started job runs to its end. ``trace_after`` (the traced
    run's profiler) wraps one more job once the window has closed: the
    window's first job again, on the same scene with the same seed, so that
    the trace's device time can be set against that job's unprofiled wall
    time, and no job of the window runs under or after the profiler.
    Returns the window's jobs, then the profiled one, if any."""
    jobs: List[JobRecord] = []
    t0 = time.perf_counter()
    while not jobs or time.perf_counter() - t0 < seconds:
        i = len(jobs)
        k = i % len(pool)
        jobs.append(run_job(i, k, pool[k], cfg, run_seed, device, sync))
    if trace_after is not None:
        with trace_after:
            jobs.append(run_job(0, 0, pool[0], cfg, run_seed, device, sync))
    return jobs


def end_to_end(jobs: List[JobRecord]) -> Dict[str, float]:
    """``frames_per_s`` (the views of every job started in the window over
    the time from the first start to the last end; a failed job counts its
    time and not its views) and the window's length."""
    span = jobs[-1].end - jobs[0].start
    views = sum(j.views for j in jobs if not j.failed)
    return {"frames_per_s": views / span, "window_s": span}
