"""The one traffic generator: a cell's pool of scenes, rendered from the
run's seed and written as JPEG files, as users hand the engines a
directory of images.

A cell file (``workloads/<cell>.json``) names its scene generator
(``renderer``) and the generator's keywords (``render``), the first view a
job takes and how many, and the pool's size; the configuration file gives
the camera (``image_hw``, ``f``). Each name is a file of this directory,
found by name, so that a new generator or imaging step is a new file:

* ``renderer``: ``<renderer>.py`` defines ``render(rng, **kw) -> (images,
  K, poses, X)``. A generator that makes every random draw before its first
  view may also define ``draw(rng, **kw)`` (a dict with ``K``, ``poses``
  and ``X``) and ``view(scene, v)`` (view ``v``, drawing nothing); its
  views are then rendered in worker processes, with the same bytes.
* ``imaging`` (optional): a list of ``{"step": <name>, "kw": {...}}``
  applied in turn to the job's views; ``<name>.py`` defines
  ``apply(rng, images, **kw)``, and, where each frame depends on that frame
  alone and no draw, ``view(image, i, **kw)``, which runs in the workers.
* ``order`` (optional): ``"rendered"`` (the default) or ``"shuffled"``, in
  which files ``1.jpg..N.jpg`` take a permutation of the job's views drawn
  from the scene's seed; the ground-truth poses follow their files.
* a configuration's ``intrinsics`` (optional), ``{"exif_focal_mm": ...,
  "camera_sensor": <SensorType name>}``: the files carry the focal length
  as an EXIF tag, and the jobs take K from it (``jobs.engine_args``).

Scene ``s`` of seed ``n`` is drawn from ``default_rng([n, 1, s])``; the
warm-up scene, which no job of the window uses, from ``default_rng([n,
2])``. Imaging step ``k`` of a scene draws from the scene's words followed
by ``4, k``, and the shuffle from its words followed by ``5``, so that a
step or a shuffle changes no draw of the render. A cell that names a
``scene_seed`` draws its scenes from that number whatever the run's seed,
so that every run reconstructs the same set of scenes in the same order and
the run's seed draws only the jobs' RANSAC seeds.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from portbench.scenes import render
from portbench.spec import load_module

SCENES = os.path.dirname(os.path.abspath(__file__))
ORDERS = ("rendered", "shuffled")


class Scene(NamedTuple):
    dir: str                   # 1.jpg .. N.jpg
    files: List[str]
    K: np.ndarray
    poses: List[Tuple[np.ndarray, np.ndarray]]   # ground truth, world to camera, per file


def seed_words(seed: int) -> int:
    """The seed as a non-negative integer for ``SeedSequence``."""
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def scene_module(scenes: str, name: str, attr: str):
    """The module of ``<scenes>/<name>.py``, which must define ``attr``."""
    mod = load_module(os.path.join(scenes, f"{name}.py"), "portbench.scenes")
    if not callable(getattr(mod, attr, None)):
        raise ValueError(f"{mod.__file__} defines no {attr}()")
    return mod


def check_cell(cell: dict, scenes: str = SCENES):
    """(the cell's generator module, [(imaging module, keywords), ...]);
    raises where a name has no file or the order is unknown."""
    gen = scene_module(scenes, cell["renderer"], "render")
    steps = [(scene_module(scenes, s["step"], "apply"), dict(s.get("kw", {})))
             for s in cell.get("imaging", [])]
    if cell.get("order", "rendered") not in ORDERS:
        raise ValueError(f"order {cell['order']!r} is none of {ORDERS}")
    return gen, steps


def _calls(path: str, fn: str, kw: dict, calls: list) -> list:
    """In a worker: ``fn(*args, **kw)`` of the file ``path`` for each args."""
    f = getattr(load_module(path, "portbench.scenes"), fn)
    return [f(*args, **kw) for args in calls]


class Workers:
    """Worker processes (spawned: they share nothing with a process that
    holds the card, and import the main module again, which must start
    nothing at import) that run a scene file's per-view function over
    chunks of views; every process has ended once the block has."""

    def __init__(self, n: int):
        self.n = n
        self.ex = concurrent.futures.ProcessPoolExecutor(
            n, mp_context=multiprocessing.get_context("spawn"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.ex.shutdown(wait=True, cancel_futures=True)
        # The pool's queues started multiprocessing's resource tracker, a
        # process of its own: end it and wait for it here, or it outlives
        # this process unreaped.
        from multiprocessing import resource_tracker

        resource_tracker._resource_tracker._stop()

    def map(self, mod, fn: str, calls: list, kw: Optional[dict] = None) -> list:
        """``[mod.fn(*args, **kw) for args in calls]``, in order; arguments
        shared by the calls of a chunk are sent once."""
        size = -(-len(calls) // self.n)
        futs = [self.ex.submit(_calls, os.path.abspath(mod.__file__), fn, kw or {},
                               calls[i:i + size]) for i in range(0, len(calls), size)]
        return [out for f in futs for out in f.result()]


def _render(gen, kw: dict, rng, workers: Optional[Workers]):
    if workers is None or not hasattr(gen, "draw") or not hasattr(gen, "view"):
        return gen.render(rng, **kw)
    scene = gen.draw(rng, **kw)
    images = workers.map(gen, "view", [(scene, v) for v in range(len(scene["poses"]))])
    return images, scene["K"], scene["poses"], scene["X"]


def make_scene(cell: dict, config: dict, gen, steps, s: int, key: tuple, out_dir: str,
               workers: Optional[Workers] = None) -> Scene:
    """Render the scene of words ``[s, *key]`` with the generator module
    ``gen`` and the imaging ``steps`` of ``check_cell``, and write the job's
    views into ``out_dir``."""
    kw = dict(cell["render"])
    kw.update(img_hw=tuple(config["image_hw"]), f=float(config["f"]))
    images, K, poses, _ = _render(gen, kw, np.random.default_rng([s, *key]), workers)
    first, n = cell["first_view"], cell["views"]
    images, poses = list(images[first:first + n]), list(poses[first:first + n])
    for k, (step, step_kw) in enumerate(steps):
        if workers is not None and hasattr(step, "view"):
            images = workers.map(step, "view", list(zip(images, range(n))), step_kw)
        else:
            images = step.apply(np.random.default_rng([s, *key, 4, k]), images, **step_kw)
    if cell.get("order", "rendered") == "shuffled":
        perm = np.random.default_rng([s, *key, 5]).permutation(n)
        images, poses = [images[p] for p in perm], [poses[p] for p in perm]
    exif = config.get("intrinsics", {}).get("exif_focal_mm")
    os.makedirs(out_dir, exist_ok=True)
    render.write_sequence(out_dir, images, exif_focal_mm=exif)
    files = [os.path.join(out_dir, f"{i}.jpg") for i in range(1, n + 1)]
    return Scene(out_dir, files, np.asarray(K, np.float64),
                 [(np.asarray(R, np.float64), np.asarray(t, np.float64)) for R, t in poses])


def make_pool(cell: dict, config: dict, seed: int, root: str, scenes: str = SCENES,
              workers: Optional[int] = None):
    """(the pool's scenes, the warm-up scene) under ``root``. ``workers``
    (default: the cores this process may use) render the views of a
    generator that defines ``draw`` and ``view``, and run the per-view
    imaging steps; one process renders the others."""
    gen, steps = check_cell(cell, scenes)
    s = seed_words(cell.get("scene_seed", seed))
    n = len(os.sched_getaffinity(0)) if workers is None else workers
    parallel = n > 1 and (hasattr(gen, "draw") and hasattr(gen, "view")
                          or any(hasattr(m, "view") for m, _ in steps))

    def build(w):
        pool = [make_scene(cell, config, gen, steps, s, (1, i), os.path.join(root, f"scene{i:04d}"),
                           w) for i in range(cell["pool"])]
        return pool, make_scene(cell, config, gen, steps, s, (2,), os.path.join(root, "warm"), w)

    if not parallel:
        return build(None)
    with Workers(n) as w:
        return build(w)


def job_seed(seed: int, job: int) -> int:
    """The RANSAC seed (``config.seed``) of job ``job`` of a run."""
    return int(np.random.default_rng([seed_words(seed), 3, job]).integers(2 ** 31 - 1))
