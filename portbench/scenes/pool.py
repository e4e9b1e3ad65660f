"""The one traffic generator: a cell's pool of scenes, rendered from the
run's seed by the frozen renderer and written as JPEG files, as users hand
the engines a directory of images.

A cell file (``workloads/<cell>.json``) names the renderer, its keywords,
the first view a job takes and how many, and the pool's size; the
configuration file gives the camera (``image_hw``, ``f``). Scene ``s`` of
seed ``n`` is drawn from ``default_rng([n, 1, s])``; the warm-up scene, which
no job of the window uses, from ``default_rng([n, 2])``. A cell that names a
``scene_seed`` draws its scenes from that number whatever the run's seed,
so that every run reconstructs the same set of scenes in the same order and
the run's seed draws only the jobs' RANSAC seeds.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np

from portbench.scenes import render

RENDERERS = {"render_sequence": render.render_sequence}


class Scene(NamedTuple):
    dir: str                   # 1.jpg .. N.jpg
    files: List[str]
    K: np.ndarray
    poses: List[Tuple[np.ndarray, np.ndarray]]   # ground truth, world to camera, per file


def seed_words(seed: int) -> int:
    """The seed as a non-negative integer for ``SeedSequence``."""
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def make_scene(cell: dict, config: dict, rng, out_dir: str) -> Scene:
    """Render one scene and write the job's views into ``out_dir``."""
    kw = dict(cell["render"])
    kw.update(img_hw=tuple(config["image_hw"]), f=float(config["f"]))
    images, K, poses, _ = RENDERERS[cell["renderer"]](rng, **kw)
    first, n = cell["first_view"], cell["views"]
    os.makedirs(out_dir, exist_ok=True)
    render.write_sequence(out_dir, images[first:first + n])
    files = [os.path.join(out_dir, f"{i}.jpg") for i in range(1, n + 1)]
    return Scene(out_dir, files, np.asarray(K, np.float64),
                 [(np.asarray(R, np.float64), np.asarray(t, np.float64))
                  for R, t in poses[first:first + n]])


def make_pool(cell: dict, config: dict, seed: int, root: str):
    """(the pool's scenes, the warm-up scene) under ``root``."""
    s = seed_words(cell.get("scene_seed", seed))
    pool = [make_scene(cell, config, np.random.default_rng([s, 1, i]),
                       os.path.join(root, f"scene{i:04d}")) for i in range(cell["pool"])]
    warm = make_scene(cell, config, np.random.default_rng([s, 2]), os.path.join(root, "warm"))
    return pool, warm


def job_seed(seed: int, job: int) -> int:
    """The RANSAC seed (``config.seed``) of job ``job`` of a run."""
    return int(np.random.default_rng([seed_words(seed), 3, job]).integers(2 ** 31 - 1))
