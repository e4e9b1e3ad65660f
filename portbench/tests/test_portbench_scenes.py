"""The frozen renderer against checksums of the repository's
``tests/render.py`` output, and the generator's seeding."""

import hashlib

import numpy as np

from portbench.scenes import pool, render

# sha256 of tests/render.py's render_sequence(default_rng(11), ...) output:
# images, poses, points and K, bytes in that order.
CHECKSUMS = {
    "sequence": "40bab41a83ab261c30745f50c06589165b174b434a022bfd8cf189a1fb6ec008",
    "orbit": "ee1fd3488bce70feb6f85b1b7c103821bbd7b1144f3b5ffc4bb9c04510d03018",
}


def _digest(kw):
    imgs, K, poses, X = render.render_sequence(np.random.default_rng(11), **kw)
    h = hashlib.sha256()
    for a in imgs:
        h.update(np.ascontiguousarray(a).tobytes())
    for R, t in poses:
        h.update(np.asarray(R, np.float64).tobytes())
        h.update(np.asarray(t, np.float64).tobytes())
    h.update(np.asarray(X).tobytes())
    h.update(np.asarray(K).tobytes())
    return h.hexdigest()


def test_renderer_copy_matches_the_original_checksums():
    assert _digest(dict(num_views=3, num_points=50, img_hw=(48, 64), f=70.0)) == CHECKSUMS["sequence"]
    assert _digest(dict(num_views=3, num_points=40, img_hw=(48, 64), f=70.0,
                        orbit_step_deg=4.0)) == CHECKSUMS["orbit"]


def test_scenes_and_job_seeds_follow_the_seed(tmp_path):
    cell = {"renderer": "render_sequence", "render": {"num_views": 3, "num_points": 30},
            "first_view": 1, "views": 2, "pool": 2}
    cfg = {"image_hw": [40, 56], "f": 60.0}
    big = 2 ** 31 + 12345
    a, wa = pool.make_pool(cell, cfg, big, str(tmp_path / "a"))
    b, _ = pool.make_pool(cell, cfg, big, str(tmp_path / "b"))
    c, _ = pool.make_pool(cell, cfg, 7, str(tmp_path / "c"))
    assert len(a) == 2 and len(a[0].files) == 2 and len(a[0].poses) == 2
    assert all(open(x, "rb").read() == open(y, "rb").read() for x, y in zip(a[0].files, b[0].files))
    assert open(a[0].files[0], "rb").read() != open(c[0].files[0], "rb").read()
    assert open(a[0].files[0], "rb").read() != open(wa.files[0], "rb").read()
    # the job's first image is the renderer's view first_view
    imgs, _, poses, _ = render.render_sequence(np.random.default_rng([big, 1, 0]), num_views=3,
                                               num_points=30, img_hw=(40, 56), f=60.0)
    assert np.allclose(a[0].poses[0][0], poses[1][0])
    assert pool.job_seed(big, 3) == pool.job_seed(big, 3) != pool.job_seed(big, 4)
    assert 0 <= pool.job_seed(-5, 0) < 2 ** 31



def test_a_scene_seed_fixes_the_scenes_whatever_the_run_seed(tmp_path):
    cell = {"renderer": "render_sequence", "render": {"num_views": 2, "num_points": 30},
            "first_view": 0, "views": 2, "pool": 2, "scene_seed": 1}
    cfg = {"image_hw": [40, 56], "f": 60.0}
    a, wa = pool.make_pool(cell, cfg, 2 ** 31 + 5, str(tmp_path / "a"))
    b, wb = pool.make_pool(cell, cfg, 9, str(tmp_path / "b"))
    same = lambda x, y: open(x, "rb").read() == open(y, "rb").read()   # noqa: E731
    assert all(same(x.files[0], y.files[0]) for x, y in zip(a + [wa], b + [wb]))
    assert not same(a[0].files[0], a[1].files[0])
    assert pool.job_seed(2 ** 31 + 5, 0) != pool.job_seed(9, 0)   # the run's seed draws the jobs'
