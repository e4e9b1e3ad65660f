"""Scene generators and imaging steps found by name: the frozen copies
against checksums of the repository's ``tests/render.py`` output, views
rendered in worker processes against one process, the existing cells'
pools against the bytes they had before generators were files, a generator
dropped into a directory, the shuffled order and EXIF intrinsics."""

import hashlib
import os
import shutil

import numpy as np
import pytest

from portbench import jobs as J
from portbench.scenes import pool
from portbench.spec import Bench

from test_portbench_layout import PB, ROOT

SCENES = os.path.join(PB, "scenes")

# sha256 of tests/render.py's output (images, poses, points and K, bytes in
# that order): render_planes(default_rng(11), num_views=3, img_hw=(48, 64),
# f=70.0, orbit_step_deg=12.0, layout=..., textures=...), its "real"
# texture matplotlib 3.10.8's photograph, which the committed copy equals;
# the degradations of render_planes(default_rng(11), num_views=4,
# img_hw=(48, 64), f=70.0), from default_rng(12), degrade_sequence with
# blur_every=2 (degrade_camera's JPEG round trip is Pillow 12.1.0's).
CHECKSUMS = {
    "planes_box_noise": "a346dee9857362bbf45b26d682e0c715a0f6245f83956b5d47fc300e4d87fc08",
    "planes_box_real": "63223cf8bf0ba28be97d8eb02c4474db0c31a178ecb91377deb77e3e9319bcd6",
    "planes_wall_noise": "238a1604b80fbbfca17335d78c21ff5cfd8c793945afc7fc5a1ffec99457a357",
    "planes_wall_real": "8f531de64f4f8334451de618968d20bd76848d529131ddebbacc18d48c04f9b9",
    "planes_doppel_noise": "8eeaa5e7ea5fa2368cf2dd5bfb26ecadf32f44171103c2c4cec388c043b3df23",
    "planes_doppel_real": "2908bf0733609b9baf58d9771dd08e7ba589b67fc3b039c377481f62de3ea462",
    "degrade_sequence": "883db74937da104132de4538efd421bbf98cce93f26301a71df5395709059d95",
    "degrade_camera": "8c09a1bf3f4fa2a2a827723dbc1bb902b2f4053e5f2a4cd4d422a965562c3ee0",
}

# sha256 of the JPEG bytes of each cell's pool cut to one scene (and
# kf150_video to 20 views), then its warm-up scene, at run seed 2**31 + 77,
# as the harness wrote them while its one renderer was a dict entry
# (Pillow 12.1.0's encoder); kf150_video's at its scene seed 2.
POOL_DIGESTS = {
    "inc10_bench": "0f5987e088752304534c81695218f5981b1e7282ce7bfc7e695c613e0162beec",
    "glob20_ring": "b86633f38bf6fcbe851540fd9624e0b5fe09b3357b49f04966ae91875f8d3eaa",
    "inc2_pairs": "1e5ef1170e108c977b4986a43699b15a06c9b68d5691a66256c7e6dffb94a35b",
    "kf150_video": "a9b400007d9d53b8286831f54c10e2d07ce15c420ab86ad821c67cec4c6944dc",
}

TINY = {"image_hw": [48, 64], "f": 70.0}


def _digest(imgs, K=None, poses=(), X=None):
    h = hashlib.sha256()
    for a in imgs:
        h.update(np.ascontiguousarray(a).tobytes())
    for R, t in poses:
        h.update(np.asarray(R, np.float64).tobytes())
        h.update(np.asarray(t, np.float64).tobytes())
    if X is not None:
        h.update(np.asarray(X).tobytes())
    if K is not None:
        h.update(np.asarray(K).tobytes())
    return h.hexdigest()


def _module(name, attr="render"):
    return pool.scene_module(SCENES, name, attr)


def _planes(n=3, **kw):
    return _module("render_planes").render(np.random.default_rng(11), num_views=n,
                                           img_hw=(48, 64), f=70.0, **kw)


def _bytes(scene):
    return [open(f, "rb").read() for f in scene.files]


@pytest.mark.parametrize("layout", ["box", "wall", "doppel"])
@pytest.mark.parametrize("textures", ["noise", "real"])
def test_the_planes_copy_matches_the_original_checksums(layout, textures):
    imgs, K, poses, X = _planes(orbit_step_deg=12.0, layout=layout, textures=textures)
    assert _digest(imgs, K, poses, X) == CHECKSUMS[f"planes_{layout}_{textures}"]


@pytest.mark.parametrize("step, kw", [("degrade_sequence", {"blur_every": 2}),
                                      ("degrade_camera", {})])
def test_the_degradation_copies_match_the_original_checksums(step, kw):
    imgs = _planes(4)[0]
    out = _module(step, "apply").apply(np.random.default_rng(12), imgs, **kw)
    assert _digest(out) == CHECKSUMS[step]


def test_the_real_texture_is_held_to_its_sha256(tmp_path, monkeypatch):
    planes = _module("render_planes")
    assert planes.real_photo_texture().shape == (512, 512)
    with pytest.raises(ValueError):
        planes.real_photo_texture(256)
    bad = tmp_path / "tex.npz"
    np.savez(bad, tex=np.zeros((512, 512), np.uint8))
    monkeypatch.setattr(planes, "REAL_TEXTURE", str(bad))
    with pytest.raises(ValueError, match="sha256"):
        planes.real_photo_texture()


def test_views_rendered_in_workers_are_the_bytes_of_one_process():
    planes = _module("render_planes")
    camera = _module("degrade_camera", "apply")
    serial = _planes(5, textures="real")
    scene = planes.draw(np.random.default_rng(11), num_views=5, img_hw=(48, 64), f=70.0,
                        textures="real")
    with pool.Workers(2) as w:
        images = w.map(planes, "view", [(scene, v) for v in range(5)])
        degraded = w.map(camera, "view", list(zip(images, range(5))), {"k1": -0.1})
    assert _digest(images) == _digest(serial[0])
    assert _digest(degraded) == _digest(camera.apply(None, serial[0], k1=-0.1))


def _children():
    pids = set()
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            pids |= set(f.read().split())
    return pids


def test_no_process_of_the_workers_outlives_the_pool(tmp_path):
    before = _children()
    cell = dict(_planes_cell(), pool=1)
    pool.make_pool(cell, TINY, 5, str(tmp_path), workers=2)
    assert _children() <= before


def _planes_cell(**kw):
    cell = {"renderer": "render_planes", "render": {"num_views": 6, "orbit_step_deg": 8.0},
            "first_view": 1, "views": 4, "pool": 2}
    cell.update(kw)
    return cell


def test_a_pool_in_workers_is_the_bytes_of_one_process(tmp_path):
    cell = _planes_cell(imaging=[{"step": "degrade_sequence", "kw": {}},
                                 {"step": "degrade_camera", "kw": {"jpeg_quality": 70}}],
                        order="shuffled")
    a, wa = pool.make_pool(cell, TINY, 2 ** 31 + 3, str(tmp_path / "a"), workers=1)
    b, wb = pool.make_pool(cell, TINY, 2 ** 31 + 3, str(tmp_path / "b"), workers=3)
    assert [_bytes(s) for s in a + [wa]] == [_bytes(s) for s in b + [wb]]
    assert all(np.array_equal(p[0], q[0]) for s, t in zip(a, b) for p, q in zip(s.poses, t.poses))


@pytest.mark.parametrize("name", sorted(POOL_DIGESTS))
def test_each_cell_pool_is_the_bytes_it_was(name, tmp_path):
    bench = Bench(ROOT)
    cell = dict(bench.cell(name), pool=1)
    if name == "kf150_video":
        cell.update(views=20, render=dict(cell["render"], num_views=20))
    cfg = bench.config(bench.workload(name)["config"])
    scenes, warm = pool.make_pool(cell, cfg, 2 ** 31 + 77, str(tmp_path), bench.scenes)
    h = hashlib.sha256()
    for b in (x for s in scenes + [warm] for x in _bytes(s)):
        h.update(b)
    assert h.hexdigest() == POOL_DIGESTS[name]


CHECKER = '''
import numpy as np


def render(rng, num_views=2, img_hw=(32, 32), f=50.0, square=4):
    H, W = img_hw
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]])
    yy, xx = np.mgrid[:H, :W]
    board = ((yy // square + xx // square) % 2).astype(np.float32)
    shifts = rng.integers(0, W, num_views)
    poses = [(np.eye(3), np.array([0.1 * v, 0.0, 0.0])) for v in range(num_views)]
    return [np.roll(board, int(s), axis=1) for s in shifts], K, poses, None
'''

INVERT = '''
def apply(rng, images, level=1.0):
    return [level - x for x in images]
'''


def test_a_generator_and_a_step_dropped_into_the_directory_are_found_by_name(tmp_path):
    d = tmp_path / "bench"
    d.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), d / "BENCHMARK.json")
    shutil.copytree(PB, d / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    (d / "portbench/scenes/render_checker.py").write_text(CHECKER)
    (d / "portbench/scenes/invert.py").write_text(INVERT)
    bench = Bench(str(d))
    cell = {"renderer": "render_checker", "render": {"num_views": 3, "square": 2},
            "imaging": [{"step": "invert", "kw": {"level": 1.0}}],
            "first_view": 0, "views": 3, "pool": 2}
    scenes, warm = pool.make_pool(cell, TINY, 5, str(tmp_path / "p"), bench.scenes)
    assert len(scenes) == 2 and len(scenes[0].files) == 3
    assert np.array_equal(scenes[0].poses[2][1], [0.2, 0.0, 0.0])
    from PIL import Image

    top_left = np.asarray(Image.open(scenes[0].files[0]))[0, 0, 0]
    assert top_left in (0, 255)
    with pytest.raises(FileNotFoundError):
        pool.make_pool(cell, TINY, 5, str(tmp_path / "q"))   # the repository's own directory


def test_a_shuffled_order_permutes_the_poses_with_the_files(tmp_path):
    cell = _planes_cell(render={"num_views": 6, "orbit_step_deg": 8.0})
    a, _ = pool.make_pool(cell, TINY, 41, str(tmp_path / "a"), workers=1)
    b, _ = pool.make_pool(dict(cell, order="shuffled"), TINY, 41, str(tmp_path / "b"), workers=1)
    moved = 0
    for s, t in zip(a, b):
        src = _bytes(s)
        assert sorted(src) == sorted(_bytes(t))
        for j, data in enumerate(_bytes(t)):
            i = src.index(data)
            moved += i != j
            assert np.array_equal(t.poses[j][0], s.poses[i][0])
            assert np.array_equal(t.poses[j][1], s.poses[i][1])
    assert moved > 0
    c, _ = pool.make_pool(dict(cell, order="shuffled"), TINY, 41, str(tmp_path / "c"), workers=1)
    assert [_bytes(s) for s in b] == [_bytes(s) for s in c]
    with pytest.raises(ValueError):
        pool.make_pool(dict(cell, order="sorted"), TINY, 41, str(tmp_path / "d"))


def test_intrinsics_write_exif_and_the_job_takes_k_from_it(tmp_path, monkeypatch):
    from PIL import Image

    from sfmfromscratch_tpu_torch.geometry.camera import SensorType, intrinsics_from_exif

    focal = 208.0 / 15.0
    cfg = dict(TINY, engine="GlobalSfmEngine", extractor={}, matcher={}, ransac={}, ba={},
               scale_factor=1.0, engine_kwargs={"pair_window": 3},
               intrinsics={"exif_focal_mm": focal, "camera_sensor": "ONE_INCH"})
    cell = _planes_cell(pool=1)
    scenes, _ = pool.make_pool(cell, cfg, 3, str(tmp_path), workers=1)
    sc = scenes[0]
    assert Image.open(sc.files[0])._getexif()[0x920A] == pytest.approx(focal)
    K = intrinsics_from_exif(sc.files[0], SensorType.ONE_INCH)
    assert K[0, 0] == pytest.approx(focal * 64 / 12.8)   # a one-inch sensor is 12.8 mm wide
    seen = {}

    class FakeEngine:
        def __init__(self, img_path, max_img, **kw):
            seen.update(kw, img_path=img_path, max_img=max_img)
            self.stage_times, self.filter_hyps_used, self.pair_geometry = {}, None, {}
            self.map = None
            self.global_poses = [(np.zeros(3), np.zeros(3))] * max_img
            self.global_K = [np.eye(3)] * max_img

    monkeypatch.setattr(J, "engine_class", lambda name: FakeEngine)
    monkeypatch.setattr(J, "pipeline_config", lambda cfg, seed: seed)
    rec = J.run_job(0, 0, sc, cfg, 7, "cpu", lambda: None)
    assert not rec.failed, rec.error
    assert seen["single_K"] is None and seen["camera_sensor"] is SensorType.ONE_INCH
    assert seen["pair_window"] == 3 and seen["img_path"] == sc.dir and seen["max_img"] == 4
    plain = dict(cfg)
    del plain["intrinsics"]
    assert J.engine_args(plain, sc)["single_K"] is sc.K
    assert "camera_sensor" not in J.engine_args(plain, sc)
