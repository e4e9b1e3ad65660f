"""The JAX package's last end-to-end checks, run through the PyTorch port on the CPU.

Real photographic texture through the front end and through the whole
degradation stack (``tests/test_realistic.py``), the planar-wall scene with
its contrast run (``tests/test_graph_surgery.py:44-77``), each through
``chip_smoke.scenario_run`` as ``chip_smoke.py``'s scenarios phase runs it
on the card, and TinyPoint's wide-baseline shootout
(``tools/eval_superpoint.py``, the port's ``tools/eval_superpoint_torch.py``).
The texture is the committed photograph (``tests/data/grace_hopper_512_u8.npz``),
in both packages. Each tolerance is stated where it is used; the launch
predictions of ``chip_smoke.py`` are checked here by counting the kernels'
plain versions, which the wrappers run for CPU tensors in place of each
launch.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "sfmfromscratch_tpu")


@pytest.fixture(scope="module")
def api():
    return chip_smoke.port_scenario_api(torch.device("cpu"))


@pytest.fixture()
def plain_calls(monkeypatch):
    """Calls of the kernels' plain versions under the names of
    ``chip_smoke._launch_counts``: on the CPU each stands for one launch."""
    from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
    from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK

    calls = {"harris_response_fused": 0, "match_top2_fused": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(HK, "harris_response", counted("harris_response_fused", HK.harris_response))
    monkeypatch.setattr(MK, "match_top2_plain", counted("match_top2_fused", MK.match_top2_plain))
    return calls


def _run(name, api, tmp_path, calls=None):
    if calls is not None:
        calls.update(dict.fromkeys(calls, 0))
    row = chip_smoke.scenario_run(name, api, str(tmp_path))
    assert not chip_smoke.scenario_failures(name, row), (chip_smoke.scenario_failures(name, row), row)
    return row


# ---------------------------------------------------------------- the texture


def test_committed_texture_is_real_photo_texture():
    """The committed array over 255 is ``tests/render.py::real_photo_texture()``
    bit for bit (made from matplotlib's photograph, which the card's machine
    lacks), 512x512 float32, with the committed sha256."""
    pytest.importorskip("matplotlib")
    from tests.render import real_photo_texture

    tex, digest = chip_smoke.real_texture()
    ref = real_photo_texture()
    assert ref is not None and tex.dtype == ref.dtype == np.float32 and tex.shape == (512, 512)
    np.testing.assert_array_equal(tex.view(np.int32), ref.view(np.int32))
    assert digest == chip_smoke.REAL_TEXTURE_SHA256


def test_real_scenes_fail_without_the_committed_texture(tmp_path, monkeypatch):
    """No silent fallback to noise textures: a missing file or another array
    raises, the renderer's own ``real_photo_texture`` is back after every
    call, and a renderer that does not ask for the texture is refused."""
    mod = chip_smoke._render_module()
    own = mod.real_photo_texture
    kw = dict(num_views=1, img_hw=(24, 32))
    (images, _, _, _), digest = chip_smoke.render_real_planes(mod, np.random.default_rng(5), **kw)
    assert mod.real_photo_texture is own and digest == chip_smoke.REAL_TEXTURE_SHA256
    with np.load(ROOT / chip_smoke.REAL_TEXTURE_NPZ) as z:
        tex = z["tex"].copy()
    tex[0, 0] ^= 1
    np.savez_compressed(tmp_path / "other.npz", tex=tex)
    monkeypatch.setattr(chip_smoke, "REAL_TEXTURE_NPZ", str(tmp_path / "other.npz"))
    with pytest.raises(ValueError, match="not the committed texture"):
        chip_smoke.render_real_planes(mod, np.random.default_rng(5), **kw)
    monkeypatch.setattr(chip_smoke, "REAL_TEXTURE_NPZ", str(tmp_path / "absent.npz"))
    with pytest.raises(FileNotFoundError):
        chip_smoke.render_real_planes(mod, np.random.default_rng(5), **kw)
    monkeypatch.undo()
    monkeypatch.setattr(mod, "render_planes", lambda rng, **k: ([], None, [], None))
    with pytest.raises(RuntimeError, match="committed"):
        chip_smoke.render_real_planes(mod, np.random.default_rng(5), **kw)
    monkeypatch.undo()
    assert mod.real_photo_texture is own


# ---------------------------------------------------------------- the scenarios


def _keypoints(f):
    """Each valid keypoint slot's level-0 (x, y)."""
    kp = f.keypoints
    return {i: (int(x), int(y)) for i, (x, y, m) in enumerate(zip(
        np.asarray(kp.x), np.asarray(kp.y), np.asarray(kp.mask))) if m}


def _matches(fr):
    """The match set as keypoint coordinates (slot order may differ)."""
    k1, k2 = _keypoints(fr.features1), _keypoints(fr.features2)
    idx, mask = np.asarray(fr.matches.indices), np.asarray(fr.matches.mask)
    return {(k1[int(a)], k2[int(b)]) for (a, b), m in zip(idx, mask) if m}


def test_real_pair_matches_jax(api, tmp_path, plain_calls):
    """``tests/test_realistic.py:50-89`` on the committed texture, both
    packages: the port's keypoints equal JAX's but for 1% of either set,
    descriptors of shared keypoints within 1e-4 on at least 97% of the rows
    (the extractor parity tests' tolerances, ``tests/test_torch_two_view.py``
    and ``tests/test_torch_ops.py``), match sets with a Jaccard index of at
    least 0.95, and both packages inside the JAX test's gates. (Seen: the
    same 251 matches and inlier share 0.912; the medians 0.327 and 0.403 px
    come from each package's own RANSAC draws.) The port launches Harris 4
    times and the matcher once (``chip_smoke.E2E_LAUNCHES``)."""
    from tools.scenario_pins import jax_scenario_api

    jax_api = jax_scenario_api()
    mod = chip_smoke._render_module()
    (images, _, _, _), _ = chip_smoke.render_real_planes(mod, np.random.default_rng(5),
                                                         **chip_smoke.REAL_PAIR_SCENE)
    fj = chip_smoke.real_pair_features(jax_api, images)
    ft = chip_smoke.real_pair_features(api, images)
    for a, b in ((fj.features1, ft.features1), (fj.features2, ft.features2)):
        ka, kb = _keypoints(a), _keypoints(b)
        sa, sb = set(ka.values()), set(kb.values())
        assert len(sa) > 100 and len(sa ^ sb) <= 0.01 * len(sa | sb)
        same = [i for i in ka if kb.get(i) == ka[i]]
        assert len(same) >= 0.99 * len(ka)
        da, db = np.asarray(a.descriptors)[same], b.descriptors.numpy()[same]
        assert da.shape[1] == 128 and np.all(np.abs(da - db) <= 1e-4, axis=1).mean() >= 0.97
    mj, mt = _matches(fj), _matches(ft)
    assert len(mj) > 60 and len(mj & mt) / len(mj | mt) >= 0.95, (len(mj), len(mt), len(mj & mt))
    ref = _run("real_pair", jax_api, tmp_path / "jax")
    row = _run("real_pair", api, tmp_path / "port", plain_calls)
    assert plain_calls == chip_smoke.E2E_LAUNCHES["real_pair"]
    assert row["texture_sha256"] == ref["texture_sha256"] == chip_smoke.REAL_TEXTURE_SHA256
    assert abs(row["matches"] - ref["matches"]) <= 0.05 * ref["matches"], (row, ref)


def test_real_texture_degraded_e2e(api, tmp_path, plain_calls):
    """``tests/test_realistic.py:92-151`` through the port: 12 real-texture
    views under the whole degradation stack, K from EXIF on a CROP_FRAME
    sensor, inside the JAX test's gates (focal within rtol 1e-6 of 400, under
    1.0 px, ATE under 4% of the extent, more than 300 tracks; seen 0.473 px,
    0.0116, 865 tracks against JAX's 0.480 px, 0.0117, 796). Each written
    file's EXIF K is JAX's, bit for bit, and the engine's K for image 1 is
    JAX's decoded K within rtol 1e-6. Launches Harris 2, matcher 1."""
    from sfmfromscratch_tpu.geometry import camera as jcam
    from sfmfromscratch_tpu_torch.geometry import camera as tcam

    row = _run("real_degraded_global", api, tmp_path, plain_calls)
    assert plain_calls == chip_smoke.E2E_LAUNCHES["real_degraded_global"]
    assert row["cameras"] == 12 and row["K_per_camera"]
    for i in range(1, 13):
        path = str(tmp_path / "seq" / f"{i}.jpg")
        got = tcam.intrinsics_from_exif(path, tcam.SensorType.CROP_FRAME)
        ref = jcam.intrinsics_from_exif(path, jcam.SensorType.CROP_FRAME)
        np.testing.assert_array_equal(got, ref)
        if i == 1:
            np.testing.assert_allclose(row["K0_focal"], ref[0, 0], rtol=1e-6)


def test_planar_wall_with_and_without_the_fix(api, tmp_path, plain_calls):
    """``tests/test_graph_surgery.py:44-77`` through the port: the
    one-plane scene warns "planar-degenerate", every live edge's rotation
    within 2 degrees (seen 0.328, JAX 0.320), under 2 px after BA, and with
    ``_fix_planar_degenerate_edges`` a no-op the largest edge error is more
    than twice the fixed run's (seen 5.40 degrees, JAX 6.35). The fix is
    back on the class after the scenario, also when the contrast run
    raises. Launches Harris 4, matcher 2 (two engine runs)."""
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine

    fix = vars(GlobalSfmEngine)["_fix_planar_degenerate_edges"]
    row = _run("planar_wall", api, tmp_path / "ok", plain_calls)
    assert plain_calls == chip_smoke.E2E_LAUNCHES["planar_wall"]
    assert vars(GlobalSfmEngine)["_fix_planar_degenerate_edges"] is fix
    assert not row["contrast_planar_warning"]

    runs = []

    def engine(*a, **k):
        runs.append(vars(GlobalSfmEngine)["_fix_planar_degenerate_edges"] is fix)
        if len(runs) == 2:
            raise RuntimeError("contrast run")
        return api.GlobalSfmEngine(*a, **k)

    failing = type(api)(**{**vars(api), "GlobalSfmEngine": engine})
    with pytest.raises(RuntimeError, match="contrast run"):
        chip_smoke.scenario_run("planar_wall", failing, str(tmp_path / "raise"))
    assert runs == [True, False]
    assert vars(GlobalSfmEngine)["_fix_planar_degenerate_edges"] is fix


# ---------------------------------------------------------------- the shootout


@pytest.mark.parametrize("step", [8.0, 32.0])
def test_shootout_matches_jax(step, plain_calls):
    """``tools/eval_superpoint.py`` and ``tools/eval_superpoint_torch.py`` on
    the same pair with the committed checkpoint: JAX's rows are
    ``chip_smoke.SHOOTOUT_JAX``'s, and the port's are within its pins (match
    counts within 10%, inlier shares within 3 points). Seen: TinyPoint and
    the hybrid the same numbers as JAX, SIFT 335 and 124 matches against
    338 and 125. Launches Harris 6, matcher 3."""
    from tools.eval_superpoint import run_pair as jax_run_pair

    (row,) = chip_smoke.shootout_rows(torch.device("cpu"), steps=(step,))
    assert plain_calls == chip_smoke.SHOOTOUT_LAUNCHES
    assert not chip_smoke.shootout_failures([row])
    for (n, r), (n_pin, inl_pin), name in zip(jax_run_pair(step), chip_smoke.SHOOTOUT_JAX[step],
                                              ("sift", "tinypoint", "hybrid")):
        assert (n, r) == (n_pin, inl_pin / n_pin), name
        got = row[name]
        assert abs(got["matches"] - n) <= 0.10 * n and abs(got["inlier_share"] - r) <= 0.03, \
            (name, got, n, r)


def test_shootout_failures_flag_each_pin():
    """``shootout_failures`` passes JAX's own rows and flags a match count
    11% off and an inlier share 4 points off."""
    rows = [dict(step=s, **{name: dict(matches=n, inlier_share=inl / n) for name, (n, inl)
                            in zip(("sift", "tinypoint", "hybrid"), v)})
            for s, v in chip_smoke.SHOOTOUT_JAX.items()]
    assert chip_smoke.shootout_failures(rows) == []
    rows[0]["hybrid"]["matches"] = round(1.11 * rows[0]["hybrid"]["matches"])
    rows[4]["sift"]["inlier_share"] -= 0.04
    fails = chip_smoke.shootout_failures(rows)
    assert len(fails) == 2 and "8.0 deg hybrid" in fails[0] and "32.0 deg sift" in fails[1]


def test_eval_tool_imports_no_jax():
    """``python tools/eval_superpoint_torch.py 8 --device cpu`` in a fresh
    interpreter loads neither ``jax`` nor the JAX package, prints JAX's
    TinyPoint row at 8 degrees, and without ``--device`` asks for the card
    (and raises here, where there is none)."""
    tool = ROOT / "tools" / "eval_superpoint_torch.py"
    code = (
        "import runpy, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "sys.argv = ['eval_superpoint_torch.py', '8', '--device', 'cpu']\n"
        f"runpy.run_path({str(tool)!r}, run_name='__main__')\n"
        f"print('FORBIDDEN', sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r}))\n"
        "torch.cuda.is_available = lambda: False\n"
        "mod = runpy.run_path(" + repr(str(tool)) + ")\n"
        "try:\n"
        "    mod['run_pair'](8.0)\n"
        "except RuntimeError as e:\n"
        "    print('NO CARD', e)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN []" in r.stdout and "NO CARD" in r.stdout, r.stdout
    line = next(ln for ln in r.stdout.splitlines() if ln.strip().startswith("8 |"))
    assert line.split("|")[2].split() == ["261", "25.7%"], line
