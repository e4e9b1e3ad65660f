"""The JAX package's scenario tests, run through the PyTorch port on the CPU.

Each test builds its JAX test's scene with the same renderer calls, seeds
and files, runs the port's engines at that test's configuration
(``chip_smoke.scenario_run``, which ``chip_smoke.py``'s scenarios phase runs
on the card) and asserts that test's own gates, cited by ``file:line``:
a featureless frame, a duplicate frame and two images
(``tests/test_robustness.py``), degraded imaging (``tests/test_adversarial.py``),
the wide baselines (``tests/test_wide_baseline.py``) and per-image K from
EXIF (``tests/test_exif.py``). The cheap parts are held against JAX on the
same inputs: ``intrinsics_from_exif`` on the same JPEGs, and the 20-degree
pair's match count and epipolar median.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tests.render import render_sequence, write_sequence

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


@pytest.fixture(scope="module")
def api():
    return chip_smoke.port_scenario_api(torch.device("cpu"))


def _run(name, api, tmp_path):
    return chip_smoke.scenario_run(name, api, str(tmp_path))


def test_featureless_frame_recovery(api, tmp_path):
    """A flat frame 4 of the 6-view orbit: the incremental engine in recover
    mode registers 5 cameras and warns, the global engine keeps 6 and warns
    of components (``tests/test_robustness.py:40-42, 46-48``)."""
    row = _run("featureless", api, tmp_path)
    assert row["incremental_cameras"] == 5
    assert row["incremental_recovery_warning"], row["incremental_warnings"]
    assert row["incremental_reproj_px"] < 3.0
    assert row["global_cameras"] == 6
    assert row["global_components_warning"], row["global_warnings"]
    assert row["global_reproj_px"] < 3.0


def test_duplicate_image_zero_baseline(api, tmp_path):
    """Frame 3 a copy of frame 2: both engines end BA under 3 px
    (``tests/test_robustness.py:63, 67``)."""
    row = _run("duplicate", api, tmp_path)
    assert row["incremental_reproj_px"] < 3.0
    assert row["global_reproj_px"] < 3.0


def test_minimal_two_view_sequences(api, tmp_path):
    """Two images: both engines reconstruct them under 3 px
    (``tests/test_robustness.py:82, 85``)."""
    row = _run("two_images", api, tmp_path)
    assert row["incremental_reproj_px"] < 3.0
    assert row["global_reproj_px"] < 3.0


def test_incremental_engine_on_degraded_sequence(api, tmp_path):
    """The 6-view planes scene clean and through ``degrade_sequence``: the
    degraded run under 2.5 px and 8% ATE, with more than 0.4x the clean
    run's tracks (``tests/test_adversarial.py:71-73``)."""
    row = _run("degraded_incremental", api, tmp_path)
    assert row["degraded_reproj_px"] < 2.5
    assert row["degraded_ate_pct"] < 8.0
    assert row["degraded_tracks"] > 0.4 * row["clean_tracks"]


def test_global_engine_on_degraded_planes(api, tmp_path):
    """The degraded 8-view planes scene through the global engine: under
    2.0 px and 8% ATE (``tests/test_adversarial.py:92, 97``)."""
    row = _run("degraded_global", api, tmp_path)
    assert row["reproj_px"] < 2.0
    assert row["ate_pct"] < 8.0


def test_two_view_twenty_degrees_matches_jax(api, tmp_path):
    """Views 0 and 2 of the 10-degree planes scene: more than 80 matches and
    a median epipolar distance under 1.5 px (``tests/test_wide_baseline.py:37,
    45``); against JAX's ``FeatureRunner`` on the same images, the match
    count within 15% of JAX's and the median within 0.1 px. (Seen: 170 and
    0.794 px against JAX's 154 and 0.812 px. The port's SIFT gradients are
    exactly zero where the image is constant along an axis; JAX's
    convolution leaves residues of either sign there, which move pixels
    between the first and the last orientation bin on 12% of this scene.)"""
    from tools.scenario_pins import jax_scenario_api

    row = _run("pair_20deg", api, tmp_path)
    assert row["matches"] > 80
    assert row["median_epipolar_px"] < 1.5
    ref = _run("pair_20deg", jax_scenario_api(), tmp_path / "jax")
    assert abs(row["matches"] - ref["matches"]) <= 0.15 * ref["matches"], (row, ref)
    assert abs(row["median_epipolar_px"] - ref["median_epipolar_px"]) <= 0.1, (row, ref)


def test_sift_gradients_are_exact_where_the_image_is_flat(monkeypatch):
    """``sobel_jax_residues`` on the 20-degree pair's first view, alone and
    in a batch with the second: where the three pixel pairs that the Sobel
    differences are equal (on this scene more than 5% of the pixels for each
    axis) JAX's bits, signed zeros included: the exact gradient there is 0
    and JAX's bits hold rounding residues, which torch's convolution puts
    elsewhere; everywhere else the convolution's bits
    (``sobel_gradients``). ``sift_descriptors`` reads it."""
    import jax.numpy as jnp
    import torch.nn.functional as F

    from sfmfromscratch_tpu.ops.image import sobel_gradients as jax_sobel
    from sfmfromscratch_tpu_torch.ops import sift
    from sfmfromscratch_tpu_torch.ops.image import sobel_gradients

    images, _, _, _ = chip_smoke._render_module().render_planes(
        np.random.default_rng(0), num_views=2, orbit_step_deg=10.0)
    bits = lambda a: np.asarray(a).view(np.int32)
    for ims in (images[0], np.stack(images[:2])):
        img = torch.as_tensor(ims)
        x = F.pad(img, (1, 1, 1, 1)).numpy()
        eq_x, eq_y = x[..., :, 2:] == x[..., :, :-2], x[..., 2:, :] == x[..., :-2, :]
        flats = (eq_x[..., :-2, :] & eq_x[..., 1:-1, :] & eq_x[..., 2:, :],
                 eq_y[..., :, :-2] & eq_y[..., :, 1:-1] & eq_y[..., :, 2:])
        for g, ref, conv, flat in zip(sift.sobel_jax_residues(img), jax_sobel(jnp.asarray(ims)),
                                      sobel_gradients(img), flats):
            g, ref, conv = bits(g.numpy()), bits(ref), bits(conv.numpy())
            assert flat.mean() > 0.05
            np.testing.assert_array_equal(g[flat], ref[flat])
            np.testing.assert_array_equal(g[~flat], conv[~flat])
            assert np.any(g[flat] != 0) and np.any(conv[flat] != g[flat])
    img = torch.as_tensor(images[0])
    calls, real = [], sift.sobel_jax_residues
    monkeypatch.setattr(sift, "sobel_jax_residues", lambda im: calls.append(im.shape) or real(im))
    xy = torch.tensor([100, 120], dtype=torch.int32)
    sift.sift_descriptors(img, xy, xy, torch.ones(2, dtype=torch.bool), feature_width=16)
    assert calls == [img.shape]


@pytest.mark.parametrize("rotation_invariant", [False, True])
def test_sift_descriptors_match_jax_on_planes(monkeypatch, rotation_invariant):
    """``sift_descriptors`` of both packages on the 20-degree pair's first
    view, 12% of whose pixels are flat along an axis, at 300 keypoints
    (rows agree when every entry is within 1e-4):

    * the port (JAX's residues where the image is flat along an axis,
      ``sobel_jax_residues``) equals JAX at every keypoint with the dominant
      orientation, and at 80% (0.801 seen) without it, where XLA's and
      torch's ``atan2`` part by one ulp at -pi/2 on a residue beside a
      vertical edge, on a bin edge;
    * with the gradients set to exactly +0 where the image is flat along
      the derivative's axis, in both packages, the two agree at every
      keypoint (9e-7 seen);
    * that rule moves most rows: JAX with it agrees with plain JAX at 12.5%
      (without) and 13.6% (with the dominant orientation) of the keypoints,
      which is why the port keeps JAX's residues there."""
    import jax
    import jax.numpy as jnp

    from sfmfromscratch_tpu.ops import sift as jsift
    from sfmfromscratch_tpu_torch.ops import sift
    from tools.sobel_residue_pairs import jax_exact_zeros, port_exact_zeros

    images, _, _, _ = chip_smoke._render_module().render_planes(
        np.random.default_rng(0), num_views=1, orbit_step_deg=10.0)
    img = images[0].astype(np.float32)
    r = np.random.default_rng(9)
    x, y = r.integers(0, 320, 300).astype(np.int32), r.integers(0, 240, 300).astype(np.int32)
    mask = r.uniform(size=300) > 0.1
    jax_sobel = jsift.sobel_gradients

    def jax_rows(sobel):
        monkeypatch.setattr(jsift, "sobel_gradients", sobel)
        jax.clear_caches()   # the jitted function reads the name when it traces
        try:
            return np.asarray(jsift.sift_descriptors(
                jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                feature_width=16, rotation_invariant=rotation_invariant))
        finally:
            monkeypatch.setattr(jsift, "sobel_gradients", jax_sobel)
            jax.clear_caches()

    def port_rows():
        return sift.sift_descriptors(torch.as_tensor(img), torch.as_tensor(x), torch.as_tensor(y),
                                     torch.as_tensor(mask), feature_width=16,
                                     rotation_invariant=rotation_invariant).numpy()

    def close(a, b):
        return np.all(np.abs(a - b) <= 1e-4, axis=1)[mask]

    ref, ref_zeros, got = jax_rows(jax_sobel), jax_rows(jax_exact_zeros(jax_sobel)), port_rows()
    assert close(got, ref).mean() >= (1.0 if rotation_invariant else 0.8)
    monkeypatch.setattr(sift, "sobel_jax_residues", port_exact_zeros(sift.sobel_jax_residues))
    assert close(port_rows(), ref_zeros).all()
    assert 0.1 <= close(ref_zeros, ref).mean() <= 0.2, close(ref_zeros, ref).mean()


def test_global_reconstruction_ten_degree_steps(api, tmp_path):
    """The 12-view planes scene at 10-degree steps through the global
    engine with window and retrieval pairs: more than 500 tracks, under
    1.0 px and 2% ATE (``tests/test_wide_baseline.py:68-69, 83``)."""
    row = _run("global_10deg", api, tmp_path)
    assert row["tracks"] > 500
    assert row["reproj_px"] < 1.0
    assert row["ate_pct"] < 2.0


def test_engine_exif_intrinsics_e2e(api, tmp_path):
    """Four 472x312 JPEGs with a 26 mm EXIF focal on a CROP_FRAME sensor:
    each file's K is the render K, the engine keeps one K per camera, each
    the render K, registers at least 3 cameras and ends BA under 2.0 px
    (``tests/test_exif.py:125-126, 131-135``; rtol 1e-6 as there)."""
    row = _run("exif", api, tmp_path)
    assert row["file_K_rel_gap"] <= 1e-6
    assert row["K_per_camera"] and row["cameras"] >= 3
    assert row["engine_K_rel_gap"] <= 1e-6
    assert np.isfinite(row["reproj_px"]) and row["reproj_px"] < 2.0


def test_engine_exif_scale_factor(api, tmp_path):
    """With ``scale_factor=0.5`` every camera's K is the render K scaled by
    0.5 (``tests/test_exif.py:159-161``)."""
    row = _run("exif_half", api, tmp_path)
    assert row["engine_K_rel_gap"] <= 1e-6


def test_intrinsics_from_exif_matches_jax(tmp_path):
    """``intrinsics_from_exif`` of both packages on the same JPEGs (the EXIF
    scenes' 472x312 files at 26 mm, the bench's 480x360 files at 208/15 mm)
    gives the same K, bit for bit, for every sensor; on ONE_INCH the bench
    files give the render K (f = 520 px) within 1e-6."""
    from sfmfromscratch_tpu.geometry import camera as jcam
    from sfmfromscratch_tpu_torch.geometry import camera as tcam

    files = []
    for hw, focal in (((312, 472), 26.0), ((360, 480), chip_smoke.EXIF_BENCH_FOCAL_MM)):
        images, K, _, _ = render_sequence(np.random.default_rng(3), num_views=2,
                                          num_points=40, img_hw=hw, f=520.0)
        d = tmp_path / f"{hw[1]}x{hw[0]}"
        d.mkdir()
        write_sequence(str(d), images, exif_focal_mm=focal)
        files += [(str(d / f"{i}.jpg"), K) for i in (1, 2)]
    assert [m.name for m in tcam.SensorType] == [m.name for m in jcam.SensorType]
    for path, _ in files:
        for st in tcam.SensorType:
            got = tcam.intrinsics_from_exif(path, st)
            ref = jcam.intrinsics_from_exif(path, jcam.SensorType[st.name])
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    for path, K in files[2:]:
        got = tcam.intrinsics_from_exif(path, tcam.SensorType[chip_smoke.EXIF_BENCH_SENSOR])
        np.testing.assert_allclose(got, K, rtol=1e-6)
