"""The port's ``SfmEngine`` on odd inputs against the JAX engine, on the CPU:
images of different sizes, images of one size in different modes (RGB and
grayscale files), and a two-image sequence.

Scenes: ``tests/test_pipeline.py::test_engine_mixed_image_shapes``'s 4 views
(``render_sequence(default_rng(9), 4 views, 110 points)``, 240x320, f=400)
at its ``_small_config``, with image 2 padded by 16 px at the bottom and
right, or with image 3 saved as a grayscale file; and the first two views of
``tests/test_torch_engine.py``'s 160x220 scene at that file's configuration.
The features stage is compared on the same files; the engine runs draw their
own RANSAC samples, so their gates are the seed spreads measured on these
scenes over ``config.seed`` 0-4 in both packages, stated at each test.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from sfmfromscratch_tpu.pipeline import incremental as jinc
from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.pipeline import incremental as tinc
from tests.render import render_sequence, write_sequence
from tests.test_pipeline import _small_config
from tests.test_torch_engine import _ate_over_extent, _jax_config

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def four_views():
    return render_sequence(np.random.default_rng(9), num_views=4, num_points=110)


def _write_odd(d, images, kind):
    """Grayscale JPEGs as the JAX test writes them, with image 2 padded
    (``sizes``) or every image but 3 saved as RGB (``modes``)."""
    for i, im in enumerate(images, start=1):
        arr = (np.clip(im, 0, 1) * 255).astype(np.uint8)
        if kind == "sizes" and i == 2:
            arr = np.pad(arr, ((0, 16), (0, 16)), mode="edge")
        if kind == "modes" and i != 3:
            arr = np.stack([arr] * 3, -1)
        Image.fromarray(arr).save(str(d / f"{i}.jpg"), quality=97)


@pytest.mark.parametrize("kind", ["sizes", "modes"])
def test_odd_images_features_match_jax(kind, four_views, tmp_path):
    """The features stage on images of two sizes (each extracted on its own)
    and on RGB and grayscale files of one size (one batch, each image
    preprocessed from float): per image the same keypoints as JAX's
    ``_extract_all_features`` but for 1% (a near-tie at the capacity cut).
    Descriptors of common keypoints: at least 97% of the rows with a cosine
    above 0.99 to JAX's row, and at least 70% within 1e-4. On grayscale
    JPEGs the pixels are multiples of 1/255, so gradient angles tie on bin
    edges far more often than on the float images of ``test_torch_ops.py``
    (97% within 1e-4 there): measured between the two packages on these
    images, 77-85% of the rows within 1e-4 and 99-100% above a cosine of
    0.99 (a tied pixel moves to the next bin)."""
    images, K, _, _ = four_views
    _write_odd(tmp_path, images, kind)
    cfg = _small_config()
    jeng = jinc.SfmEngine(str(tmp_path), 4, config=cfg, single_K=K, auto_run=False)
    teng = tinc.SfmEngine(str(tmp_path), 4, config=interop.config_from_dict(
        dataclasses.asdict(cfg)), single_K=K, device="cpu", auto_run=False)
    jf, tf = jeng._extract_all_features(), teng._extract_all_features()
    assert tuple(tf.descriptors.shape) == tuple(jf.descriptors.shape) == (4, 400, 128)
    for i in range(4):
        jk, tk = jf.keypoints, tf.keypoints
        sj = {(int(x), int(y)) for x, y, m in zip(_np(jk.x[i]), _np(jk.y[i]), _np(jk.mask[i])) if m}
        st = {(int(x), int(y)) for x, y, m in zip(_np(tk.x[i]), _np(tk.y[i]), _np(tk.mask[i])) if m}
        assert len(st) > 100 and len(sj ^ st) <= 0.01 * len(sj | st), i
        same = (_np(tk.x[i]) == _np(jk.x[i])) & (_np(tk.y[i]) == _np(jk.y[i])) & _np(tk.mask[i])
        g, r = _np(tf.descriptors[i])[same], _np(jf.descriptors[i])[same]
        close = np.all(np.abs(g - r) <= 1e-4, axis=1)
        cos = (g * r).sum(1) / np.maximum(np.linalg.norm(g, axis=1) * np.linalg.norm(r, axis=1),
                                          1e-12)
        assert (cos > 0.99).mean() >= 0.97 and close.mean() >= 0.7, (i, cos.min(), close.mean())


@pytest.mark.parametrize("kind", ["sizes", "modes"])
def test_odd_images_engine_matches_jax(kind, four_views, tmp_path):
    """The whole engine on those files in both packages. Seed spreads on
    these scenes (config.seed 0-4): two sizes, ATE over extent JAX
    0.041-0.180, port 0.028-0.123, post-BA error JAX 0.076-0.137 px, port
    0.062-0.109 px, tracks JAX 146-161, port 151-164; two modes, ATE JAX
    0.012-0.034, port 0.010-0.050, error JAX 0.086-0.107, port 0.070-0.110,
    tracks JAX 162-166, port 152-167. So: every camera registered, the
    post-BA error within 0.08 px of JAX's, ATE at most JAX's plus 0.25 and
    tracks within 15% of JAX's (``test_torch_engine.py``'s gates), and the
    JAX test's own gates (over 30 tracks, under 3 px)."""
    images, K, poses, _ = four_views
    _write_odd(tmp_path, images, kind)
    cfg = _small_config()
    jeng = jinc.SfmEngine(str(tmp_path), 4, config=cfg, single_K=K)
    teng = tinc.SfmEngine(str(tmp_path), 4, config=interop.config_from_dict(
        dataclasses.asdict(cfg)), single_K=K, device="cpu")
    assert len(teng.global_poses) == len(jeng.global_poses) == 3
    e1, j1 = teng.errors_before_after_ba[1], jeng.errors_before_after_ba[1]
    assert teng.map.num_tracks > 30 and e1 < 3.0
    assert abs(e1 - j1) <= 0.08, (e1, j1)
    ate_t = _ate_over_extent(teng.global_poses, poses)
    ate_j = _ate_over_extent(jeng.global_poses, poses)
    assert ate_t <= ate_j + 0.25, (ate_t, ate_j)
    assert abs(teng.map.num_tracks - jeng.map.num_tracks) <= 0.15 * jeng.map.num_tracks


def test_two_images_match_jax(tmp_path):
    """``SfmEngine(max_img=2)``: the bootstrap and the final BA only, on the
    staged path (no fused front, as ``incremental.py:863``), in both
    packages. Seed spreads (config.seed 0-4): rotation error JAX
    0.30-1.31 deg, port 0.35-1.79 deg; tracks JAX 44-47, port 44-48; both
    end BA under 2e-6 px (two views fit exactly). The translation
    direction of this short baseline is not gated (23-102 deg over the same
    seeds in both packages). So: one pose each, rotation within 2.5 deg of
    the truth, tracks within 15% of JAX's, the post-BA error under 1e-4 px,
    and the same stages run."""
    from scipy.spatial.transform import Rotation

    images, K, poses, _ = render_sequence(
        np.random.default_rng(21), num_views=3, num_points=90, img_hw=(160, 220), f=300.0,
        step_t=(-0.2, 0.02, 0.03), step_r=(0.008, -0.02, 0.005))
    write_sequence(str(tmp_path), images[:2])
    K_half = K.copy()
    K_half[:2] *= 0.5
    cfg = _jax_config()
    jeng = jinc.SfmEngine(str(tmp_path), 2, config=cfg, single_K=K_half)
    teng = tinc.SfmEngine(str(tmp_path), 2, config=interop.config_from_dict(
        dataclasses.asdict(cfg)), single_K=K_half, device="cpu")
    assert len(teng.global_poses) == len(jeng.global_poses) == 1
    R_gt = poses[1][0] @ poses[0][0].T
    R = Rotation.from_rotvec(teng.global_poses[0][0]).as_matrix()
    rot = np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
    assert rot <= 2.5, rot
    assert abs(teng.map.num_tracks - jeng.map.num_tracks) <= 0.15 * jeng.map.num_tracks
    assert teng.errors_before_after_ba[1] < 1e-4 and jeng.errors_before_after_ba[1] < 1e-4
    assert set(teng.stage_times) >= {"features", "matching", "filter", "bootstrap", "chain", "ba"}
    assert set(teng.pair_geometry) == set(jeng.pair_geometry) == {(1, 2), (2, 1)}
