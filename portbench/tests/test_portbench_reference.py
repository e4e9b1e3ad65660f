"""The plain reference on tiny inputs."""

import numpy as np
import pytest
import torch

from portbench.reference import frontend as F
from portbench.reference import geometry as G


def _rot(rv):
    return G.rodrigues(np.asarray(rv, float))


def test_rodrigues_and_angles():
    assert np.allclose(_rot([0, 0, 0]), np.eye(3))
    R = _rot([0, 0, np.pi / 2])
    assert np.allclose(R @ [1, 0, 0], [0, 1, 0])
    assert G.rotation_angle_deg(_rot([0.1, -0.2, 0.3])) == pytest.approx(
        np.degrees(np.linalg.norm([0.1, -0.2, 0.3])))


def _scene(rng, n=40):
    K = np.array([[500.0, 0, 240], [0, 500.0, 180], [0, 0, 1]])
    X = rng.uniform([-2, -1.5, 5], [2, 1.5, 9], (n, 3))
    poses = [(np.eye(3), np.zeros(3)), (_rot([0.01, -0.05, 0.02]), np.array([-0.4, 0.05, 0.1])),
             (_rot([0.02, -0.1, 0.03]), np.array([-0.8, 0.1, 0.15]))]

    def proj(R, t):
        p = (X @ R.T + t) @ K.T
        return p[:, :2] / p[:, 2:]

    return K, X, poses, [proj(R, t) for R, t in poses]


def test_epipolar_distance_is_zero_for_true_matches_and_grows_off_the_line():
    K, X, poses, uv = _scene(np.random.default_rng(0))
    F_ = G.fundamental(K, K, *poses[0], *poses[1])
    assert np.max(G.epipolar_px(F_, uv[0], uv[1])) < 1e-8
    moved = uv[1] + np.array([0.0, 3.0])
    d = G.epipolar_px(F_, uv[0], moved)
    assert np.all(d > 1.0) and np.all(d < 4.0)   # the larger of the two sides' distances


def test_reprojection_is_zero_for_exact_observations():
    K, X, poses, uv = _scene(np.random.default_rng(1))
    rv = [np.zeros(3), np.array([0.01, -0.05, 0.02])]
    t = [poses[0][1], poses[1][1]]
    frames = np.repeat([0, 1], len(X))
    tracks = np.tile(np.arange(len(X)), 2)
    xy = np.vstack([uv[0], uv[1]])
    err = G.reprojection_px(rv, t, [K, K], X, frames, tracks, xy)
    assert err.max() < 1e-9
    err = G.reprojection_px(rv, t, [K, K], X, frames, tracks, xy + [3.0, 4.0])
    assert np.allclose(err, 5.0)


def test_pose_errors_ignore_the_gauge():
    K, X, poses, _ = _scene(np.random.default_rng(2))
    # the same cameras in another world frame, at another scale
    S, Rw, tw = 2.5, _rot([0.3, 0.2, -0.1]), np.array([1.0, -2.0, 0.5])
    moved = [(R @ Rw.T, S * (t - R @ Rw.T @ tw)) for R, t in poses]
    rot, ate = G.pose_errors(moved, poses)
    assert rot < 1e-5 and ate < 1e-9
    bent = list(moved)
    bent[2] = (_rot([0, 0.02, 0]) @ moved[2][0], moved[2][1])
    assert G.pose_errors(bent, poses)[0] == pytest.approx(np.degrees(0.02), rel=1e-6)


def test_depths_and_the_first_camera_projection():
    K, X, _, uv = _scene(np.random.default_rng(3))
    rv, t = [np.zeros(3)], [np.zeros(3)]
    frames, tracks = np.zeros(len(X), np.int64), np.arange(len(X))
    assert np.allclose(G.depths(rv, t, X, frames, tracks), X[:, 2])
    assert G.first_camera_px(K, X, uv[0]).max() < 1e-9
    # the twin decomposition: the mirrored points reproject onto the same pixels, behind
    assert G.first_camera_px(K, -X, uv[0]).max() < 1e-9
    assert np.all(G.depths(rv, t, -X, frames, tracks) < 0)
    assert G.first_camera_px(K, X, uv[0] + [0.0, 2.0]) == pytest.approx(np.full(len(X), 2.0))


def test_front_end_on_a_tiny_stack(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (48, 64))
    files = []
    for i, shift in enumerate((0, 2), start=1):
        img = (np.roll(base, shift, axis=1) * 255).astype(np.uint8)
        p = tmp_path / f"{i}.png"
        Image.fromarray(np.stack([img] * 3, -1)).save(p)
        files.append(str(p))
    ex = dict(num_interest_points=60, ksize=3, gaussian_size=5, sigma=2.0, alpha=0.05,
              feature_width=8, pyramid_level=2, pyramid_scale_factor=1.5)
    xy, mask, matches = F.run_front(files, ex, [(1, 2)], 0.9, torch.device("cpu"))
    assert xy.shape == (2, 60, 2) and mask.shape == (2, 60) and mask.sum() > 20
    nn, ok = matches[(1, 2)]
    # the second image is the first rolled by 2 px: accepted matches move by +2 in x
    good = ok & mask[0]
    d = xy[1][nn[good]] - xy[0][good]
    inside = (xy[0][good, 0] > 8) & (xy[0][good, 0] < 52)
    assert good.sum() > 10 and np.mean(np.abs(d[inside] - [2, 0]).max(1) < 1e-3) > 0.6
    xy2, mask2, _ = F.run_front(files, ex, [(1, 2)], 0.9, torch.device("cpu"))
    assert np.array_equal(xy, xy2) and np.array_equal(mask, mask2)


def test_ratio_test_on_hand_made_descriptors():
    d1 = torch.tensor([[1.0, 0.0], [0.5, 1.0], [0.7, 0.7]])
    d2 = torch.tensor([[1.0, 0.05], [0.0, 1.0], [0.05, 1.0], [5.0, 5.0]])
    m1 = torch.tensor([True, True, True])
    m2 = torch.tensor([True, True, True, False])
    nn, ok = F.ratio_test(d1, d2, m1, m2, 0.8)
    assert nn.tolist()[0] == 0 and ok.tolist() == [True, False, False]
