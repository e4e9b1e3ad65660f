"""The port's other front ends against the JAX package, on the CPU: the DoG
detector and its extractor, the SuperPoint network at both widths and its
extractors, their checkpoints, and both engines with the extractor slot.

Images come from numpy seeds; the SuperPoint weights cross from flax through
``interop.superpoint_params_from_flax``, so both packages run the same net.
The matcher's plain version is held to the JAX Pallas kernel at the
256-wide descriptors of the full SuperPoint. Each tolerance is stated where
it is used.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu.ops import dog as jdog
from sfmfromscratch_tpu.ops import superpoint as jsp
from sfmfromscratch_tpu.ops.pallas.match_kernel import match_top2_fused as jmatch_top2
from sfmfromscratch_tpu.pipeline import frontend as jfront
from sfmfromscratch_tpu.pipeline import incremental as jinc
from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine as JGlobal

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ops import dog as tdog
from sfmfromscratch_tpu_torch.ops import superpoint as tsp
from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK
from sfmfromscratch_tpu_torch.pipeline import frontend as tfront
from sfmfromscratch_tpu_torch.pipeline import incremental as tinc
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as TGlobal
from sfmfromscratch_tpu_torch.utils.metrics import absolute_trajectory_error, camera_centers
from tests import test_global_sfm, test_pipeline
from tests.render import render_sequence, write_sequence

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _image(hw, seed, blobs=True):
    """Smoothed uniform noise in [0, 1] with a few Gaussian blobs."""
    r = np.random.default_rng(seed)
    img = r.uniform(0, 1, hw)
    k = np.ones(3) / 3
    img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 0, img)
    img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, img) * 0.5
    if blobs:
        yy, xx = np.mgrid[:hw[0], :hw[1]]
        for _ in range(4):
            cy, cx, s = r.uniform(8, hw[0] - 8), r.uniform(8, hw[1] - 8), r.uniform(1.5, 4)
            img += 0.5 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def _same_keypoints(got, ref):
    """Equal masks, and equal coordinates and scores (1e-5) under the mask;
    masked slots carry arbitrary coordinates in both packages."""
    m = _np(ref.mask)
    np.testing.assert_array_equal(_np(got.mask), m)
    np.testing.assert_array_equal(_np(got.x)[m], _np(ref.x)[m])
    np.testing.assert_array_equal(_np(got.y)[m], _np(ref.y)[m])
    np.testing.assert_allclose(_np(got.score), _np(ref.score), atol=1e-5)
    assert got.x.dtype == torch.int32 and got.mask.dtype == torch.bool
    return m


# --- ops/dog.py and make_dog_extractor ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dog_matches_jax(seed):
    """``detect_dog_keypoints`` at 64x80 with k=300 (past the last
    candidate, so the -inf tail is ranked too): the same masked keypoints in
    the same order, scores within 1e-5 (|DoG| responses below 1; measured
    8e-7)."""
    img = _image((64, 80), seed)
    ref = jdog.detect_dog_keypoints(jnp.asarray(img), k=300)
    got = tdog.detect_dog_keypoints(_t(img), k=300)
    m = _same_keypoints(got, ref)
    assert 5 < m.sum() < 300


def test_dog_finds_blob_centres():
    """The JAX test's blobs of three sizes: each centre is found within 4 px
    (``tests/test_extensions.py::test_dog_detector``)."""
    r = np.random.default_rng(3)
    img = r.uniform(0, 0.05, (96, 128)).astype(np.float32)
    yy, xx = np.mgrid[:96, :128]
    centres = [(30, 40, 3.0), (60, 90, 6.0), (70, 30, 2.0)]
    for cy, cx, s in centres:
        img += 0.8 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)).astype(np.float32)
    kps = tdog.detect_dog_keypoints(_t(img), k=16)
    m = _np(kps.mask)
    pts = list(zip(_np(kps.x)[m], _np(kps.y)[m]))
    for cy, cx, _ in centres:
        assert any(abs(x - cx) <= 4 and abs(y - cy) <= 4 for x, y in pts), (cy, cx, pts)


def test_top_k_stable_orders_ties_by_index():
    """Equal scores rank in index order and the -inf tail follows, as
    ``lax.top_k`` ranks them."""
    s = np.array([1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, -np.inf, 2.0], np.float32)
    top, idx = tdog.top_k_stable(_t(s), 8)
    jtop, jidx = jax.lax.top_k(jnp.asarray(s), 8)
    np.testing.assert_array_equal(_np(idx), _np(jidx))
    np.testing.assert_array_equal(_np(top), _np(jtop))


def _rendered_image():
    images, _, _, _ = render_sequence(np.random.default_rng(42), num_views=2, num_points=110)
    return np.asarray(images[0], np.float32)


def _same_descriptors(got, ref, m):
    """RootSIFT rows: at least 97% within 1e-4 and every valid row's cosine
    above 0.9 (the tolerance of ``test_sift_descriptors_match_jax``: an
    ``arctan2`` one ulp apart moves a pixel to the next orientation bin);
    invalid rows zero."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.all(got[~m] == 0)
    close = np.all(np.abs(got - ref) <= 1e-4, axis=1)[m]
    assert close.mean() >= 0.97, close.mean()
    cos = (got * ref).sum(1) / np.maximum(np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1),
                                          1e-12)
    assert np.all(cos[m] > 0.9), cos[m].min()


def test_make_dog_extractor_matches_jax():
    """The DoG front end on a rendered 240x320 view at 400 keypoints: the
    same keypoints, RootSIFT descriptors at feature width 16 as
    ``_same_descriptors`` holds them."""
    cfg = test_pipeline._small_config().extractor
    img = _rendered_image()
    ref = jfront.make_dog_extractor(cfg)(jnp.asarray(img))
    got = tfront.make_dog_extractor(interop.config_from_dict(dataclasses.asdict(cfg)))(_t(img))
    m = _same_keypoints(got.keypoints, ref.keypoints)
    assert m.sum() > 100
    _same_descriptors(got.descriptors, ref.descriptors, m)


# --- ops/superpoint.py --------------------------------------------------------

def _flax_variables(width, hw, seed):
    net = jsp.SuperPointNet.tiny() if width == "tiny" else jsp.SuperPointNet()
    return net, net.init(jax.random.key(seed), jnp.zeros((1,) + hw + (1,), jnp.float32))


def _port_net(width, variables):
    net = tsp.SuperPointNet.tiny() if width == "tiny" else tsp.SuperPointNet()
    net.load_state_dict(interop.superpoint_params_from_flax(variables))
    return net.eval()


@pytest.mark.parametrize("hw", [(32, 48), (64, 80)])
@pytest.mark.parametrize("width,weights", [("full", "init"), ("tiny", "init"),
                                           ("tiny", "tinypoint")])
def test_superpoint_net_matches_jax(width, weights, hw):
    """The network with flax's random initialisation or the TinyPoint
    checkpoint carried across: detector logits and descriptor maps (NHWC in
    JAX, NCHW here) within 1e-4 (measured 3e-7), and the extractor's
    forward pass (heatmap, NMS, top-k, bilinear descriptors) with the same
    keypoints and descriptors within 1e-4."""
    img = np.random.default_rng(4).uniform(0, 1, hw).astype(np.float32)
    if weights == "tinypoint":
        variables, jnet = jsp.load_flax_weights(jsp.default_weights_path())
        tnet = tsp.load_flax_weights(tsp.default_weights_path()).eval()
        assert tnet.channels == (32, 32, 64, 64, 128) and tnet.desc_dim == 128
    else:
        jnet, variables = _flax_variables(width, hw, seed=hw[0])
        tnet = _port_net(width, variables)
    semi, desc = jnet.apply(variables, jnp.asarray(img)[None, :, :, None])
    with torch.no_grad():
        tsemi, tdesc = tnet(_t(img)[None, None])
    np.testing.assert_allclose(_np(tsemi)[0].transpose(1, 2, 0), _np(semi)[0], atol=1e-4)
    np.testing.assert_allclose(_np(tdesc)[0].transpose(1, 2, 0), _np(desc)[0], atol=1e-4)
    assert tdesc.shape[1] == (256 if width == "full" else 128)

    k = 64
    ref = jsp._forward_impl(jnet, variables, jnp.asarray(img), k, 4, 4)
    got = tsp._forward_impl(tnet, _t(img), k, 4, 4)
    m = _np(ref[3])
    np.testing.assert_array_equal(_np(got[3]), m)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(_np(a)[m], _np(b)[m])
    np.testing.assert_allclose(_np(got[2]), _np(ref[2]), atol=1e-5)
    np.testing.assert_allclose(_np(got[4]), _np(ref[4]), atol=1e-4)
    assert m.sum() > 0


def test_cells_to_heatmap_matches_jax():
    """The cell unshuffle: class 8*dy + dx of cell (i, j) lands on pixel
    (8i + dy, 8j + dx) in both packages (channel-last there, channel-first
    here); an unshuffle in the other order would still run."""
    semi = np.random.default_rng(5).normal(size=(3, 5, 65)).astype(np.float32)
    ref = _np(jsp._cells_to_heatmap(jnp.asarray(semi)))
    got = _np(tsp._cells_to_heatmap(_t(semi.transpose(2, 0, 1))))
    np.testing.assert_allclose(got, ref, atol=1e-7)
    assert got.shape == (24, 40)


def test_superpoint_random_init_contract():
    """The port's ``tests/test_extensions.py::test_superpoint_random_init_contract``:
    full width, 256-D unit descriptors, keypoints inside the image. The
    initialisation is flax's (LeCun-normal kernels truncated at two
    deviations, zero biases) drawn from the seed: each layer's weight
    deviation within 10% of flax's, equal weights for equal seeds."""
    r = np.random.default_rng(6)
    ext = tsp.SuperPointExtractor(weights_path=None)
    f = ext(_t(r.uniform(0, 1, (120, 160)), torch.float32), k=128)
    assert f.descriptors.shape == (128, 256)
    valid = _np(f.keypoints.mask)
    assert valid.sum() > 0
    np.testing.assert_allclose(np.linalg.norm(_np(f.descriptors), axis=1)[valid], 1.0, atol=1e-3)
    assert (_np(f.keypoints.x)[valid] < 160).all() and (_np(f.keypoints.y)[valid] < 120).all()
    _, variables = _flax_variables("full", (120, 160), seed=0)
    for name in tsp.LAYERS:
        w = getattr(ext.net, name).weight
        want = float(np.std(np.asarray(variables["params"][name]["kernel"])))
        assert abs(float(w.detach().std()) / want - 1) < 0.1, name
        assert float(getattr(ext.net, name).bias.abs().max()) == 0.0
    same = tsp.SuperPointExtractor(weights_path=None, seed=0).net.conv3a.weight
    other = tsp.SuperPointExtractor(weights_path=None, seed=1).net.conv3a.weight
    assert torch.equal(same, ext.net.conv3a.weight) and not torch.equal(same, other)


def test_tinypoint_checkpoint_contract():
    """The port's ``test_tinypoint_checkpoint_contract``: "auto" finds the
    JAX package's TinyPoint checkpoint in place and emits 128-D unit
    descriptors."""
    assert tsp.default_weights_path() == jsp.default_weights_path()
    ext = tsp.SuperPointExtractor()
    img = _t(np.random.default_rng(7).uniform(0, 1, (120, 160)), torch.float32)
    f = ext(img, k=128)
    assert f.descriptors.shape == (128, 128)
    valid = _np(f.keypoints.mask)
    assert valid.sum() > 0
    np.testing.assert_allclose(np.linalg.norm(_np(f.descriptors), axis=1)[valid], 1.0, atol=1e-3)


def test_tinypoint_detects_synthetic_corners():
    """The port's ``test_tinypoint_detects_synthetic_corners``: on the
    synthetic shapes of the JAX trainer's ``_draw_shapes`` (drawn with PIL;
    no cv2), most ground-truth corners have a detection within 4 px."""
    from sfmfromscratch_tpu.ops.sp_train import _draw_shapes

    ext = tsp.SuperPointExtractor()
    hits, total = 0, 0
    for seed in range(3):
        img, corners = _draw_shapes(np.random.default_rng(seed), 120, 160)
        if len(corners) == 0:
            continue
        f = ext(_t(img, torch.float32), k=128)
        valid = _np(f.keypoints.mask)
        kp = np.stack([_np(f.keypoints.xf)[valid], _np(f.keypoints.yf)[valid]], 1)
        d = np.linalg.norm(corners[:, None, :] - kp[None, :, :], axis=-1)
        hits += int((d.min(axis=1) <= 4.0).sum())
        total += len(corners)
    assert total > 0 and hits / total > 0.6, (hits, total)


def test_magicleap_checkpoint_roundtrip(tmp_path):
    """A random state dict in the MagicLeap layout (``superpoint_v1.pth``,
    as ``tests/test_extensions.py::test_superpoint_weight_roundtrip`` makes
    it): ``load_magicleap_weights`` in JAX and ``load_state_dict`` in the
    port read the same net (the converter's flax params map back to the
    state dict exactly), and both extractors give the same keypoints and
    descriptors within 1e-4 on a 96x128 image."""
    shapes = {
        "conv1a": (64, 1), "conv1b": (64, 64), "conv2a": (64, 64), "conv2b": (64, 64),
        "conv3a": (128, 64), "conv3b": (128, 128), "conv4a": (128, 128), "conv4b": (128, 128),
        "convPa": (256, 128), "convDa": (256, 128),
    }
    g = torch.Generator().manual_seed(0)
    state = {}
    for name, (o, i) in shapes.items():
        state[f"{name}.weight"] = torch.randn(o, i, 3, 3, generator=g) * 0.05
        state[f"{name}.bias"] = torch.randn(o, generator=g) * 0.01
    state["convPb.weight"] = torch.randn(65, 256, 1, 1, generator=g) * 0.05
    state["convPb.bias"] = torch.zeros(65)
    state["convDb.weight"] = torch.randn(256, 256, 1, 1, generator=g) * 0.05
    state["convDb.bias"] = torch.zeros(256)
    path = str(tmp_path / "sp.pth")
    torch.save(state, path)

    back = interop.superpoint_params_from_flax(jsp.load_magicleap_weights(path))
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    img = _image((96, 128), 8)
    ref = jsp.SuperPointExtractor(weights_path=path)(jnp.asarray(img), k=32)
    got = tsp.SuperPointExtractor(weights_path=path)(_t(img), k=32)
    m = _same_keypoints(got.keypoints, ref.keypoints)
    assert m.sum() > 0
    np.testing.assert_allclose(_np(got.descriptors), _np(ref.descriptors), atol=1e-4)


def test_flax_npz_checkpoints_cross(tmp_path):
    """Each package reads the other's npz checkpoint: the port's
    ``save_flax_weights`` writes the flax layout and widths that JAX's
    ``load_flax_weights`` reads, and back; weights equal."""
    _, variables = _flax_variables("tiny", (32, 48), seed=9)
    net = _port_net("tiny", variables)
    path = str(tmp_path / "port.npz")
    tsp.save_flax_weights(path, net)
    jvars, jnet = jsp.load_flax_weights(path)
    assert tuple(jnet.channels) == net.channels and jnet.desc_dim == net.desc_dim
    for layer, p in variables["params"].items():
        for leaf, v in p.items():
            np.testing.assert_array_equal(np.asarray(jvars["params"][layer][leaf]), np.asarray(v))
    jpath = str(tmp_path / "jax.npz")
    jsp.save_flax_weights(jpath, variables, (32, 32, 64, 64, 128), 128)
    again = tsp.load_flax_weights(jpath)
    for k, v in net.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_make_hybrid_extractor_matches_jax():
    """TinyPoint keypoints inside the SIFT border (16) with RootSIFT
    descriptors on a rendered 240x320 view at k=400: the same keypoints,
    descriptors as ``_same_descriptors`` holds them."""
    img = _rendered_image()
    ref = jsp.make_hybrid_extractor(k=400)(jnp.asarray(img))
    got = tsp.make_hybrid_extractor(k=400)(_t(img))
    m = _same_keypoints(got.keypoints, ref.keypoints)
    assert m.sum() > 100
    xs, ys = _np(got.keypoints.x)[m], _np(got.keypoints.y)[m]
    assert xs.min() >= 16 and ys.min() >= 16 and xs.max() < 320 - 16 and ys.max() < 240 - 16
    _same_descriptors(got.descriptors, ref.descriptors, m)


# --- the matcher at the full SuperPoint's 256-wide descriptors ----------------

@pytest.mark.parametrize("n2,masked", [(300, False), (600, True)])
def test_match_top2_plain_matches_pallas_at_d256(n2, masked):
    """The matcher kernel's plain version (the wrapper on CPU tensors) at
    D=256, unit descriptors of either sign as the SuperPoint head gives
    them, against the Pallas kernel in interpret mode: squared distances
    within 1e-5 (they lie in [0, 4]), indices equal."""
    r = np.random.default_rng(10 + n2)
    unit = lambda n: (lambda a: a / np.linalg.norm(a, axis=1, keepdims=True))(
        r.normal(size=(n, 256))).astype(np.float32)
    d1, d2 = unit(40), unit(n2)
    mask2 = (r.uniform(size=n2) > 0.3) if masked else None
    got = MK.match_top2_fused(_t(d1), _t(d2), None if mask2 is None else _t(mask2))
    ref = jmatch_top2(jnp.asarray(d1), jnp.asarray(d2),
                      None if mask2 is None else jnp.asarray(mask2), interpret=True)
    np.testing.assert_allclose(_np(got[0]), _np(ref[0]), atol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), atol=1e-5)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))


# --- the engines' extractor slot ------------------------------------------------

@pytest.fixture(scope="module")
def scene4(tmp_path_factory):
    """``tests/test_pipeline.py``'s 4-view scene."""
    images, K, poses, _ = render_sequence(np.random.default_rng(42), num_views=4, num_points=110)
    d = tmp_path_factory.mktemp("seq4")
    write_sequence(str(d), images)
    return dict(dir=str(d), K=K, poses=poses, n=4)


def _ate_over_extent(global_poses, gt_poses, first_image):
    est = camera_centers(np.stack([rv for rv, _ in global_poses]),
                         np.stack([t for _, t in global_poses]))
    gt = np.stack([-(R.T @ t) for R, t in gt_poses[first_image - 1:first_image - 1 + len(est)]])
    return absolute_trajectory_error(est, gt) / float(np.linalg.norm(gt.max(0) - gt.min(0)))


# Gates set beside both packages' spreads on this scene over config.seed
# (post-BA px, ATE over extent, tracks):
#   dog, seeds 0-4: JAX 0.080-0.091, 0.0098-0.0131, 168-172;
#                   port 0.076-0.120, 0.011-0.023, 158-171;
#   hybrid (k=400), seeds 0-19: JAX 0.058-0.234, 0.0007-0.085, 107-122;
#                   port 0.067-0.345, 0.003-0.237, 102-122.
# Both packages have a second, worse mode on this 4-view scene, where the
# bootstrap draws a slightly wrong pose that the chain follows; the gates
# cover JAX's with the margin of the engine's pins.
_SLOT_GATES = {"dog": dict(reproj_px=0.15, ate=0.05, tracks=0.85),
               "hybrid": dict(reproj_px=0.35, ate=0.13, tracks=0.8)}


@pytest.mark.parametrize("which", ["dog", "hybrid"])
def test_engine_extractor_slot_within_jax_spread(which, scene4, monkeypatch):
    """``SfmEngine(feature_extractor=...)`` with the DoG front end and the
    TinyPoint hybrid at ``_small_config`` on the 4-view scene, both packages
    on the same files: the extractor is called once per image on its float
    grayscale (never per pair, and the Harris path is not taken), every
    camera is registered, BA lowers the error, and the result lies within
    ``_SLOT_GATES``."""
    jcfg = test_pipeline._small_config()
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    if which == "dog":
        jext, text = jfront.make_dog_extractor(jcfg.extractor), tfront.make_dog_extractor(tcfg.extractor)
    else:
        jext, text = jsp.make_hybrid_extractor(k=400), tsp.make_hybrid_extractor(k=400)
    calls = []

    def counted(img):
        calls.append(tuple(img.shape))
        assert img.dtype == torch.float32 and img.dim() == 2
        return text(img)

    monkeypatch.setattr(tinc, "extract_features_batch", None)   # the SIFT front end is not run
    ref = jinc.SfmEngine(scene4["dir"], 4, config=jcfg, single_K=scene4["K"], feature_extractor=jext)
    eng = tinc.SfmEngine(scene4["dir"], 4, config=tcfg, single_K=scene4["K"], device="cpu",
                         feature_extractor=counted)
    assert calls == [(240, 320)] * 4
    gates = _SLOT_GATES[which]
    assert len(eng.global_poses) == len(ref.global_poses) == 3
    e0, e1 = eng.errors_before_after_ba
    assert e1 < e0 and e1 <= gates["reproj_px"], (e0, e1, ref.errors_before_after_ba)
    assert _ate_over_extent(eng.global_poses, scene4["poses"], 2) <= gates["ate"]
    assert eng.map.num_tracks >= gates["tracks"] * ref.map.num_tracks
    assert eng.pair_geometry[(1, 2)].p1.shape == ref.pair_geometry[(1, 2)].p1.shape


def test_global_engine_extractor_slot_within_jax_spread(tmp_path):
    """``GlobalSfmEngine(feature_extractor=make_dog_extractor(...))`` at
    ``tests/test_global_sfm.py``'s configuration on its 6-view orbit, both
    packages on the same files. Over ``config.seed`` 0-4 JAX gives
    0.217-0.534 px after BA, ATE over extent 0.0034-0.147 and 133-169
    tracks, the port 0.202-0.350 px, 0.0037-0.053 and 146-176 (JAX's seed 2
    misses the JAX fixture's 8% ATE gate with DoG features). So: every
    camera, camera 0 the identity, at most 0.8 px and ATE at most 0.22
    (1.5x JAX's worst), tracks at least 80% of JAX's."""
    images, K, poses, _ = render_sequence(np.random.default_rng(7), num_views=6, num_points=160,
                                          orbit_step_deg=5.0)
    write_sequence(str(tmp_path), images)
    jcfg = test_global_sfm._small_config()
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    kw = dict(single_K=K, pair_window=3, rel_num_hypotheses=512)
    ref = JGlobal(str(tmp_path), 6, config=jcfg, output_dir=str(tmp_path / "j"),
                  feature_extractor=jfront.make_dog_extractor(jcfg.extractor), **kw)
    eng = TGlobal(str(tmp_path), 6, config=tcfg, device="cpu",
                  feature_extractor=tfront.make_dog_extractor(tcfg.extractor), **kw)
    assert len(eng.global_poses) == len(ref.global_poses) == 6
    assert np.allclose(np.hstack(eng.global_poses[0]), 0.0, atol=1e-5)
    assert eng.errors_before_after_ba[1] <= 0.8, (eng.errors_before_after_ba,
                                                  ref.errors_before_after_ba)
    assert _ate_over_extent(eng.global_poses, poses, 1) <= 0.22
    assert eng.map.num_tracks >= 0.8 * ref.map.num_tracks
