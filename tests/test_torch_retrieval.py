"""The port's VLAD retrieval and the global engine's retrieval pair modes
against the JAX package, on the CPU.

The functions run on seeded random descriptors; the pair proposals and the
engine on ``tests/test_global_sfm.py::test_global_retrieval_unordered``'s
shuffled 12-view planes scene at that file's small configuration. The
k-means init draws uniform scores; the port is fed the scores JAX draws for
its key. Each tolerance is stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmfromscratch_tpu.ops import retrieval as jret
from sfmfromscratch_tpu.pipeline.global_sfm import GlobalSfmEngine as JGlobal

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ops import retrieval as tret
from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine as TGlobal
from sfmfromscratch_tpu_torch.types import Features, Keypoints
from sfmfromscratch_tpu_torch.utils.metrics import absolute_trajectory_error, camera_centers
from tests.render import render_planes, render_sequence, write_sequence
from tests.test_global_sfm import _small_config

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


@pytest.fixture(scope="module")
def descriptors():
    """6 images x 64 slots of unit 128-d descriptors, a fifth of the slots
    invalid, and JAX's init scores for key 0."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((6, 64, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    m = rng.uniform(size=(6, 64)) > 0.2
    key = jax.random.key(0)
    scores = np.asarray(jax.random.uniform(key, (6 * 64,)))
    return d, m, key, scores


def test_kmeans_vocabulary_matches_jax(descriptors):
    """Lloyd's k-means from JAX's init scores: the 8 centres after 8 steps
    agree with JAX's to rtol 1e-5 (atol 1e-6); with more clusters than the
    data fills, empty clusters keep their centre as in JAX."""
    d, m, key, scores = descriptors
    for V in (8, 48):
        ref = np.asarray(jret.kmeans_vocabulary(key, jnp.asarray(d), jnp.asarray(m),
                                                num_clusters=V))
        got = tret.kmeans_vocabulary(None, torch.as_tensor(d), torch.as_tensor(m), num_clusters=V,
                                     scores=torch.as_tensor(scores)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_vlad_embeddings_match_jax(descriptors):
    """VLAD embeddings of the same descriptors and centres: rtol 1e-5 (atol
    1e-6), unit norm, and an image with no valid slot embeds to zeros (the
    1e-9 norm floor)."""
    d, m, key, _ = descriptors
    m = m.copy()
    m[3] = False
    centers = np.asarray(jret.kmeans_vocabulary(key, jnp.asarray(d), jnp.asarray(m),
                                                num_clusters=8))
    ref = np.asarray(jret.vlad_embeddings(jnp.asarray(d), jnp.asarray(m), jnp.asarray(centers)))
    got = tret.vlad_embeddings(torch.as_tensor(d), torch.as_tensor(m),
                               torch.as_tensor(centers)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    norms = np.linalg.norm(got, axis=1)
    np.testing.assert_allclose(np.delete(norms, 3), 1.0, rtol=1e-5)
    assert norms[3] == 0.0


def test_retrieval_similarity_matches_jax(descriptors):
    """The cosine matrix minus 3 I from JAX's init scores: rtol 1e-5 (atol
    1e-6); the diagonal sits below -1.5, so no image proposes itself."""
    d, m, key, scores = descriptors
    ref = np.asarray(jret.retrieval_similarity(key, jnp.asarray(d), jnp.asarray(m),
                                               num_clusters=8))
    got = tret.retrieval_similarity(None, torch.as_tensor(d), torch.as_tensor(m), num_clusters=8,
                                    scores=torch.as_tensor(scores)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert (np.diag(got) < -1.5).all()


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    rng = np.random.default_rng(3)
    images, K, poses, _ = render_planes(rng, num_views=12, orbit_step_deg=10.0)
    perm = rng.permutation(len(images))
    d = tmp_path_factory.mktemp("planes")
    write_sequence(str(d), [images[p] for p in perm])
    return dict(dir=str(d), K=K, poses=[poses[p] for p in perm], n=len(images))


def _port(sc, **kw):
    cfg = interop.config_from_dict(dataclasses.asdict(_small_config()))
    return TGlobal(sc["dir"], sc["n"], config=cfg, single_K=sc["K"], device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_features(planes):
    return JGlobal(planes["dir"], planes["n"], config=_small_config(), single_K=planes["K"],
                   auto_run=False)._extract_all_features()


@pytest.mark.parametrize("mode", [dict(pair_mode="retrieval", retrieval_k=4),
                                  dict(pair_mode="both", retrieval_k=3, keyframe_step=2)])
def test_candidate_pairs_match_jax(planes, jax_features, mode):
    """On JAX's features with JAX's init scores, the port proposes JAX's
    exact pairs: each image's top-k by VLAD cosine as sorted (min, max)
    pairs; with keyframes, proposals among keyframes only, unioned with the
    keyframe window pairs."""
    jeng = JGlobal(planes["dir"], planes["n"], config=_small_config(), single_K=planes["K"],
                   auto_run=False, **mode)
    keys = []
    next_key = jeng._next_key

    def rec_key():
        keys.append(next_key())
        return keys[-1]

    jeng._next_key = rec_key
    ref = jeng._candidate_pairs(jax_features)
    C, Kc = np.asarray(jax_features.keypoints.mask).shape
    scores = torch.as_tensor(np.asarray(jax.random.uniform(keys[0], (C * Kc,))))
    teng = _port(planes, auto_run=False, **mode)
    feats = interop.features_from_numpy(jax.device_get(jax_features))
    window = set()
    if mode["pair_mode"] == "both":      # the window half, which draws nothing
        teng.pair_mode = "window"
        window = set(teng._candidate_pairs(None))
        teng.pair_mode = "both"
    got = sorted(teng._retrieval_pairs(feats, scores=scores) | window)
    assert got == ref
    assert all(a < b for a, b in got)
    if "keyframe_step" in mode:
        assert set(x for p in got for x in p) <= set(teng.keyframes)


def test_retrieval_ties_break_toward_the_lower_index():
    """Equal similarities are proposed in index order, as ``lax.top_k``
    breaks ties: identical descriptors make every image tie with every
    other, so each image proposes the two lowest other indices."""
    eng = TGlobal.__new__(TGlobal)
    eng.max_img, eng.retrieval_k, eng.keyframe_step = 5, 2, 1
    eng._generator = None
    C, K = 5, 16
    z = torch.zeros((C, K))
    feats = Features(keypoints=Keypoints(
        x=z.int(), y=z.int(), score=z + 1, mask=torch.ones((C, K), dtype=torch.bool),
        xf=z, yf=z), descriptors=torch.ones((C, K, 8)))
    got = eng._retrieval_pairs(feats, scores=torch.arange(C * K, dtype=torch.float32))
    assert got == {(1, 2), (1, 3), (2, 3), (1, 4), (2, 4), (1, 5), (2, 5)}


def test_retrieval_engine_passes_the_jax_gates(planes):
    """``GlobalSfmEngine(pair_mode="retrieval", retrieval_k=4)`` end to end on
    the shuffled planes, held to ``test_global_retrieval_unordered``'s gates:
    under 2 px after BA, over 40 tracks, ATE under 8% of the extent."""
    eng = _port(planes, pair_mode="retrieval", retrieval_k=4, rel_num_hypotheses=512)
    assert eng.errors_before_after_ba[1] < 2.0
    assert eng.map.num_tracks > 40
    rv = np.stack([r for r, _ in eng.global_poses])
    ts = np.stack([t for _, t in eng.global_poses])
    gt = np.stack([-R.T @ t for R, t in planes["poses"]])
    ate = absolute_trajectory_error(camera_centers(rv, ts), gt)
    assert ate / np.linalg.norm(gt.max(0) - gt.min(0)) < 0.08


def test_both_pair_mode_runs(tmp_path):
    """``pair_mode="both"`` on an ordered orbit (window pairs and retrieval
    proposals unioned) runs to a result under 2 px with a pose per image."""
    images, K, _, _ = render_sequence(np.random.default_rng(7), num_views=6, num_points=160,
                                      orbit_step_deg=5.0)
    write_sequence(str(tmp_path), images)
    eng = _port(dict(dir=str(tmp_path), K=K, n=6), pair_mode="both", retrieval_k=2,
                pair_window=2, rel_num_hypotheses=512)
    assert len(eng.global_poses) == 6
    assert eng.errors_before_after_ba[1] < 2.0
    assert {(i, i + 1) for i in range(1, 6)} <= set(eng._edges)
