"""The port's chain refresh (``pipeline/chain_refresh.py``) against the JAX
package, on the CPU.

The chain state comes from the JAX engine on a small low-parallax orbit
(``render_sequence(default_rng(7), 8 views, 300 points, 360x480, f=520,
orbit_step_deg=0.8)`` at the settings of
``test_chain_refresh_de_bends_orbit``: 600 keypoints, 2 levels x1.2), run up
to the end of its chain and imported into the port's engine through
``interop``. Each tolerance is stated where it is used.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu import config as jconfig
from sfmfromscratch_tpu.pipeline import chain_refresh as jcr
from sfmfromscratch_tpu.pipeline import incremental as jinc

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.pipeline import chain_refresh as tcr
from sfmfromscratch_tpu_torch.pipeline import incremental as tinc
from tests.render import render_sequence, write_sequence

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

VIEWS = 8


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _jax_config():
    return jconfig.PipelineConfig(
        extractor=jconfig.ExtractorConfig(
            num_interest_points=600, ksize=3, gaussian_size=7, sigma=3.0, alpha=0.05,
            feature_width=16, pyramid_level=2, pyramid_scale_factor=1.2),
        matcher=jconfig.MatcherConfig(ratio_threshold=0.85, max_matches=600),
        ransac=jconfig.RansacConfig(), ba=jconfig.BundleAdjustConfig(), scale_factor=1.0,
    )


@pytest.fixture(scope="module")
def chain_state(tmp_path_factory):
    """The JAX engine's chain state on the small orbit (before refresh and
    BA), with its scene."""
    images, K, poses, _ = render_sequence(
        np.random.default_rng(7), num_views=VIEWS, num_points=300, img_hw=(360, 480), f=520.0,
        orbit_step_deg=0.8)
    d = tmp_path_factory.mktemp("orbit")
    write_sequence(str(d), images)
    jeng = jinc.SfmEngine(str(d), VIEWS, config=_jax_config(), single_K=K, auto_run=False)
    assert jeng._try_run_front_fused(jeng._extract_all_features())
    return dict(dir=str(d), K=K, poses=poses, jeng=jeng)


def _port_engine(cs):
    cfg = interop.config_from_dict(dataclasses.asdict(_jax_config()))
    teng = tinc.SfmEngine(cs["dir"], VIEWS, config=cfg, single_K=cs["K"], device="cpu",
                          chain_refresh="averaging", auto_run=False)
    interop.import_engine_state(teng, cs["jeng"])
    return teng


def _edges(cs, cap=192):
    frames, tracks, xy = cs["jeng"].map.observations()
    C = len(cs["jeng"].global_poses)
    return jcr.collect_edge_correspondences(np.asarray(frames), np.asarray(tracks),
                                            np.asarray(xy, np.float64), C, 6, cap, 24)


def test_collect_edge_correspondences_exact(chain_state):
    """The (track, frame) join on the chain's own map, and on the JAX test's
    hand-made map: every output array identical."""
    frames, tracks, xy = chain_state["jeng"].map.observations()
    C = len(chain_state["jeng"].global_poses)
    args = (np.asarray(frames), np.asarray(tracks), np.asarray(xy, np.float64), C, 6, 192, 24)
    ref = jcr.collect_edge_correspondences(*args)
    got = tcr.collect_edge_correspondences(*args)
    assert len(ref[0]) >= C - 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    small = (np.array([0, 1, 2, 1, 3, 0]), np.array([0, 0, 0, 1, 1, 2]),
             np.arange(12, dtype=np.float64).reshape(6, 2), 4, 2, 8, 1)
    for g, r in zip(tcr.collect_edge_correspondences(*small),
                    jcr.collect_edge_correspondences(*small)):
        np.testing.assert_array_equal(g, r)


def test_edge_poses_match_jax(chain_state):
    """Batched 8-point -> E -> cheirality choice -> Sampson GN per edge on the
    chain's track correspondences: rotations within 1e-3 rad, directions
    within 3e-3 (float32 SVDs at 0.8 deg of parallax per view), supports
    equal, RMS within 1e-3 px, and the unit-baseline
    depths the scale solve takes within 1e-2 relative where positive
    (measured 3.4e-3)."""
    ei, ej, p1, p2, mask, _ = _edges(chain_state)
    Ks = np.stack([np.asarray(K, np.float32) for K in chain_state["jeng"].global_K])
    ref = jcr._edge_poses(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                          jnp.asarray(Ks[ei]), jnp.asarray(Ks[ej]))
    got = tcr._edge_poses(torch.as_tensor(p1), torch.as_tensor(p2), torch.as_tensor(mask),
                          torch.as_tensor(Ks[ei]), torch.as_tensor(Ks[ej]))
    gap = np.linalg.norm(_np(got[0]) - _np(ref[0]), axis=(1, 2)) / np.sqrt(2.0)
    assert gap.max() < 1e-3, gap.max()
    # Directions of the shortest baselines are the least determined: 3e-3
    # (measured 1.0e-3 on one component).
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), atol=3e-3)
    np.testing.assert_allclose(_np(got[2]), _np(ref[2]), atol=1e-3)
    np.testing.assert_array_equal(_np(got[3]), _np(ref[3]))
    for zg, zr in ((got[4], ref[4]), (got[5], ref[5])):
        zr = _np(zr)
        ok = mask & (zr > 1e-4)
        # A 1e-3 change of direction at this parallax moves depths by ~3e-3.
        np.testing.assert_allclose(_np(zg)[ok], zr[ok], rtol=1e-2)


def test_solve_edge_scales_matches_jax_and_recovers_ratios():
    """The group-consistency scale solve on the JAX test's synthetic ratios
    (``test_edge_scale_solver_recovers_ratios``): within 1e-4 relative of
    JAX's scales, exact ratios on clean depths (p90/p10 of lam/lam_true
    under 1.01), robust on a contaminated seventh (under 1.5), and an edge
    with no usable depth keeps its initial scale."""
    rng = np.random.default_rng(0)
    E, cap, C, T = 30, 50, 12, 200
    edge_i = rng.integers(0, C - 1, E).astype(np.int32)
    edge_j = (edge_i + 1 + rng.integers(0, 3, E)).clip(max=C - 1).astype(np.int32)
    lam_true = np.exp(rng.normal(0, 0.5, E))
    tid = rng.integers(0, T, (E, cap))
    mask = rng.uniform(size=(E, cap)) > 0.2
    d = np.exp(rng.normal(1.0, 0.3, (C, T)))
    z1 = d[edge_i[:, None], tid] / lam_true[:, None]
    z2 = d[edge_j[:, None], tid] / lam_true[:, None]
    z1c = z1.copy()
    z1c[::7] *= np.exp(rng.normal(0, 3.0, z1c[::7].shape))
    lam_init = np.ones(E)
    for zz1, bound in ((z1, 1.01), (z1c, 1.5)):
        got = tcr.solve_edge_scales(edge_i, edge_j, tid, mask, zz1, z2, lam_init, device="cpu")
        ref = jcr.solve_edge_scales(edge_i, edge_j, tid, mask, zz1, z2, lam_init)
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        r = got / lam_true
        assert np.percentile(r, 90) / np.percentile(r, 10) < bound
    dead = mask.copy()
    dead[4] = False
    lam0 = np.linspace(0.5, 2.0, E)
    got = tcr.solve_edge_scales(edge_i, edge_j, tid, dead, z1, z2, lam0, device="cpu")
    assert got[4] == np.float32(lam0[4])
    np.testing.assert_allclose(got, jcr.solve_edge_scales(edge_i, edge_j, tid, dead, z1, z2, lam0),
                               rtol=1e-4)


def test_averaging_refresh_matches_jax(chain_state):
    """The whole refresh on the JAX engine's chain state imported into the
    port's engine, against the JAX refresh of the same state: refreshed
    rotations within 1e-3 rad, camera centres within 1e-3 of the trajectory
    extent (measured 2e-5), re-triangulated points of tracks with 2
    observations or more within 3e-3 of their distance (measured 1e-3: the
    low-parallax rays amplify the poses' rounding), the same warnings; the chain's camera count and map are kept."""
    from sfmfromscratch_tpu_torch.ops.lie import so3_exp

    cs = chain_state
    teng = _port_engine(cs)
    jeng = cs["jeng"]
    jposes = list(jeng.global_poses)
    jpts = jeng.map.points().copy()
    jwarn = list(jeng.warnings)
    try:
        jcr.averaging_refresh(jeng)
        ref_poses, ref_pts = list(jeng.global_poses), jeng.map.points().copy()
        ref_warn = jeng.warnings[len(jwarn):]
    finally:   # the fixture's state stays the chain's
        jeng.global_poses = jposes
        jeng.map.update_points(jpts)
        jeng.warnings = jwarn
    tcr.averaging_refresh(teng)
    assert teng.warnings == ref_warn and any("averaged" in w for w in ref_warn)
    assert "chain_refresh" in teng.stage_times
    assert len(teng.global_poses) == len(ref_poses) == VIEWS - 1

    def rot_c(poses):
        rv = torch.as_tensor(np.stack([r for r, _ in poses]), dtype=torch.float32)
        R = _np(so3_exp(rv)).astype(np.float64)
        t = np.stack([t for _, t in poses])
        return R, -np.einsum("cij,ci->cj", R, t)

    Rg, cg = rot_c(teng.global_poses)
    Rr, cr = rot_c(ref_poses)
    assert (np.linalg.norm(Rg - Rr, axis=(1, 2)) / np.sqrt(2.0)).max() < 1e-3
    extent = float(np.linalg.norm(cr.max(0) - cr.min(0)))
    assert np.abs(cg - cr).max() <= 1e-3 * extent
    # A track of one observation has no defined point (its DLT system has a
    # 2-D null space): only tracks of 2 or more are compared.
    _, tracks, _ = teng.map.observations()
    multi = np.bincount(tracks, minlength=len(ref_pts)) >= 2
    got_pts, ref_pts = teng.map.points()[multi], ref_pts[multi]
    rel = np.linalg.norm(got_pts - ref_pts, axis=1) / np.linalg.norm(ref_pts, axis=1)
    assert multi.sum() > 100
    assert rel.max() < 3e-3, np.sort(rel)[-5:]
