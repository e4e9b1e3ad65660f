"""The port's device mesh (``sfmfromscratch_tpu_torch/parallel/``) against the
JAX package's, on the CPU.

Ranks are spawned processes over gloo, one thread each, brought up by the
port's ``init_distributed`` on a ``file://`` store under ``tmp_path`` with a
60 s collective timeout; each group is waited for with its own time limit
(``_Ranks``), so a deadlock fails its tests and nothing else. The spawn
targets live here and import no JAX: a spawned child imports this module, so
JAX (and the test helpers that import it) is imported inside the test
functions only, and inputs reach the ranks as numpy arrays. The JAX side runs
on the 8 virtual CPU devices of ``tests/conftest.py``.

BA problems come from ``tests/test_ba.py``'s problem helpers, matcher inputs from
numpy seeds, the engines' scene is ``tests/test_parallel.py``'s
(``render_sequence(default_rng(5), num_views=4, num_points=110)``), the
streaming map ``tests/mp_ba_worker.py``'s. Tolerances are the JAX tests'
own, stated where used.
"""

import dataclasses
import os
import pickle
import tempfile
import time
import types
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

RANK_TIMEOUT_S = 180       # per group of ranks
COLLECTIVE_TIMEOUT = timedelta(seconds=60)


# ----------------------------------------------------------------- harness

def _rank_main(target, rank, world, store, out_dir, args):
    """Body of one spawned rank: bring up the group, run ``target``, write
    its result for the parent."""
    import torch.distributed as dist

    from sfmfromscratch_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"file://{store}", world, rank, device="cpu", timeout=COLLECTIVE_TIMEOUT)
    try:
        out = globals()[target](rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class _Ranks:
    """``world`` spawned ranks running ``target(rank, *args)``; ``wait()``
    returns their results in rank order, or kills them all and fails."""

    def __init__(self, target, world, tmp_path, *args):
        self.dir = tempfile.mkdtemp(prefix=f"{target}_", dir=str(tmp_path))
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(target, r, world, os.path.join(self.dir, "store"),
                                        self.dir, args))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + RANK_TIMEOUT_S
        self._out = None

    def wait(self):
        if self._out is None:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            alive = [p for p in self.procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join(10)
            assert not alive, f"{len(alive)} rank(s) still running after {RANK_TIMEOUT_S} s"
            assert [p.exitcode for p in self.procs] == [0] * len(self.procs)
            self._out = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.dir, f"rank{r}.pkl"), "rb") as f:
                    self._out.append(pickle.load(f))
        return self._out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _problem(d):
    from sfmfromscratch_tpu_torch import interop

    return interop.ba_problem_from_numpy(types.SimpleNamespace(**d))


def _problem_arrays(jp):
    fields = ("cam_params", "points", "K", "obs_cam", "obs_pt", "obs_xy", "obs_w", "cam_fixed",
              "pt_fixed")
    return {f: None if getattr(jp, f, None) is None else np.asarray(getattr(jp, f))
            for f in fields}


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        for a, b in zip(o[key], outs[0][key]):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- rank bodies

# BA cases: (problem helper args, solver keywords, selfcal, PCG forced).
_BA_KW = dict(max_iters=12, cg_iters=40, ftol=1e-8)
_BA_CASES = {
    "plain_dense": (dict(num_cams=5, num_pts=80, perturb=0.02, noise=0.3), _BA_KW, False, False),
    "plain_pcg": (dict(num_cams=5, num_pts=80, perturb=0.02, noise=0.3), _BA_KW, False, True),
    "padded": (dict(num_cams=3, num_pts=41, perturb=0.02), dict(max_iters=6, cg_iters=30),
               False, False),
    "huber": ("contaminated", dict(_BA_KW, huber_delta=3.0), False, False),
    "huber_pcg": ("contaminated", dict(_BA_KW, huber_delta=3.0), False, True),
    "selfcal": ("focal", dict(max_iters=30, cg_iters=60, ftol=1e-12), True, True),
}


def _ba_result(res, s=None):
    return dict(cams=_np(res.cam_params), pts=_np(res.points),
                e0=float(res.initial_mean_error), e1=float(res.final_mean_error),
                s=None if s is None else float(s))


def _sharded_ba_ranks(rank, problems):
    """Every BA case sharded by observation over a 2-rank data axis."""
    from sfmfromscratch_tpu_torch.parallel import bundle_adjust_sharded, make_mesh

    mesh = make_mesh(2)
    out = {}
    for name, (_, kw, selfcal, pcg) in _BA_CASES.items():
        if pcg:
            os.environ["SFM_NO_DENSE_SCHUR"] = "1"
        try:
            r = bundle_adjust_sharded(_problem(problems[name]), mesh, selfcal=selfcal, **kw)
        finally:
            os.environ.pop("SFM_NO_DENSE_SCHUR", None)
        out[name] = _ba_result(*r) if selfcal else _ba_result(r)
    return out


def _tp_match_ranks(rank, cases, model_parallel):
    """Every matcher case with the database sharded over the model axis."""
    from sfmfromscratch_tpu_torch.parallel import make_mesh, tp_match_ratio_test

    mesh = make_mesh(model_parallel=model_parallel)
    out = {"mesh": (mesh.mesh_dim_names, tuple(mesh.shape))}
    for name, (d1, d2, m1, m2) in cases.items():
        res = tp_match_ratio_test(mesh, torch.as_tensor(d1), torch.as_tensor(d2),
                                  torch.as_tensor(m1), torch.as_tensor(m2), ratio_threshold=0.85)
        out[name] = tuple(_np(v) for v in res)
    return out


def _sharded_ransac_ranks(rank, root, pairs):
    """The global engine's relative poses sharded by pair against the
    unsharded call, adaptive and fixed-count, each from a fresh generator."""
    from sfmfromscratch_tpu_torch.config import PipelineConfig, RansacConfig
    from sfmfromscratch_tpu_torch.parallel import make_mesh
    from sfmfromscratch_tpu_torch.parallel.mesh import mesh_axis
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine

    mesh = make_mesh(2)
    args = [torch.as_tensor(a) for a in pairs]
    out = {}
    for mode, ransac in (("adaptive", RansacConfig()), ("fixed", RansacConfig(adaptive=False))):
        cfg = dataclasses.replace(PipelineConfig(), ransac=ransac)
        kw = dict(config=cfg, device="cpu", auto_run=False, rel_num_hypotheses=512)
        sharded = GlobalSfmEngine(root, 5, mesh=mesh, **kw)
        single = GlobalSfmEngine(root, 5, **kw)
        got = sharded._sharded_relative_poses(mesh_axis(mesh, "data"), *args)
        ref = single._relative_pose_batch(*args)
        out[mode] = dict(
            equal=all(torch.equal(a, b) for a, b in zip(got, ref)),
            got=tuple(_np(v) for v in got),
            state=_np(sharded._generator.get_state()),
            state_single=_np(single._generator.get_state()))
    return out


def _engine_ranks(rank, scene, cfg, stream_map):
    """Both engines and the streaming BA on a 2-rank data axis."""
    from sfmfromscratch_tpu_torch.parallel import make_mesh
    from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine
    from sfmfromscratch_tpu_torch.pipeline.streaming import MapBlockStore, stream_bundle_adjust

    mesh = make_mesh(2)
    kw = dict(config=cfg, single_K=scene["K"], device="cpu", mesh=mesh)
    out = {}

    eng = SfmEngine(scene["dir"], scene["n"], auto_run=False, **kw)
    feats = eng._extract_all_features()
    out["features"] = (tuple(_np(v) for v in feats.keypoints), _np(feats.descriptors))

    def summary(e):
        return dict(poses=[np.hstack(p) for p in e.global_poses],
                    errors=tuple(e.errors_before_after_ba), tracks=e.map.num_tracks,
                    warnings=list(e.warnings), focal_scale=e.focal_scale,
                    stream=None if getattr(e, "stream_stats", None) is None else dict(
                        windows=e.stream_stats.windows_run))

    out["engine"] = summary(eng.run())
    out["selfcal"] = summary(SfmEngine(scene["dir"], scene["n"], refine_focal=True, **kw))
    gkw = dict(kw, pair_window=3, rel_num_hypotheses=512)
    out["global"] = summary(GlobalSfmEngine(scene["dir"], scene["n"], **gkw))
    out["global_stream"] = summary(GlobalSfmEngine(
        scene["dir"], scene["n"], stream_ba_window=2, stream_ba_block_cams=1, **gkw))

    # tests/mp_ba_worker.py's streaming run: each rank its own store.
    root = tempfile.mkdtemp(prefix=f"stream_rank{rank}_")
    store = MapBlockStore.build_from_arrays(
        root, stream_map["cam_params"], stream_map["K"], stream_map["points"],
        stream_map["obs_cam"], stream_map["obs_pt"], stream_map["obs_xy"], block_cams=8)
    st = stream_bundle_adjust(store, window_blocks=3, mesh=mesh, sweeps=2, max_iters=10,
                              cg_iters=30, ftol=1e-6, device="cpu")
    cams, _ = store.read_cameras()
    out["stream"] = dict(err0=st.initial_error, err1=st.final_error, windows=st.windows_run,
                         resident=st.peak_resident_obs / max(st.total_obs, 1), cams=cams,
                         root=root)
    return out


# ----------------------------------------------------------------- inputs

def _ba_problems():
    from tests.test_ba import _focal_observable_problem, _multi_view_problem

    out = {}
    for name, (spec, _, _, _) in _BA_CASES.items():
        rng = np.random.default_rng(5)
        if spec == "focal":
            jp = _focal_observable_problem(rng)
        elif spec == "contaminated":
            jp, _, _ = _multi_view_problem(rng, num_cams=5, num_pts=80, perturb=0.02, noise=0.3)
            xy = np.asarray(jp.obs_xy).copy()
            xy[::37] += 60.0       # test_parallel.py:166-183
            jp = jp._replace(obs_xy=xy)
        else:
            jp, _, _ = _multi_view_problem(rng, **spec)
        out[name] = _problem_arrays(jp)
    return out


def _match_cases():
    """test_parallel.py:29-54's inputs (random descriptors: few or no rows
    pass the ratio test), then queries near database rows on 128-row
    databases split in two: random masks, a shard with every row masked, a
    shard with one valid row, and exact ties across the shard boundary (for
    the best and for the second-best)."""
    rng = np.random.default_rng(5)
    d1 = rng.uniform(0, 1, (96, 128)).astype(np.float32)
    d2 = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    m1 = rng.uniform(size=96) > 0.1
    m2 = rng.uniform(size=128) > 0.1
    q = (d2[:96] + rng.normal(0, 0.02, (96, 128))).astype(np.float32)
    cases = {"random": (d1, d2, m1, m2), "near": (q, d2, m1, m2)}
    masked = m2.copy()
    masked[64:] = False
    cases["shard_all_masked"] = (q, d2, m1, masked)
    one = m2.copy()
    one[:64] = False
    one[17] = True
    cases["shard_one_valid"] = (q, d2, m1, one)
    # Rows 63 and 64 (the shards' edges) equal.
    tie = d2.copy()
    tie[64] = tie[63]
    tie[10] = tie[63]
    tie[10, :4] += 0.5
    qt = q.copy()
    qt[5] = tie[63] + 0.01           # the best tied across the boundary
    qt[6] = tie[10] + 0.001          # best row 10, the second tied across it
    cases["tie_across_shards"] = (qt, tie, np.ones(96, bool), np.ones(128, bool))
    return cases


def _pair_batch():
    """Five synthetic pairs (240 correspondences, 0.3 px noise, shared K)
    whose outlier shares rise along the batch, so the adaptive lanes of the
    second rank run more stages than the first's; a few rows masked."""
    rng = np.random.default_rng(11)
    E, N = 5, 240
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    p1s, p2s, masks = [], [], []
    for e, out_share in enumerate((0.0, 0.05, 0.1, 0.3, 0.4)):
        X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(4, 9, N)], 1)
        a = 0.05 * (e + 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([-0.4, 0.05 * e, 0.02])

        def proj(Xc):
            h = Xc @ K.T
            return h[:, :2] / h[:, 2:]

        p1 = proj(X) + rng.normal(0, 0.3, (N, 2))
        p2 = proj(X @ R.T + t) + rng.normal(0, 0.3, (N, 2))
        bad = rng.uniform(size=N) < out_share
        p2[bad] = rng.uniform([0, 0], [320, 240], (int(bad.sum()), 2))
        m = np.ones(N, bool)
        m[rng.choice(N, 10, replace=False)] = False
        p1s.append(p1)
        p2s.append(p2)
        masks.append(m)
    Ks = np.repeat(K[None], E, 0).astype(np.float32)
    return [np.stack(p1s).astype(np.float32), np.stack(p2s).astype(np.float32), Ks, Ks,
            np.stack(masks)]


# ----------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def ba_inputs():
    return _ba_problems()


@pytest.fixture(scope="module")
def ba_ranks(ba_inputs, tmp_path_factory):
    return _Ranks("_sharded_ba_ranks", 2, tmp_path_factory.mktemp("ba"), ba_inputs)


@pytest.fixture(scope="module")
def jax_sharded_ba(ba_inputs, ba_ranks):
    """JAX's ``bundle_adjust_sharded`` on ``make_mesh(8, model_parallel=1)``
    for every case (computed while the ranks run)."""
    import jax.numpy as jnp

    from sfmfromscratch_tpu.ba import problem as jprob
    from sfmfromscratch_tpu.parallel.mesh import make_mesh
    from sfmfromscratch_tpu.parallel.sharded_ba import bundle_adjust_sharded

    mesh = make_mesh(8, model_parallel=1)
    out = {}
    for name, (_, kw, selfcal, pcg) in _BA_CASES.items():
        d = ba_inputs[name]
        jp = jprob.BAProblem(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})
        if pcg:
            os.environ["SFM_NO_DENSE_SCHUR"] = "1"
        try:
            r = bundle_adjust_sharded(jp, mesh, selfcal=selfcal, **kw)
        finally:
            os.environ.pop("SFM_NO_DENSE_SCHUR", None)
        out[name] = _ba_result(*r) if selfcal else _ba_result(r)
    return out


@pytest.fixture(scope="module")
def port_single_ba(ba_inputs):
    """The port's unsharded solvers on every case."""
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.selfcal import bundle_adjust_selfcal

    out = {}
    for name, (_, kw, selfcal, pcg) in _BA_CASES.items():
        p = _problem(ba_inputs[name])
        if selfcal:
            out[name] = _ba_result(*bundle_adjust_selfcal(p, **kw))
        else:
            out[name] = _ba_result(bundle_adjust(p, use_dense=not pcg, **kw))
    return out


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A 1-rank gloo group in this process and its (1, 1) mesh."""
    import torch.distributed as dist

    from sfmfromscratch_tpu_torch.parallel import make_mesh

    store = tmp_path_factory.mktemp("one_rank") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def match_cases():
    return _match_cases()


@pytest.fixture(scope="module")
def tp2_ranks(match_cases, tmp_path_factory):
    return _Ranks("_tp_match_ranks", 2, tmp_path_factory.mktemp("tp2"), match_cases, 2)


@pytest.fixture(scope="module")
def tp4_ranks(match_cases, tmp_path_factory):
    return _Ranks("_tp_match_ranks", 4, tmp_path_factory.mktemp("tp4"), match_cases, None)


@pytest.fixture(scope="module")
def ransac_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ransac_seq")
    return _Ranks("_sharded_ransac_ranks", 2, tmp_path_factory.mktemp("ransac"), str(root),
                  _pair_batch())


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tests.render import render_sequence, write_sequence

    images, K, poses, X = render_sequence(np.random.default_rng(5), num_views=4, num_points=110)
    d = tmp_path_factory.mktemp("seq")
    write_sequence(str(d), images)
    return dict(dir=str(d), K=K, n=4, poses=poses)


@pytest.fixture(scope="module")
def port_config():
    from sfmfromscratch_tpu_torch import interop
    from tests.test_pipeline import _small_config

    return interop.config_from_dict(dataclasses.asdict(_small_config()))


@pytest.fixture(scope="module")
def engine_ranks(scene, port_config, tmp_path_factory):
    from tests.test_streaming import _synthetic_map

    m, _ = _synthetic_map(np.random.default_rng(5), C=48, track_len=10, perturb=0.008)
    return _Ranks("_engine_ranks", 2, tmp_path_factory.mktemp("engines"), scene, port_config,
                  {k: np.asarray(v) for k, v in m.items()})


# ----------------------------------------------------------------- mesh

@pytest.mark.parametrize("n, want", [(8, (4, 2)), (2, (2, 1)), (4, (2, 2)), (1, (1, 1))])
def test_mesh_shape_rule(n, want):
    """``mesh_shape`` keeps JAX's rule (test_parallel.py:22-26): model 2 for
    an even count of 4 or more, else 1; the JAX mesh has the same shape."""
    from sfmfromscratch_tpu.parallel.mesh import make_mesh as jmake_mesh

    from sfmfromscratch_tpu_torch.parallel.mesh import mesh_shape

    assert mesh_shape(n) == want
    m = jmake_mesh(n)
    assert (m.shape["data"], m.shape["model"]) == want


def test_four_rank_mesh_is_two_by_two(tp4_ranks):
    """A real 4-rank ``make_mesh()`` is (data 2, model 2) on every rank."""
    for o in tp4_ranks.wait():
        assert o["mesh"] == (("data", "model"), (2, 2))


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist

    from sfmfromscratch_tpu_torch.parallel import make_mesh
    from sfmfromscratch_tpu_torch.parallel.mesh import choose_backend, init_distributed

    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh()
    assert init_distributed("localhost:1", 1, 0) is None      # one process: nothing
    assert choose_backend(2, "cpu")[0] == "gloo"


# ----------------------------------------------------------------- sharded BA

@pytest.mark.parametrize("case", list(_BA_CASES))
def test_sharded_ba_matches_jax_and_single(case, ba_inputs, ba_ranks, jax_sharded_ba,
                                            port_single_ba):
    """2 ranks against JAX's sharded solver (8 virtual devices) and the
    port's unsharded one, with test_parallel.py's tolerances: final errors
    within 0.05 px, points within rtol 0.05 / atol 0.02 (:57-68); cameras
    within 5e-3 under Huber (:166-183); selfcal ``s`` within 5e-3 of JAX's
    and 0.01 of 1/1.06 (:124-140); the padded count no worse than its start
    (:71-77). Both ranks return the same bits."""
    outs = ba_ranks.wait()
    got = outs[0][case]
    for o in outs[1:]:
        for k in ("cams", "pts"):
            np.testing.assert_array_equal(o[case][k], got[k])
        assert o[case]["e1"] == got["e1"] and o[case]["s"] == got["s"]
    for ref in (jax_sharded_ba[case], port_single_ba[case]):
        assert abs(got["e1"] - ref["e1"]) < 0.05
    if case == "padded":
        assert len(ba_inputs[case]["obs_cam"]) % 2 != 0
        assert got["e1"] <= got["e0"] + 1e-6
        return
    if case.startswith("plain"):
        assert got["e1"] < 1.0
        for ref in (jax_sharded_ba[case], port_single_ba[case]):
            np.testing.assert_allclose(got["pts"], ref["pts"], rtol=0.05, atol=0.02)
    if case.startswith("huber"):
        for ref in (jax_sharded_ba[case], port_single_ba[case]):
            np.testing.assert_allclose(got["cams"], ref["cams"], atol=5e-3)
    if case == "selfcal":
        assert abs(got["s"] - 1 / 1.06) < 0.01
        assert abs(got["s"] - jax_sharded_ba[case]["s"]) < 5e-3
        assert got["e1"] < 0.35


@pytest.mark.parametrize("case", ["plain_dense", "plain_pcg", "huber", "selfcal"])
def test_one_rank_mesh_is_the_unsharded_solve(case, one_rank_mesh, ba_inputs):
    """On a 1-rank mesh ``bundle_adjust_sharded`` gives the unsharded
    solver's bits: the same arithmetic, reduced over one rank."""
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.selfcal import bundle_adjust_selfcal
    from sfmfromscratch_tpu_torch.parallel import bundle_adjust_sharded

    _, kw, selfcal, pcg = _BA_CASES[case]
    p = _problem(ba_inputs[case])
    if pcg:
        os.environ["SFM_NO_DENSE_SCHUR"] = "1"
    try:
        got = bundle_adjust_sharded(p, one_rank_mesh, selfcal=selfcal, **kw)
    finally:
        os.environ.pop("SFM_NO_DENSE_SCHUR", None)
    ref = bundle_adjust_selfcal(p, **kw) if selfcal else bundle_adjust(p, use_dense=not pcg, **kw)
    if not selfcal:
        got, ref = (got,), (ref,)
    for a, b in zip(got, ref):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("dense, selfcal, huber", [
    (True, False, 0.0), (False, False, 0.0), (False, False, 3.0), (False, True, 0.0)])
def test_reduce_fn_none_leaves_the_solve_unchanged(dense, selfcal, huber, ba_inputs):
    """``lm_run(reduce_fn=None)`` and an explicit identity reduction give the
    same bits as ``bundle_adjust`` / ``bundle_adjust_selfcal``: threading the
    reduction through the Schur core changes no arithmetic of the
    single-device path."""
    from sfmfromscratch_tpu_torch.ba.lm import bundle_adjust
    from sfmfromscratch_tpu_torch.ba.lm_core import lm_run
    from sfmfromscratch_tpu_torch.ba.selfcal import bundle_adjust_selfcal
    from sfmfromscratch_tpu_torch.utils.precision import f32_precision

    p = _problem(ba_inputs["selfcal" if selfcal else "huber"])
    kw = dict(max_iters=8, cg_iters=40, init_damping=1e-3, damping_up=4.0, damping_down=0.5,
              ftol=1e-8, huber_delta=huber)
    runs = []
    for red in (None, lambda x: x.clone()):
        with f32_precision():
            runs.append(lm_run(p, selfcal=selfcal, use_dense=dense, forcing=True,
                               reduce_fn=red, **kw))
    if selfcal:
        res, s = bundle_adjust_selfcal(p, **kw)
    else:
        res, s = bundle_adjust(p, use_dense=dense, **kw), None
    for out in runs:
        assert torch.equal(out.cam_params, res.cam_params)
        assert torch.equal(out.points, res.points)
        assert torch.equal(out.final_cost, res.final_cost)
        assert torch.equal(out.final_mean_error, res.final_mean_error)
        assert out.iterations_used == res.iterations_used
        if selfcal:
            assert torch.equal(out.s, s)


# ----------------------------------------------------------------- matcher

def _jax_matches(cases, name, model):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sfmfromscratch_tpu.ops.matcher import match_ratio_test
    from sfmfromscratch_tpu.parallel.sharded_match import tp_match_ratio_test

    d1, d2, m1, m2 = (jnp.asarray(a) for a in cases[name])
    mesh = Mesh(np.array(jax.devices()[:model]), ("model",))
    tp = tp_match_ratio_test(mesh, d1, d2, m1, m2, ratio_threshold=0.85)
    single = match_ratio_test(d1, d2, m1, m2, ratio_threshold=0.85, max_matches=d1.shape[0])
    return [tuple(np.asarray(v) for v in r) for r in (tp, single)]


def _match_set(res):
    idx, conf, mask = res
    n = int(mask.sum())
    return {tuple(r) for r in idx[:n]}, np.sort(conf[:n])


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("case", ["random", "near", "shard_all_masked", "shard_one_valid",
                                  "tie_across_shards"])
def test_tp_match_equals_jax(case, ranks, match_cases, tp2_ranks, tp4_ranks):
    """The database sharded over 2 model ranks, and over the model axis of a
    2 x 2 mesh: the match set equals JAX's ``tp_match_ratio_test`` (on as
    many devices) and its ``match_ratio_test``, confidences within 1e-5
    (test_parallel.py:29-54, mp_ba_worker.py:61-74), and every rank returns
    the same bits. (The order of rows whose ratios agree to float rounding
    may differ: the kernel sums the distances in another order.)"""
    outs = (tp2_ranks if ranks == 2 else tp4_ranks).wait()
    _same_on_every_rank(outs, case)
    got = outs[0][case]
    gset, gconf = _match_set(got)
    assert gset or case == "random", "no matches"
    for ref in _jax_matches(match_cases, case, 2):
        rset, rconf = _match_set(ref)
        assert gset == rset
        np.testing.assert_allclose(gconf, rconf, atol=1e-5)
    np.testing.assert_array_equal(got[2], _jax_matches(match_cases, case, 2)[0][2])


def test_tp_match_refuses_a_ragged_database(one_rank_mesh):
    """``n2`` must split into equal shards of 2 rows or more, as JAX's
    ``shard_map`` and ``top_k(2)`` require; no padding is invented."""
    from sfmfromscratch_tpu_torch.parallel import tp_match_ratio_test

    d = torch.rand(4, 8)
    with pytest.raises(ValueError, match="shards"):
        tp_match_ratio_test(one_rank_mesh, d, torch.rand(1, 8))
    with pytest.raises(ValueError, match="axis"):
        tp_match_ratio_test(one_rank_mesh, d, d, axis="pairs")


# ----------------------------------------------------------------- RANSAC

@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_sharded_relative_poses_equal_the_unsharded_call(mode, ransac_ranks):
    """Five pairs on 2 ranks (padded to 6): every field equals the unsharded
    call bit for bit, and each rank's generator ends where the unsharded
    call's does, so every later draw of the engine agrees."""
    outs = ransac_ranks.wait()
    for o in outs:
        assert o[mode]["equal"]
        np.testing.assert_array_equal(o[mode]["state"], o[mode]["state_single"])
    for o in outs[1:]:
        np.testing.assert_array_equal(o[mode]["state"], outs[0][mode]["state"])
        for a, b in zip(o[mode]["got"], outs[0][mode]["got"]):
            np.testing.assert_array_equal(a, b)
    assert outs[0][mode]["got"][0].shape == (5, 3, 3)
    assert outs[0][mode]["got"][4].min() >= 50     # every pair found its pose


# ----------------------------------------------------------------- engines

def test_engine_on_mesh(engine_ranks, scene):
    """``SfmEngine(mesh)`` at 2 ranks on the 4-view scene, with
    test_parallel.py:106-121's gates: 3 poses, error after <= before and
    < 3 px; both ranks' poses the same bits."""
    outs = engine_ranks.wait()
    r = outs[0]["engine"]
    assert len(r["poses"]) == scene["n"] - 1
    b, a = r["errors"]
    assert a <= b + 1e-6 and a < 3.0
    for o in outs[1:]:
        np.testing.assert_array_equal(np.stack(o["engine"]["poses"]), np.stack(r["poses"]))


def test_engine_features_on_mesh(engine_ranks, scene, port_config):
    """The features, extracted by image on each rank and gathered, equal the
    unsharded port's: the same keypoints, descriptors within 1e-5."""
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    eng = SfmEngine(scene["dir"], scene["n"], config=port_config, single_K=scene["K"],
                    device="cpu", auto_run=False)
    ref = eng._extract_all_features()
    for o in engine_ranks.wait():
        kps, desc = o["features"]
        for got, want in zip(kps, ref.keypoints):
            np.testing.assert_array_equal(got, _np(want))
        np.testing.assert_allclose(desc, _np(ref.descriptors), atol=1e-5)


def test_engine_selfcal_on_mesh(engine_ranks):
    """``refine_focal=True`` on the mesh (test_parallel.py:143-163): the
    border rides the sharded solver, the error gates hold and the focal
    scale stays within 0.05 of 1 (K was the true focal)."""
    outs = engine_ranks.wait()
    r = outs[0]["selfcal"]
    assert any("focal self-calibration" in w for w in r["warnings"])
    b, a = r["errors"]
    assert a <= b + 1e-6 and a < 3.0
    assert abs(r["focal_scale"] - 1.0) < 0.05
    for o in outs[1:]:
        assert o["selfcal"]["focal_scale"] == r["focal_scale"]
        np.testing.assert_array_equal(np.stack(o["selfcal"]["poses"]), np.stack(r["poses"]))


@pytest.mark.parametrize("run", ["global", "global_stream"])
def test_global_engine_on_mesh(run, engine_ranks):
    """``GlobalSfmEngine(mesh)`` at 2 ranks (test_global_sfm.py:142-153):
    final error < 2 px and no worse than before, more than 40 tracks; with
    ``stream_ba_window`` the final BA streams window by window (2 or more)
    through each rank's own store. Both ranks' poses are the same bits."""
    outs = engine_ranks.wait()
    r = outs[0][run]
    b, a = r["errors"]
    assert a < 2.0 and a <= b + 1e-6
    assert r["tracks"] > 40
    if run == "global_stream":
        assert r["stream"]["windows"] >= 2
    for o in outs[1:]:
        np.testing.assert_array_equal(np.stack(o[run]["poses"]), np.stack(r["poses"]))


def test_stream_bundle_adjust_on_mesh(engine_ranks):
    """``stream_bundle_adjust(mesh=...)`` on mp_ba_worker.py's map, with its
    gates (test_multiprocess.py:64-68): final error < min(0.6, initial),
    2 windows or more, a resident share under 0.85; each rank has its own
    store root, and the refined cameras are the same bits."""
    outs = engine_ranks.wait()
    s = outs[0]["stream"]
    assert s["err1"] < min(0.6, s["err0"])
    assert s["windows"] >= 2
    assert s["resident"] < 0.85
    assert len({o["stream"]["root"] for o in outs}) == len(outs)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["stream"]["cams"], s["cams"])
