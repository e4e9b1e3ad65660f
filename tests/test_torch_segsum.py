"""The port's planned segment sums, on the CPU.

``ba/schur.py::segment_plan`` orders each index vector once for as long as
it stays fixed (an LM solve, an averaging, triangulation or scale-solve
call); ``ops/cuda/segsum_kernel.py`` launches ``csrc/segment_sum.cu`` over
the plan for CUDA tensors and adds with ``index_add_`` for CPU tensors. The
kernel runs only on the card (``chip_smoke.py``'s segsum phase); here the
plan, the walk over it that the kernel makes, the wrapper's checks and
counters (with the launch faked) and the plans' use in ``lm_run`` and the
other callers.
"""

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu_torch.ba import lm_core, schur
from sfmfromscratch_tpu_torch.ba.problem import make_problem, pad_problem
from sfmfromscratch_tpu_torch.geometry import averaging, triangulation
from sfmfromscratch_tpu_torch.ops.cuda import segsum_kernel as SK
from sfmfromscratch_tpu_torch.pipeline import chain_refresh
from sfmfromscratch_tpu_torch.utils import profiling

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

THREADS = 256   # csrc/segment_sum.cu's block


def _padded_idx(rng, real, num_segments, pad):
    """``real`` random in-range indices, then ``pad`` zeros: the run that
    ``pad_problem`` puts on segment 0."""
    return torch.from_numpy(np.concatenate([rng.integers(0, num_segments, real),
                                            np.zeros(pad, np.int64)]))


@pytest.mark.parametrize("real, num_segments, pad", [(500, 37, 0), (300, 1000, 4095),
                                                     (2000, 5, 0), (0, 4, 7)])
def test_segment_plan_orders_rows_stably(real, num_segments, pad):
    """``perm`` lists each segment's rows in index order, segment after
    segment; ``offsets`` has S + 1 starts with empty segments included;
    ``long_segs`` is every segment of more than ``LONG_ROWS`` rows, in index
    order; ``group`` is the least power of two that leaves no lane of a
    shorter segment more than ``ROWS_PER_LANE`` rows."""
    idx = _padded_idx(np.random.default_rng(real), real, num_segments, pad)
    plan = schur.segment_plan(idx, num_segments)
    assert plan.perm.dtype == plan.offsets.dtype == plan.long_segs.dtype == torch.int32
    assert plan.idx is idx
    counts = torch.bincount(idx, minlength=num_segments)
    assert plan.offsets.tolist() == [0] + torch.cumsum(counts, 0).tolist()
    for s in range(num_segments):
        rows = plan.perm[plan.offsets[s]:plan.offsets[s + 1]].tolist()
        assert rows == torch.nonzero(idx == s).flatten().tolist()
    assert plan.long_segs.tolist() == torch.nonzero(counts > SK.LONG_ROWS).flatten().tolist()
    short = counts[counts <= SK.LONG_ROWS]
    need = max(1, -(-int(short.max()) // SK.ROWS_PER_LANE)) if short.numel() else 1
    assert plan.group >= need and (plan.group == 1 or plan.group // 2 < need)
    assert plan.group & (plan.group - 1) == 0 and plan.group <= 32


def test_segment_plan_padding_run_and_range():
    """A 4,095-row run on segment 0, as ``pad_problem`` leaves it, makes
    segment 0 long and keeps its rows in order; indices outside the segments
    are refused."""
    idx = torch.cat([torch.arange(40) % 8, torch.zeros(4095, dtype=torch.int64)])
    plan = schur.segment_plan(idx, 8)
    assert plan.long_segs.tolist() == [0]
    assert int(plan.offsets[1]) == 4095 + 5
    assert plan.perm[:5].tolist() == [0, 8, 16, 24, 32]
    assert plan.perm[5:4100].tolist() == list(range(40, 4135))
    assert plan.group == 1          # 5 rows a short segment: one lane
    for bad in (torch.tensor([0, 8]), torch.tensor([-1, 0])):
        with pytest.raises(ValueError, match="outside"):
            schur.segment_plan(bad, 8)


def _kernel_walk(plan):
    """For each segment, the rows the kernel adds into it, in the order of
    ``csrc/segment_sum.cu``: (lane or thread, row) pairs, read from the plan
    as the kernel reads it; and the number of times each segment is written."""
    offsets, perm = plan.offsets.tolist(), plan.perm.tolist()
    S = len(offsets) - 1
    seen = {s: [] for s in range(S)}
    writes = [0] * S
    for seg in plan.long_segs.tolist():
        b, e = offsets[seg], offsets[seg + 1]
        for t in range(THREADS):
            seen[seg] += [(t, perm[i]) for i in range(b + t, e, THREADS)]
        writes[seg] += 1
    for seg in range(S):
        b, e = offsets[seg], offsets[seg + 1]
        if e - b > SK.LONG_ROWS:
            continue
        for lane in range(plan.group):
            seen[seg] += [(lane, perm[i]) for i in range(b + lane, e, plan.group)]
        writes[seg] += 1
    return seen, writes


@pytest.mark.parametrize("real, num_segments, pad", [(3000, 40, 4095), (600, 200, 100),
                                                     (5000, 8, 0)])
def test_kernel_walk_reads_every_row_once(real, num_segments, pad):
    """The kernel's walk over a plan writes every segment once and adds
    every row once, into its own segment, each lane or thread in row order
    and at most ``ROWS_PER_LANE`` rows a lane of a short segment."""
    idx = _padded_idx(np.random.default_rng(pad), real, num_segments, pad)
    plan = schur.segment_plan(idx, num_segments)
    seen, writes = _kernel_walk(plan)
    assert writes == [1] * num_segments
    all_rows = sorted(r for v in seen.values() for _, r in v)
    assert all_rows == list(range(idx.shape[0]))
    for seg, pairs in seen.items():
        assert all(int(idx[r]) == seg for _, r in pairs)
        per_lane = {}
        for lane, r in pairs:
            per_lane.setdefault(lane, []).append(r)
        assert all(v == sorted(v) for v in per_lane.values())
        if seg not in plan.long_segs.tolist():
            assert max((len(v) for v in per_lane.values()), default=0) <= SK.ROWS_PER_LANE


def _emulate_kernel(x, plan):
    """The kernel's float32 arithmetic in numpy: each lane's rows added in
    order, the butterfly over the group (or the warp), a long segment's 8
    warp partials added in warp order."""
    x = x.numpy()
    S, F = plan.offsets.numel() - 1, x.shape[1]
    out = np.zeros((S, F), np.float32)
    seen, _ = _kernel_walk(plan)
    longs = set(plan.long_segs.tolist())
    for seg, pairs in seen.items():
        lanes = THREADS if seg in longs else plan.group
        acc = np.zeros((lanes, F), np.float32)
        for lane, r in pairs:
            acc[lane] = acc[lane] + x[r]
        width = 32 if seg in longs else plan.group
        acc = acc.reshape(-1, width, F)
        off = width // 2
        while off:
            acc = acc + acc[:, np.arange(width) ^ off]
            off //= 2
        parts = acc[:, 0]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        out[seg] = total
    return torch.from_numpy(out)


@pytest.mark.parametrize("width", SK.WIDTHS)
def test_segment_sum_with_plan_is_index_add_on_cpu(width):
    """On the CPU a planned segment sum is the plain one bit for bit, for
    every row width the kernel takes, with the shapes of the BA's blocks;
    the kernel's order of addition (emulated) stays within the stated
    tolerance of it: 2 n 2^-24 of the segment's sum of absolute values."""
    rng = np.random.default_rng(width)
    idx = _padded_idx(rng, 700, 60, 4095)
    shape = {1: (), 3: (3,), 6: (6,), 9: (3, 3), 16: (4, 4), 18: (3, 6), 36: (6, 6)}[width]
    x = torch.from_numpy(rng.standard_normal((idx.shape[0],) + shape).astype(np.float32))
    plan = schur.segment_plan(idx, 60)
    got = schur.segment_sum(x, plan)
    assert torch.equal(got, torch.zeros((60,) + shape).index_add_(0, idx, x))
    emu = _emulate_kernel(x.reshape(-1, width), plan).reshape(got.shape)
    absum = torch.zeros((60,) + shape, dtype=torch.float64).index_add_(0, idx, x.double().abs())
    n = torch.bincount(idx, minlength=60).double().reshape((60,) + (1,) * len(shape))
    assert bool(((emu.double() - got.double()).abs() <= 2 * n * 2.0 ** -24 * absum).all())


def test_segsum_wrapper_dispatch_checks_and_counters(monkeypatch):
    """CPU rows take ``segsum_plain`` and count no launch; a tensor on
    another device, a width the kernel is not built for, a type other than
    float32 and float64, non-contiguous rows and a plan of another length
    are refused; a CUDA call (faked) is one launch over every segment,
    counted with its rows, in the rows' type, and a failed launch raises and
    counts nothing."""
    idx = torch.tensor([2, 0, 2, 1, 0, 0])
    plan = schur.segment_plan(idx, 4)
    x = torch.randn(6, 6, generator=torch.Generator().manual_seed(0))
    before = (SK.launches, SK.rows)
    assert torch.equal(SK.segment_sum_planned(x, plan), SK.segsum_plain(x, idx, 4))
    assert (SK.launches, SK.rows) == before
    with pytest.raises(ValueError):
        SK.segment_sum_planned(torch.empty(6, 6, device="meta"), plan)
    for bad in (torch.zeros(6, 6, dtype=torch.float16), torch.zeros(6, 4), torch.zeros(6),
                torch.zeros(6, 12)[:, ::2], torch.zeros(5, 6)):
        with pytest.raises(ValueError):
            SK._launch(bad, plan)
    with pytest.raises(ValueError):
        SK._launch(x, plan._replace(perm=plan.perm.long()))
    with pytest.raises(ValueError):
        SK._launch(x, plan._replace(group=3))

    calls = []

    def fake_segment_sum(device, *args):
        calls.append(args[4:9])        # segments, long segments, group, width, value bytes

    def failing(*args):
        raise RuntimeError("sfm_segment_sum failed with CUDA error 1")

    monkeypatch.setattr(SK, "_segment_sum", fake_segment_sum)
    out = SK._launch(x, plan)
    assert calls == [(4, 0, 1, 6, 4)] and tuple(out.shape) == (4, 6)
    assert SK._launch(x.double(), plan).dtype == torch.float64 and calls[-1] == (4, 0, 1, 6, 8)
    assert SK._launch(x[:, :1].contiguous(), plan).shape == (4, 1) and calls[-1] == (4, 0, 1, 1, 4)
    assert (SK.launches, SK.rows) == (before[0] + 3, before[1] + 18)
    monkeypatch.setattr(SK, "_segment_sum", failing)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        SK._launch(x, plan)
    assert SK.launches == before[0] + 3


def _scene(num_cams, num_pts, seed=0):
    """A padded BA problem: ``num_pts`` points seen by every camera, the
    first camera fixed, the estimate perturbed."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, num_pts), rng.uniform(-1.5, 1.5, num_pts),
                  rng.uniform(5, 9, num_pts)], 1)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    cams = np.array([[0.0, 0.02 * c, 0.0, -0.3 * c, 0.0, 0.0] for c in range(num_cams)])
    obs_cam, obs_pt, obs_xy = [], [], []
    for c in range(num_cams):
        th = cams[c, 1]
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        p = (X @ R.T + cams[c, 3:]) @ K.T
        obs_cam += [c] * num_pts
        obs_pt += list(range(num_pts))
        obs_xy.append(p[:, :2] / p[:, 2:] + 0.3 * rng.standard_normal((num_pts, 2)))
    init = cams + 0.01 * rng.standard_normal(cams.shape)
    init[0] = cams[0]
    fixed = np.zeros(num_cams, bool)
    fixed[0] = True
    return pad_problem(make_problem(init, X + 0.02 * rng.standard_normal(X.shape),
                                    np.array(obs_cam), np.array(obs_pt), np.concatenate(obs_xy),
                                    np.stack([K] * num_cams), cam_fixed=fixed, device="cpu"))


@pytest.mark.parametrize("dense, selfcal, plans", [(False, False, 2), (True, False, 3),
                                                   (False, True, 2)])
def test_lm_run_plans_once_and_counts(dense, selfcal, plans, monkeypatch):
    """``lm_run`` builds its plans once, before the loop (2 on PCG, 3 on the
    dense path), hands a plan to every segment sum of the solve, and counts
    both on the innermost open span: ``segsum_plans`` and
    ``segsum_launches``, one per planned sum."""
    built, sums = [], []
    plan_fn, sum_fn = schur.segment_plan, schur.segment_sum

    def counting_plan(idx, n):
        built.append(n)
        return plan_fn(idx, n)

    def recording_sum(x, plan):
        sums.append(isinstance(plan, schur.SegmentPlan))
        return sum_fn(x, plan)

    monkeypatch.setattr(schur, "segment_plan", counting_plan)
    monkeypatch.setattr(lm_core, "segment_plan", counting_plan)
    monkeypatch.setattr(schur, "segment_sum", recording_sum)
    monkeypatch.setattr(lm_core, "segment_sum", recording_sum)
    p = _scene(5, 40)
    timer = profiling.StageTimer()
    with timer.run():
        with timer.stage("ba"):
            out = lm_core.lm_run(p, selfcal=selfcal, use_dense=dense, huber_delta=0.0,
                                 max_iters=4, cg_iters=20, init_damping=1e-3, damping_up=4.0,
                                 damping_down=0.5, ftol=1e-6)
    C, P = p.num_cameras, p.num_points
    assert built == [C, P] + ([P * C] if dense else [])
    assert out.iterations_used == 4 and sums and all(sums)
    span = next(s for s in timer.spans if s.name == "ba")
    assert span.counters == {"segsum_plans": plans, "lm_iters": 4, "segsum_launches": len(sums)}
    assert float(out.final_cost) < float(out.initial_cost)


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _view_graph(C=6, pad=10):
    """A noisy view graph of ``C`` cameras, its edge list padded as the
    global engine pads it (weight-0 edges (0, 0), identity rotations)."""
    rng = np.random.default_rng(21)
    R = _rotations(rng, C)
    c = rng.standard_normal((C, 3))
    ei = np.array([i for k in (1, 2) for i in range(C)])
    ej = (ei + np.repeat([1, 2], C)) % C
    noise = np.eye(3) + 0.02 * rng.standard_normal((len(ei), 3, 3))
    R_rel = np.einsum("eij,ekj,ekl->eil", R[ej], R[ei], noise)      # R_j R_i^T, perturbed
    u = c[ei] - c[ej] + 0.05 * rng.standard_normal((len(ei), 3))

    def padded(a, fill, dtype=torch.float32):
        a = np.concatenate([a, np.broadcast_to(np.asarray(fill, a.dtype), (pad,) + a.shape[1:])])
        return torch.as_tensor(a, dtype=dtype)

    return dict(C=C, R_rel=padded(R_rel, np.eye(3)), edge_i=padded(ei, 0, torch.int64),
                edge_j=padded(ej, 0, torch.int64), edge_w=padded(np.ones(len(ei)), 0.0),
                u_dir=padded(u / np.linalg.norm(u, axis=1, keepdims=True), 0.0),
                edge_s=padded(np.linalg.norm(u, axis=1), 1.0),
                R_init=torch.as_tensor(R + 0.05 * rng.standard_normal(R.shape), dtype=torch.float32),
                c_init=torch.as_tensor(c + 0.1 * rng.standard_normal(c.shape), dtype=torch.float32))


def _caller(name):
    """The module of caller ``name``, a call of it on a small problem, and
    the (index vector, segments) it must plan, in order."""
    if name == "_solve_scales_cg":
        rng = np.random.default_rng(5)
        E, G = 8, 10
        eidx = torch.as_tensor(np.concatenate([np.arange(E), rng.integers(0, E, 32)]))
        gidx = torch.as_tensor(np.concatenate([np.arange(G), rng.integers(0, G, 30)]))
        logz = torch.as_tensor(rng.standard_normal(eidx.shape[0]), dtype=torch.float32)
        return (chain_refresh,
                lambda: chain_refresh._solve_scales_cg(eidx, gidx, logz, E, G, cg_iters=30,
                                                       irls_rounds=2),
                [(gidx, G), (eidx, E)])
    if name == "triangulate_multiview":
        # 12 tracks seen by 4 cameras, then 9 zero-weight rows on the last
        # track, as the global engine pads them; track 3 is seen once.
        rng = np.random.default_rng(7)
        C, T, pad = 4, 12, 9
        K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
        P = np.stack([K @ np.hstack([np.eye(3), [[0.3 * c], [0.0], [0.0]]]) for c in range(C)])
        X = np.stack([rng.uniform(-1, 1, T), rng.uniform(-1, 1, T), rng.uniform(4, 6, T)], 1)
        obs_cam = np.concatenate([np.arange(C).repeat(T), np.zeros(pad, np.int64)])
        obs_pt = np.concatenate([np.tile(np.arange(T), C), np.full(pad, T - 1)])
        h = np.einsum("oij,oj->oi", P[obs_cam], np.hstack([X[obs_pt], np.ones((len(obs_pt), 1))]))
        xy = h[:, :2] / h[:, 2:] + 0.5 * rng.standard_normal((len(obs_pt), 2))
        w = np.r_[np.ones(C * T), np.zeros(pad)]
        w[[T + 3, 2 * T + 3, 3 * T + 3]] = 0.0
        pt = torch.as_tensor(obs_pt)
        return (triangulation,
                lambda: triangulation.triangulate_multiview(
                    torch.as_tensor(P, dtype=torch.float32), torch.as_tensor(obs_cam), pt,
                    torch.as_tensor(xy, dtype=torch.float32), num_points=T,
                    obs_w=torch.as_tensor(w, dtype=torch.float32), gn_iters=3),
                [(pt, T)])
    g = _view_graph()
    C, ei, ej, w = g["C"], g["edge_i"], g["edge_j"], g["edge_w"]
    call = {
        "chordal_rotation_init": lambda: averaging.chordal_rotation_init(
            g["R_rel"], ei, ej, g["R_init"], edge_w=w, num_cameras=C, cg_iters=20),
        "rotation_averaging": lambda: averaging.rotation_averaging(
            g["R_rel"], ei, ej, g["R_init"], edge_w=w, num_cameras=C, num_iters=6),
        "translation_averaging": lambda: averaging.translation_averaging(
            g["u_dir"], ei, ej, g["c_init"], edge_w=w, num_cameras=C, num_iters=4, cg_iters=12),
        "translation_averaging(edge_s)": lambda: averaging.translation_averaging(
            g["u_dir"], ei, ej, g["c_init"], edge_w=w, num_cameras=C, num_iters=4, cg_iters=12,
            edge_s=g["edge_s"]),
    }[name]
    return averaging, call, [(ei, C), (ej, C)]


@pytest.mark.parametrize("name", ["chordal_rotation_init", "rotation_averaging",
                                  "translation_averaging", "translation_averaging(edge_s)",
                                  "triangulate_multiview", "_solve_scales_cg"])
def test_callers_plan_each_index_vector_once(name, monkeypatch):
    """Averaging (both translation solvers), triangulation and the chain
    refresh's scale solve plan each of their index vectors once a call and
    hand one of those plans to every segment sum; on the CPU their output
    is, bit for bit, what they give with each sum a sequential ``np.add.at``
    over the index vector in the rows' type (``index_add_``'s order), and
    triangulation's counts are the integer counts of weighted rows."""
    module, call, want = _caller(name)
    built, plans, sums = [], [], []

    def counting_plan(idx, n):
        built.append((idx, n))
        plans.append(schur.segment_plan(idx, n))
        return plans[-1]

    def recording_sum(x, plan):
        sums.append(any(plan is p for p in plans))
        return schur.segment_sum(x, plan)

    with monkeypatch.context() as m:
        m.setattr(module, "segment_plan", counting_plan)
        m.setattr(module, "segment_sum", recording_sum)
        got = call()
    assert len(built) == len(want)
    assert all(n == wn and torch.equal(idx, widx) for (idx, n), (widx, wn) in zip(built, want))
    assert len(sums) >= 4 and all(sums)

    def sequential_sum(x, plan):
        idx, n = plan
        out = np.zeros((n,) + tuple(x.shape[1:]), x.numpy().dtype)
        np.add.at(out, idx.numpy(), x.numpy())
        return torch.from_numpy(out)

    with monkeypatch.context() as m:
        m.setattr(module, "segment_plan", lambda idx, n: (idx, n))
        m.setattr(module, "segment_sum", sequential_sum)
        ref = call()
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for a, b in zip(got, ref, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if name == "triangulate_multiview":
        assert got[1].dtype == torch.int32 and got[1].tolist() == [4, 4, 4, 1] + [4] * 8
