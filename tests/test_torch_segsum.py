"""The planned segment sums of bundle adjustment, on the CPU.

``ba/schur.py::segment_plan`` orders each index vector once per LM solve;
``ops/cuda/segsum_kernel.py`` launches ``csrc/segment_sum.cu`` over the plan
for CUDA tensors and adds with ``index_add_`` for CPU tensors. The kernel
runs only on the card (``chip_smoke.py``'s segsum phase); here the plan, the
walk over it that the kernel makes, the wrapper's checks and counters (with
the launch faked) and the plans' use in ``lm_run``.
"""

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu_torch.ba import lm_core, schur
from sfmfromscratch_tpu_torch.ba.problem import make_problem, pad_problem
from sfmfromscratch_tpu_torch.ops.cuda import segsum_kernel as SK
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
    shape = {3: (3,), 6: (6,), 9: (3, 3), 18: (3, 6), 36: (6, 6)}[width]
    x = torch.from_numpy(rng.standard_normal((idx.shape[0],) + shape).astype(np.float32))
    plan = schur.segment_plan(idx, 60)
    got = schur.segment_sum(x, idx, 60, plan)
    assert torch.equal(got, schur.segment_sum(x, idx, 60))
    assert torch.equal(got, torch.zeros((60,) + shape).index_add_(0, idx, x))
    emu = _emulate_kernel(x.reshape(-1, width), plan).reshape(got.shape)
    absum = torch.zeros((60,) + shape, dtype=torch.float64).index_add_(0, idx, x.double().abs())
    n = torch.bincount(idx, minlength=60).double().reshape((60,) + (1,) * len(shape))
    assert bool(((emu.double() - got.double()).abs() <= 2 * n * 2.0 ** -24 * absum).all())
    with pytest.raises(ValueError, match="a plan of 60 segments for 61"):
        schur.segment_sum(x, idx, 61, plan)


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

    def fake_kernel(*args):
        calls.append(args[4:9])        # segments, long segments, group, width, value bytes
        return 0

    monkeypatch.setattr(SK, "_kernel", lambda: fake_kernel)
    monkeypatch.setattr(SK, "_call", lambda fn, args, dev: fn(*args, 0))
    out = SK._launch(x, plan)
    assert calls == [(4, 0, 1, 6, 4)] and tuple(out.shape) == (4, 6)
    assert SK._launch(x.double(), plan).dtype == torch.float64 and calls[-1] == (4, 0, 1, 6, 8)
    assert (SK.launches, SK.rows) == (before[0] + 2, before[1] + 12)
    monkeypatch.setattr(SK, "_kernel", lambda: lambda *a: 1)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        SK._launch(x, plan)
    assert SK.launches == before[0] + 2


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

    def recording_sum(x, idx, n, plan=None):
        sums.append(plan is not None)
        return sum_fn(x, idx, n, plan)

    monkeypatch.setattr(schur, "segment_plan", counting_plan)
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
