"""The translation-averaging kernel's wrapper (``ops/cuda/transavg_kernel.py``)
on the CPU: CPU tensors take the plain version, whose results are, bit for
bit, what ``geometry/averaging.py::translation_averaging`` returned before
the kernel (digests below); the launch's input checks and its arguments,
with the C entry faked. The kernel itself runs only on the card
(``chip_smoke.py``'s ``transavg`` phase)."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from sfmfromscratch_tpu_torch.ba import schur
from sfmfromscratch_tpu_torch.geometry import averaging
from sfmfromscratch_tpu_torch.ops.cuda import transavg_kernel as TK

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _graph(C, window, padded, seed):
    """A window view graph over a random walk of C centres, noisy unit
    directions with two outliers, scales with 5% noise, weights in
    [0.3, 1], padded with zero-weight self-loops on camera 0 as
    ``GlobalSfmEngine`` pads."""
    r = np.random.default_rng(seed)
    c = np.cumsum(r.normal(0, 1.0, (C, 3)), axis=0)
    c -= c[0]
    edges = [(i, j) for i in range(C) for j in range(i + 1, min(C, i + window + 1))]
    E, pad = len(edges), padded - len(edges)
    ei, ej = (np.array(v) for v in zip(*edges))
    u = c[ei] - c[ej]
    s = np.linalg.norm(u, axis=1)
    u = u / s[:, None] + 0.02 * r.normal(size=(E, 3))
    for k in r.choice(E, 2, replace=False):
        u[k] = r.normal(size=3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    s *= np.exp(r.normal(0, 0.05, E))
    w = r.uniform(0.3, 1.0, E)
    zeros = np.zeros(pad, np.int64)
    return dict(C=C, u=np.concatenate([u, np.tile([[0.0, 0.0, 1.0]], (pad, 1))]),
                ei=np.concatenate([ei, zeros]), ej=np.concatenate([ej, zeros]),
                s=np.concatenate([s, np.ones(pad)]), w=np.concatenate([w, np.zeros(pad)]),
                c0=c + 0.3 * r.normal(size=c.shape))


def _tensors(g, dtype):
    f = lambda k: torch.as_tensor(g[k], dtype=dtype)
    return (f("u"), torch.as_tensor(g["ei"]), torch.as_tensor(g["ej"]), f("c0"), f("w"),
            f("s"))


# sha256 (first 16 hex digits) of translation_averaging's (C, 3) result on
# the CPU before the kernel (the Python loops, then in geometry/averaging.py),
# for (C, window, padded edges, seed, dtype, branch); "ones": no edge_w, 5
# rounds of 7 CG steps.
_BEFORE = {
    (20, 3, 128, 1, "float32", "anchored"): "df13abe2098a6479",
    (20, 3, 128, 1, "float32", "projection"): "cd21af5ed757ff50",
    (20, 3, 128, 1, "float32", "ones"): "050282a7656ecd2a",
    (20, 3, 128, 1, "float64", "anchored"): "54caeb4228ee75e2",
    (20, 3, 128, 1, "float64", "projection"): "011b1b8dbdd505d9",
    (20, 3, 128, 1, "float64", "ones"): "bdb2c17b7d4b33b9",
    (12, 2, 32, 3, "float32", "anchored"): "2e9a3bfd12629673",
    (12, 2, 32, 3, "float32", "projection"): "52f51fef219752fa",
    (12, 2, 32, 3, "float32", "ones"): "c68b30de5fa4e3f5",
}


@pytest.mark.parametrize("case", sorted(_BEFORE), ids=lambda c: "-".join(map(str, c)))
def test_cpu_takes_the_plain_version_bit_for_bit(case):
    """For CPU tensors ``translation_averaging`` runs the plain version,
    launches nothing, and returns what it returned before the kernel, bit
    for bit, in both branches and both types."""
    C, window, padded, seed, dtype, branch = case
    g = _graph(C, window, padded, seed)
    u, ei, ej, c0, w, s = _tensors(g, getattr(torch, dtype))
    kw = dict(num_iters=5, cg_iters=7) if branch == "ones" else dict(
        edge_w=w, edge_s=s if branch == "anchored" else None)
    before = TK.launches
    got = averaging.translation_averaging(u, ei, ej, c0, num_cameras=C, **kw)
    assert TK.launches == before
    assert hashlib.sha256(got.numpy().tobytes()).hexdigest()[:16] == _BEFORE[case]
    plans = schur.segment_plan(ei, C), schur.segment_plan(ej, C)
    plain = TK.translation_averaging_plain(
        u, ei, ej, c0, kw.get("edge_w"), *plans, kw.get("num_iters", 12), kw.get("cg_iters", 64),
        0.5, 0.05, kw.get("edge_s"), schur.segment_sum)
    assert torch.equal(got, plain)
    assert torch.equal(got[0], torch.zeros(3, dtype=got.dtype))


def _launch_args(g, dtype=torch.float32):
    u, ei, ej, c0, w, s = _tensors(g, dtype)
    C = g["C"]
    return [u, ei, ej, c0, w, schur.segment_plan(ei, C), schur.segment_plan(ej, C), 12, 64, 0.5,
            0.05, s]


def _replace(args, i, value):
    return args[:i] + [value] + args[i + 1:]


def test_launch_checks_its_inputs():
    """The launch refuses what the kernel does not take: another type than
    float32 or float64, mixed types, wrong shapes, int32 edges, a plan of
    another length, non-contiguous tensors, no camera; a device that is
    neither the CPU nor a card is refused by the dispatch."""
    g = _graph(12, 2, 32, 3)
    args = _launch_args(g)
    u, ei, ej, c0, w, pi, pj = args[:7]
    bad = [
        _replace(_replace(_replace(_replace(args, 0, u.half()), 3, c0.half()), 4, w.half()),
                 11, args[11].half()),
        _replace(args, 3, c0.double()),                  # mixed types
        _replace(args, 4, w.double()),
        _replace(args, 11, args[11].double()),
        _replace(args, 0, u[:, :2].contiguous()),        # (E, 2) directions
        _replace(args, 3, c0[:-1]),                      # plans over one camera more
        _replace(args, 11, args[11][:-1]),               # one scale short
        _replace(args, 1, ei.int()),                     # int32 edges
        _replace(args, 5, schur.segment_plan(ei[:-1], 12)),
        _replace(args, 0, u.t().contiguous().t()),       # non-contiguous
        _replace(args, 3, torch.zeros((0, 3))),          # no camera
    ]
    for a in bad:
        with pytest.raises(ValueError):
            TK._launch(*a)
    with pytest.raises(ValueError, match="unsupported device"):
        TK.translation_averaging_planned(
            u.to("meta"), ei, ej, c0, w, pi, pj, num_iters=12, cg_iters=64, huber_start=0.5,
            huber_final=0.05, edge_s=None, segment_sum=schur.segment_sum)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("anchored", [True, False])
def test_launch_arguments(dtype, anchored, monkeypatch):
    """One launch a call with the C entry's arguments in order: the tensors'
    pointers (none for absent weights or scales), cameras, edges, rounds, CG
    steps, the Huber schedule (start, final and the decay ``anneal``
    uses), the value size, a scratch buffer of ``state_bytes`` and the
    (C, 3) output; a failed launch raises and counts nothing."""
    g = _graph(12, 2, 32, 3)
    args = _launch_args(g, dtype)
    if not anchored:
        args[11] = None
    args[4] = None if anchored else args[4]
    calls = []
    monkeypatch.setattr(TK, "_transavg", lambda *a: calls.append(a))
    before = TK.launches
    out = TK._launch(*args)
    assert TK.launches == before + 1 and len(calls) == 1
    assert tuple(out.shape) == (12, 3) and out.dtype == dtype
    (dev, *ptrs), = [c[:11] for c in calls]
    u, ei, ej, c0, w, pi, pj = args[:7]
    assert dev == u.device
    want = [u, ei, ej, c0, w, args[11], pi.perm, pi.offsets, pj.perm, pj.offsets]
    assert ptrs == [None if t is None else t.data_ptr() for t in want]
    rest = calls[0][11:]
    itemsize = 4 if dtype == torch.float32 else 8
    assert rest[:4] == (12, 32, 12, 64)
    assert rest[4:7] == (0.5, 0.05, (0.05 / 0.5) ** (1 / 6))
    assert rest[7] == itemsize
    assert rest[9] == TK.state_bytes(12, 32, itemsize) == itemsize * (18 * 12 + 10 * 32) + 4 * (
        4 * 32 + 2 * 12 + 2)
    assert rest[10] == out.data_ptr()
    anneal = TK.anneal(0.5, 0.05, 12, 3, torch.float64, "cpu")
    assert float(anneal) == pytest.approx(max(0.5 * rest[6] ** 3, 0.05), rel=1e-15)

    def failing(*a):
        raise RuntimeError("sfm_translation_averaging failed with CUDA error 1")

    monkeypatch.setattr(TK, "_transavg", failing)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        TK._launch(*args)
    assert TK.launches == before + 1


def test_bound_counts_one_pass_a_step():
    """The bound's bytes: one pass over the state a CG step and two a
    round (7.0 MB at glob20_ring's 20 cameras and 128 edges in float32)."""
    assert TK.transavg_bytes(20, 128, 12, 64) == 12 * 66 * TK.state_bytes(20, 128, 4) == 6950592


@pytest.mark.parametrize("name", sorted(chip_smoke.TRANSAVG_SHAPES))
def test_smoke_graphs_have_the_cells_shapes(name):
    """``chip_smoke.py``'s graphs for the kernel phase: ``glob20_ring``'s 20
    cameras with its 54 window edges (and 20 chords), ``kf150_video``'s 150
    cameras of which 10 have edges, 1,000 cameras with over 3,000 edges;
    each padded as the engine pads, with zero-weight self-loops on camera
    0, in range for a plan, the same graph from the same seed."""
    shape = chip_smoke.TRANSAVG_SHAPES[name]
    g = chip_smoke.transavg_graph(shape, seed=22)
    E, C = g["edges"], shape["cams"]
    assert g["u"].shape == (shape["pad"], 3) and g["c0"].shape == (C, 3)
    assert {"glob20_ring": 74, "kf150_video": 24}.get(name, E) == E and (E >= 3000) == (C >= 1000)
    used = np.unique(np.concatenate([g["edge_i"][:E], g["edge_j"][:E]]))
    assert len(used) == shape["active"] and used.max() < C
    assert (g["w"][E:] == 0).all() and (g["edge_i"][E:] == 0).all() and (g["edge_j"][E:] == 0).all()
    assert (g["w"][:E] > 0).all() and np.allclose(np.linalg.norm(g["u"], axis=1), 1.0)
    schur.segment_plan(torch.as_tensor(g["edge_i"]), C)   # raises on an index out of range
    again = chip_smoke.transavg_graph(shape, seed=22)
    assert all(np.array_equal(g[k], again[k]) for k in ("u", "edge_i", "edge_j", "s", "w", "c0"))
