"""Translation averaging's whole solve in one launch: wrapper of the CUDA
kernel ``csrc/translation_averaging.cu``.

Replaces no Pallas kernel: the JAX package leaves this solve, a ``lax.scan``
of IRLS rounds around a ``lax.scan`` of CG steps, to XLA. It was added
because it is launch-bound: as Python loops of PyTorch ops it made ~24,000
launches a call at the engines' 12 rounds of 64 CG steps, each on at most a
few hundred floats. The kernel runs every round, both branches (edge scales
given or not) and the re-anchoring in one block of one launch, in float32 or
float64, with no atomics: each camera's sums walk the plans of ``edge_i`` and
``edge_j`` (``ba/schur.py::segment_plan``) in order (``csrc/
translation_averaging.cu`` has the design).

Bound on the card: one pass over the solver's state (``state_bytes``: per
camera 6 3-vectors, per edge 10 values and 4 indices) a CG step, about
``num_iters x (cg_iters + 2)`` passes a call (``transavg_bytes``), from
shared memory or L2 at one SM's 128 bytes a clock: 7.0 MB, 0.027 ms at
``glob20_ring``'s shape (20 cameras, 128 edges). A chain of four block
barriers a CG step sets the time.

Callers: ``geometry/averaging.py::translation_averaging``, reached by
``pipeline/global_sfm.py::GlobalSfmEngine._motion_averaging`` and
``pipeline/chain_refresh.py::_average_poses``.

``translation_averaging_plain`` is the plain PyTorch version (Python loops
over the planned segment sums): the wrapper runs it for CPU tensors,
launches the kernel for CUDA tensors, and never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from sfmfromscratch_tpu_torch.ops.cuda.build import bind

__all__ = ["translation_averaging_planned", "translation_averaging_plain", "anneal",
           "add_row0", "state_bytes", "transavg_bytes", "launches"]

# Launches of the CUDA kernel since the last reset (set to 0 to reset).
launches = 0

_transavg = bind("translation_averaging", "sfm_translation_averaging",
                 [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_double] * 3
                 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])


def state_bytes(num_cameras: int, num_edges: int, itemsize: int) -> int:
    """Bytes of the kernel's state (its ``state_bytes``): per camera c, x,
    r, p, A p and b; per edge u and its term of the sums (3 each), w0, the
    data scale, the IRLS weight and ``along``; the edge and plan indices."""
    return (itemsize * (18 * num_cameras + 10 * num_edges)
            + 4 * (4 * num_edges + 2 * num_cameras + 2))


def transavg_bytes(num_cameras: int, num_edges: int, num_iters: int, cg_iters: int,
                   itemsize: int = 4) -> int:
    """Bytes a call moves through shared memory or L2: one pass over the
    state a CG step, two more a round (its weights and right-hand side)."""
    return num_iters * (cg_iters + 2) * state_bytes(num_cameras, num_edges, itemsize)


def add_row0(out: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out.at[0].add(v)``."""
    return torch.cat([out[:1] + v[None], out[1:]])


def anneal(start: float, final: float, num_iters: int, t: int, dtype, device) -> torch.Tensor:
    """``max(start * decay ** t, final)`` in the JAX dtype, decay chosen so
    the threshold reaches ``final`` at half of ``num_iters`` (the kernel
    computes the same from ``_decay``)."""
    tt = torch.tensor(float(t), dtype=dtype, device=device)
    return torch.clamp_min(start * _decay(start, final, num_iters) ** tt, final)


def _decay(start: float, final: float, num_iters: int) -> float:
    return (final / start) ** (1.0 / max(num_iters // 2, 1))


def _cg_fixed(apply, c: torch.Tensor, b: torch.Tensor, cg_iters: int) -> torch.Tensor:
    """Plain CG for exactly ``cg_iters`` steps from ``c`` (the JAX ``scan``:
    no early exit, guarded divisions)."""
    rr = b - apply(c)
    p = rr
    rs = torch.sum(rr * rr)
    x = c
    for _ in range(cg_iters):
        Ap = apply(p)
        denom = torch.sum(p * Ap)
        alpha = rs / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
        x = x + alpha * p
        rr = rr - alpha * Ap
        rs_new = torch.sum(rr * rr)
        beta = rs_new / torch.where(rs < 1e-12, 1e-12, rs)
        p = rr + beta * p
        rs = rs_new
    return x


def translation_averaging_plain(
    u_dir: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor, c_init: torch.Tensor,
    edge_w: Optional[torch.Tensor], plan_i, plan_j, num_iters: int, cg_iters: int,
    huber_start: float, huber_final: float, edge_s: Optional[torch.Tensor],
    segment_sum: Callable,
) -> torch.Tensor:
    """``geometry/averaging.py::translation_averaging`` in PyTorch ops, over
    the plans ``plan_i``, ``plan_j`` of ``ei``, ``ej`` (int64), each sum
    taken by ``segment_sum(x, plan)`` (``ba/schur.py::segment_sum``)."""
    dt, dev = c_init.dtype, c_init.device
    w0 = torch.ones(u_dir.shape[0], dtype=u_dir.dtype, device=u_dir.device) \
        if edge_w is None else edge_w
    pin = 10.0
    sum_w0 = torch.clamp_min(torch.sum(w0), 1e-9)
    c = c_init - c_init[0][None]

    if edge_s is not None:
        s_data = edge_s.to(u_dir.dtype)

        def apply_L(cc, w):
            d = cc[ei] - cc[ej]
            wd = w[:, None] * d
            out = segment_sum(wd, plan_i) - segment_sum(wd, plan_j)
            out = add_row0(out, pin * cc[0])
            return out + 1e-8 * cc

        for t in range(num_iters):
            delta_t = anneal(huber_start, huber_final, num_iters, t, dt, dev)
            d = c[ei] - c[ej]
            along = torch.sum(u_dir * d, dim=-1)
            lam = 0.5 ** torch.tensor(float(t), dtype=dt, device=dev)
            s = lam * s_data + (1.0 - lam) * torch.maximum(along, 0.05 * s_data)
            r = torch.linalg.norm(d - s[:, None] * u_dir, dim=-1)
            rn = r / torch.clamp_min(s, 1e-9)
            w = w0 * torch.clamp_max(delta_t / torch.clamp_min(rn, 1e-9), 1.0)
            wsu = (w * s)[:, None] * u_dir
            b = segment_sum(wsu, plan_i) - segment_sum(wsu, plan_j)
            c_new = _cg_fixed(lambda p: apply_L(p, w), c, b, cg_iters)
            c = c_new - c_new[0][None]
        return c

    rho = 1.0
    target = sum_w0

    def gvec(w):
        wu = w[:, None] * u_dir
        return segment_sum(wu, plan_i) - segment_sum(wu, plan_j)

    def apply_A(cc, w, g):
        d = cc[ei] - cc[ej]
        proj = d - u_dir * torch.sum(u_dir * d, dim=-1, keepdim=True)
        wp = w[:, None] * proj
        out = segment_sum(wp, plan_i) - segment_sum(wp, plan_j)
        out = add_row0(out, pin * cc[0])
        return out + rho * torch.sum(g * cc) * g

    for t in range(num_iters):
        delta_t = anneal(huber_start, huber_final, num_iters, t, dt, dev)
        d = c[ei] - c[ej]
        along = torch.sum(u_dir * d, dim=-1)
        mean_len = torch.sum(w0 * torch.abs(along)) / sum_w0
        scale = torch.clamp_min(mean_len, 1e-9)
        r = torch.linalg.norm(d - along[:, None] * u_dir, dim=-1) / scale
        w = w0 * torch.clamp_max(delta_t / torch.clamp_min(r, 1e-9), 1.0)
        w = w * torch.where(along > 0, 1.0, 0.05)
        g = gvec(w)
        b = rho * target * g
        c_new = _cg_fixed(lambda p: apply_A(p, w, g), c, b, cg_iters)
        c = c_new - c_new[0][None]
    return c


def _launch(u_dir, ei, ej, c_init, edge_w, plan_i, plan_j, num_iters, cg_iters, huber_start,
            huber_final, edge_s) -> torch.Tensor:
    """One launch of the whole solve for CUDA tensors of one type, float32
    or float64, all contiguous and on one card."""
    global launches

    dtype, dev = u_dir.dtype, u_dir.device
    E, C = u_dir.shape[0], c_init.shape[0]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"translation-averaging kernel takes float32 or float64, got {dtype}")
    values = {"u_dir": (u_dir, (E, 3)), "c_init": (c_init, (C, 3)), "edge_w": (edge_w, (E,)),
              "edge_s": (edge_s, (E,))}
    ints = {"edge_i": (ei, torch.int64, (E,)), "edge_j": (ej, torch.int64, (E,)),
            "plan_i.perm": (plan_i.perm, torch.int32, (E,)),
            "plan_i.offsets": (plan_i.offsets, torch.int32, (C + 1,)),
            "plan_j.perm": (plan_j.perm, torch.int32, (E,)),
            "plan_j.offsets": (plan_j.offsets, torch.int32, (C + 1,))}
    for name, (t, shape) in values.items():
        if t is not None and (t.dtype != dtype or tuple(t.shape) != shape):
            raise ValueError(f"translation-averaging kernel: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, (t, want, shape) in ints.items():
        if t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(f"translation-averaging kernel: {name} must be {want} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    tensors = [t for t, _ in values.values() if t is not None] + [t for t, _, _ in ints.values()]
    if any(not t.is_contiguous() or t.device != dev for t in tensors):
        raise ValueError("translation-averaging kernel takes contiguous tensors on one card")
    if not 1 <= C < 2 ** 31 - 1 or E >= 2 ** 31 or num_iters < 0 or cg_iters < 0:
        raise ValueError(f"translation-averaging kernel: {C} cameras, {E} edges, "
                         f"{num_iters} rounds of {cg_iters} steps")
    nbytes = state_bytes(C, E, u_dir.element_size())
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty((C, 3), dtype=dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _transavg(dev, u_dir.data_ptr(), ei.data_ptr(), ej.data_ptr(), c_init.data_ptr(),
              ptr(edge_w), ptr(edge_s), plan_i.perm.data_ptr(), plan_i.offsets.data_ptr(),
              plan_j.perm.data_ptr(), plan_j.offsets.data_ptr(), C, E, num_iters, cg_iters,
              huber_start, huber_final, _decay(huber_start, huber_final, num_iters),
              u_dir.element_size(), scratch.data_ptr(), nbytes, out.data_ptr())
    launches += 1
    return out


def translation_averaging_planned(
    u_dir: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor, c_init: torch.Tensor,
    edge_w: Optional[torch.Tensor], plan_i, plan_j, *, num_iters: int, cg_iters: int,
    huber_start: float, huber_final: float, edge_s: Optional[torch.Tensor],
    segment_sum: Callable,
) -> torch.Tensor:
    """(C, 3) centres of ``geometry/averaging.py::translation_averaging``
    over the plans of ``ei`` and ``ej`` (int64): one kernel launch for CUDA
    tensors, ``translation_averaging_plain`` with ``segment_sum`` for CPU
    tensors."""
    args = (u_dir, ei, ej, c_init, edge_w, plan_i, plan_j, num_iters, cg_iters, huber_start,
            huber_final, edge_s)
    if u_dir.device.type == "cpu":
        return translation_averaging_plain(*args, segment_sum)
    if u_dir.device.type == "cuda":
        return _launch(*args)
    raise ValueError(f"unsupported device {u_dir.device}")
