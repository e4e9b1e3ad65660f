"""The port's motion averaging (``geometry/averaging.py``) against the JAX
package, on the CPU.

One seeded view graph: 12 cameras, a window-1 chain plus 14 extra edges,
2 deg of rotation noise on every edge and two outlier edges (a random
rotation and direction). Both packages get the same float32 inputs. The
padded case appends zero-weight self-loops on camera 0 with identity
rotations up to 128 edges, as ``GlobalSfmEngine`` pads its edge list;
rotation averaging normalises its weights by their mean over that list, so
both packages get the padded list. Tolerances: rotations within 1e-3 rad,
centres within 1e-3 of the trajectory extent (float32 IRLS sweeps, SVDs and
CG by two LAPACK paths; each test states what it measured).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu.geometry import averaging as ja
from sfmfromscratch_tpu_torch.geometry import averaging as ta

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

C, EXTRA, NOISE_DEG, PAD = 12, 14, 2.0, 128


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _rot(r, angle):
    ax = r.normal(size=3)
    ax /= np.linalg.norm(ax)
    W = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(angle) * W + (1 - np.cos(angle)) * W @ W


@pytest.fixture(scope="module")
def graph():
    r = np.random.default_rng(30)
    R_abs = [np.eye(3)]
    for _ in range(C - 1):
        R_abs.append(_rot(r, r.uniform(0, 0.3)) @ R_abs[-1])
    R_abs = np.stack(R_abs)
    c_abs = np.cumsum(r.normal(0, 1.0, (C, 3)), axis=0)
    c_abs -= c_abs[0]
    edges = [(i, i + 1) for i in range(C - 1)]
    while len(edges) < C - 1 + EXTRA:
        i, j = sorted(r.choice(C, 2, replace=False))
        if (i, j) not in edges:
            edges.append((int(i), int(j)))
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    R_rel = np.stack([_rot(r, np.radians(r.uniform(0, NOISE_DEG))) @ R_abs[j] @ R_abs[i].T
                      for i, j in edges])
    u = c_abs[ei] - c_abs[ej]
    s = np.linalg.norm(u, axis=1)
    u /= s[:, None]
    s *= np.exp(r.normal(0, 0.05, len(s)))
    for b in (C + 2, C + 7):                       # two outlier edges among the extras
        R_rel[b] = _rot(r, 2.0) @ R_rel[b]
        v = r.normal(size=3)
        u[b] = v / np.linalg.norm(v)
    w = r.uniform(0.3, 1.0, len(edges))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(R_abs=R_abs, c_abs=c_abs, R_rel=f32(R_rel), u=f32(u), s=f32(s), w=f32(w),
                ei=ei.astype(np.int32), ej=ej.astype(np.int32),
                extent=float(np.linalg.norm(c_abs.max(0) - c_abs.min(0))))


def _pad(g, padded):
    """The edge arrays, padded to PAD edges as the global engine pads them."""
    E = len(g["ei"])
    n = PAD - E if padded else 0
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3))
    z = np.zeros(n, np.int32)
    return dict(R_rel=np.concatenate([g["R_rel"], eye]), ei=np.concatenate([g["ei"], z]),
                ej=np.concatenate([g["ej"], z]), w=np.concatenate([g["w"], np.zeros(n, np.float32)]),
                u=np.concatenate([g["u"], np.tile(np.float32([0, 0, 1]), (n, 1))]),
                s=np.concatenate([g["s"], np.ones(n, np.float32)]))


def _jt(a, dtype=None):
    return jnp.asarray(a), (torch.as_tensor(np.array(a)) if dtype is None
                            else torch.as_tensor(np.array(a)).to(dtype))


def _rot_gap_rad(A, B):
    """Largest angle between paired rotations, from the chordal distance
    ||A - B||_F = 2 sqrt(2) sin(theta / 2): exact at small angles, where the
    arccos of a float32 trace is not."""
    d = np.linalg.norm(np.asarray(A, np.float64) - np.asarray(B, np.float64), axis=(1, 2))
    return float(np.max(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0))))


def test_project_so3_and_chain_inits_match_jax(graph):
    """``_project_so3`` on noisy matrices within 1e-5 (measured 5e-7); the
    host chain walks (float64 in both) within 1e-6 on the chain edges."""
    r = np.random.default_rng(31)
    M = (graph["R_rel"] + 0.1 * r.normal(size=graph["R_rel"].shape)).astype(np.float32)
    np.testing.assert_allclose(_np(ta._project_so3(torch.as_tensor(M))),
                               _np(ja._project_so3(jnp.asarray(M))), atol=1e-5)
    chain = slice(0, C - 1)
    g = graph
    Rj = ja.chain_initial_rotations(jnp.asarray(g["R_rel"][chain]), g["ei"][chain], g["ej"][chain], C)
    Rt = ta.chain_initial_rotations(torch.as_tensor(g["R_rel"][chain]), g["ei"][chain],
                                    g["ej"][chain], C)
    assert Rt.dtype == torch.float32 and Rt.device.type == "cpu"
    np.testing.assert_allclose(_np(Rt), _np(Rj), atol=1e-6)
    su = g["u"] * g["s"][:, None]
    cj = ja.chain_initial_centers(jnp.asarray(su), g["ei"], g["ej"], C)
    ct = ta.chain_initial_centers(su, g["ei"], g["ej"], C)
    np.testing.assert_allclose(_np(ct), _np(cj), atol=1e-6)
    # Every camera reached: the walk follows the chain.
    assert np.abs(_np(ct)[1:]).sum(1).min() > 0


@pytest.mark.parametrize("padded", [False, True])
def test_rotation_averaging_matches_jax(graph, padded):
    """Chain walk, chordal CG init (2 Huber rounds) and 64 IRLS sweeps, with
    the padded list in both packages when ``padded``: every stage within 1e-3
    rad of JAX (measured below 1e-5), and the result within a few degrees of
    the truth despite the two outliers."""
    g = graph
    p = _pad(g, padded)
    R0 = ja.chain_initial_rotations(jnp.asarray(g["R_rel"][:C - 1]), g["ei"][:C - 1],
                                    g["ej"][:C - 1], C)
    R0t = torch.as_tensor(_np(R0))
    (Rrj, Rrt), (eij, eit), (ejj, ejt), (wj, wt) = (
        _jt(p["R_rel"]), _jt(p["ei"], torch.int64), _jt(p["ej"], torch.int64), _jt(p["w"]))
    chj = ja.chordal_rotation_init(Rrj, eij, ejj, R0, edge_w=wj, num_cameras=C, cg_iters=128)
    cht = ta.chordal_rotation_init(Rrt, eit, ejt, R0t, edge_w=wt, num_cameras=C, cg_iters=128)
    assert _rot_gap_rad(_np(cht), _np(chj)) < 1e-3
    rj = ja.rotation_averaging(Rrj, eij, ejj, chj, edge_w=wj, num_cameras=C, eps_final=0.02)
    rt = ta.rotation_averaging(Rrt, eit, ejt, torch.as_tensor(_np(chj)), edge_w=wt,
                               num_cameras=C, eps_final=0.02)
    assert _rot_gap_rad(_np(rt), _np(rj)) < 1e-3
    np.testing.assert_allclose(_np(rt)[0], np.eye(3), atol=1e-5)        # gauge
    assert np.degrees(_rot_gap_rad(_np(rt), g["R_abs"])) < 3.0


@pytest.mark.parametrize("anchored", [True, False])
@pytest.mark.parametrize("padded", [False, True])
def test_translation_averaging_matches_jax(graph, anchored, padded):
    """12 IRLS rounds of 64 CG steps from the scaled chain walk, with the
    per-edge scales (``anchored``) or by projection least squares: centres
    within 1e-3 of the trajectory extent of JAX's (measured below 1e-5),
    camera 0 at the origin."""
    g = graph
    p = _pad(g, padded)
    su = g["u"] * g["s"][:, None]
    c0 = _np(ja.chain_initial_centers(jnp.asarray(su), g["ei"], g["ej"], C))
    (uj, ut), (eij, eit), (ejj, ejt), (wj, wt) = (
        _jt(p["u"]), _jt(p["ei"], torch.int64), _jt(p["ej"], torch.int64), _jt(p["w"]))
    kw = dict(num_cameras=C, num_iters=12)
    sj, st = _jt(p["s"]) if anchored else (None, None)
    cj = ja.translation_averaging(uj, eij, ejj, jnp.asarray(c0), edge_w=wj, edge_s=sj, **kw)
    ct = ta.translation_averaging(ut, eit, ejt, torch.as_tensor(c0), edge_w=wt, edge_s=st, **kw)
    assert np.abs(_np(ct) - _np(cj)).max() <= 1e-3 * g["extent"]
    np.testing.assert_allclose(_np(ct)[0], 0.0, atol=1e-6)


def test_relative_translations_known_rotations_matches_jax(graph):
    """Translation directions of the graph's edges from 60 correspondences
    each (0.3 px noise, a fifth masked off, padded edges all masked) under the
    true relative rotations: directions within 1e-3 and eigengap confidences
    within 1e-3 of JAX's; the sign follows the cheirality majority, so it
    agrees with the truth."""
    g = graph
    r = np.random.default_rng(32)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    E, N = len(g["ei"]), 60
    Rij, P1, P2, M, t_true = [], [], [], [], []
    for i, j in zip(g["ei"], g["ej"]):
        Ri, Rj = g["R_abs"][i], g["R_abs"][j]
        R = Rj @ Ri.T
        t = Rj @ (g["c_abs"][i] - g["c_abs"][j])
        Xc = np.column_stack([r.uniform(-2, 2, N), r.uniform(-2, 2, N), r.uniform(6, 10, N)])
        Xc[:, 2] += np.linalg.norm(t)
        x1 = Xc @ K.T
        x2 = (Xc @ R.T + t) @ K.T
        keep = x2[:, 2] > 0
        P1.append(x1[:, :2] / x1[:, 2:] + r.normal(0, 0.3, (N, 2)))
        P2.append(x2[:, :2] / x2[:, 2:] + r.normal(0, 0.3, (N, 2)))
        M.append(keep & (r.uniform(size=N) > 0.2))
        Rij.append(R)
        t_true.append(t / np.linalg.norm(t))
    n = 4   # padded edges
    f32 = lambda a: np.asarray(a, np.float32)
    Rij = f32(np.concatenate([Rij, np.tile(np.eye(3), (n, 1, 1))]))
    P1 = f32(np.concatenate([P1, np.zeros((n, N, 2))]))
    P2 = f32(np.concatenate([P2, np.zeros((n, N, 2))]))
    Ks = f32(np.tile(K, (E + n, 1, 1)))
    M = np.concatenate([np.array(M), np.zeros((n, N), bool)])
    tj, cj = ja.relative_translations_known_rotations(*(jnp.asarray(a) for a in (Rij, P1, P2, Ks, Ks, M)))
    tt, ct = ta.relative_translations_known_rotations(
        *(torch.as_tensor(a) for a in (Rij, P1, P2, Ks, Ks)), torch.as_tensor(M))
    np.testing.assert_allclose(_np(tt)[:E], _np(tj)[:E], atol=1e-3)
    np.testing.assert_allclose(_np(ct)[:E], _np(cj)[:E], atol=1e-3)
    cos = np.sum(_np(tt)[:E] * np.array(t_true), axis=1)
    assert cos.min() > 0.99
