"""The PyTorch port's ops against the JAX package, on the CPU at small sizes.

Inputs are made with numpy from a seed and handed to both packages. The JAX
Pallas kernels run as ``tests/test_pallas_kernels.py`` runs them, with
``interpret=True``; the port's kernel wrappers run their plain PyTorch
versions, because the tensors lie on the CPU. Each tolerance is stated where
it is used.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from sfmfromscratch_tpu.ops import harris as jharris
from sfmfromscratch_tpu.ops import image as jimage
from sfmfromscratch_tpu.ops import lie as jlie
from sfmfromscratch_tpu.ops import matcher as jmatcher
from sfmfromscratch_tpu.ops import sift as jsift
from sfmfromscratch_tpu.ops import smallsvd as jsvd
from sfmfromscratch_tpu.ops.pallas.harris_kernel import (
    harris_response_pallas,
    harris_response_pallas_tiled,
)
from sfmfromscratch_tpu.ops.pallas.match_kernel import match_top2_fused as jmatch_top2

from sfmfromscratch_tpu_torch.ops import harris as tharris
from sfmfromscratch_tpu_torch.ops import image as timage
from sfmfromscratch_tpu_torch.ops import lie as tlie
from sfmfromscratch_tpu_torch.ops import matcher as tmatcher
from sfmfromscratch_tpu_torch.ops import sift as tsift
from sfmfromscratch_tpu_torch.ops import smallsvd as tsvd
from sfmfromscratch_tpu_torch.ops.cuda import harris_kernel as HK
from sfmfromscratch_tpu_torch.ops.cuda import match_kernel as MK

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


def _img(hw, seed=0):
    """Smooth random texture in [0, 1], the kind of image Harris sees."""
    r = np.random.default_rng(seed)
    a = gaussian_filter(r.uniform(0, 1, hw), 1.5)
    a = (a - a.min()) / (a.max() - a.min())
    return a.astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _rootsift_like(r, n, d=128):
    """Non-negative unit-norm rows, as RootSIFT descriptors are."""
    a = r.uniform(0, 1, (n, d)).astype(np.float32) ** 2
    return np.sqrt(a / a.sum(-1, keepdims=True)).astype(np.float32)


# --- ops/image.py ---------------------------------------------------------

def test_image_ops_match_jax():
    r = np.random.default_rng(1)
    rgb = r.uniform(0, 1, (40, 52, 3)).astype(np.float32)
    # Elementwise weights: exact up to float32 rounding of the same products.
    np.testing.assert_allclose(_np(timage.rgb_to_gray(_t(rgb))),
                               _np(jimage.rgb_to_gray(jnp.asarray(rgb))), rtol=0, atol=1e-6)
    g = _img((40, 52), 1)
    for ks, sigma in ((7, 6.0), (5, 2.0)):
        # Same float32 taps from the same float64 linspace: 1 ulp.
        np.testing.assert_allclose(_np(timage.gaussian_kernel(ks, sigma)),
                                   _np(jimage.gaussian_kernel(ks, sigma)), rtol=1e-6, atol=0)
        k = jimage.gaussian_kernel(ks, sigma)
        # Zero-padded cross-correlation; sums in another order: 1e-6 of the range.
        np.testing.assert_allclose(_np(timage.conv2d_same(_t(g), _t(k))),
                                   _np(jimage.conv2d_same(jnp.asarray(g), k)), atol=1e-6)
    for a, b in zip(timage.sobel_gradients(_t(g)), jimage.sobel_gradients(jnp.asarray(g))):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


@pytest.mark.parametrize("out_hw", [(36, 47), (33, 43), (60, 80)])
def test_resize_bilinear_matches_jax(out_hw):
    """Antialiased downscale (and plain bilinear upscale), half-pixel centres:
    float32 agreement to 1e-5 on a [0, 1] image."""
    g = _img((40, 52), 2)
    got = _np(timage.resize_bilinear(_t(g), out_hw))
    ref = _np(jimage.resize_bilinear(jnp.asarray(g), out_hw))
    assert got.shape == ref.shape == out_hw
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_pyramid_matches_jax():
    g = _img((90, 120), 3)
    assert timage.pyramid_shapes((360, 480), 3, 1.1) == jimage.pyramid_shapes((360, 480), 3, 1.1) \
        == [(360, 480), (327, 436), (297, 396)]
    got = timage.build_pyramid(_t(g), 3, 1.1)
    ref = jimage.build_pyramid(jnp.asarray(g), 3, 1.1)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)   # two chained resizes


# --- ops/harris.py and the Harris kernel (K1, K2) -------------------------

@pytest.mark.parametrize("hw", [(96, 128), (200, 168)])
@pytest.mark.parametrize("G,sigma,alpha", [(7, 6.0, 0.05), (5, 2.0, 0.04)])
def test_harris_plain_matches_jax_and_pallas(hw, G, sigma, alpha):
    """The kernel's plain version (what the wrapper runs for CPU tensors)
    against the JAX reference and the Pallas kernels in interpret mode:
    max |diff| <= 1e-5 * max |R|, the tolerance the Pallas tests use."""
    img = _img(hw, 4)
    got = _np(HK.harris_response_fused(_t(img), G, sigma, alpha))
    assert np.array_equal(got, _np(tharris.harris_response(_t(img), G, sigma, alpha)))
    ref = _np(jharris.harris_response(jnp.asarray(img), G, sigma, alpha))
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    k1 = _np(harris_response_pallas(jnp.asarray(img), G, sigma, alpha, interpret=True))
    np.testing.assert_allclose(got, k1, rtol=0, atol=tol)
    if hw == (200, 168):   # the row-tiled kernel, with seams inside the image
        k2 = _np(harris_response_pallas_tiled(jnp.asarray(img), G, sigma, alpha,
                                              interpret=True, tile_rows=64))
        np.testing.assert_allclose(got, k2, rtol=0, atol=tol)


def test_harris_wrapper_batched_and_taps():
    imgs = np.stack([_img((48, 64), s) for s in range(3)])
    batched = _np(HK.harris_response_fused(_t(imgs), 7, 6.0, 0.05))
    for b in range(3):
        single = _np(HK.harris_response_fused(_t(imgs[b]), 7, 6.0, 0.05))
        np.testing.assert_allclose(batched[b], single, rtol=0, atol=1e-6 * np.abs(single).max())
    # Host taps as the Pallas kernel computes them (harris_kernel.py:95-98):
    # the outer product is the JAX package's normalised 2-D Gaussian.
    taps = HK.gaussian_taps(7, 6.0)
    assert taps.dtype == np.float32 and taps.shape == (7,)
    mean = 3
    axis = jnp.asarray(np.linspace(-mean, mean, 7), dtype=jnp.float32)
    e = jnp.exp(-(axis ** 2) / (2.0 * jnp.asarray(6.0, jnp.float32) ** 2))
    np.testing.assert_allclose(taps, _np(e / jnp.sum(e)), rtol=1e-6)
    np.testing.assert_allclose(np.outer(taps, taps), _np(jimage.gaussian_kernel(7, 6.0)), rtol=1e-5)


@pytest.mark.parametrize("G", [3, 5, 7, 31])
def test_harris_cached_taps_equal_gaussian_taps(G):
    """The wrapper's cached taps are ``gaussian_taps`` for each (G, sigma),
    computed once."""
    for sigma in (1.0, 6.0):
        taps, address = HK.cached_taps(G, sigma)
        np.testing.assert_array_equal(taps, HK.gaussian_taps(G, sigma))
        assert taps.dtype == np.float32 and taps.shape == (G,)
        assert address == taps.ctypes.data
        assert HK.cached_taps(G, sigma)[0] is taps


@pytest.mark.parametrize("G", [4, 8, 33])
def test_harris_launch_rejects_sizes_before_building(G, monkeypatch):
    """An even Gaussian size or one past 31 has no kernel instance: the
    launch raises before anything is built or loaded."""
    from sfmfromscratch_tpu_torch.ops.cuda import build

    def no_build(*args, **kwargs):
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build_all", no_build)
    # A fresh binding, not yet loaded: a launch would reach build.load.
    monkeypatch.setattr(HK, "_harris", build.bind("harris", "sfm_harris_response", []))
    with pytest.raises(ValueError, match="gaussian_size"):
        HK._launch(torch.zeros(1, 8, 8), G, 6.0, 0.05)
    with pytest.raises(ValueError, match="gaussian_size"):
        HK.cached_taps(G, 6.0)


def test_window_max_and_median_match_jax():
    r = np.random.default_rng(6)
    R = r.standard_normal((31, 40)).astype(np.float32)
    for ks in (3, 7):
        np.testing.assert_array_equal(_np(tharris._window_max(_t(R), ks)),
                                      _np(jharris._window_max(jnp.asarray(R), ks)))
    for shape in ((31, 40), (31, 41)):   # even and odd counts
        a = r.standard_normal(shape).astype(np.float32)
        assert float(tharris._median(_t(a))) == float(jnp.median(jnp.asarray(a)))


@pytest.mark.parametrize("hw,k", [((96, 128), 150), ((120, 90), 400)])
def test_detect_harris_keypoints_matches_jax(hw, k):
    """Same keypoints, in the same order: response maps agree to ~1e-7 of
    their range, so at most 1% of the selected set may differ (a tie at the
    capacity cut or a near-equal neighbour in the NMS window)."""
    img = _img(hw, 7)
    kw = dict(k=k, feature_width=16, nms_ksize=3, gaussian_size=7, sigma=6.0, alpha=0.05)
    got = tharris.detect_harris_keypoints(_t(img), **kw)
    ref = jharris.detect_harris_keypoints(jnp.asarray(img), **kw)
    gm, rm = _np(got.mask), _np(ref.mask)
    gs = {(int(x), int(y)) for x, y, m in zip(_np(got.x), _np(got.y), gm) if m}
    rs = {(int(x), int(y)) for x, y, m in zip(_np(ref.x), _np(ref.y), rm) if m}
    assert len(gs) > 20
    assert len(gs ^ rs) <= 0.01 * len(gs | rs)
    same = (_np(got.x) == _np(ref.x)) & (_np(got.y) == _np(ref.y)) & gm & rm
    assert same.sum() >= 0.98 * rm.sum()
    np.testing.assert_allclose(_np(got.xf)[same], _np(ref.xf)[same], atol=1e-3)
    np.testing.assert_allclose(_np(got.yf)[same], _np(ref.yf)[same], atol=1e-3)
    np.testing.assert_allclose(_np(got.score)[same], _np(ref.score)[same],
                               rtol=1e-4, atol=1e-6 * np.abs(_np(ref.score)).max())
    assert got.x.dtype == torch.int32 and got.mask.dtype == torch.bool


# --- ops/sift.py ------------------------------------------------------------

@pytest.mark.parametrize("fw", [18, 14])
def test_sift_descriptors_match_jax(fw):
    """RootSIFT on the same keypoints. ``arctan2`` and the bin ``floor`` can
    land one ulp apart between XLA and torch, which moves a pixel to the next
    orientation bin (and rarely flips a dominant orientation), so the
    tolerance is a share: at least 97% of the rows agree to 1e-4, and every
    row keeps a cosine similarity above 0.9 with the JAX row."""
    img = _img((96, 128), 8)
    r = np.random.default_rng(9)
    K = 200
    x = r.integers(0, 128, K).astype(np.int32)
    y = r.integers(0, 96, K).astype(np.int32)
    mask = r.uniform(size=K) > 0.1
    got = _np(tsift.sift_descriptors(_t(img), _t(x), _t(y), _t(mask), feature_width=fw))
    ref = _np(jsift.sift_descriptors(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(mask), feature_width=fw))
    assert got.shape == ref.shape == (K, 128)
    assert np.all(got[~mask] == 0)
    close = np.all(np.abs(got - ref) <= 1e-4, axis=1)
    assert close.mean() >= 0.97, close.mean()
    cos = (got * ref).sum(1) / np.maximum(np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1), 1e-12)
    assert np.all(cos[mask] > 0.9), cos[mask].min()


def test_sift_patch_gather_clamps_like_dynamic_slice():
    """Keypoints near and past the border: the port's gather wraps a negative
    start once and clamps every start, as ``lax.dynamic_slice`` does."""
    r = np.random.default_rng(10)
    field = r.standard_normal((30, 40)).astype(np.float32)
    x = np.array([0, 39, 5, -60, 200, -200], np.int32)
    y = np.array([0, 29, 80, -50, 3, -7], np.int32)
    got = _np(tsift._extract_patches(_t(field), _t(x), _t(y), 18))
    ref = _np(jsift._extract_patches(jnp.asarray(field), jnp.asarray(x), jnp.asarray(y), 18))
    np.testing.assert_array_equal(got, ref)


# --- ops/matcher.py and the matcher kernel (K3) ----------------------------

def test_pairwise_sq_dists_matches_jax():
    r = np.random.default_rng(11)
    a, b = _rootsift_like(r, 50), _rootsift_like(r, 70)
    np.testing.assert_allclose(_np(tmatcher.pairwise_sq_dists(_t(a), _t(b))),
                               _np(jmatcher.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)


@pytest.mark.parametrize("n1,n2,masked", [(40, 300, False), (40, 300, True), (24, 6144, True)])
def test_match_top2_plain_matches_pallas(n1, n2, masked):
    """The matcher kernel's plain version against the Pallas kernel in
    interpret mode: n2 = 6144 crosses the 4096 single-shot gate into the
    running merge over three tiles of 2048. (A ragged last tile is compared
    with numpy below: in interpret mode the Pallas kernel's out-of-range
    ``pl.ds`` is clamped back inside the block, so its ragged tile rereads
    earlier rows.) Squared distances agree to 1e-5 absolute (they lie in
    [0, 4]); indices agree exactly."""
    r = np.random.default_rng(12)
    d1, d2 = _rootsift_like(r, n1), _rootsift_like(r, n2)
    mask2 = (r.uniform(size=n2) > 0.3) if masked else None
    got = MK.match_top2_fused(_t(d1), _t(d2), None if mask2 is None else _t(mask2))
    ref = jmatch_top2(jnp.asarray(d1), jnp.asarray(d2),
                      None if mask2 is None else jnp.asarray(mask2), interpret=True)
    np.testing.assert_allclose(_np(got[0]), _np(ref[0]), atol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), atol=1e-5)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))
    assert got[2].dtype == torch.int32
    if masked:
        assert np.all(mask2[_np(got[2])])


def test_match_top2_ragged_database_matches_numpy():
    """n2 = 4500: two full tiles of 2048 and a ragged one, with a mask,
    against an exact float64 numpy reference (1e-5 absolute on squared
    distances; indices exact)."""
    r = np.random.default_rng(19)
    d1, d2 = _rootsift_like(r, 24), _rootsift_like(r, 4500)
    mask2 = r.uniform(size=4500) > 0.3
    got = MK.match_top2_fused(_t(d1), _t(d2), _t(mask2))
    sq = ((d1[:, None, :].astype(np.float64) - d2[None].astype(np.float64)) ** 2).sum(-1)
    sq[:, ~mask2] = np.inf
    srt = np.sort(sq, axis=1)
    np.testing.assert_allclose(_np(got[0]), srt[:, 0], atol=1e-5)
    np.testing.assert_allclose(_np(got[1]), srt[:, 1], atol=1e-5)
    np.testing.assert_array_equal(_np(got[2]), np.argmin(sq, axis=1))


def test_match_top2_ties_go_to_lowest_index():
    """Duplicated database rows tie exactly: the nearest index is the lowest
    of the tied rows (jnp.argmin semantics, in the single-shot and in the
    tiled Pallas paths), and the second distance equals the first."""
    r = np.random.default_rng(13)
    n2 = 6144
    d2 = _rootsift_like(r, n2)
    q = np.array([5, 100, 2100, 4400, 6000])
    d2[q + 3] = d2[q]               # same tile
    d2[(q + 2048) % n2] = d2[q]     # another tile of the running merge
    d1 = d2[q].copy()
    got = MK.match_top2_fused(_t(d1), _t(d2))
    np.testing.assert_array_equal(_np(got[2]), np.minimum(q, (q + 2048) % n2))
    np.testing.assert_array_equal(_np(got[0]), _np(got[1]))
    ref = jmatch_top2(jnp.asarray(d1), jnp.asarray(d2), interpret=True)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))
    ref_small = jmatch_top2(jnp.asarray(d1[:2]), jnp.asarray(d2[:200]), interpret=True)
    got_small = MK.match_top2_fused(_t(d1[:2]), _t(d2[:200]))
    np.testing.assert_array_equal(_np(got_small[2]), _np(ref_small[2]))


def test_match_top2_batched_wrapper():
    r = np.random.default_rng(14)
    d1 = np.stack([_rootsift_like(r, 30) for _ in range(3)])
    d2 = np.stack([_rootsift_like(r, 45) for _ in range(3)])
    m2 = r.uniform(size=(3, 45)) > 0.2
    b1, b2, bi = MK.match_top2_fused(_t(d1), _t(d2), _t(m2))
    for b in range(3):
        s1, s2, si = MK.match_top2_fused(_t(d1[b]), _t(d2[b]), _t(m2[b]))
        np.testing.assert_allclose(_np(b1[b]), _np(s1), atol=1e-6)
        np.testing.assert_allclose(_np(b2[b]), _np(s2), atol=1e-6)
        np.testing.assert_array_equal(_np(bi[b]), _np(si))


@pytest.mark.parametrize("n2", [300, 4096])
@pytest.mark.parametrize("masked", [False, True])
def test_match_top2_bf16_plain_matches_pallas(n2, masked):
    """The bf16 mode (``bf16=True``: bfloat16 multiplicands, float32 sums)
    on the CPU against the Pallas kernel's bf16 mode in interpret mode, at
    n1 = 40 (n2 <= 4096: the single-shot path, clear of the interpret-mode
    ragged-tile reread). Products of two bfloat16 values are exact in
    float32, so only the order of the sums differs: squared distances agree
    to 1e-5 absolute and indices exactly."""
    r = np.random.default_rng(31)
    d1, d2 = _rootsift_like(r, 40), _rootsift_like(r, n2)
    mask2 = (r.uniform(size=n2) > 0.3) if masked else None
    got = MK.match_top2_fused(_t(d1), _t(d2), None if mask2 is None else _t(mask2), bf16=True)
    ref = jmatch_top2(jnp.asarray(d1), jnp.asarray(d2),
                      None if mask2 is None else jnp.asarray(mask2), interpret=True, bf16=True)
    np.testing.assert_allclose(_np(got[0]), _np(ref[0]), atol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(ref[1]), atol=1e-5)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))
    # The rounding is real: the f32 mode gives other distances.
    f32 = MK.match_top2_fused(_t(d1), _t(d2), None if mask2 is None else _t(mask2))
    assert np.abs(_np(f32[0]) - _np(got[0])).max() > 1e-6


def test_match_top2_ties_go_to_lowest_index_bf16():
    """The tie test above in the bf16 mode: rows equal in float32 are equal
    after rounding, so the nearest index is the lowest duplicate and the
    second distance equals the first, as in the Pallas bf16 mode (tiled
    path, n2 = 6144)."""
    r = np.random.default_rng(13)
    n2 = 6144
    d2 = _rootsift_like(r, n2)
    q = np.array([5, 100, 2100, 4400, 6000])
    d2[q + 3] = d2[q]
    d2[(q + 2048) % n2] = d2[q]
    d1 = d2[q].copy()
    got = MK.match_top2_fused(_t(d1), _t(d2), bf16=True)
    np.testing.assert_array_equal(_np(got[2]), np.minimum(q, (q + 2048) % n2))
    np.testing.assert_array_equal(_np(got[0]), _np(got[1]))
    ref = jmatch_top2(jnp.asarray(d1), jnp.asarray(d2), interpret=True, bf16=True)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))


def test_match_top2_batched_wrapper_bf16():
    """A (B, n, D) batch in the bf16 mode equals its pairs one by one."""
    r = np.random.default_rng(14)
    d1 = np.stack([_rootsift_like(r, 30) for _ in range(3)])
    d2 = np.stack([_rootsift_like(r, 45) for _ in range(3)])
    m2 = r.uniform(size=(3, 45)) > 0.2
    b1, b2, bi = MK.match_top2_fused(_t(d1), _t(d2), _t(m2), bf16=True)
    for b in range(3):
        s1, s2, si = MK.match_top2_fused(_t(d1[b]), _t(d2[b]), _t(m2[b]), bf16=True)
        np.testing.assert_allclose(_np(b1[b]), _np(s1), atol=1e-6)
        np.testing.assert_allclose(_np(b2[b]), _np(s2), atol=1e-6)
        np.testing.assert_array_equal(_np(bi[b]), _np(si))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_match_ratio_test_matches_jax(use_pallas, monkeypatch):
    """The whole ratio test, against the JAX XLA path and its Pallas path
    (interpret mode): the same accepted (query, nearest) pairs in the same
    best-first order, confidences to 1e-5."""
    r = np.random.default_rng(15)
    d2 = _rootsift_like(r, 150)
    d1 = np.concatenate([d2[:90] + 0.02 * r.standard_normal((90, 128)).astype(np.float32),
                         _rootsift_like(r, 30)])
    m1 = r.uniform(size=120) > 0.1
    m2 = r.uniform(size=150) > 0.1
    kw = dict(ratio_threshold=0.85, max_matches=100)
    got = tmatcher.match_ratio_test(_t(d1), _t(d2), _t(m1), _t(m2), **kw)
    if use_pallas:
        import functools
        from sfmfromscratch_tpu.ops.pallas import match_kernel as jMK
        monkeypatch.setattr(jMK, "match_top2_fused",
                            functools.partial(jMK.match_top2_fused, interpret=True))
        ref = jmatcher.match_ratio_test.__wrapped__(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
            use_pallas=True, **kw)
    else:
        ref = jmatcher.match_ratio_test(jnp.asarray(d1), jnp.asarray(d2),
                                        jnp.asarray(m1), jnp.asarray(m2), **kw)
    n = int(_np(ref.mask).sum())
    assert n > 40 and int(_np(got.mask).sum()) == n
    np.testing.assert_array_equal(_np(got.indices)[:n], _np(ref.indices)[:n])
    np.testing.assert_allclose(_np(got.confidence), _np(ref.confidence), atol=1e-5)
    assert np.all(_np(got.indices)[n:] == 0)
    assert got.indices.dtype == torch.int32 and got.indices.shape == (100, 2)


# --- ops/smallsvd.py --------------------------------------------------------

def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    np.testing.assert_allclose(a, s * b, atol=atol)


@pytest.mark.parametrize("m,n", [(8, 9), (4, 4), (40, 9)])
def test_nullvec_lstsq_matches_jax(m, n):
    """Minimal (QR), square (SVD) and overdetermined (QR then SVD) systems:
    the same unit null vector up to sign, to 1e-4 (float32 factorizations
    by different LAPACK paths)."""
    r = np.random.default_rng(16)
    A = r.standard_normal((64, m, n)).astype(np.float32)
    got = _np(tsvd.nullvec_lstsq(_t(A)))
    ref = _np(jsvd.nullvec_lstsq(jnp.asarray(A)))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    if m < n:   # exact null space: residual at float32 rounding
        assert np.abs(np.einsum("bmn,bn->bm", A, got)).max() < 1e-4
    _same_up_to_sign(got, ref, atol=1e-4 if m <= n else 1e-3)


def test_project_rank2_and_decompose_essential_match_jax():
    r = np.random.default_rng(17)
    F = r.standard_normal((32, 3, 3)).astype(np.float32)
    got = _np(tsvd.project_rank2(_t(F)))
    np.testing.assert_allclose(got, _np(jsvd.project_rank2(jnp.asarray(F))), atol=1e-5)
    assert np.abs(np.linalg.det(got)).max() < 1e-4
    # Essential matrices E = [t]x R; the rotation candidates form the same
    # set in both packages (singular-vector signs are arbitrary).
    R = _np(tlie.so3_exp(_t(r.normal(0, 0.4, (32, 3)).astype(np.float32))))
    t = r.standard_normal((32, 3)).astype(np.float32)
    E = (_np(tlie.so3_hat(_t(t))) @ R).astype(np.float32)
    R1, R2, tt = (_np(x) for x in tsvd.decompose_essential(_t(E)))
    J1, J2, jt = (_np(x) for x in jsvd.decompose_essential(jnp.asarray(E)))
    for i in range(32):
        for Rg in (R1[i], R2[i]):
            np.testing.assert_allclose(Rg @ Rg.T, np.eye(3), atol=1e-5)
            assert abs(np.linalg.det(Rg) - 1.0) < 1e-5
            assert min(np.abs(Rg - J1[i]).max(), np.abs(Rg - J2[i]).max()) < 1e-4
        assert min(np.abs(R1[i] - R[i]).max(), np.abs(R2[i] - R[i]).max()) < 1e-4
    _same_up_to_sign(tt, jt, atol=1e-5)


# --- ops/lie.py -------------------------------------------------------------

def test_so3_matches_jax():
    """Rodrigues and its inverse, including the small-angle branch and the
    near-pi axis extraction: float32 agreement to 1e-5."""
    r = np.random.default_rng(18)
    w = r.normal(0, 1.0, (64, 3)).astype(np.float32)
    w[:4] *= 1e-6                                          # Taylor branch
    axes = r.standard_normal((6, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w[4:10] = (axes * (np.pi - 2e-4)).astype(np.float32)   # near pi
    np.testing.assert_allclose(_np(tlie.so3_hat(_t(w))), _np(jlie.so3_hat(jnp.asarray(w))), atol=0)
    Rt = _np(tlie.so3_exp(_t(w)))
    Rj = _np(jlie.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    wt, wj = _np(tlie.so3_log(_t(Rj))), _np(jlie.so3_log(jnp.asarray(Rj)))
    np.testing.assert_allclose(wt[:4], wj[:4], atol=1e-6)
    np.testing.assert_allclose(wt[10:], wj[10:], atol=1e-5)
    # Near pi, theta = arccos((trace - 1) / 2) has slope 1 / sin(theta) ~ 5e3
    # here, so one ulp of difference between the two arccos implementations
    # moves theta (and the axis from sqrt of the diagonal) by ~3e-4.
    np.testing.assert_allclose(wt[4:10], wj[4:10], atol=2e-3)
    inside = np.linalg.norm(w, axis=1) < 3.0   # log returns angles in [0, pi]
    inside[:10] = False
    np.testing.assert_allclose(wt[inside], w[inside], atol=1e-4)
    assert tlie.so3_exp(_t(w[:2].reshape(2, 1, 3))).shape == (2, 1, 3, 3)


def test_small_3x3_closed_forms_match_jax():
    """Adjugate inverse, closed-form Cholesky, SPD solve and SPD inverse of
    well-conditioned SPD matrices (and the adjugate of general ones): 1e-5
    relative to each result's scale."""
    r = np.random.default_rng(19)
    A = r.standard_normal((64, 3, 3)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    g = r.standard_normal((64, 3)).astype(np.float32)
    for name, args in (("inv3", (A,)), ("inv3", (M,)), ("chol3", (M,)),
                       ("solve3_spd", (M, g)), ("inv3_spd", (M,))):
        got = _np(getattr(tsvd, name)(*(_t(a) for a in args)))
        ref = _np(getattr(jsvd, name)(*(jnp.asarray(a) for a in args)))
        scale = np.abs(ref).reshape(64, -1).max(-1).reshape((64,) + (1,) * (ref.ndim - 1))
        np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(_np(tsvd.inv3_spd(_t(M))) @ M, np.broadcast_to(np.eye(3), M.shape),
                               atol=1e-4)
    L = _np(tsvd.chol3(_t(M), eps=0.1))
    np.testing.assert_allclose(L @ L.transpose(0, 2, 1), M + 0.1 * np.eye(3), rtol=1e-5, atol=1e-5)


# --- pipeline/frontend.py: the engine's batched frontend -------------------

def test_preprocess_image_batch_matches_jax():
    """uint8 stacks: grayscale input converts bit-identically
    (``x * float32(1/255)`` on both sides); RGB goes through the weighted sum
    (1e-6, as ``rgb_to_gray``) and a 0.5 rescale through the antialiased
    resize (1e-5, as ``resize_bilinear``)."""
    from sfmfromscratch_tpu.pipeline import frontend as jfrontend
    from sfmfromscratch_tpu_torch.pipeline import frontend as tfrontend

    r = np.random.default_rng(41)
    gray = r.integers(0, 256, (3, 40, 52), dtype=np.uint8)
    rgb = r.integers(0, 256, (3, 40, 52, 3), dtype=np.uint8)
    got = _np(tfrontend.preprocess_image_batch(_t(gray), 1.0))
    ref = _np(jfrontend.preprocess_image_batch(jnp.asarray(gray), 1.0))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    for imgs, sf, atol in ((rgb, 1.0, 1e-6), (rgb, 0.5, 1e-5), (gray, 0.5, 1e-5)):
        got = _np(tfrontend.preprocess_image_batch(_t(imgs), sf))
        ref = _np(jfrontend.preprocess_image_batch(jnp.asarray(imgs), sf))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=atol)


def test_extract_features_batch_matches_jax():
    """Three small images as one batch (one Harris launch per level on the
    card): the same keypoints per image as the JAX batch, and the same
    features as the port's single-image extraction; descriptors of shared
    keypoints within 1e-4 on at least 97% of the rows (the ulp orientation
    bins of ``test_sift_descriptors_match_jax``)."""
    from sfmfromscratch_tpu import config as jconfig
    from sfmfromscratch_tpu.pipeline import frontend as jfrontend
    from sfmfromscratch_tpu_torch import config as tconfig
    from sfmfromscratch_tpu_torch.pipeline import frontend as tfrontend

    kw = dict(num_interest_points=200, ksize=3, gaussian_size=7, sigma=3.0, alpha=0.05,
              feature_width=16, pyramid_level=2, pyramid_scale_factor=1.2)
    imgs = np.stack([_img((80, 104), s) for s in (42, 43, 44)])
    got = tfrontend.extract_features_batch(_t(imgs), tconfig.ExtractorConfig(**kw))
    ref = jfrontend.extract_features_batch(jnp.asarray(imgs), jconfig.ExtractorConfig(**kw),
                                           serial=True)
    assert got.descriptors.shape == ref.descriptors.shape == (3, 200, 128)
    for b in range(3):
        gk, rk = got.keypoints, ref.keypoints
        same = ((_np(gk.x[b]) == _np(rk.x[b])) & (_np(gk.y[b]) == _np(rk.y[b]))
                & _np(gk.mask[b]) & _np(rk.mask[b]))
        np.testing.assert_array_equal(_np(gk.mask[b]), _np(rk.mask[b]))
        assert same.sum() == _np(rk.mask[b]).sum() > 50
        close = np.all(np.abs(_np(got.descriptors[b]) - _np(ref.descriptors[b])) <= 1e-4, axis=1)
        assert close[same].mean() >= 0.97, close[same].mean()
        one = tfrontend.extract_features(_t(imgs[b]), tconfig.ExtractorConfig(**kw))
        np.testing.assert_array_equal(_np(one.keypoints.x), _np(gk.x[b]))
        np.testing.assert_allclose(_np(one.descriptors), _np(got.descriptors[b]), atol=1e-6)
    with pytest.raises(ValueError):
        tfrontend.extract_features_batch(_t(imgs[0]), tconfig.ExtractorConfig(**kw))


def test_match_pairs_batch_matches_jax(monkeypatch):
    """Three pairs of four images in one call, JAX through its Pallas
    matcher in interpret mode: identical match indices and masks, and the
    gathered subpixel coordinates equal."""
    import functools

    from sfmfromscratch_tpu.ops.pallas import match_kernel as jMK

    monkeypatch.setattr(jMK, "match_top2_fused",
                        functools.partial(jMK.match_top2_fused, interpret=True))
    r = np.random.default_rng(45)
    C, Kc = 4, 120
    base = _rootsift_like(r, Kc)
    desc = np.stack([np.sqrt(np.abs(base ** 2 + r.normal(0, 0.002 * (c + 1), base.shape)))
                     for c in range(C)]).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    kp_mask = r.uniform(size=(C, Kc)) > 0.1
    xf = r.uniform(0, 200, (C, Kc)).astype(np.float32)
    yf = r.uniform(0, 150, (C, Kc)).astype(np.float32)
    pi, pj = np.array([0, 1, 2], np.int32), np.array([1, 2, 3], np.int32)
    kw = dict(ratio_threshold=0.85, max_matches=100)
    res_t, p1_t, p2_t = tmatcher.match_pairs_batch(_t(desc), _t(kp_mask), _t(xf), _t(yf),
                                                   _t(pi), _t(pj), **kw)
    res_j, p1_j, p2_j = jmatcher.match_pairs_batch(
        jnp.asarray(desc), jnp.asarray(kp_mask), jnp.asarray(xf), jnp.asarray(yf),
        jnp.asarray(pi), jnp.asarray(pj), use_pallas=True, **kw)
    np.testing.assert_array_equal(_np(res_t.mask), _np(res_j.mask))
    np.testing.assert_array_equal(_np(res_t.indices), _np(res_j.indices))
    assert _np(res_t.mask).sum(-1).min() > 20
    np.testing.assert_array_equal(_np(p1_t), _np(p1_j))
    np.testing.assert_array_equal(_np(p2_t), _np(p2_j))
    np.testing.assert_allclose(_np(res_t.confidence), _np(res_j.confidence), atol=1e-5)
