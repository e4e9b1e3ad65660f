"""ctypes bindings of the native host components (counterpart of
``sfmfromscratch_tpu/native/bindings.py``), with their plain numpy versions.

``build_tracks`` (union-find over match edges, ``trackgraph.cpp``) and
``resize_gray`` (fused uint8 resize and grayscale, ``preprocess.cpp``) call
the C++ libraries that ``native/build.py`` builds at first use. A failed
build raises with the compiler's output: the calls never fall back quietly.
``build_tracks_plain`` and ``resize_gray_plain`` are the numpy versions the
JAX package falls back to; they give the same track ids and pixels to
float32 rounding. ``resize_gray`` takes the numpy path for input that is not
uint8, as the JAX package does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from sfmfromscratch_tpu_torch.native import build

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)


def _lib(name: str) -> ctypes.CDLL:
    """The library ``name`` (built at first use), its C signatures set."""
    lib = build.load(name)
    if name == "sfmtrack":
        lib.build_tracks.argtypes = [_i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p]
        lib.build_tracks.restype = ctypes.c_int64
        lib.filter_duplicate_image_tracks.argtypes = [_i64p, _i64p, ctypes.c_int64,
                                                      ctypes.c_int64, _i64p, _i64p]
        lib.filter_duplicate_image_tracks.restype = None
    else:
        for fn in (lib.resize_gray_u8, lib.resize_gray1_u8):
            fn.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _f32p, ctypes.c_int, ctypes.c_int]
            fn.restype = None
    return lib


def native_available() -> bool:
    """True when both libraries build and load."""
    try:
        _lib("sfmpre")
        _lib("sfmtrack")
    except (RuntimeError, OSError):
        return False
    return True


# ----------------------------------------------------------------- preprocess

def resize_gray(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 RGB or gray image -> resized float32 [0, 1] grayscale in one
    native pass: bilinear with half-pixel centres, OpenCV's gray weights.
    Other input takes ``resize_gray_plain``."""
    oh, ow = out_hw
    rgb = img.ndim == 3 and img.shape[2] == 3
    if img.dtype != np.uint8 or not (rgb or img.ndim == 2):
        return resize_gray_plain(img, out_hw)
    lib = _lib("sfmpre")
    img = np.ascontiguousarray(img)
    out = np.empty((oh, ow), dtype=np.float32)
    fn = lib.resize_gray_u8 if rgb else lib.resize_gray1_u8
    fn(img.ctypes.data_as(_u8p), img.shape[0], img.shape[1], out.ctypes.data_as(_f32p), oh, ow)
    return out


def resize_gray_plain(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """numpy ``resize_gray`` (the same convention)."""
    f = img.astype(np.float32)
    if f.ndim == 3:
        f = f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114
    if img.dtype == np.uint8:
        f = f / 255.0
    h, w = f.shape
    oh, ow = out_hw
    fy = (np.arange(oh) + 0.5) * (h / oh) - 0.5
    fx = (np.arange(ow) + 0.5) * (w / ow) - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(fy - y0, 0, 1)[:, None]
    wx = np.clip(fx - x0, 0, 1)[None, :]
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


# ----------------------------------------------------------------- trackgraph

def build_tracks(
    edges_a: np.ndarray, edges_b: np.ndarray, num_nodes: int,
    node_image: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """Connected-component track ids from match edges (union-find in C++).

    Nodes are (image, keypoint) slots flattened image-major. Returns
    (track_id_per_node, num_tracks, track_valid_or_None). Track ids are
    numbered in the order of each component's first node. When
    ``node_image`` is given (image id per node, image-major ordered), tracks
    observed twice in one image are flagged invalid, the standard
    track-consistency rule.
    """
    lib = _lib("sfmtrack")
    ea = np.ascontiguousarray(edges_a, dtype=np.int64)
    eb = np.ascontiguousarray(edges_b, dtype=np.int64)
    n = int(num_nodes)
    parent = np.empty(n, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    num_tracks = int(lib.build_tracks(ea.ctypes.data_as(_i64p), eb.ctypes.data_as(_i64p),
                                      len(ea), n, parent.ctypes.data_as(_i64p),
                                      out.ctypes.data_as(_i64p)))
    valid = None
    if node_image is not None:
        ni = np.ascontiguousarray(node_image, dtype=np.int64)
        valid = np.empty(num_tracks, dtype=np.int64)
        scratch = np.empty(num_tracks, dtype=np.int64)
        lib.filter_duplicate_image_tracks(ni.ctypes.data_as(_i64p), out.ctypes.data_as(_i64p), n,
                                          num_tracks, valid.ctypes.data_as(_i64p),
                                          scratch.ctypes.data_as(_i64p))
        valid = valid.astype(bool)
    return out, num_tracks, valid


def build_tracks_plain(
    edges_a: np.ndarray, edges_b: np.ndarray, num_nodes: int,
    node_image: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """numpy ``build_tracks``: the same partition and track ids."""
    ea = np.ascontiguousarray(edges_a, dtype=np.int64)
    eb = np.ascontiguousarray(edges_b, dtype=np.int64)
    n = int(num_nodes)
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in zip(ea, eb):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    out = np.full(n, -1, dtype=np.int64)
    num_tracks = 0
    root_id = {}
    for i in range(n):
        r = find(i)
        if r not in root_id:
            root_id[r] = num_tracks
            num_tracks += 1
        out[i] = root_id[r]
    valid = None
    if node_image is not None:
        valid = np.ones(num_tracks, dtype=bool)
        last_img = np.full(num_tracks, -1, dtype=np.int64)
        for i in range(n):
            t = out[i]
            if last_img[t] == node_image[i]:
                valid[t] = False
            else:
                last_img[t] = node_image[i]
    return out, num_tracks, valid
