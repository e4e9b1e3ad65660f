"""Union-find track building over match edges: the port's own copy of the
numpy path of ``sfmfromscratch_tpu/native/bindings.py::build_tracks``.

The JAX package also loads a C++ union-find (``native/trackgraph.cpp``)
through ctypes when it can build it; the port does not load it yet. Both give
the same partition of nodes into tracks (track ids may be numbered
differently).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def build_tracks(
    edges_a: np.ndarray, edges_b: np.ndarray, num_nodes: int,
    node_image: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """Connected-component track ids from match edges (union-find).

    Nodes are (image, keypoint) slots flattened image-major. Returns
    (track_id_per_node, num_tracks, track_valid_or_None). When ``node_image``
    is given (image id per node, image-major ordered), tracks observed twice
    in one image are flagged invalid, the standard track-consistency rule.
    """
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
