"""How the Sobel gradients' rounding residues move the 20-degree pair gate.

On the wide-baseline planes scene (``tests/test_wide_baseline.py:12-16``, 12
views at 10-degree steps) every pair of views two apart, ``(i, i + 2)`` for
i = 0..9, goes through ``FeatureRunner`` at the test's extractor; each pair's
match count and median epipolar distance are printed, with how many pairs
reach the test's 1.5 px limit (``tests/test_wide_baseline.py:45`` holds the
first pair). The Sobel gradients that SIFT reads are, by ``--variant``:

* ``jax``: the JAX package as it is (XLA's convolution);
* ``jax_zeros``: the JAX package with its gradients set to +0 where the
  image is flat along the derivative's axis;
* ``port``: the port as it is (JAX's residues where the image is flat
  along the derivative's axis, torch's convolution elsewhere:
  ``sfmfromscratch_tpu_torch/ops/sift.py::sobel_jax_residues``);
* ``port_conv``: the port with torch's convolution alone;
* ``port_zeros``: the port with its gradients set to +0 where the image is
  flat along the derivative's axis.

Each variant is one process on the CPU, about 2 min:

    JAX_PLATFORMS=cpu python tools/sobel_residue_pairs.py --variant jax
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402  (the scene and the scenario calls)

VARIANTS = ("jax", "jax_zeros", "port", "port_conv", "port_zeros")


def jax_exact_zeros(sobel):
    """The JAX package's ``sobel`` with its gradients set to +0 where the
    image (H, W or a stack) is flat along the derivative's axis: each of the
    three pixel pairs that the Sobel differences is equal."""
    import jax.numpy as jnp

    def exact_zeros(image):
        Ix, Iy = sobel(image)
        pad = [(0, 0)] * (image.ndim - 2) + [(1, 1), (1, 1)]
        p = jnp.pad(image, pad)
        eq_x, eq_y = p[..., :, 2:] == p[..., :, :-2], p[..., 2:, :] == p[..., :-2, :]
        return (jnp.where(eq_x[..., :-2, :] & eq_x[..., 1:-1, :] & eq_x[..., 2:, :], 0.0, Ix),
                jnp.where(eq_y[..., :, :-2] & eq_y[..., :, 1:-1] & eq_y[..., :, 2:], 0.0, Iy))

    return exact_zeros


def port_exact_zeros(sobel):
    """``jax_exact_zeros`` for the port's ``sobel`` (torch tensors)."""
    import torch

    def exact_zeros(image):
        Ix, Iy = sobel(image)
        p = torch.nn.functional.pad(image, (1, 1, 1, 1))
        eq_x, eq_y = p[..., :, 2:] == p[..., :, :-2], p[..., 2:, :] == p[..., :-2, :]
        return (torch.where(eq_x[..., :-2, :] & eq_x[..., 1:-1, :] & eq_x[..., 2:, :], 0.0, Ix),
                torch.where(eq_y[..., :, :-2] & eq_y[..., :, 1:-1] & eq_y[..., :, 2:], 0.0, Iy))

    return exact_zeros


def variant_api(variant):
    """The scenario API of ``variant``'s package with its Sobel swapped in."""
    if variant.startswith("jax"):
        from tools.scenario_pins import jax_scenario_api

        api = jax_scenario_api()
        if variant == "jax_zeros":
            from sfmfromscratch_tpu.ops import sift as jsift

            jsift.sobel_gradients = jax_exact_zeros(jsift.sobel_gradients)
        return api
    import torch

    from sfmfromscratch_tpu_torch.ops import sift
    from sfmfromscratch_tpu_torch.ops.image import sobel_gradients

    if variant == "port_conv":
        sift.sobel_jax_residues = sobel_gradients
    elif variant == "port_zeros":
        sift.sobel_jax_residues = port_exact_zeros(sift.sobel_jax_residues)
    return chip_smoke.port_scenario_api(torch.device("cpu"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=VARIANTS, default="port")
    args = ap.parse_args()
    api = variant_api(args.variant)
    images, _, _, _ = chip_smoke._render_module().render_planes(
        np.random.default_rng(0), num_views=12, orbit_step_deg=10.0)
    pairs = []
    for i in range(10):
        fr = api.feature_runner(images[i], images[i + 2], chip_smoke._wide_extractor(api),
                                scale_factor=1.0)
        p1, p2, m = api.matches_to_coords(fr.matches, fr.features1, fr.features2, 600)
        F = api.eight_point_fundamental(api.asarray(api.host(p1)), api.asarray(api.host(p2)),
                                        mask=m)
        dist = api.host(api.epipolar_distances(F, p1, p2))
        pairs.append(dict(views=[i, i + 2], matches=int(api.host(fr.matches.mask).sum()),
                          median_epipolar_px=float(np.median(dist[api.host(m).astype(bool)]))))
    meds = [p["median_epipolar_px"] for p in pairs]
    print(json.dumps(dict(variant=args.variant, pairs=pairs,
                          pairs_at_or_over_1p5_px=sum(v >= 1.5 for v in meds),
                          median_of_medians=float(np.median(meds)))), flush=True)


if __name__ == "__main__":
    main()
