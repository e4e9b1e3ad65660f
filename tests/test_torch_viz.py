"""The port's ``viz/`` (overlays and the 3-D viewer) and the CLI's ``show``
against the JAX package's, on the CPU.

The overlays are host code on numpy and PIL in both packages: on the same
inputs, made from a seed, their arrays are bit-equal. The viewer renders
headless (``show=False``, the Agg backend) to a PNG.
"""

import matplotlib

matplotlib.use("Agg", force=True)

import numpy as np
import pytest
import torch

from sfmfromscratch_tpu.viz import overlays as J
from sfmfromscratch_tpu_torch.viz import overlays as T

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once


@pytest.fixture
def imgs():
    r = np.random.default_rng(5)
    a = r.uniform(0, 1, (40, 60, 3)).astype(np.float32)
    b = r.uniform(0, 1, (50, 70, 3)).astype(np.float32)
    return a, b


def test_viz_names_match_jax():
    """Every public function of the JAX ``viz.overlays`` and the ``V3D``
    class have counterparts."""
    import sfmfromscratch_tpu.viz as jviz
    import sfmfromscratch_tpu_torch.viz as tviz

    public = {n for n in dir(J) if not n.startswith("_") and callable(getattr(J, n))
              and getattr(getattr(J, n), "__module__", "") == J.__name__}
    assert public == {"hstack_images", "show_interest_points", "show_correspondence_lines",
                      "show_correspondence_circles", "save_feature_figure", "save_match_figure"}
    assert all(callable(getattr(T, n)) for n in public)
    assert tviz.V3D.__name__ == jviz.V3D.__name__ == "V3D"


@pytest.mark.parametrize("gray", [False, True])
def test_hstack_matches_jax(imgs, gray):
    a, b = imgs
    if gray:
        a, b = a[..., 0], b[..., 1]
    np.testing.assert_array_equal(T.hstack_images(a, b), J.hstack_images(a, b))


@pytest.mark.parametrize("kind", ["points", "lines", "lines_colored", "circles"])
def test_overlays_bit_equal_to_jax(imgs, kind):
    """Each overlay on the same images and coordinates: the same array, bit
    for bit; the port also takes the coordinates as tensors."""
    a, b = imgs
    r = np.random.default_rng(8)
    X1, Y1 = r.integers(0, 60, 6), r.integers(0, 40, 6)
    X2, Y2 = r.integers(0, 70, 6), r.integers(0, 50, 6)
    tt = lambda v: torch.as_tensor(v)
    if kind == "points":
        got = T.show_interest_points(a, tt(X1), tt(Y1), radius=3, seed=2)
        ref = J.show_interest_points(a, X1, Y1, radius=3, seed=2)
    elif kind == "circles":
        got = T.show_correspondence_circles(a, b, tt(X1), Y1, X2, tt(Y2), radius=3)
        ref = J.show_correspondence_circles(a, b, X1, Y1, X2, Y2, radius=3)
    else:
        colors = r.uniform(0, 1, (6, 3)) if kind == "lines_colored" else None
        got = T.show_correspondence_lines(a, b, tt(X1), Y1, X2, Y2, line_colors=colors,
                                          width=2, radius=2)
        ref = J.show_correspondence_lines(a, b, X1, Y1, X2, Y2, line_colors=colors,
                                          width=2, radius=2)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got[:40, :60], a)   # something was drawn


def test_feature_and_match_figures(tmp_path):
    """``save_feature_figure`` and ``save_match_figure`` on the JAX package's
    FeatureRunner result, handed to the port as tensors
    (``interop.features_from_numpy``): the same files, byte for byte; the
    port's own FeatureRunner result renders too."""
    from sfmfromscratch_tpu.config import ExtractorConfig as JE, MatcherConfig as JM
    from sfmfromscratch_tpu.pipeline.frontend import FeatureRunner as JFR
    from sfmfromscratch_tpu_torch import interop
    from sfmfromscratch_tpu_torch.config import ExtractorConfig as TE, MatcherConfig as TM
    from sfmfromscratch_tpu_torch.pipeline.frontend import FeatureRunner as TFR

    r = np.random.default_rng(5)
    img = r.uniform(0, 0.3, (64, 80)).astype(np.float32)
    img[20:30, 30:40] += 0.6
    kw = dict(num_interest_points=40, ksize=3, pyramid_level=1, feature_width=16, sigma=3.0)
    jfr = JFR.run(img, img, JE(**kw), JM(ratio_threshold=0.99, max_matches=40), scale_factor=1.0)
    f1, f2 = (interop.features_from_numpy(f) for f in (jfr.features1, jfr.features2))
    m = interop.match_result_from_numpy(jfr.matches)
    T.save_feature_figure(str(tmp_path / "ft.png"), img, img, f1, f2)
    J.save_feature_figure(str(tmp_path / "fj.png"), img, img, jfr.features1, jfr.features2)
    T.save_match_figure(str(tmp_path / "mt.png"), torch.as_tensor(img), img, f1, f2, m)
    J.save_match_figure(str(tmp_path / "mj.png"), img, img, jfr.features1, jfr.features2,
                        jfr.matches)
    for name in ("f", "m"):
        assert (tmp_path / f"{name}t.png").read_bytes() == (tmp_path / f"{name}j.png").read_bytes()
    tfr = TFR.run(img, img, TE(**kw), TM(ratio_threshold=0.99, max_matches=40),
                  scale_factor=1.0, device="cpu")
    T.save_match_figure(str(tmp_path / "own.png"), img, img, tfr.features1, tfr.features2,
                        tfr.matches)
    assert (tmp_path / "own.png").stat().st_size > 0


def _model(tmp_path):
    """A saved model in the engines' npz layout: 30 points seen by 3 frames."""
    r = np.random.default_rng(3)
    frames = np.repeat(np.arange(3), 20)
    tracks = np.concatenate([np.arange(20), np.arange(5, 25), np.arange(10, 30)])
    np.savez(tmp_path / "m.npz", p3d=r.normal(size=(30, 3)), frame_idx=frames, pt_idx=tracks,
             obs_xy=r.uniform(0, 50, (60, 2)), poses=np.zeros((3, 6)), K=np.stack([np.eye(3)] * 3),
             errors_ba=np.array([1.0, 0.5]))
    return frames


def test_v3d_saves_png_headless(tmp_path):
    """``V3D`` with ``show=False`` draws one scatter per frame, as JAX's
    does, and ``save`` writes a PNG of the same size."""
    from PIL import Image

    from sfmfromscratch_tpu.viz.scatter3d import V3D as JV3D
    from sfmfromscratch_tpu_torch.viz.scatter3d import V3D as TV3D

    _model(tmp_path)
    with np.load(tmp_path / "m.npz") as z:
        args = (z["p3d"], z["frame_idx"], z["pt_idx"])
    tv, jv = TV3D(*args, show=False), JV3D(*args, show=False)
    assert len(tv.scatter_plot) == len(jv.scatter_plot) == 3
    tv.change_color()
    tv.save(str(tmp_path / "t.png"))
    jv.save(str(tmp_path / "j.png"))
    with Image.open(tmp_path / "t.png") as a, Image.open(tmp_path / "j.png") as b:
        assert a.size == b.size and a.size[0] > 100


def test_cli_show_save_png(tmp_path):
    """``cli.py show <model> --save-png`` renders the saved model headless in
    both packages: the same image size; ``SfmEngine.load`` returns the
    viewer by default."""
    from PIL import Image

    from sfmfromscratch_tpu.cli import main as jmain
    from sfmfromscratch_tpu_torch import cli as tcli
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine
    from sfmfromscratch_tpu_torch.viz.scatter3d import V3D

    _model(tmp_path)
    out = str(tmp_path)
    assert tcli.main(["show", "m", "--output-dir", out, "--save-png", str(tmp_path / "t.png")]) == 0
    assert jmain(["show", "m", "--output-dir", out, "--save-png", str(tmp_path / "j.png")]) == 0
    with Image.open(tmp_path / "t.png") as a, Image.open(tmp_path / "j.png") as b:
        assert a.size == b.size
    assert tcli.main(["show", "m", "--output-dir", out]) == 0
    assert isinstance(SfmEngine.load("m", out), V3D)


def test_viz_imports_no_matplotlib():
    """The port's viz modules import matplotlib only inside their functions,
    so they import on a machine without it."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys; import sfmfromscratch_tpu_torch.viz.overlays, "
            "sfmfromscratch_tpu_torch.viz.scatter3d, sfmfromscratch_tpu_torch.compat; "
            "print('MPL', 'matplotlib' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stderr
    assert "MPL False" in r.stdout
