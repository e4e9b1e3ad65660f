"""Command-line entry point of the port (counterpart of
``sfmfromscratch_tpu/cli.py``): the same subcommands, flags, defaults and
printed lines, and ``--device``, which runs the engines on the CUDA card
unless it says otherwise.

    python -m sfmfromscratch_tpu_torch.cli reconstruct test_data/tallneck2_mini \\
        --max-img 10 --sensor CROP_FRAME --model-name model
    python -m sfmfromscratch_tpu_torch.cli reconstruct seq --max-img 4 --device cpu
    python -m sfmfromscratch_tpu_torch.cli resize in_dir out_dir --ratio 0.3

Every ``reconstruct`` flag of the JAX CLI runs: ``--refine-focal`` on both
pipelines, and on ``--pipeline global`` ``--keyframe-step k|auto`` with
``--keyframe-flow-px``, ``--pair-mode retrieval|both`` with
``--retrieval-k``, and ``--stream-ba-window`` with
``--stream-ba-block-cams``. ``show`` opens the 3-D viewer (``viz/``) on a
saved model, or with ``--save-png`` renders it headless to a PNG.

    python -m sfmfromscratch_tpu_torch.cli show model --output-dir output --save-png m.png
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np


def _add_extractor_flags(p: argparse.ArgumentParser) -> None:
    # Defaults = the reference demo config (main.py:19-28).
    p.add_argument("--num-interest-points", type=int, default=2500)
    p.add_argument("--ksize", type=int, default=3)
    p.add_argument("--gaussian-size", type=int, default=7)
    p.add_argument("--sigma", type=float, default=6.0)
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--feature-width", type=int, default=18)
    p.add_argument("--pyramid-level", type=int, default=3)
    p.add_argument("--pyramid-scale-factor", type=float, default=1.1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sfmfromscratch-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("reconstruct", help="run incremental SfM on an image folder")
    rec.add_argument("img_path")
    rec.add_argument("--max-img", type=int, required=True)
    rec.add_argument("--match-threshold", type=float, default=0.85)
    rec.add_argument("--dist-threshold", type=float, default=5.0)
    rec.add_argument("--scale-factor", type=float, default=0.5)
    rec.add_argument("--sensor", default=None,
                     help="sensor type for EXIF intrinsics (e.g. CROP_FRAME)")
    rec.add_argument("--focal", type=float, default=None,
                     help="use a synthetic K with this focal instead of EXIF")
    rec.add_argument("--model-name", default=None)
    rec.add_argument("--output-dir", default="output")
    rec.add_argument("--assoc-mode", choices=["index", "distance"], default="index")
    rec.add_argument("--pair-window", type=int, default=1,
                     help="match pairs (i, i+1..i+w); w>1 links multi-view tracks")
    rec.add_argument("--chain-refresh", choices=["averaging"], default=None,
                     help="post-chain pose refresh: motion averaging over the "
                          "map's track correspondences (de-bends orbit drift)")
    rec.add_argument("--local-ba-every", type=int, default=None,
                     help="run windowed BA every N chain frames")
    rec.add_argument("--on-pose-failure", choices=["raise", "recover"], default="raise")
    rec.add_argument("--ransac-iterations", type=int, default=None,
                     help="override the derived RANSAC hypothesis count")
    rec.add_argument("--profile-dir", default=None,
                     help="capture a torch.profiler trace of the whole "
                          "reconstruction (open in Perfetto/TensorBoard)")
    rec.add_argument("--pair-cache-dir", default=None,
                     help="persist each matched pair here; a killed run "
                          "resumes the matching at the first uncomputed pair")
    rec.add_argument("--refine-focal", action="store_true",
                     help="self-calibrate a shared focal scale inside BA "
                          "(EXIF focals are nominal)")
    rec.add_argument("--export-ply", default=None,
                     help="also write a colored PLY point cloud here")
    rec.add_argument("--export-colmap", default=None,
                     help="also write a COLMAP sparse text model to this dir")
    rec.add_argument("--pipeline", choices=["incremental", "global"],
                     default="incremental",
                     help="incremental PnP chain, or global motion averaging "
                          "(all-pairs relative poses + rotation/translation "
                          "averaging; best for wide-baseline/unordered sets)")
    rec.add_argument("--pair-mode", choices=["window", "retrieval", "both"],
                     default="window",
                     help="global pipeline pair proposal: sequential window, "
                          "VLAD retrieval (unordered sets), or both")
    rec.add_argument("--retrieval-k", type=int, default=6)
    rec.add_argument("--keyframe-step", default="1",
                     help="global pipeline: reconstruct every k-th frame and "
                          "register the rest by batched PnP ('auto' = "
                          "flow-adaptive selection; best for dense video)")
    rec.add_argument("--keyframe-flow-px", type=float, default=None,
                     help="flow target for --keyframe-step auto (default 5%% "
                          "of the image diagonal)")
    rec.add_argument("--stream-ba-window", type=int, default=None,
                     help="global pipeline: run the final BA out of core "
                          "through the block store (pipeline/streaming.py) with "
                          "this many resident blocks")
    rec.add_argument("--stream-ba-block-cams", type=int, default=32,
                     help="cameras per map block for --stream-ba-window")
    rec.add_argument("--device", default=None,
                     help="torch device to run on (default: the CUDA card; "
                          "'cpu' runs on the CPU)")
    _add_extractor_flags(rec)

    show = sub.add_parser("show", help="load a saved model and open the 3-D viewer")
    show.add_argument("model_name")
    show.add_argument("--output-dir", default="output")
    show.add_argument("--save-png", default=None, help="render headless to PNG")

    rez = sub.add_parser("resize", help="batch-resize a dataset, keeping EXIF")
    rez.add_argument("input_folder")
    rez.add_argument("output_folder")
    rez.add_argument("--ratio", type=float, default=0.3)
    rez.add_argument("--no-exif", action="store_true")

    args = parser.parse_args(argv)

    if args.cmd == "resize":
        from sfmfromscratch_tpu_torch.io.images import fast_resize

        fast_resize(args.input_folder, args.output_folder, ratio=args.ratio,
                    exif=not args.no_exif)
        return 0

    if args.cmd == "show":
        from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

        if args.save_png:
            import matplotlib

            matplotlib.use("Agg", force=True)
            from sfmfromscratch_tpu_torch.viz.scatter3d import V3D

            data = SfmEngine.load(args.model_name, output_dir=args.output_dir, show=False)
            V3D(data["p3d"], data["frame_idx"], data["pt_idx"], show=False,
                save_path=args.save_png)
        else:
            SfmEngine.load(args.model_name, output_dir=args.output_dir, show=True)
        return 0

    # reconstruct
    from sfmfromscratch_tpu_torch.config import (
        ExtractorConfig, MatcherConfig, PipelineConfig, RansacConfig,
    )
    from sfmfromscratch_tpu_torch.geometry.camera import SensorType
    from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

    cfg = PipelineConfig(
        extractor=ExtractorConfig(
            num_interest_points=args.num_interest_points, ksize=args.ksize,
            gaussian_size=args.gaussian_size, sigma=args.sigma, alpha=args.alpha,
            feature_width=args.feature_width, pyramid_level=args.pyramid_level,
            pyramid_scale_factor=args.pyramid_scale_factor,
        ),
        matcher=MatcherConfig(ratio_threshold=args.match_threshold,
                              max_matches=args.num_interest_points),
        ransac=RansacConfig(max_iterations=args.ransac_iterations),
        scale_factor=args.scale_factor,
        dist_threshold=args.dist_threshold,
    )
    sensor = SensorType[args.sensor] if args.sensor else None
    single_K = None
    if args.focal is not None:
        from PIL import Image

        with Image.open(os.path.join(args.img_path, "1.jpg")) as im:
            w, h = im.size
        # K at the working scale; the engine does not rescale single_K.
        w, h = int(w * args.scale_factor), int(h * args.scale_factor)
        single_K = np.array(
            [[args.focal, 0, w / 2], [0, args.focal, h / 2], [0, 0, 1]], np.float64
        )

    prof = contextlib.nullcontext()
    if args.profile_dir:
        from sfmfromscratch_tpu_torch.utils import profiling

        prof = profiling.trace(args.profile_dir)

    common = dict(config=cfg, single_K=single_K, camera_sensor=sensor,
                  model_name=args.model_name, output_dir=args.output_dir,
                  pair_cache_dir=args.pair_cache_dir, refine_focal=args.refine_focal,
                  device=args.device)
    with prof:
        if args.pipeline == "global":
            from sfmfromscratch_tpu_torch.pipeline.global_sfm import GlobalSfmEngine

            kf = args.keyframe_step
            eng = GlobalSfmEngine(
                args.img_path, args.max_img, pair_window=max(2, args.pair_window),
                pair_mode=args.pair_mode, retrieval_k=args.retrieval_k,
                keyframe_step=kf if kf == "auto" else int(kf),
                keyframe_flow_px=args.keyframe_flow_px,
                stream_ba_window=args.stream_ba_window,
                stream_ba_block_cams=args.stream_ba_block_cams, **common,
            )
        else:
            eng = SfmEngine(
                args.img_path, args.max_img, assoc_mode=args.assoc_mode,
                pair_window=args.pair_window, local_ba_every=args.local_ba_every,
                on_pose_failure=args.on_pose_failure, chain_refresh=args.chain_refresh,
                **common,
            )
    if args.export_ply:
        eng.save_ply(args.export_ply)
    if args.export_colmap:
        eng.save_colmap(args.export_colmap)
    b, a = eng.errors_before_after_ba
    print(f"tracks={eng.map.num_tracks} observations={eng.map.num_observations}")
    print(f"mean reprojection error: {b:.4f} -> {a:.4f} px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
