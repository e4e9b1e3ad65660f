"""Reference numbers for the train phase of the port's chip smoke test.

Runs the JAX package's TinyPoint trainer (``ops/sp_train.py``) on the CPU at
the recipe of ``tools/train_superpoint.py`` (1,500 steps of batch 16 at
120x160, ``chip_smoke.TRAIN_*``) for training seeds 0-2, one process per
seed, each step as ``sp_train.train`` takes it (``jax.random.key(seed)``
initialisation, ``np.random.default_rng(seed)`` batches). For each seed's
checkpoint it records:

* the mean detector and descriptor losses over the last 100 steps;
* the corner hit rate of ``SuperPointExtractor(weights_path=<checkpoint>)``
  on ``_draw_shapes`` seeds 0-19 (``chip_smoke.corner_hit_rate``, the test
  at ``tests/test_extensions.py:51-70`` at 20 seeds), and the committed
  checkpoint's beside it;
* the hybrid engine, ``SfmEngine(feature_extractor=make_hybrid_extractor(
  k=HYBRID_K, weights_path=<checkpoint>))``, on the bench sequence at the
  bench configuration for ``config.seed`` 0-9 (``--engine-seeds``): ATE
  over extent, post-BA reprojection error and tracks.

From these it prints the phase's pins by the house rule: losses 1.25x the
highest, a hit rate no lower than 0.9x the lowest, the hybrid run 1.6x the
worst ATE and error and two thirds of the fewest tracks. With ``--package
port`` the same runs go through the PyTorch port on the CPU (its own
flax-style initialisation and RANSAC draws). About 15 min of training a
seed on 8 CPU cores, plus ~30 s a hybrid run.

    JAX_PLATFORMS=cpu python tools/train_pins.py [--seeds 0 1 2] [--engine-seeds 0 ... 9]
        [--package jax|port]
    JAX_PLATFORMS=cpu python tools/train_pins.py --write-init tests/data/tinypoint_init_key0.npz

``--write-init`` writes JAX's ``SuperPointNet.tiny()`` initialised at
``jax.random.key(0)`` in ``save_flax_weights``' format (the carried initial
weights of the train phase's card-against-CPU check) and exits.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the scene and settings, no JAX)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _write_init(path: str) -> None:
    jax = _jax()
    import jax.numpy as jnp

    from sfmfromscratch_tpu.ops.superpoint import SuperPointNet, save_flax_weights

    net = SuperPointNet.tiny()
    H, W = chip_smoke.TRAIN_HW
    variables = net.init(jax.random.key(0), jnp.zeros((1, H, W, 1)))
    save_flax_weights(path, variables, net.channels, net.desc_dim)
    print(f"wrote {path}")


def _train_jax(seed, steps, ckpt):
    """JAX's ``sp_train.train`` loop with every step's losses kept."""
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    from sfmfromscratch_tpu.ops import sp_train
    from sfmfromscratch_tpu.ops.superpoint import SuperPointNet, save_flax_weights

    net = SuperPointNet.tiny()
    H, W = chip_smoke.TRAIN_HW
    rng = np.random.default_rng(seed)
    params = net.init(jax.random.key(seed), jnp.zeros((1, H, W, 1)))["params"]
    tx, step = sp_train.make_train_step(net)
    opt_state = tx.init(params)
    losses = []
    for _ in range(steps):
        b = tuple(jnp.asarray(x) for x in sp_train.make_batch(rng, chip_smoke.TRAIN_BATCH, H, W))
        params, opt_state, loss, ld, ldesc = step(params, opt_state, b)
        losses.append((float(loss), float(ld), float(ldesc)))
    save_flax_weights(ckpt, {"params": params}, net.channels, net.desc_dim)
    return losses


def _train_port(seed, steps, ckpt, device="cpu", init=None):
    """The port's ``train`` loop on ``device`` with every step's losses kept,
    from the weights in ``init`` or from the port's draw at ``seed``."""
    import numpy as np
    import torch

    from sfmfromscratch_tpu_torch.ops import sp_train
    from sfmfromscratch_tpu_torch.ops.superpoint import (
        SuperPointNet, load_flax_weights, save_flax_weights,
    )

    if init:
        net = load_flax_weights(init)
    else:
        net = SuperPointNet.tiny()
        net.reset_parameters_flax(torch.Generator().manual_seed(seed))
    net.to(device).train()
    H, W = chip_smoke.TRAIN_HW
    rng = np.random.default_rng(seed)
    _, step = sp_train.make_train_step(net)
    losses = [torch.stack(step(sp_train.make_batch(rng, chip_smoke.TRAIN_BATCH, H, W)))
              for _ in range(steps)]
    save_flax_weights(ckpt, net.cpu())
    return [tuple(r) for r in torch.stack(losses).tolist()]


def _hit_rate(package, ckpt, device="cpu"):
    """(hits, corners) of the extractor on ``ckpt`` (None: the committed
    checkpoint)."""
    import numpy as np

    if package == "jax":
        _jax()
        import jax.numpy as jnp

        from sfmfromscratch_tpu.ops.sp_train import _draw_shapes
        from sfmfromscratch_tpu.ops.superpoint import SuperPointExtractor

        ext = SuperPointExtractor(ckpt or "auto")
        to_image = jnp.asarray
    else:
        import torch

        from sfmfromscratch_tpu_torch.ops.sp_train import _draw_shapes
        from sfmfromscratch_tpu_torch.ops.superpoint import SuperPointExtractor

        ext = SuperPointExtractor(ckpt or "auto")

        def to_image(img):
            return torch.as_tensor(img, device=device)

    def detect(img):
        kp = ext(to_image(img), k=chip_smoke.HIT_K).keypoints
        m = np.asarray(_host(kp.mask))
        return np.stack([np.asarray(_host(kp.xf))[m], np.asarray(_host(kp.yf))[m]], 1)

    return chip_smoke.corner_hit_rate(detect, _draw_shapes)


def _host(x):
    """A JAX array as it is, a tensor on the host."""
    return x.cpu() if hasattr(x, "cpu") else x


def _hybrid_runs(package, ckpt, engine_seeds, device="cpu"):
    import functools

    if package == "jax":
        _jax()
        from sfmfromscratch_tpu.config import (
            BundleAdjustConfig, ExtractorConfig, MatcherConfig, PipelineConfig, RansacConfig,
        )
        from sfmfromscratch_tpu.ops.superpoint import make_hybrid_extractor
        from sfmfromscratch_tpu.pipeline.incremental import SfmEngine
    else:
        from sfmfromscratch_tpu_torch.config import (
            BundleAdjustConfig, ExtractorConfig, MatcherConfig, PipelineConfig, RansacConfig,
        )
        from sfmfromscratch_tpu_torch.ops.superpoint import make_hybrid_extractor
        from sfmfromscratch_tpu_torch.pipeline.incremental import SfmEngine

        SfmEngine = functools.partial(SfmEngine, device=device)
    bench = PipelineConfig(
        extractor=ExtractorConfig(**chip_smoke.BENCH_EXTRACTOR),
        matcher=MatcherConfig(**chip_smoke.BENCH_MATCHER), ransac=RansacConfig(),
        ba=BundleAdjustConfig(**chip_smoke.BENCH_BA), scale_factor=1.0,
    )
    rows = []
    with tempfile.TemporaryDirectory(prefix="train_pins_") as seq:
        n = chip_smoke.EXTRACTOR_VIEWS
        K, gt = chip_smoke.bench_sequence(seq, n)
        for seed in engine_seeds:
            t0 = time.perf_counter()
            try:
                eng = SfmEngine(seq, n, config=dataclasses.replace(bench, seed=seed), single_K=K,
                                feature_extractor=make_hybrid_extractor(k=chip_smoke.HYBRID_K,
                                                                        weights_path=ckpt))
            except RuntimeError as e:   # a failed run is a result too; the pins skip it
                rows.append(dict(engine_seed=seed, error=str(e)))
                continue
            ate, extent = chip_smoke.trajectory_error(eng.global_poses, gt, 2)
            rows.append(dict(engine_seed=seed, wall_s=time.perf_counter() - t0,
                             cameras=len(eng.global_poses), ate_over_extent=ate / extent,
                             reproj_after_px=float(eng.errors_before_after_ba[1]),
                             tracks=int(eng.map.num_tracks)))
    return rows


def _worker(args) -> None:
    """One training seed: train, then the hit rate and the hybrid runs."""
    with tempfile.TemporaryDirectory(prefix="train_pins_ckpt_") as tmp:
        ckpt = os.path.join(tmp, "tinypoint.npz")
        t0 = time.perf_counter()
        if args.package == "jax":
            losses = _train_jax(args.worker, chip_smoke.TRAIN_STEPS, ckpt)
        else:
            losses = _train_port(args.worker, chip_smoke.TRAIN_STEPS, ckpt, args.device, args.init)
        train_s = time.perf_counter() - t0
        last = losses[-chip_smoke.TRAIN_LAST:]
        hits, corners = _hit_rate(args.package, ckpt, args.device)
        hybrid = _hybrid_runs(args.package, ckpt, args.engine_seeds, args.device)
    print(json.dumps(dict(
        seed=args.worker, package=args.package, device=args.device, init=args.init,
        steps=chip_smoke.TRAIN_STEPS, train_s=train_s,
        first_loss=losses[0], last_loss=losses[-1],
        last_mean_ld=sum(r[1] for r in last) / len(last),
        last_mean_ldesc=sum(r[2] for r in last) / len(last),
        hit_rate=hits / max(corners, 1), hits=hits, corners=corners, hybrid=hybrid)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--engine-seeds", type=int, nargs="+", default=list(range(10)))
    ap.add_argument("--package", choices=["jax", "port"], default="jax")
    ap.add_argument("--device", default="cpu", help="the port's device (cpu or cuda)")
    ap.add_argument("--init", default=None, help="the port's initial weights (npz)")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--write-init", default=None)
    args = ap.parse_args()
    if args.write_init:
        _write_init(args.write_init)
        return
    if args.package == "jax" and (args.device != "cpu" or args.init):
        ap.error("--device and --init apply to --package port")
    if args.worker is not None:
        _worker(args)
        return

    procs = []
    for seed in args.seeds:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", str(seed),
               "--package", args.package, "--device", args.device,
               *(["--init", args.init] if args.init else []),
               "--engine-seeds", *map(str, args.engine_seeds)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True))
    rows = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"worker failed ({p.returncode})")
        print(out, end="", flush=True)
        rows.append(json.loads(out.strip().splitlines()[-1]))
    committed = _hit_rate(args.package, None, args.device)
    runs = [h for r in rows for h in r["hybrid"] if "error" not in h]
    spread = dict(
        last_mean_ld=[min(r["last_mean_ld"] for r in rows), max(r["last_mean_ld"] for r in rows)],
        last_mean_ldesc=[min(r["last_mean_ldesc"] for r in rows),
                         max(r["last_mean_ldesc"] for r in rows)],
        hit_rate=[min(r["hit_rate"] for r in rows), max(r["hit_rate"] for r in rows)],
        hybrid_cameras=[min(h["cameras"] for h in runs), max(h["cameras"] for h in runs)],
        hybrid_ate_over_extent=[min(h["ate_over_extent"] for h in runs),
                                max(h["ate_over_extent"] for h in runs)],
        hybrid_reproj_px=[min(h["reproj_after_px"] for h in runs),
                          max(h["reproj_after_px"] for h in runs)],
        hybrid_tracks=[min(h["tracks"] for h in runs), max(h["tracks"] for h in runs)])
    pins = dict(
        PIN_TRAIN_LD=1.25 * spread["last_mean_ld"][1],
        PIN_TRAIN_LDESC=1.25 * spread["last_mean_ldesc"][1],
        PIN_TRAIN_HIT_RATE=0.9 * spread["hit_rate"][0],
        PIN_TRAIN_HYBRID=dict(ate_over_extent=1.6 * spread["hybrid_ate_over_extent"][1],
                              reproj_px=1.6 * spread["hybrid_reproj_px"][1],
                              min_tracks=int(2 * spread["hybrid_tracks"][0] // 3)))
    print(json.dumps({"seeds": args.seeds, "engine_seeds": args.engine_seeds,
                      "package": args.package, "device": args.device, "init": args.init,
                      f"{args.package}_{args.device}_range": spread,
                      "hybrid_failed": [[r["seed"], h["engine_seed"]] for r in rows
                                        for h in r["hybrid"] if "error" in h],
                      "committed_hit_rate": committed[0] / max(committed[1], 1),
                      "committed_hits": list(committed), "pins": pins}))


if __name__ == "__main__":
    main()
