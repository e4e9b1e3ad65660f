"""Self-supervised training of the SuperPoint slot (counterpart of
``sfmfromscratch_tpu/ops/sp_train.py``).

TinyPoint is trained from scratch the way SuperPoint was bootstrapped
(DeTone et al., CVPRW'18): a MagicPoint stage on synthetic shapes with exact
corner ground truth, joint with a homography-pair descriptor loss.

* data: random polygons, stars, checkerboards and rotated quads drawn with
  PIL, or blocky multi-scale noise with Shi-Tomasi pseudo-labels, each
  paired with a random homography warp of itself. Host numpy, PIL and cv2,
  drawing from the ``np.random.Generator`` in the JAX module's order, so one
  seed gives the JAX module's arrays byte for byte.
* detector loss: the 65-way cell cross-entropy (8x8 pixel classes and a
  dustbin) on both views, corner and dustbin cells weighted 0.5 each over
  the whole batch.
* descriptor loss: the pairwise hinge on the cell-centre correspondence the
  homography induces (positives within 8 px).
* optimiser: ``torch.optim.Adam(lr=1e-3)``, which is ``optax.adam(1e-3)``.

Forward, backward and the Adam step run inside one scope
(:func:`train_scope`): float32 convolutions and matmuls with TF32 off
(``f32_precision``), and cuDNN's deterministic algorithms, so the card's
training repeats bit for bit. Plain PyTorch: the
JAX module has no Pallas kernel. PIL and cv2 are imported inside the
functions that use them.

``tools/train_superpoint_torch.py`` runs :func:`train` and writes the
checkpoint in the JAX package's npz format.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfmfromscratch_tpu_torch.ops.superpoint import SuperPointNet
from sfmfromscratch_tpu_torch.utils.device import resolve_device
from sfmfromscratch_tpu_torch.utils.precision import f32_precision

# --------------------------------------------------------------------------
# Synthetic-shapes dataset (host-side generation, exact corner ground truth)
# --------------------------------------------------------------------------

MAX_CORNERS = 64


def _draw_shapes(rng: np.random.Generator, H: int, W: int):
    """One synthetic image and its corner list (``sp_train.py:41-107``)."""
    from PIL import Image, ImageDraw, ImageFilter

    bg = rng.uniform(0.1, 0.9)

    def lum(v: float) -> int:  # PIL "L" mode wants uint8
        return int(np.clip(v, 0, 1) * 255)

    img = Image.new("L", (W, H), color=lum(bg))
    d = ImageDraw.Draw(img)
    corners = []

    kind = rng.integers(0, 4)
    if kind == 0:  # polygons
        for _ in range(rng.integers(2, 5)):
            n = int(rng.integers(3, 7))
            cx, cy = rng.uniform(0.15, 0.85) * W, rng.uniform(0.15, 0.85) * H
            r = rng.uniform(0.06, 0.22) * min(H, W)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            pts = [(cx + r * np.cos(a), cy + r * np.sin(a)) for a in ang]
            d.polygon(pts, fill=lum(bg + rng.uniform(-0.6, 0.6)))
            corners += pts
    elif kind == 1:  # star of segments
        cx, cy = rng.uniform(0.3, 0.7) * W, rng.uniform(0.3, 0.7) * H
        corners.append((cx, cy))
        for _ in range(rng.integers(3, 8)):
            ex, ey = rng.uniform(0, W - 1), rng.uniform(0, H - 1)
            d.line([(cx, cy), (ex, ey)],
                   fill=lum(bg + rng.uniform(-0.6, 0.6)),
                   width=int(rng.integers(1, 3)))
            corners.append((ex, ey))
    elif kind == 2:  # checkerboard patch
        rows, cols = int(rng.integers(3, 6)), int(rng.integers(3, 6))
        cw = rng.uniform(0.08, 0.16) * min(H, W)
        x0, y0 = rng.uniform(0.05, 0.4) * W, rng.uniform(0.05, 0.4) * H
        for r in range(rows):
            for c in range(cols):
                if (r + c) % 2 == 0:
                    d.rectangle(
                        [x0 + c * cw, y0 + r * cw, x0 + (c + 1) * cw, y0 + (r + 1) * cw],
                        fill=lum(bg + rng.uniform(0.3, 0.6) * rng.choice([-1, 1])),
                    )
        for r in range(rows + 1):
            for c in range(cols + 1):
                corners.append((x0 + c * cw, y0 + r * cw))
    else:  # quads (rectangles under rotation)
        for _ in range(rng.integers(2, 5)):
            cx, cy = rng.uniform(0.2, 0.8) * W, rng.uniform(0.2, 0.8) * H
            w2, h2 = rng.uniform(0.05, 0.2) * W, rng.uniform(0.05, 0.2) * H
            th = rng.uniform(0, np.pi)
            R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            base = np.array([[-w2, -h2], [w2, -h2], [w2, h2], [-w2, h2]])
            pts = (base @ R.T + [cx, cy]).tolist()
            d.polygon([tuple(p) for p in pts],
                      fill=lum(bg + rng.uniform(-0.6, 0.6)))
            corners += [tuple(p) for p in pts]

    if rng.uniform() < 0.7:
        img = img.filter(ImageFilter.GaussianBlur(radius=float(rng.uniform(0.3, 1.2))))
    arr = np.asarray(img, np.float32) / 255.0
    arr = np.clip(arr + rng.normal(0, rng.uniform(0.0, 0.04), arr.shape), 0, 1)

    c = np.array(corners, np.float32).reshape(-1, 2) if corners else np.zeros((0, 2), np.float32)
    keep = (c[:, 0] >= 4) & (c[:, 0] < W - 4) & (c[:, 1] >= 4) & (c[:, 1] < H - 4)
    c = c[keep][:MAX_CORNERS]
    return arr.astype(np.float32), c


def _draw_texture(rng: np.random.Generator, H: int, W: int):
    """Corner-rich blocky multi-scale noise with Shi-Tomasi pseudo-labels
    (``sp_train.py:110-136``): mixing textured samples in keeps the hinge's
    negatives informative."""
    import cv2

    img = np.zeros((H, W), np.float32)
    for n in (6, 12, 24, 48):
        g = rng.uniform(0, 1, (n, n)).astype(np.float32)
        img += cv2.resize(g, (W, H), interpolation=cv2.INTER_NEAREST) * rng.uniform(0.3, 1.0)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
    if rng.uniform() < 0.5:
        img = cv2.GaussianBlur(img, (0, 0), float(rng.uniform(0.3, 1.0)))
    img = np.clip(img + rng.normal(0, rng.uniform(0, 0.03), img.shape), 0, 1)

    pts = cv2.goodFeaturesToTrack(
        (img * 255).astype(np.uint8), maxCorners=MAX_CORNERS,
        qualityLevel=0.1, minDistance=8,
    )
    c = (pts.reshape(-1, 2).astype(np.float32)
         if pts is not None else np.zeros((0, 2), np.float32))
    keep = (c[:, 0] >= 4) & (c[:, 0] < W - 4) & (c[:, 1] >= 4) & (c[:, 1] < H - 4)
    return img.astype(np.float32), c[keep]


def _photometric_jitter(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Brightness, contrast and gamma jitter (``sp_train.py:139-145``)."""
    g = rng.uniform(0.7, 1.4)
    img = np.clip(img, 0, 1) ** g
    img = img * rng.uniform(0.7, 1.2) + rng.uniform(-0.15, 0.15)
    return np.clip(img, 0, 1).astype(np.float32)


def _random_homography(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """Random perspective warp: corner perturbation, rotation and scale
    (``sp_train.py:148-160``)."""
    import cv2

    src = np.array([[0, 0], [W, 0], [W, H], [0, H]], np.float32)
    mag = 0.18
    dst = src + rng.uniform(-mag, mag, (4, 2)).astype(np.float32) * [W, H]
    th = rng.uniform(-0.6, 0.6)
    s = rng.uniform(0.8, 1.25)
    c, sn = np.cos(th) * s, np.sin(th) * s
    ctr = np.array([W / 2, H / 2], np.float32)
    dst = (dst - ctr) @ np.array([[c, -sn], [sn, c]], np.float32).T + ctr
    return cv2.getPerspectiveTransform(src, dst.astype(np.float32))


def _warp_points(Hm: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Points through ``Hm``, dividing by |w| (at least 1e-8) and keeping
    w's sign (``sp_train.py:163-168``)."""
    if len(pts) == 0:
        return pts
    ph = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
    q = ph @ Hm.T
    return q[:, :2] / np.maximum(np.abs(q[:, 2:3]), 1e-8) * np.sign(q[:, 2:3])


def _cell_labels(corners: np.ndarray, H: int, W: int) -> np.ndarray:
    """(Hc, Wc) int32 labels: 8*(y%8)+(x%8) of a corner in the cell, else
    64; the last corner in a cell wins (``sp_train.py:171-179``)."""
    Hc, Wc = H // 8, W // 8
    lab = np.full((Hc, Wc), 64, np.int32)
    for x, y in corners:
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            lab[yi // 8, xi // 8] = 8 * (yi % 8) + (xi % 8)
    return lab


def make_batch(rng: np.random.Generator, B: int, H: int, W: int):
    """(imgs, labels, imgs_w, labels_w, homographies) as numpy, each sample
    paired with a random homography warp of itself (``sp_train.py:182-210``)."""
    import cv2

    imgs = np.zeros((B, H, W), np.float32)
    imgs_w = np.zeros((B, H, W), np.float32)
    labs = np.zeros((B, H // 8, W // 8), np.int32)
    labs_w = np.zeros((B, H // 8, W // 8), np.int32)
    Hs = np.zeros((B, 3, 3), np.float32)
    for b in range(B):
        if rng.uniform() < 0.5:
            img, c = _draw_shapes(rng, H, W)
        else:
            img, c = _draw_texture(rng, H, W)
        Hm = _random_homography(rng, H, W)
        imgs[b] = _photometric_jitter(rng, img)
        imgs_w[b] = _photometric_jitter(
            rng,
            cv2.warpPerspective(img, Hm, (W, H), borderMode=cv2.BORDER_REFLECT),
        )
        labs[b] = _cell_labels(c, H, W)
        cw = _warp_points(Hm, c)
        if len(cw):
            keep = (cw[:, 0] >= 0) & (cw[:, 0] < W) & (cw[:, 1] >= 0) & (cw[:, 1] < H)
            cw = cw[keep]
        labs_w[b] = _cell_labels(cw, H, W)
        Hs[b] = Hm
    return imgs, labs, imgs_w, labs_w, Hs


# --------------------------------------------------------------------------
# Losses and train step
# --------------------------------------------------------------------------


def _detector_ce(semi: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The weighted 65-way cell cross-entropy of (B, 65, Hc, Wc) logits and
    (B, Hc, Wc) int64 labels (``sp_train.py:218-227``): corner cells share
    half the weight and dustbin cells the other half, counted over the
    whole batch."""
    logp = F.log_softmax(semi, dim=1)
    ce = -torch.gather(logp, 1, labels[:, None]).squeeze(1)
    is_corner = labels < 64
    n_pos = torch.clamp_min(is_corner.sum(), 1)
    n_neg = torch.clamp_min((~is_corner).sum(), 1)
    w = torch.where(is_corner, 0.5 / n_pos, 0.5 / n_neg)
    return torch.sum(ce * w)


def _descriptor_hinge(desc_a: torch.Tensor, desc_b: torch.Tensor, Hm: torch.Tensor,
                      mp: float = 1.0, mn: float = 0.2) -> torch.Tensor:
    """The SuperPoint pairwise hinge of each sample, (B,)
    (``sp_train.py:230-251``, batched where JAX maps over the batch).

    ``desc_a``/``desc_b``: (B, D, Hc, Wc) unit descriptors; ``Hm``: (B, 3, 3)
    maps view-A pixels to view-B pixels. Cells are taken row-major over
    (y, x), with centres (8x + 4, 8y + 4); a warped centre within 8 px of a
    centre (``d2 <= 64``) is a positive. Unlike :func:`_warp_points`, a
    |w| under 1e-8 becomes +1e-8."""
    B, D, Hc, Wc = desc_a.shape
    ys, xs = torch.meshgrid(torch.arange(Hc, device=desc_a.device),
                            torch.arange(Wc, device=desc_a.device), indexing="ij")
    pc = torch.stack([xs * 8 + 4, ys * 8 + 4], -1).reshape(-1, 2).to(torch.float32)
    ph = torch.cat([pc, torch.ones_like(pc[:, :1])], 1)
    q = ph @ Hm.transpose(1, 2)                                  # (B, N, 3)
    w = q[..., 2:3]
    q = q[..., :2] / torch.where(torch.abs(w) < 1e-8, 1e-8, w)
    d2 = torch.sum((q[:, :, None, :] - pc[None, None]) ** 2, -1)  # (B, N, N)
    s = (d2 <= 64.0).to(torch.float32)
    da = desc_a.flatten(2).transpose(1, 2)                       # (B, N, D)
    db = desc_b.flatten(2).transpose(1, 2)
    dot = da @ db.transpose(1, 2)
    pos = torch.clamp_min(mp - dot, 0.0)
    neg = torch.clamp_min(dot - mn, 0.0)
    n_pos = torch.clamp_min(torch.sum(s, (1, 2)), 1.0)
    n_neg = torch.clamp_min(torch.sum(1 - s, (1, 2)), 1.0)
    return 0.5 * (torch.sum(s * pos, (1, 2)) / n_pos + torch.sum((1 - s) * neg, (1, 2)) / n_neg)


@contextlib.contextmanager
def train_scope():
    """The scope of a train step's forward and backward: float32 without
    TF32 (:func:`f32_precision`); cuDNN's deterministic algorithms with
    autotuning off, so the backward convolutions add in a fixed order; and
    on the CPU no oneDNN convolutions, whose backward at the full width
    parts from float64 far more than the native convolutions and XLA do
    (``tests/test_torch_sp_train.py`` holds the scope's gradients to the
    float64 net's). The flags are restored afterwards."""
    cudnn, mkldnn = torch.backends.cudnn, torch.backends.mkldnn
    saved = cudnn.deterministic, cudnn.benchmark, mkldnn.enabled
    cudnn.deterministic, cudnn.benchmark, mkldnn.enabled = True, False, False
    try:
        with f32_precision():
            yield
    finally:
        cudnn.deterministic, cudnn.benchmark, mkldnn.enabled = saved


def make_train_step(net: SuperPointNet, lambda_desc: float = 1.0):
    """(optimizer, step) for ``net`` (``sp_train.py:254-275``).

    ``optimizer`` is ``torch.optim.Adam(lr=1e-3)``: optax's ``adam(1e-3)``
    (b1 0.9, b2 0.999, eps 1e-8 outside the square root). ``step(batch)``
    takes :func:`make_batch`'s arrays, moves them to the net's device
    (labels as int64), runs both views through the net, updates ``net`` and
    the optimizer in place by ``ld + lambda_desc * ldesc``, and returns
    (loss, ld, ldesc) as device tensors without reading them on the host."""
    optimizer = torch.optim.Adam(net.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)

    def step(batch):
        dev = next(net.parameters()).device
        imgs, labs, imgs_w, labs_w, Hs = batch
        imgs, imgs_w, Hs = (torch.as_tensor(a, dtype=torch.float32).to(dev)
                            for a in (imgs, imgs_w, Hs))
        labs, labs_w = (torch.as_tensor(a).to(dev, torch.int64) for a in (labs, labs_w))
        with train_scope():
            semi_a, desc_a = net(imgs[:, None])
            semi_b, desc_b = net(imgs_w[:, None])
            ld = _detector_ce(semi_a, labs) + _detector_ce(semi_b, labs_w)
            ldesc = torch.mean(_descriptor_hinge(desc_a, desc_b, Hs))
            loss = ld + lambda_desc * ldesc
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        return loss.detach(), ld.detach(), ldesc.detach()

    return optimizer, step


def train(steps: int = 1500, batch: int = 16, hw: Tuple[int, int] = (120, 160),
          seed: int = 0, log_every: int = 100, net: SuperPointNet = None,
          device=None) -> SuperPointNet:
    """Train TinyPoint on synthetic shapes (``sp_train.py:278-297``) and
    return the trained net.

    ``net`` (default ``SuperPointNet.tiny()``) gives the architecture only:
    its weights are drawn afresh with flax's initialisation from
    ``torch.Generator().manual_seed(seed)``. The batches come from
    ``np.random.default_rng(seed)``, which the initialisation does not
    touch. Prints the JAX trainer's lines at the same steps, the only host
    reads of the loop. ``device=None`` means the CUDA card and raises
    without one; ``device="cpu"`` runs on the CPU."""
    dev = resolve_device(device)
    net = net if net is not None else SuperPointNet.tiny()
    H, W = hw
    rng = np.random.default_rng(seed)
    net.reset_parameters_flax(torch.Generator().manual_seed(seed))
    net.to(dev).train()
    _, step = make_train_step(net)
    for i in range(steps):
        loss, ld, ldesc = step(make_batch(rng, batch, H, W))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i}: loss {float(loss):.4f} "
                  f"(det {float(ld):.4f}, desc {float(ldesc):.4f})", flush=True)
    return net
