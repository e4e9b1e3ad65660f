"""SuperPoint learned feature extractor (counterpart of
``sfmfromscratch_tpu/ops/superpoint.py``).

The standard SuperPoint network (VGG-style shared encoder, a 65-way cell
detector head, an L2-normalised descriptor head) as an ``nn.Module`` whose
layers carry the MagicLeap checkpoint's names (``conv1a`` ... ``convDb``, each
with ``.weight`` and ``.bias``), so ``superpoint_v1.pth`` loads with
``load_state_dict``. The TinyPoint checkpoint (``weights/``) is a byte-equal
copy of the JAX package's npz of flax kernels. ``SuperPointExtractor`` adapts the net
to the engines' fixed-capacity Features; ``make_hybrid_extractor`` keeps the
TinyPoint detector and swaps in RootSIFT descriptors.

The network is NCHW, as torch's convolutions and the MagicLeap layout are;
the JAX network is NHWC. Its convolutions run with TF32 off
(``f32_precision``): cuDNN would run float32 convolutions in TF32 and move
heatmap ranks off the float32 reference. Plain PyTorch: the JAX module has
no Pallas kernel.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmfromscratch_tpu_torch.ops.dog import top_k_stable
from sfmfromscratch_tpu_torch.types import Features, Keypoints
from sfmfromscratch_tpu_torch.utils.precision import f32_precision

LAYERS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
          "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")


class SuperPointNet(nn.Module):
    """VGG-style encoder + detector/descriptor heads (SuperPoint, CVPRW'18;
    ``superpoint.py:37-84``). The default widths are the MagicLeap
    checkpoint's, with 256-D descriptors; ``tiny()`` is TinyPoint's, with
    128-D descriptors (the SIFT front end's width).

    ``forward`` takes (B, 1, H, W) grayscale in [0, 1] and returns the
    detector logits (B, 65, H/8, W/8) and unit descriptors (B, D, H/8, W/8).
    """

    def __init__(self, channels: Tuple[int, int, int, int, int] = (64, 64, 128, 128, 256),
                 desc_dim: int = 256):
        super().__init__()
        self.channels = tuple(int(c) for c in channels)
        self.desc_dim = int(desc_dim)
        c1, c2, c3, c4, c5 = self.channels
        conv3 = lambda i, o: nn.Conv2d(i, o, 3, padding=1)
        self.conv1a, self.conv1b = conv3(1, c1), conv3(c1, c1)
        self.conv2a, self.conv2b = conv3(c1, c2), conv3(c2, c2)
        self.conv3a, self.conv3b = conv3(c2, c3), conv3(c3, c3)
        self.conv4a, self.conv4b = conv3(c3, c4), conv3(c4, c4)
        self.convPa, self.convPb = conv3(c4, c5), nn.Conv2d(c5, 65, 1)
        self.convDa, self.convDb = conv3(c4, c5), nn.Conv2d(c5, self.desc_dim, 1)

    @classmethod
    def tiny(cls) -> "SuperPointNet":
        return cls(channels=(32, 32, 64, 64, 128), desc_dim=128)

    def reset_parameters_flax(self, generator: torch.Generator) -> None:
        """Flax's default ``Conv`` initialisation, drawn from ``generator``:
        LeCun-normal kernels (truncated normal at two deviations, variance
        1 / fan_in) and zero biases."""
        with torch.no_grad():
            for name in LAYERS:
                conv = getattr(self, name)
                fan_in = conv.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(conv.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                conv.weight.copy_(w * std)
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        relu, pool = F.relu, lambda t: F.max_pool2d(t, 2, 2)
        x = relu(self.conv1b(relu(self.conv1a(x))))
        x = relu(self.conv2b(relu(self.conv2a(pool(x)))))
        x = relu(self.conv3b(relu(self.conv3a(pool(x)))))
        x = relu(self.conv4b(relu(self.conv4a(pool(x)))))
        semi = self.convPb(relu(self.convPa(x)))
        desc = self.convDb(relu(self.convDa(x)))
        desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=1, keepdim=True), 1e-10)
        return semi, desc


def state_dict_from_flax(params: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """Flax ``params`` ({layer: {"kernel": (kh, kw, in, out), "bias"}}) ->
    a ``SuperPointNet`` state dict ((out, in, kh, kw) weights)."""
    sd = {}
    for name in LAYERS:
        p = params[name]
        sd[f"{name}.weight"] = torch.as_tensor(
            np.ascontiguousarray(np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1))))
        sd[f"{name}.bias"] = torch.as_tensor(np.array(p["bias"], np.float32))
    return sd


def save_flax_weights(path: str, net: SuperPointNet) -> None:
    """Write ``net`` as the JAX package's npz checkpoint: flax kernels and
    biases under ``<layer>.kernel`` / ``<layer>.bias`` with the widths
    (``superpoint.py:107-119``)."""
    flat = {}
    for name in LAYERS:
        conv = getattr(net, name)
        flat[f"{name}.kernel"] = np.transpose(conv.weight.detach().cpu().numpy(), (2, 3, 1, 0))
        flat[f"{name}.bias"] = conv.bias.detach().cpu().numpy()
    np.savez_compressed(path, __channels__=np.asarray(net.channels, np.int32),
                        __desc_dim__=np.asarray(net.desc_dim, np.int32), **flat)


def load_flax_weights(path: str) -> SuperPointNet:
    """A ``SuperPointNet`` at the widths of an npz checkpoint written by
    either package's ``save_flax_weights``, with its weights
    (``superpoint.py:122-134``)."""
    with np.load(path) as z:
        params: Dict[str, Dict[str, np.ndarray]] = {}
        for key in z.files:
            if not key.startswith("__"):
                layer, leaf = key.rsplit(".", 1)
                params.setdefault(layer, {})[leaf] = z[key]
        net = SuperPointNet(channels=tuple(int(c) for c in z["__channels__"]),
                            desc_dim=int(z["__desc_dim__"]))
    net.load_state_dict(state_dict_from_flax(params))
    return net


def default_weights_path() -> Optional[str]:
    """The synthetically trained TinyPoint checkpoint
    (``weights/tinypoint_synth.npz`` of this package, a byte-equal copy of the
    JAX package's), or None when it is absent."""
    p = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights",
                     "tinypoint_synth.npz")
    return p if os.path.exists(p) else None


def _cells_to_heatmap(semi: torch.Tensor) -> torch.Tensor:
    """(65, Hc, Wc) detector logits -> (Hc*8, Wc*8) probability map: softmax
    over the 65 classes, the dustbin dropped, class 8*dy + dx of cell (i, j)
    to pixel (8i + dy, 8j + dx) (``superpoint.py:147-153``)."""
    prob = torch.softmax(semi, dim=0)[:64]
    _, Hc, Wc = prob.shape
    return prob.reshape(8, 8, Hc, Wc).permute(2, 0, 3, 1).reshape(Hc * 8, Wc * 8)


def _forward_impl(net: SuperPointNet, image: torch.Tensor, k: int, nms_radius: int, border: int):
    """The extractor's forward pass (``superpoint.py:205-247``): the net on
    the image cropped to multiples of 8, the heatmap, NMS by max-pool
    equality inside the border, the top-k, and descriptors sampled
    bilinearly on the cell grid, renormalised and zeroed off the mask.
    Returns (x, y, score, mask, descriptors (k, D))."""
    H, W = image.shape
    Hp, Wp = (H // 8) * 8, (W // 8) * 8
    with torch.no_grad(), f32_precision():
        semi, desc = net(image[:Hp, :Wp][None, None])
    heat = _cells_to_heatmap(semi[0])                          # (Hp, Wp)

    local_max = F.max_pool2d(heat[None, None], 2 * nms_radius + 1, stride=1,
                             padding=nms_radius)[0, 0]
    rows = torch.arange(Hp, device=heat.device)[:, None]
    cols = torch.arange(Wp, device=heat.device)[None, :]
    in_b = (rows >= border) & (rows < Hp - border) & (cols >= border) & (cols < Wp - border)
    cand = (heat == local_max) & in_b
    top, idx = top_k_stable(torch.where(cand, heat, float("-inf")).reshape(-1), k)
    y = (idx // Wp).to(torch.int32)
    xc = (idx % Wp).to(torch.int32)
    mask = torch.isfinite(top)

    dmap = desc[0].permute(1, 2, 0)                            # (Hc, Wc, D)
    Hc, Wc = dmap.shape[0], dmap.shape[1]
    fy = y.to(torch.float32) / 8.0 - 0.5
    fx = xc.to(torch.float32) / 8.0 - 0.5
    y0 = torch.clamp(torch.floor(fy).long(), 0, Hc - 1)
    x0 = torch.clamp(torch.floor(fx).long(), 0, Wc - 1)
    y1 = torch.clamp_max(y0 + 1, Hc - 1)
    x1 = torch.clamp_max(x0 + 1, Wc - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(fx - x0, 0.0, 1.0)[:, None]
    d = (dmap[y0, x0] * (1 - wy) * (1 - wx) + dmap[y0, x1] * (1 - wy) * wx
         + dmap[y1, x0] * wy * (1 - wx) + dmap[y1, x1] * wy * wx)
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-10)
    d = d * mask[:, None]
    return xc, y, torch.where(mask, top, 0.0), mask, d


class SuperPointExtractor:
    """The engines' ``feature_extractor`` of a SuperPoint net, with the
    fixed-capacity Features contract (``superpoint.py:156-202``).

    ``weights_path``: "auto" takes the in-repo TinyPoint checkpoint when
    present (random initialisation otherwise); an ``.npz`` path loads a
    ``save_flax_weights`` checkpoint; another path loads a MagicLeap-layout
    torch state dict (``superpoint_v1.pth``); None forces the full-width net
    with flax's initialisation drawn from ``torch.Generator().manual_seed(seed)``.
    The net moves to the device of the image it is given.
    """

    def __init__(self, weights_path: Optional[str] = "auto", seed: int = 0):
        if weights_path == "auto":
            weights_path = default_weights_path()
        if weights_path and str(weights_path).endswith(".npz"):
            self.net = load_flax_weights(weights_path)
        elif weights_path:
            self.net = SuperPointNet()
            self.net.load_state_dict(torch.load(weights_path, map_location="cpu"))
        else:
            self.net = SuperPointNet()
            self.net.reset_parameters_flax(torch.Generator().manual_seed(seed))
        self.net.eval()

    def __call__(self, image_bw: torch.Tensor, k: int = 1024, nms_radius: int = 4,
                 border: int = 4) -> Features:
        if next(self.net.parameters()).device != image_bw.device:
            self.net.to(image_bw.device)
        x, y, score, mask, desc = _forward_impl(self.net, image_bw, k, nms_radius, border)
        kps = Keypoints(x=x, y=y, score=score, mask=mask,
                        xf=x.to(torch.float32), yf=y.to(torch.float32))
        return Features(keypoints=kps, descriptors=desc)


def make_hybrid_extractor(
    k: int = 1024,
    feature_width: int = 16,
    rotation_invariant: bool = True,
    weights_path: Optional[str] = "auto",
    nms_radius: int = 4,
):
    """TinyPoint detector + RootSIFT descriptors for the engines'
    ``feature_extractor`` slot (``superpoint.py:250-288``): the learned
    detector's keypoints inside a border that fits the SIFT window, and the
    SIFT front end's descriptors at them. Returns a callable (H, W) image ->
    Features."""
    from sfmfromscratch_tpu_torch.ops.sift import sift_descriptors

    ext = SuperPointExtractor(weights_path)
    border = max(4, feature_width)   # the SIFT window must fit inside the image

    def extract(image_bw: torch.Tensor) -> Features:
        kp = ext(image_bw, k=k, nms_radius=nms_radius, border=border).keypoints
        desc = sift_descriptors(image_bw, kp.x, kp.y, kp.mask, feature_width=feature_width,
                                rotation_invariant=rotation_invariant)
        return Features(keypoints=kp, descriptors=desc)

    return extract
