"""Frozen copy of the planes renderer (``render_planes`` of the repository's
``tests/render.py``): a room of textured planes rendered by ray-plane
intersection and bilinear texture sampling, so that appearance warps
projectively with the viewpoint. Returns ``(images, K, poses, None)``.

Every random draw (the plane textures) is made in ``draw``, before any view
is rendered; ``view`` renders one view from what ``draw`` returned and draws
nothing, so the views can be rendered in any order or in other processes
and give the same bytes. ``textures="real"`` takes crops of the committed
512x512 photograph ``grace_hopper_512_u8.npz`` beside this file (held to
its sha256), never a file of the environment.
``portbench/tests/test_portbench_generators.py`` holds the copy to
checksums of the original's output.
"""

import hashlib
import os

import numpy as np

REAL_TEXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "grace_hopper_512_u8.npz")
REAL_TEXTURE_SHA256 = "8a9cc9e2bf7cebf35f84c9bfb874dfcb4b1d6fa979a945fc8e9b311e3e05b355"


def real_photo_texture(tex_size: int = 512) -> np.ndarray:
    """The photograph as a grayscale texture in [0, 1]: the original's
    ``real_photo_texture`` at 512x512, bit for bit."""
    if tex_size != 512:
        raise ValueError(f"the committed photograph is 512x512; tex_size {tex_size} is not")
    tex = np.load(REAL_TEXTURE)["tex"]
    digest = hashlib.sha256(tex.tobytes()).hexdigest()
    if digest != REAL_TEXTURE_SHA256:
        raise ValueError(f"{REAL_TEXTURE}: sha256 {digest}, not {REAL_TEXTURE_SHA256}")
    return tex.astype(np.float32) / 255.0


def draw(
    rng,
    num_views: int = 8,
    img_hw=(240, 320),
    f: float = 400.0,
    orbit_step_deg: float = 10.0,
    tex_size: int = 512,
    orbit_radius: float = 7.0,
    layout: str = "box",
    textures: str = "noise",
) -> dict:
    """Every random draw of a scene, and its camera and poses."""
    H, W = img_hw
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]])
    center = np.array([0.0, 0.0, 7.0])

    real_tex = real_photo_texture(tex_size) if textures == "real" else None

    def smooth_texture():
        if real_tex is not None:
            t = np.roll(real_tex,
                        (int(rng.integers(0, tex_size)),
                         int(rng.integers(0, tex_size))), axis=(0, 1))
            if rng.uniform() < 0.5:
                t = t[:, ::-1]
            if rng.uniform() < 0.5:
                t = t[::-1]
            return np.ascontiguousarray(t)

        def blocks(n):
            g = rng.uniform(0, 1, (n, n))
            r = tex_size // n
            return np.repeat(np.repeat(g, r, axis=0), r, axis=1)

        return np.clip(0.15 + 0.5 * blocks(64) + 0.35 * blocks(16), 0, 1)

    # "box": textured box and ground; "wall": one dominant plane; "doppel":
    # the box with opposite faces sharing one texture (repeated structure)
    h = 1.8
    box = [
        (center + [-h, -h, -h], [2 * h, 0, 0], [0, 2 * h, 0]),   # front (-z)
        (center + [-h, -h, h], [2 * h, 0, 0], [0, 2 * h, 0]),    # back (+z)
        (center + [-h, -h, -h], [0, 0, 2 * h], [0, 2 * h, 0]),   # left (-x)
        (center + [h, -h, -h], [0, 0, 2 * h], [0, 2 * h, 0]),    # right (+x)
        (center + [-h, -h, -h], [2 * h, 0, 0], [0, 0, 2 * h]),   # top (-y)
        (center + [-4.5, 2.2, -4.5], [9.0, 0, 0], [0, 0, 9.0]),  # ground
    ]
    if layout == "wall":
        specs = [(center + [-4.0, -3.0, h], [8.0, 0, 0], [0, 6.0, 0])]
        tex_list = [smooth_texture()]
    elif layout == "doppel":
        t_fb, t_lr, t_top, t_gnd = (smooth_texture() for _ in range(4))
        specs = box
        tex_list = [t_fb, t_fb, t_lr, t_lr, t_top, t_gnd]
    else:
        specs = box
        tex_list = [smooth_texture() for _ in specs]
    planes = [(np.asarray(O, float), np.asarray(U, float), np.asarray(V, float), tex)
              for (O, U, V), tex in zip(specs, tex_list)]

    poses = []
    for v in range(num_views):
        a = np.radians(orbit_step_deg) * v
        c = center + orbit_radius * np.array([np.sin(a), 0.0, -np.cos(a)])
        z = center - c
        z = z / np.linalg.norm(z)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        poses.append((R, -R @ c))
    return {"K": K, "poses": poses, "X": None, "planes": planes, "img_hw": (H, W)}


def view(scene: dict, v: int) -> np.ndarray:
    """View ``v`` of a drawn scene, float32 in [0, 1]."""
    H, W = scene["img_hw"]
    R, t = scene["poses"][v]
    uu, vv = np.meshgrid(np.arange(W, dtype=float), np.arange(H, dtype=float))
    pix = np.stack([uu.ravel(), vv.ravel(), np.ones(H * W)], axis=1)
    Kinv = np.linalg.inv(scene["K"])
    c = -R.T @ t
    rays = (pix @ Kinv.T) @ R          # (HW, 3) world directions
    img = np.zeros(H * W)
    depth = np.full(H * W, np.inf)
    for O, U, V, tex in scene["planes"]:
        A = np.empty((H * W, 3, 3))
        A[:, :, 0] = U
        A[:, :, 1] = V
        A[:, :, 2] = -rays
        rhs = np.broadcast_to(c - O, (H * W, 3))[..., None]   # (HW, 3, 1)
        try:
            sol = np.linalg.solve(A, rhs)[..., 0]
        except np.linalg.LinAlgError:
            continue
        a_, b_, s_ = sol[:, 0], sol[:, 1], sol[:, 2]
        hit = (a_ >= 0) & (a_ <= 1) & (b_ >= 0) & (b_ <= 1) & (s_ > 0.1)
        hit &= s_ < depth
        if not hit.any():
            continue
        ta = np.clip(a_[hit] * (tex.shape[1] - 1), 0, tex.shape[1] - 1.001)
        tb = np.clip(b_[hit] * (tex.shape[0] - 1), 0, tex.shape[0] - 1.001)
        i0 = tb.astype(int)
        j0 = ta.astype(int)
        db = tb - i0
        da = ta - j0
        val = (tex[i0, j0] * (1 - da) * (1 - db)
               + tex[i0, j0 + 1] * da * (1 - db)
               + tex[i0 + 1, j0] * (1 - da) * db
               + tex[i0 + 1, j0 + 1] * da * db)
        img[hit] = val
        depth[hit] = s_[hit]
    return img.reshape(H, W).astype(np.float32)


def render(rng, **kw):
    """The original's ``render_planes(rng, **kw)``, one view after another."""
    scene = draw(rng, **kw)
    images = [view(scene, v) for v in range(len(scene["poses"]))]
    return images, scene["K"], scene["poses"], scene["X"]
