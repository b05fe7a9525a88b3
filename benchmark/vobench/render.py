"""The benchmark's own inputs: a textured plane world ray-cast from a camera path.

A frozen copy of the repository's synthetic renderer (numpy, float64, one frame per
call) and of its op-for-op torch version that renders a batch of frames on the card,
with the drives the cells replay. The inputs do not depend on the program: nothing
here imports it. Both renderers give the same frames to the last bit on a CPU; on the
card ``sin`` and ``exp`` in float64 may differ by a last bit, which moves a gray level
by far less than the uint8 quantisation that follows.

The seed draws the world's textures (``world``); the camera path, the resolution and
so the work per frame are the same for every seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BASE_SEED = 8214


@dataclass
class Plane:
    p0: np.ndarray      # a point on the plane
    n: np.ndarray       # unit normal, toward the cameras
    tex_seed: int
    fine_amp: float = 0.0


def texture(plane: Plane, u: np.ndarray, v: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    """Band-limited texture: 40 sinusoids of 0.3-6 rad/unit, plus, where ``fine_amp``
    is set and the world-space pixel footprint ``sigma`` is below 0.15, 16 analytically
    anti-aliased fine octaves."""
    rng = np.random.default_rng(plane.tex_seed)
    val = np.zeros_like(u)
    for _ in range(40):
        w = rng.uniform(0.3, 6.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(5, 25)
        val = val + amp * np.sin(w[0] * u + w[1] * v + phase)
    if plane.fine_amp > 0.0:
        live = sigma < 0.15
        if np.any(live):
            us, vs, ss = u[live], v[live], sigma[live]
            fine = np.zeros_like(us)
            for _ in range(16):
                w = np.exp(rng.uniform(np.log(20.0), np.log(300.0), 2))
                phase = rng.uniform(0, 2 * np.pi)
                amp = rng.uniform(4, 12) * plane.fine_amp
                att = np.exp(-0.5 * (w @ w) * ss * ss)
                fine = fine + amp * att * np.sin(w[0] * us + w[1] * vs + phase)
            val[live] += fine
    return 128.0 + val * 0.45


def world(seed: int | None = None, half_width: float = 8.0, far_z: float = 240.0,
          fine_amp: float = 0.0) -> list[Plane]:
    """The corridor: ground, two side walls and a far wall. ``seed`` None gives the
    repository's own world (texture seeds 8215-8218); a benchmark seed draws four
    texture seeds from itself."""
    if seed is None:
        tex = [_BASE_SEED + k for k in range(1, 5)]
    else:
        tex = [int(t) for t in np.random.default_rng(seed % 2 ** 63).integers(0, 2 ** 31, 4)]
    return [
        Plane(np.array([0.0, 1.6, 0.0]), np.array([0.0, -1.0, 0.0]), tex[0], fine_amp),
        Plane(np.array([-half_width, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]), tex[1], fine_amp),
        Plane(np.array([half_width, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0]), tex[2], fine_amp),
        Plane(np.array([0.0, 0.0, far_z]), np.array([0.0, 0.0, -1.0]), tex[3], fine_amp),
    ]


def plane_axes(n: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    return u, np.cross(n, u)


def render_numpy(T_wc: np.ndarray, K: np.ndarray, H: int, W: int, planes: list[Plane],
                 max_depth: float = 260.0) -> tuple[np.ndarray, np.ndarray]:
    """One frame from camera-to-world pose ``T_wc``: (gray (H, W) float32 in [0, 255],
    camera-frame depth (H, W) float32, 0 where no plane is hit)."""
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    dirs_w = (pix @ np.linalg.inv(K).T) @ T_wc[:3, :3].T
    o = T_wc[:3, 3]
    depth = np.full((H, W), np.inf)
    img = np.full((H, W), 40.0)
    fx = float(K[0, 0])
    dir_norm = np.linalg.norm(dirs_w, axis=-1)
    for pl in planes:
        denom = dirs_w @ pl.n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t = ((pl.p0 - o) @ pl.n) / denom
        hit = (t > 0.1) & (t < max_depth) & (t < depth)
        X = o + t[..., None] * dirs_w
        ax_u, ax_v = plane_axes(pl.n)
        u = (X - pl.p0) @ ax_u
        v = (X - pl.p0) @ ax_v
        cos_inc = np.clip(np.abs(denom) / dir_norm, 0.2, 1.0)
        sigma = np.abs(t) * dir_norm / fx / cos_inc
        img = np.where(hit, texture(pl, u, v, sigma), img)
        depth = np.where(hit, t, depth)
    depth = np.where(np.isinf(depth), 0.0, depth)
    return np.clip(img, 0, 255).astype(np.float32), depth.astype(np.float32)


def _texture_torch(plane: Plane, u, v, sigma):
    import torch

    rng = np.random.default_rng(plane.tex_seed)
    val = torch.zeros_like(u)
    for _ in range(40):
        w = rng.uniform(0.3, 6.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(5, 25)
        val = val + amp * torch.sin(float(w[0]) * u + float(w[1]) * v + float(phase))
    if plane.fine_amp > 0.0:
        live = sigma < 0.15
        if bool(live.any()):
            us, vs, ss = u[live], v[live], sigma[live]
            fine = torch.zeros_like(us)
            for _ in range(16):
                w = np.exp(rng.uniform(np.log(20.0), np.log(300.0), 2))
                phase = rng.uniform(0, 2 * np.pi)
                amp = rng.uniform(4, 12) * plane.fine_amp
                att = torch.exp(float(-0.5 * (w @ w)) * ss * ss)
                fine = fine + amp * att * torch.sin(float(w[0]) * us + float(w[1]) * vs
                                                    + float(phase))
            val[live] += fine
    return 128.0 + val * 0.45


def render_torch(poses: np.ndarray, K: np.ndarray, H: int, W: int, planes: list[Plane],
                 device, max_depth: float = 260.0,
                 batch: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """``render_numpy`` op for op in torch float64 on ``device``, ``batch`` frames per
    call -> (F, H, W) float32 images and depths on the host."""
    import torch

    f64 = dict(dtype=torch.float64, device=device)
    ys, xs = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    dirs_cam = pix @ torch.as_tensor(np.linalg.inv(K).T, **f64)
    fx = float(K[0, 0])
    imgs, deps = [], []
    for s in range(0, len(poses), batch):
        T = torch.as_tensor(np.asarray(poses[s:s + batch], np.float64), **f64)
        dirs_w = dirs_cam[None] @ T[:, None, :3, :3].transpose(-1, -2)
        o = T[:, None, None, :3, 3]
        depth = torch.full(dirs_w.shape[:3], float("inf"), **f64)
        img = torch.full(dirs_w.shape[:3], 40.0, **f64)
        dir_norm = torch.linalg.vector_norm(dirs_w, dim=-1)
        for pl in planes:
            n, p0 = torch.as_tensor(pl.n, **f64), torch.as_tensor(pl.p0, **f64)
            denom = dirs_w @ n
            denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
            t = ((p0 - o) @ n) / denom
            hit = (t > 0.1) & (t < max_depth) & (t < depth)
            X = o + t[..., None] * dirs_w
            ax_u, ax_v = plane_axes(pl.n)
            u = (X - p0) @ torch.as_tensor(ax_u, **f64)
            v = (X - p0) @ torch.as_tensor(ax_v, **f64)
            cos_inc = torch.clamp(denom.abs() / dir_norm, 0.2, 1.0)
            sigma = t.abs() * dir_norm / fx / cos_inc
            img = torch.where(hit, _texture_torch(pl, u, v, sigma), img)
            depth = torch.where(hit, t, depth)
        depth = torch.where(torch.isinf(depth), 0.0, depth)
        imgs.append(img.clamp(0, 255).float().cpu().numpy())
        deps.append(depth.float().cpu().numpy())
    return np.concatenate(imgs), np.concatenate(deps)


def slalom(n_frames: int, step: float = 0.8, yaw_amp: float = 0.2,
           period_m: float = 64.0) -> np.ndarray:
    """(F, 4, 4) camera-to-world poses of a forward drive whose heading swings as
    ``yaw_amp * sin(2 pi s / period_m)`` over arc length s."""
    poses = np.zeros((n_frames, 4, 4))
    pos = np.zeros(3)
    for i in range(n_frames):
        yaw = yaw_amp * np.sin(2 * np.pi * (i * step) / period_m)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos
        poses[i, 3, 3] = 1.0
        pos = pos + R @ np.array([0.0, 0.0, step])
    return poses


def depth_valid_fraction(depth: np.ndarray, lo: float = 0.0, hi: float = 50.0) -> np.ndarray:
    """Share of each frame's pixels whose depth the engine can use (0 < z < 50 m)."""
    return ((depth > lo) & (depth < hi)).mean(axis=(-2, -1))


def quantise(imgs: np.ndarray, deps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """What goes on disk: 8-bit gray (``clip`` then truncation) and uint16 millimetres
    (metres clipped to [0, 65.535] and rounded)."""
    gray = np.clip(imgs, 0, 255).astype(np.uint8)
    mm = np.round(np.clip(deps, 0.0, 65.535) * 1000.0).astype(np.uint16)
    return gray, mm


def render_drive(traffic: dict, config: dict, seed: int, device) -> dict:
    """The seed's drive as the traffic file and the camera of the configuration give
    it: {"gt" (F, 4, 4), "gray" (F, H, W) uint8, "mm" (F, H, W) uint16}. Raises when a
    frame leaves too little usable depth (a path that leaves the world)."""
    H, W = config["image_hw"]
    K = np.asarray(config["K"], np.float64)
    d = traffic["drive"]
    gt = slalom(traffic["frames"], d["step_m"], d["yaw_amp"], d["period_m"])
    planes = world(seed, d["half_width"], d["far_z"])
    imgs, deps = render_torch(gt, K, H, W, planes, device)
    dvf = depth_valid_fraction(deps)
    if float(dvf.min()) <= 0.5:
        raise RuntimeError(f"degenerate drive: depth-valid share {dvf.min():.3f} at frame "
                           f"{int(dvf.argmin())}")
    gray, mm = quantise(imgs, deps)
    return {"gt": gt, "gray": gray, "mm": mm}
