"""The replay cell's plain reference: ORB-like extraction, sparse back-projection, the
ratio matcher and one step of the keyframe VO state machine, in plain torch.

It follows the definitions of the program's main path (Harris + upright 256-bit
BRIEF, 2048 keypoints; ``ratio_binary`` at 0.85 on Hamming distances; PnP-RANSAC with
a Kabsch and a DLT bank and a Gauss-Newton polish; the engine's gates) through the
frozen plain copies in ``ref_features`` and ``ref_geometry``. The match is a plain fp32
product of the +-1 descriptors, exact in fp32. Nothing of the program is imported.

``step`` judges one frame from a given keyframe state; ``run_drive`` runs the whole
drive with its own state, which is how the control takes the program's place.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vobench import ref_features as rf
from vobench import ref_geometry as rg

_NEG = -1e30


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """fp32 matrix products and convolutions with TF32 on (``tf32``) or off, restored
    on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def extract(gray_u8: torch.Tensor, ex: dict, dtype=torch.float32):
    """(B, H, W) uint8 frames -> kp (B, N, 2) fp32, desc (B, N, bits) +-1 bf16 (0 rows
    where invalid), valid (B, N); the filters run in ``dtype``."""
    gray = gray_u8.to(dtype)
    resp = rf.harris_response(gray)
    kp, _, valid = rf.detect_keypoints(resp, max_kp=ex["max_kp"], nms_size=ex["nms_size"],
                                       rel_threshold=ex["rel_threshold"],
                                       border=ex["border"], subpixel=False)
    desc = rf.gather_brief_descriptors(rf.dense_packed_brief(gray, bits=ex["bits"]), kp,
                                       valid, bits=ex["bits"])
    return kp, desc, valid


def backproject(kp: torch.Tensor, mm: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera points at the keypoints: the depth in millimetres at the keypoint's
    truncated pixel (clipped into the image), in metres, unprojected at the float
    keypoint. kp (B, N, 2), mm (B, H, W) int32 -> (B, N, 3)."""
    H, W = mm.shape[-2:]
    xi = kp[..., 0].to(torch.int64).clamp(0, W - 1)
    yi = kp[..., 1].to(torch.int64).clamp(0, H - 1)
    z = torch.gather(mm.reshape(mm.shape[0], H * W), 1, yi * W + xi)
    return rf.unproject(kp.to(torch.float32), z.to(torch.float32) * 1e-3, K)


def ratio_match(desc_a, desc_b, valid_a, valid_b, ratio: float, bits: int):
    """k = 2 nearest neighbours on Hamming distance + Lowe's ratio -> (idx, mask)."""
    sim = desc_a.to(torch.float32) @ desc_b.to(torch.float32).T
    sim = torch.where(valid_a[:, None] & valid_b[None, :], sim, _NEG)
    nn12 = torch.argmax(sim, dim=1)
    best = sim.gather(1, nn12[:, None])[:, 0]
    second = torch.amax(sim.scatter(1, nn12[:, None], _NEG), dim=1)
    d1, d2 = (bits - best) * 0.5, (bits - second) * 0.5
    mask = (d1 < ratio * d2) & valid_a & (best > _NEG * 0.5)
    return nn12, mask


def depth_valid(valid, kp3d, eng: dict):
    z = kp3d[..., 2]
    return valid & (z > eng["min_point_depth"]) & (z < eng["max_point_depth"])


def pnp_config(eng: dict) -> rg.PnPConfig:
    p = eng["pnp"]
    return rg.PnPConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in p.items()})


def step(eng: dict, K: torch.Tensor, ref: dict, cur: dict, frame_id: int) -> dict:
    """One frame against the keyframe state ``ref`` (kp, desc, valid, kp3d, pose (4, 4),
    id, bad_pnp) -> {"pose" (a tensor), "n_matches", "n_inliers", "accepted",
    "promoted", "bad_pnp"}."""
    dev = cur["kp"].device
    bits = cur["desc"].shape[-1]
    idx, mask = ratio_match(ref["desc"], cur["desc"], ref["valid"], cur["valid"],
                            eng["ratio"], bits)
    cur_kp = cur["kp"][idx]
    cur_3d = cur["kp3d"][idx]
    cur_3d_valid = depth_valid(cur["valid"], cur["kp3d"], eng)[idx]
    ref_3d_valid = depth_valid(ref["valid"], ref["kp3d"], eng)
    disp = torch.linalg.vector_norm(ref["kp"] - cur_kp, dim=-1)
    corr = mask & (disp >= eng["min_displacement_px"]) & ref_3d_valid
    n_matches = corr.sum().to(torch.int32)

    key = rg.fold_in(rg.key(eng["seed"], device=dev),
                     torch.tensor(frame_id, dtype=torch.int32, device=dev))
    pnp = rg.pnp_ransac(key, ref["kp3d"], cur_kp, corr, K, pnp_config(eng),
                        points_3d_cur=cur_3d, valid_cur=cur_3d_valid)
    rel = rg.pose_inverse(pnp.pose)
    step_norm = torch.linalg.vector_norm(rel[:3, 3])
    gap = torch.tensor(float(frame_id - ref["id"]), dtype=torch.float32, device=dev)
    accepted = pnp.ok & (step_norm <= eng["max_speed"] * torch.clamp(gap, min=1.0))
    chained = rg.orthonormalize_pose(ref["pose"] @ rel)
    pose = torch.where(accepted, chained, ref["pose"])
    bad = 0 if bool(accepted) else ref["bad_pnp"] + 1
    promote = accepted & ((n_matches < eng["kf_min_matches"])
                          | (pnp.n_inliers < eng["kf_min_inliers"])
                          | (step_norm > eng["kf_max_step"]))
    lost = bool(n_matches < eng["kf_min_matches"])
    limit = eng["bad_pnp_limit"]
    force = bad > limit and (lost or bad > 4 * limit)
    return {"pose": pose, "n_matches": int(n_matches), "n_inliers": int(pnp.n_inliers),
            "accepted": bool(accepted), "promoted": bool(promote) or force,
            "bad_pnp": bad}


def extract_drive(gray_u8: torch.Tensor, mm: torch.Tensor, K: torch.Tensor, ex: dict,
                  batch: int, dtype=torch.float32) -> dict:
    """Features and camera points of every frame, ``batch`` frames at a time."""
    parts = []
    for s in range(0, gray_u8.shape[0], batch):
        kp, desc, valid = extract(gray_u8[s:s + batch], ex, dtype)
        parts.append((kp, desc, valid, backproject(kp, mm[s:s + batch], K)))
    return {k: torch.cat([p[i] for p in parts]) for i, k in
            enumerate(("kp", "desc", "valid", "kp3d"))}


def run_drive(gray_u8: torch.Tensor, mm: torch.Tensor, K: torch.Tensor, config: dict,
              batch: int, dtype=torch.float32, tf32: bool = False) -> dict:
    """The whole drive through the reference with its own keyframe state, as the
    program's outputs are laid out: {"poses" (F, 4, 4), "diag" {name: (F-1,)},
    "feats" {kp, desc, valid, kp3d}}. ``dtype`` and ``tf32`` lower its precision (the
    control)."""
    eng, ex = config["engine"], config["extractor"]
    with matmul_precision(tf32):
        feats = extract_drive(gray_u8, mm, K, ex, batch, dtype)
        F = gray_u8.shape[0]
        frame = lambda i: {k: v[i] for k, v in feats.items()}
        ref = dict(frame(0), pose=torch.eye(4, device=K.device), id=0, bad_pnp=0)
        poses = [np.eye(4, dtype=np.float32)]
        diag = {k: [] for k in ("n_matches", "n_inliers", "accepted", "promoted_keyframe")}
        for i in range(1, F):
            out = step(eng, K, ref, frame(i), i)
            poses.append(out["pose"].cpu().numpy())
            for k, v in (("n_matches", out["n_matches"]), ("n_inliers", out["n_inliers"]),
                         ("accepted", out["accepted"]), ("promoted_keyframe", out["promoted"])):
                diag[k].append(v)
            ref = (dict(frame(i), pose=out["pose"], id=i, bad_pnp=out["bad_pnp"])
                   if out["promoted"] else dict(ref, bad_pnp=out["bad_pnp"]))
    return {"poses": np.stack(poses), "diag": {k: np.asarray(v) for k, v in diag.items()},
            "feats": feats}
