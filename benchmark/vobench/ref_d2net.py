"""The D2-Net cell's weights and plain reference: D2-Net's multiscale extraction
(Dusmanu et al., CVPR 2019) written from the upstream's code, mihaidusmanu/d2-net:

- ``lib/model_test.py::DenseFeatureExtractionModule``: VGG16 to conv4_3 as the
  configuration's layer list states it (``nn.Conv2d`` with bias and padding, ReLU,
  ``MaxPool2d(2, 2)``, ``AvgPool2d(2, stride=1)``, conv4_x at dilation 2), then the
  ReLU of ``use_relu``;
- ``HardDetectionModule``: depthwise maximum, 3 x 3 ``max_pool2d`` local maximum, the
  edge test on the second differences, over every channel;
- ``HandcraftedLocalizationModule``: one Newton step from central differences, over
  every channel;
- ``lib/pyramid.py::process_multiscale``: the levels coarse to fine, the fused map,
  the banned mask, ``torch.nonzero``, the offset test, ``lib/utils.py::
  interpolate_dense_features`` and ``upscale_positions``, the scores;
- ``extract_features.py``: caffe preprocessing, keypoints as [x, y, 1/scale].

One frame at a time (``process_multiscale`` asserts a batch of one), in fp32 with TF32
off unless the caller turns it on. Nothing of the program is imported. Departures:

- each level keeps the best ``level_k`` (the configuration's) of its detections by
  score, as the program's fixed budget does; the upstream keeps all (the cell's
  budgets are set so that none is dropped);
- the filters of the two detection modules are applied as the sums they define, in
  the order of their taps, on the zero-padded map (the upstream's ``F.conv2d`` may
  order or transform the sum otherwise: a last-bit difference);
- a level with no keypoint still hands its map and mask on (the upstream ``continue``s
  past the hand-over: at the first level the next one then runs unfused, at a later one
  the deleted name raises);
- no ``extract_features.py`` resize: frames beyond ``max_edge`` or ``max_sum_edges``
  are refused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


def draw_weights(net: dict, seed: int, device) -> dict:
    """Seeded weights on ``device`` from one normal draw of a ``torch.Generator`` there:
    each convolution N(0, 2 / fan_in) (He), OIHW, in the layer list's order; biases 0."""
    convs = [l for l in net["layers"] if l["op"] == "conv"]
    shapes = [(l["out"], l["in"], l["k"], l["k"]) for l in convs]
    sizes = [o * i * kh * kw for o, i, kh, kw in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    return {"convs": [{"w": w.reshape(s) * (2.0 / (l["k"] * l["k"] * l["in"])) ** 0.5,
                       "b": torch.zeros(l["out"], dtype=torch.float32, device=device)}
                      for w, s, l in zip(torch.split(flat, sizes), shapes, convs)]}


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 255] -> (B, 3, H, W) fp32: ``preprocess_image(...,
    'caffe')``: fp32 pixels, BGR, minus the mean pixel in fp64, then fp32."""
    x = images_u8.to(torch.float32).permute(0, 3, 1, 2).flip(1).to(torch.float64)
    mean = torch.tensor(CAFFE_MEAN_BGR, dtype=torch.float64, device=x.device)
    return (x - mean[:, None, None]).to(torch.float32)


def forward(params: dict, net: dict, image: torch.Tensor, use_relu: bool = True,
            dtype=torch.float32) -> torch.Tensor:
    """The dense feature map (B, 512, h, w) of preprocessed (B, 3, H, W) images, the
    trunk in ``dtype``."""
    x = image.to(dtype)
    convs = iter(params["convs"])
    for l in net["layers"]:
        if l["op"] == "conv":
            p = next(convs)
            x = F.conv2d(x, p["w"].to(dtype), p["b"].to(dtype), padding=l["padding"],
                         dilation=l["dilation"])
            if l["relu"]:
                x = F.relu(x)
        elif l["op"] == "max_pool":
            x = F.max_pool2d(x, l["k"], stride=l["stride"])
        else:
            x = F.avg_pool2d(x, l["k"], stride=l["stride"])
    if use_relu:
        x = F.relu(x)
    return x.to(torch.float32)


def _taps(x: torch.Tensor):
    """(C, h, w) -> a function of (di, dj) giving the zero-padded map shifted by it."""
    h, w = x.shape[1:]
    p = F.pad(x, (1, 1, 1, 1))
    return lambda di, dj: p[:, 1 + di:1 + di + h, 1 + dj:1 + dj + w]


def _hessian(t):
    """dii [[0,1,0],[0,-2,0],[0,1,0]], dij 0.25 [[1,0,-1],[0,0,0],[-1,0,1]], djj its
    transpose: each the sum of its non-zero taps in row-major order."""
    dii = (t(-1, 0) + -2.0 * t(0, 0)) + t(1, 0)
    dij = ((0.25 * t(-1, -1) + -0.25 * t(-1, 1)) + -0.25 * t(1, -1)) + 0.25 * t(1, 1)
    djj = (t(0, -1) + -2.0 * t(0, 0)) + t(0, 1)
    return dii, dij, djj


def detect(x: torch.Tensor, edge_threshold: float) -> torch.Tensor:
    """``HardDetectionModule`` on one map (C, h, w) -> (C, h, w) bool."""
    is_depth_wise_max = x == torch.max(x, dim=0)[0]
    is_local_max = x == F.max_pool2d(x[None], 3, stride=1, padding=1)[0]
    dii, dij, djj = _hessian(_taps(x))
    det = dii * djj - dij * dij
    tr = dii + djj
    threshold = (edge_threshold + 1) ** 2 / edge_threshold
    is_not_edge = torch.min(tr * tr / det <= threshold, det > 0)
    return torch.min(is_depth_wise_max, torch.min(is_local_max, is_not_edge))


def localize(x: torch.Tensor) -> torch.Tensor:
    """``HandcraftedLocalizationModule`` on one map (C, h, w) -> (2, C, h, w) steps."""
    t = _taps(x)
    dii, dij, djj = _hessian(t)
    det = dii * djj - dij * dij
    inv_hess_00, inv_hess_01, inv_hess_11 = djj / det, -dij / det, dii / det
    di = -0.5 * t(-1, 0) + 0.5 * t(1, 0)
    dj = -0.5 * t(0, -1) + 0.5 * t(0, 1)
    step_i = -(inv_hess_00 * di + inv_hess_01 * dj)
    step_j = -(inv_hess_01 * di + inv_hess_11 * dj)
    return torch.stack([step_i, step_j], dim=0)


def interpolate_dense_features(pos: torch.Tensor, dense: torch.Tensor):
    """(2, N) [i, j] positions on a (C, h, w) map -> (descriptors (C, n), ids (n,)) of
    the positions whose four neighbouring cells lie inside the map."""
    _, h, w = dense.shape
    i, j = pos[0], pos[1]
    i_tl, j_tl = torch.floor(i).long(), torch.floor(j).long()
    i_br, j_br = torch.ceil(i).long(), torch.ceil(j).long()
    valid = (i_tl >= 0) & (j_tl >= 0) & (i_br < h) & (j_br < w)
    ids = torch.arange(pos.shape[1], device=pos.device)[valid]
    i_tl, j_tl, i_br, j_br, i, j = (v[ids] for v in (i_tl, j_tl, i_br, j_br, i, j))
    dist_i, dist_j = i - i_tl.float(), j - j_tl.float()
    w_top_left = (1 - dist_i) * (1 - dist_j)
    w_top_right = (1 - dist_i) * dist_j
    w_bottom_left = dist_i * (1 - dist_j)
    w_bottom_right = dist_i * dist_j
    descriptors = (w_top_left * dense[:, i_tl, j_tl] + w_top_right * dense[:, i_tl, j_br]
                   + w_bottom_left * dense[:, i_br, j_tl]
                   + w_bottom_right * dense[:, i_br, j_br])
    return descriptors, ids


def extract_frame(params: dict, config: dict, image: torch.Tensor, dtype=torch.float32) -> dict:
    """``process_multiscale`` on one preprocessed frame (1, 3, H, W): {"kp" (N, 3)
    [x, y, 1/scale], "desc" (N, 512), "score" (N,), "cell" (N, 4) [level, c, i, j]}."""
    net, ms = config["d2net"], config["multiscale"]
    _, _, h_init, w_init = image.shape
    if max(h_init, w_init) > ms["max_edge"] or h_init + w_init > ms["max_sum_edges"]:
        raise ValueError("the reference runs no extract_features.py resize")
    parts = {"kp": [], "desc": [], "score": [], "cell": []}
    previous = banned = None
    for idx, scale in enumerate(ms["scales"]):
        current = F.interpolate(image, scale_factor=scale, mode="bilinear", align_corners=True)
        _, _, h_level, w_level = current.shape
        dense = forward(params, net, current, net["use_relu"], dtype)
        _, _, h, w = dense.shape
        if previous is not None:
            dense = dense + F.interpolate(previous, size=[h, w], mode="bilinear",
                                          align_corners=True)
        detections = detect(dense[0], ms["edge_threshold"])[None]
        if banned is not None:
            banned = F.interpolate(banned.float(), size=[h, w]).bool()
            detections = torch.min(detections, ~banned)
            banned = torch.max(torch.max(detections, dim=1)[0].unsqueeze(1), banned)
        else:
            banned = torch.max(detections, dim=1)[0].unsqueeze(1)
        previous = dense
        fmap_pos = torch.nonzero(detections[0]).t()
        scores = dense[0, fmap_pos[0], fmap_pos[1], fmap_pos[2]] / (idx + 1)
        budget = ms["level_k"][idx]
        if scores.shape[0] > budget:
            keep = torch.sort(scores, descending=True, stable=True)[1][:budget]
            fmap_pos = fmap_pos[:, torch.sort(keep)[0]]
        displacements = localize(dense[0])
        d_i = displacements[0, fmap_pos[0], fmap_pos[1], fmap_pos[2]]
        d_j = displacements[1, fmap_pos[0], fmap_pos[1], fmap_pos[2]]
        mask = torch.min(torch.abs(d_i) < 0.5, torch.abs(d_j) < 0.5)
        fmap_pos = fmap_pos[:, mask]
        fmap_keypoints = fmap_pos[1:, :].float() + torch.stack([d_i[mask], d_j[mask]])
        raw, ids = interpolate_dense_features(fmap_keypoints, dense[0])
        fmap_pos, fmap_keypoints = fmap_pos[:, ids], fmap_keypoints[:, ids]
        keypoints = fmap_keypoints
        for _ in range(2):                                      # upscale_positions
            keypoints = keypoints * 2 + 0.5
        keypoints[0, :] *= h_init / h_level
        keypoints[1, :] *= w_init / w_level
        n = keypoints.shape[1]
        ones = torch.ones([1, n], device=image.device)
        keypoints = torch.cat([keypoints, ones * 1 / scale], dim=0)
        parts["kp"].append(keypoints[[1, 0, 2]].t())
        parts["desc"].append(F.normalize(raw, dim=0).t())
        parts["score"].append(dense[0, fmap_pos[0], fmap_pos[1], fmap_pos[2]] / (idx + 1))
        parts["cell"].append(torch.cat([torch.full_like(fmap_pos[:1], idx), fmap_pos]).t())
    return {k: torch.cat(v) for k, v in parts.items()}


def extract(params: dict, config: dict, images_u8: torch.Tensor, dtype=torch.float32) -> list:
    """(B, H, W, 3) uint8 frames -> one ``extract_frame`` dict a frame, on the host."""
    x = preprocess(images_u8)
    return [{k: v.cpu() for k, v in extract_frame(params, config, x[b:b + 1], dtype).items()}
            for b in range(x.shape[0])]
