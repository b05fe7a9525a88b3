"""The R2D2 slice as a whole against the JAX package on the CPU: ``run_offline_vo``
with ``R2D2Extractor`` features and the ``ratio_mutual_nn`` matcher, and the
visualisation tools.

The engine run: tests/test_r2d2_e2e.py's configuration (K, 180 x 240 frames of
``render_sequence``, 512 keypoints, ``ratio_mutual_nn`` at 0.9, 256 hypotheses) over
8 frames of a turning drive, with the Fast network at full width and the JAX
package's seeded parameters carried across (no published weights are in the
repository), an fp32 trunk and thresholds 0: seeded heads clear none of the published
ones. Both packages must give equal matches and accepted flags, and poses within
5e-3 m / 1e-3 rad up to the first frame whose inlier count splits (ROADMAP.md section
3's convention; measured: no split, poses within 4e-6 m).

The visualisation tools are numpy + PIL copies of the JAX package's: their arrays
and the PNG files they write are byte-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.engine import VOConfig as JVOConfig
from vo_tpu.engine.pipeline import run_offline_vo as jrun_offline_vo
from vo_tpu.estimation import PnPConfig as JPnPConfig
from vo_tpu.evalkit import plotting as jplotting
from vo_tpu.models import patchnet as jpatchnet
from vo_tpu.models.r2d2_extractor import R2D2Extractor as JR2D2Extractor
from vo_tpu.utils import viz as jviz
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.engine.pipeline import run_offline_vo
from vo_tpu_torch.evalkit import plotting
from vo_tpu_torch.models import patchnet
from vo_tpu_torch.models.r2d2_extractor import R2D2Extractor
from vo_tpu_torch.port_state import config_from_jax, patchnet_params_from_jax
from vo_tpu_torch.utils import viz

K = np.array([[200.0, 0.0, 120.0], [0.0, 200.0, 90.0], [0.0, 0.0, 1.0]], np.float32)
F = 8
JCFG = JVOConfig(matcher="ratio_mutual_nn", ratio=0.90, kf_min_matches=60,
                 kf_min_inliers=30, pnp=JPnPConfig(min_inliers=12, n_hypotheses=256))
EX = dict(max_kp=512, rel_thr=0.0, rep_thr=0.0, score_thr=0.0, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_r2d2_engine_matches_jax():
    imgs, deps, gt = render_sequence(F, K, H=180, W=240, step=0.8, yaw_rate=0.01)
    params = jax.tree_util.tree_map(
        np.asarray, jpatchnet.init_patchnet_params(jax.random.key(0),
                                                   jpatchnet.FAST_QUAD_L2NET_CONFCFS))
    jex = JR2D2Extractor.from_params(jpatchnet.FAST_QUAD_L2NET_CONFCFS,
                                     jax.tree_util.tree_map(jnp.asarray, params), **EX)
    tex = R2D2Extractor.from_params(patchnet.FAST_QUAD_L2NET_CONFCFS,
                                    patchnet_params_from_jax(params, device="cpu"), **EX)
    jposes, jdiag = jrun_offline_vo(imgs, deps, K, vo_config=JCFG, extractor=jex)
    tposes, tdiag, (feats, _) = run_offline_vo(
        imgs, deps, K, vo_config=config_from_jax(dataclasses.asdict(JCFG)), extractor=tex,
        extraction_batch=4, return_features=True, device="cpu")
    assert feats.desc.shape == (F, 512, 128) and feats.desc.dtype == torch.bfloat16
    assert bool(feats.valid.all())
    for f in ("n_matches", "accepted", "promoted_keyframe"):
        np.testing.assert_array_equal(np.asarray(getattr(tdiag, f)),
                                      np.asarray(getattr(jdiag, f)), err_msg=f)
    assert tdiag.accepted.all() and tdiag.n_matches.min() > 20
    ji, ti = np.asarray(jdiag.n_inliers), np.asarray(tdiag.n_inliers)
    split = int(np.argmax(ji != ti)) if (ji != ti).any() else len(ji)
    held = slice(0, split + 1)
    np.testing.assert_allclose(tposes[held, :3, 3], jposes[held, :3, 3], rtol=0, atol=5e-3)
    rot = np.linalg.norm(tposes[held, :3, :3] - np.asarray(jposes)[held, :3, :3],
                         axis=(1, 2)) / np.sqrt(2)
    assert rot.max() < 1e-3
    # seeded weights: no accuracy claim, but the drive is followed (8 frames, 5.6 m)
    assert np.linalg.norm(tposes[-1, :3, 3] - gt[-1, :3, 3]) < 1.5


def test_viz_arrays_match_jax():
    np.testing.assert_array_equal(viz.make_color_wheel(), jviz.make_color_wheel())
    rng = np.random.default_rng(21)
    flow = rng.normal(0, 5, (40, 50, 2)).astype(np.float32)
    flow[0, 0] = np.nan
    flow[1, 1] = 1e8
    for max_mag in (None, 4.0):
        out = viz.flow_to_color(flow, max_mag)
        assert out.shape == (40, 50, 3) and out.dtype == np.uint8
        assert (out[0, 0] == 0).all() and (out[1, 1] == 0).all()    # unknown flow: black
        np.testing.assert_array_equal(out, jviz.flow_to_color(flow, max_mag))
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    for heat in (rng.uniform(size=(40, 50)), rng.uniform(size=(20, 25))):
        for alpha in (0.5, 0.2):
            np.testing.assert_array_equal(viz.heatmap_overlay(img, heat, alpha),
                                          jviz.heatmap_overlay(img, heat, alpha))


def test_viz_and_plot_files_match_jax(tmp_path):
    """The PIL outputs are byte-equal to the JAX package's; the matplotlib plots are
    written (their bytes carry matplotlib's metadata)."""
    rng = np.random.default_rng(22)
    img = rng.uniform(0, 255, (60, 80, 3)).astype(np.float32)
    rel, rep = rng.uniform(size=(30, 40)), rng.uniform(size=(60, 80))
    flow = rng.normal(0, 3, (60, 80, 2))
    kp = rng.uniform(5, 55, (30, 2)).astype(np.float32)
    valid = rng.uniform(size=30) > 0.3
    for pkg, d in ((viz, tmp_path / "t"), (jviz, tmp_path / "j")):
        d.mkdir()
        pkg.save_heatmaps(str(d / "hm"), img, rel, rep)
        pkg.save_flow_png(str(d / "flow.png"), flow)
    for pkg, d in ((plotting, tmp_path / "t"), (jplotting, tmp_path / "j")):
        pkg.draw_matches(str(d / "m.png"), img, img[..., 0], kp, kp[::-1], stride=3)
        pkg.draw_keypoints(str(d / "k.png"), img[..., 0], kp, valid)
    for name in ("hm_reliability.png", "hm_repeatability.png", "flow.png", "m.png",
                 "k.png"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    poses = np.stack([np.eye(4)] * 20)
    poses[:, 2, 3] = np.arange(20)
    p1 = plotting.plot_trajectories(str(tmp_path / "traj.png"), poses,
                                    {i: p for i, p in enumerate(poses)})
    p2 = plotting.plot_segment_errors(str(tmp_path / "seg.png"), {100: (0.03, 0.001),
                                                                  200: (0.02, 0.002)})
    for p in (p1, p2):
        assert (tmp_path / p).stat().st_size > 500
    np.testing.assert_array_equal(plotting._poses_to_xz(poses), jplotting._poses_to_xz(poses))
