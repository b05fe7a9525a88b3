"""The streaming runner, its sparse-depth transfer and its checkpoints, against the JAX
package's ``run_offline_vo_streaming`` and against the port's in-memory run.

The frames and configuration are tests/test_torch_engine.py's (10 rendered frames,
240 x 320, 512 keypoints, 256 hypotheses), streamed in chunks of 4 (the last one
padded). Tolerances are that file's: per-frame diagnostics equal (n_inliers within 2),
poses within 5e-3 m / 1e-3 rad. Within the port, streaming gives the in-memory run's
results exactly, and a resumed run the uninterrupted one's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vo_tpu.engine import pipeline as jpipe
from vo_tpu.engine.vo import VOConfig as JVOConfig
from vo_tpu.estimation.pnp import PnPConfig as JPnPConfig
from vo_tpu.features.extractor import OrbLikeExtractor as JExtractor
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.engine import pipeline as tpipe
from vo_tpu_torch.port_state import config_from_jax

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
JCFG = JVOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
                 pnp=JPnPConfig(min_inliers=15, n_hypotheses=256))
JEX = JExtractor(max_kp=512)
CFG = config_from_jax(dataclasses.asdict(JCFG))
EX = config_from_jax(dataclasses.asdict(JEX))
F, B = 10, 4
MODES = ("float32", "uint16mm", "sparse")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its workers, and an
    oversubscribed thread pool made the port's runs here several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    imgs, deps, _ = render_sequence(F, K, H=240, W=320, step=0.8, yaw_rate=0.01)
    return imgs, deps


def _batches(frames, upto=F, depth_u16=False):
    imgs, deps = frames
    for s in range(0, upto, B):
        idx = np.arange(s, min(s + B, F))
        idx = np.concatenate([idx, np.full(B - len(idx), F - 1)])
        d = deps[idx]
        if depth_u16:   # a loader may hand over uint16 millimetres
            d = np.round(np.clip(d, 0, 65.535) * 1000).astype(np.uint16)
        yield s, imgs[idx], d


def _port(frames, n=F, upto=F, **kw):
    return tpipe.run_offline_vo_streaming(_batches(frames, upto, kw.pop("depth_u16", False)),
                                          n, K, vo_config=CFG, extractor=EX,
                                          device="cpu", **kw)


# Sparse depth transfer runs with sparse retention, so that one run checks both.
MODE_KW = {"float32": {}, "uint16mm": {}, "sparse": dict(retain="sparse", retain_stride=3)}


@pytest.fixture(scope="module")
def jax_runs(frames):
    """The JAX reference, computed once: one run per transfer mode."""
    return {m: jpipe.run_offline_vo_streaming(_batches(frames), F, K, vo_config=JCFG,
                                              extractor=JEX, transfer_depth=m,
                                              **MODE_KW[m])
            for m in MODES}


@pytest.fixture(scope="module")
def port_runs(frames):
    return {m: _port(frames, transfer_depth=m, **MODE_KW[m]) for m in MODES}


@pytest.fixture(scope="module")
def port_float32(port_runs):
    return port_runs["float32"]


def _assert_frames_agree(jposes, jdiag, tposes, tdiag, trans_tol=5e-3, rot_tol=1e-3):
    for f in ("n_matches", "accepted", "promoted_keyframe"):
        np.testing.assert_array_equal(np.asarray(getattr(tdiag, f)),
                                      np.asarray(getattr(jdiag, f)), err_msg=f)
    assert np.abs(np.asarray(tdiag.n_inliers, np.int64)
                  - np.asarray(jdiag.n_inliers, np.int64)).max() <= 2
    jposes, tposes = np.asarray(jposes, np.float64), np.asarray(tposes, np.float64)
    assert tposes.shape == jposes.shape
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() < trans_tol
    rot = np.linalg.norm(tposes[:, :3, :3] - jposes[:, :3, :3], axis=(1, 2)) / np.sqrt(2)
    assert rot.max() < rot_tol


def test_streaming_float32_equals_in_memory(frames, port_float32):
    imgs, deps = frames
    poses, diag, (feats, kp3d, rows) = port_float32
    mem_poses, mem_diag, (mem_feats, mem_kp3d) = tpipe.run_offline_vo(
        imgs, deps, K, vo_config=CFG, extractor=EX, extraction_batch=B,
        return_features=True, device="cpu")
    np.testing.assert_array_equal(poses, mem_poses)
    for a, b in zip(diag, mem_diag):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(rows, np.arange(F))     # padding rows never kept
    for a, b in zip(feats, mem_feats):
        assert torch.equal(a, b)
    assert torch.equal(kp3d, mem_kp3d)


@pytest.mark.parametrize("mode", MODES)
def test_streaming_matches_jax(jax_runs, port_runs, mode):
    poses, diag, (feats, kp3d, rows) = port_runs[mode]
    jposes, jdiag, (jfeats, jkp3d, jrows) = jax_runs[mode]
    _assert_frames_agree(jposes, jdiag, poses, diag)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(feats.kp.numpy(), np.asarray(jfeats.kp))
    np.testing.assert_allclose(kp3d.numpy(), np.asarray(jkp3d), rtol=1e-6, atol=1e-6)


def test_sparse_transfer_takes_uint16_depths(frames, port_runs):
    """Sparse mode gathers raw uint16 millimetres as they are, and gives the points and
    poses of the uint16mm mode exactly (same pixels, same quantisation)."""
    mm = port_runs["uint16mm"]
    sp = _port(frames, transfer_depth="sparse", depth_u16=True)
    np.testing.assert_array_equal(sp[0], mm[0])
    assert torch.equal(sp[2][1], mm[2][1])
    np.testing.assert_array_equal(port_runs["sparse"][0], mm[0])


def test_sparse_helpers_equal_jax(frames):
    imgs, deps = frames
    kp_j = jpipe.extract_and_kp_int16(JEX, imgs[:2])[1]
    feats, kp_t = tpipe.extract_and_kp_int16(EX, torch.from_numpy(imgs[:2]))
    assert kp_t.dtype == torch.int16
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
    d = deps[:2].copy()
    d[0, 100:140, 150:200] = np.nan                 # NaN -> 0 mm
    d[1, :50] = 80.0                                # beyond 65.535 m: clamps
    z = tpipe.gather_depth_u16mm(d, kp_t.numpy())
    np.testing.assert_array_equal(z, jpipe.gather_depth_u16mm(d, np.asarray(kp_j)))
    z_d = torch.from_numpy(z)
    np.testing.assert_array_equal(
        tpipe.backproject_sparse(feats.kp, z_d, torch.from_numpy(K)).numpy(),
        np.asarray(jpipe.backproject_sparse(np.asarray(feats.kp), z, K)))


def test_retain_sparse_rows_equal_jax(jax_runs, port_runs):
    poses, diag, (feats, kp3d, rows) = port_runs["sparse"]
    jposes, jdiag, (jfeats, _, jrows) = jax_runs["sparse"]
    np.testing.assert_array_equal(rows, jrows)
    assert rows[-1] == F - 1 and len(rows) < F
    np.testing.assert_array_equal(feats.kp.numpy(), np.asarray(jfeats.kp))
    np.testing.assert_array_equal(feats.valid.numpy(), np.asarray(jfeats.valid))
    assert kp3d.shape[0] == len(rows)


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(5)
    poses = torch.from_numpy(rng.normal(size=(3, 4, 4)).astype(np.float32))
    diag = tpipe.VOStepDiagnostics(
        n_matches=torch.tensor([5, 70000, 0], dtype=torch.int32),
        n_inliers=torch.tensor([3, 2, 0], dtype=torch.int32),
        accepted=torch.tensor([True, False, True]),
        promoted_keyframe=torch.tensor([False, True, False]),
        step_norm=torch.tensor([0.5, 1.25, 0.0]))
    packed = tpipe._pack_chunk_results(poses, diag)
    assert packed.shape == (3, 21) and packed.dtype == torch.float32
    p, d = tpipe._unpack_chunk_results(packed.numpy())
    np.testing.assert_array_equal(p, poses.numpy())
    for a, b in zip(d, diag):
        np.testing.assert_array_equal(a, b.numpy())
    jp, jd = jpipe._unpack_chunk_results(packed.numpy())
    for a, b in zip(d, jd):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_errors_propagate():
    def bad_batches():
        raise RuntimeError("decode exploded")
        yield  # pragma: no cover

    with pytest.raises(RuntimeError, match="decode exploded"):
        tpipe.run_offline_vo_streaming(bad_batches(), 4, K, device="cpu")
    with pytest.raises(ValueError, match="empty batch stream"):
        tpipe.run_offline_vo_streaming(iter(()), 4, K, device="cpu")
    for kw in ({"retain": "some"}, {"transfer_depth": "float16"}):
        with pytest.raises(ValueError):
            tpipe.run_offline_vo_streaming(iter(()), 4, K, device="cpu", **kw)


def test_stream_stats(frames):
    stats = {}
    _port(frames, upto=4, n=4, transfer_depth="sparse", stats=stats)
    imgs, _ = frames
    assert stats["chunks"] == 1 and stats["queue_wait_s"] >= 0.0
    assert stats["sync_wait_s"] == 0.0 and stats["engine_s"] > 0.0   # no device to wait on
    # no graph to replay, and PnP's bank and Gauss-Newton solves take the plain versions
    assert stats["engine_device_s"] == 0.0 and stats["gn_kernel_solves"] == 0
    assert stats["bank_kernel_calls"] == 0
    # up: the images and 512 uint16 depths per frame; down: int16 pixels + packed rows
    assert stats["h2d_bytes"] == B * imgs[0].nbytes + B * 512 * 2
    assert stats["d2h_bytes"] == B * 512 * 2 * 2 + (B - 1) * 21 * 4


def test_stream_stats_count_the_eager_extractions(frames):
    """Off CUDA every call of ``OrbLikeExtractor`` runs eagerly: the entry's ``stats``
    count one a chunk and no graph replay, over this call alone."""
    from vo_tpu_torch.features import extractor

    EX(frames[0][:B], device="cpu")               # a call outside the entry's
    before = dict(extractor.extract_counts)
    stats = {}
    _port(frames, upto=8, n=8, transfer_depth="sparse", stats=stats)
    assert stats["chunks"] == 2
    assert (stats["extract_eager_calls"], stats["extract_graph_replays"]) == (2, 0)
    assert extractor.extract_counts == {**before, "eager_calls": before["eager_calls"] + 2}


def _checkpoint_layout(path):
    with np.load(path) as blob:
        return {k: (blob[k].dtype, blob[k].shape) for k in blob.files}


def test_resume_equals_uninterrupted(frames, port_float32, tmp_path):
    ck = str(tmp_path / "vo.npz")
    _port(frames, n=8, upto=8, checkpoint_path=ck, checkpoint_every=4)
    nf, done, state = tpipe.load_vo_checkpoint(ck, device="cpu")
    assert nf == 8 and done.shape == (8, 4, 4)
    assert state.ref_desc.dtype == torch.bfloat16
    poses, diag, (feats, _, rows) = _port(frames, resume_from=ck)
    np.testing.assert_array_equal(poses, port_float32[0])
    assert diag.accepted.shape == port_float32[1].accepted.shape
    np.testing.assert_array_equal(diag.n_inliers[7:], port_float32[1].n_inliers[7:])
    assert not diag.accepted[:7].any()        # front-padding of the skipped frames
    np.testing.assert_array_equal(rows, np.arange(F))     # skipped chunks still retained


def test_checkpoints_cross_both_ways(frames, jax_runs, port_float32, tmp_path):
    """A port checkpoint has the JAX layout (keys, dtypes, shapes), loads in JAX's
    ``load_vo_checkpoint`` and JAX resumes from it; the port resumes from a JAX one."""
    ck_t, ck_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _port(frames, n=8, upto=8, checkpoint_path=ck_t, checkpoint_every=4)
    jpipe.run_offline_vo_streaming(_batches(frames, 8), 8, K, vo_config=JCFG, extractor=JEX,
                                   checkpoint_path=ck_j, checkpoint_every=4)
    assert _checkpoint_layout(ck_t) == _checkpoint_layout(ck_j)

    nf, done, jstate = jpipe.load_vo_checkpoint(ck_t)
    assert nf == 8 and jstate.ref_desc.dtype == np.dtype("bfloat16")
    jres = jpipe.run_offline_vo_streaming(_batches(frames), F, K, vo_config=JCFG,
                                          extractor=JEX, resume_from=ck_t)
    jfull = jax_runs["float32"]
    _assert_frames_agree(jfull[0], jfull[1], jres[0], jres[1]._replace(
        **{f: np.where(np.arange(F - 1) < 7, getattr(jfull[1], f), getattr(jres[1], f))
           for f in jres[1]._fields}))

    tres = _port(frames, resume_from=ck_j)
    _assert_frames_agree(jfull[0], jfull[1], tres[0], tres[1]._replace(
        **{f: np.where(np.arange(F - 1) < 7, getattr(jfull[1], f), getattr(tres[1], f))
           for f in tres[1]._fields}))
    np.testing.assert_allclose(tres[0], port_float32[0], rtol=0, atol=5e-3)
