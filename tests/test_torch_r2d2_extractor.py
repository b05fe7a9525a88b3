"""The port's R2D2 extractors and extract CLI against the JAX package's on the CPU.

The Fast network at full width with the JAX package's seeded parameters (BatchNorm
statistics perturbed), carried across by ``port_state.patchnet_params_from_jax``.
Its heads' biases are raised (reliability logit +4, repeatability +8) so that the
published thresholds (0.7 / 0.7, score > 0.85) keep some keypoints and cut others,
as trained weights do; seeded heads alone would leave almost none.

Tolerances: with an fp32 trunk the keypoints, their order and validity are equal,
scores within 1e-5 and descriptors (stored as bf16) within one bf16 ulp of their
value plus 1e-6 (the fp32 trunk's own noise on values near 0). With the default bf16
trunk each package rounds a near-tie its own way, so keypoints are compared as sets
(at least 90 % shared) and descriptors at the shared keypoints within 2e-2
(tests/test_torch_r2d2_model.py). The multiscale extractor runs
in fp32, but its one top-k over all levels ranks scores of different levels that tie
to 1e-7: keypoints (with their scale column) are compared as sets, where a near-tied
pair (within 1e-5) may swap places or straddle the cut; scores within 1e-5, and at
each shared keypoint the descriptor within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vo_tpu.models import multiscale as jms
from vo_tpu.models import patchnet as jpatchnet
from vo_tpu.models import port_weights as jport_weights
from vo_tpu.models.r2d2_extractor import R2D2Extractor as JR2D2Extractor
from vo_tpu.runners import extract as jextract
from vo_tpu_torch.io.dataset import _read_png_rgb
from vo_tpu_torch.models import multiscale, patchnet, port_weights
from vo_tpu_torch.models.r2d2_extractor import R2D2Extractor
from vo_tpu_torch.port_state import patchnet_params_from_jax
from vo_tpu_torch.runners import extract

SPEC = (jpatchnet.FAST_QUAD_L2NET_CONFCFS, patchnet.FAST_QUAD_L2NET_CONFCFS)
# tests/test_multiscale.py's configuration
CFG = dict(min_size=32, max_size=256, top_k=256, per_scale_k=128, rel_thr=0.0, rep_thr=0.0)


def seeded_params(spec, seed, heads=True):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray,
                                    jpatchnet.init_patchnet_params(jax.random.key(seed), spec))
    for layer in params["convs"]:
        if "bn_mean" in layer:
            layer["bn_mean"] = rng.normal(0, 0.1, layer["bn_mean"].shape).astype(np.float32)
            layer["bn_var"] = rng.uniform(0.5, 2.0, layer["bn_var"].shape).astype(np.float32)
    if heads:
        params["clf"]["b"] = np.array([0.0, 4.0], np.float32)
        params["sal"]["b"] = np.array([8.0], np.float32)
    return params


@pytest.fixture(scope="module")
def nets():
    params = seeded_params(SPEC[0], 7)
    return (jax.tree_util.tree_map(jnp.asarray, params),
            patchnet_params_from_jax(params, device="cpu"))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    rgb = rng.uniform(0, 255, (2, 61, 83, 3)).astype(np.float32)
    # some structure: smooth blobs over the noise
    yy, xx = np.mgrid[:61, :83]
    rgb += 60.0 * np.sin(xx / 5.0)[None, ..., None] * np.cos(yy / 7.0)[None, ..., None]
    rgb = np.clip(rgb, 0, 255)
    return {"rgb": rgb, "gray": rgb.mean(-1)}


def _extract_both(nets, imgs, **kw):
    jparams, tparams = nets
    jf = JR2D2Extractor.from_params(SPEC[0], jparams, **kw)(jnp.asarray(imgs))
    tf = R2D2Extractor.from_params(SPEC[1], tparams, **kw)(imgs, device="cpu")
    return jax.tree_util.tree_map(np.asarray, tuple(jf)), tf


CASES = {"gray, published thresholds": ("gray", {}),
         "rgb, published thresholds": ("rgb", {}),
         "rgb, thresholds 0": ("rgb", dict(rel_thr=0.0, rep_thr=0.0, score_thr=0.0)),
         "gray, score_mode rep": ("gray", dict(score_mode="rep", rep_thr=0.0,
                                               rel_thr=0.0, score_thr=0.5))}


@pytest.mark.parametrize("case", list(CASES))
def test_extractor_matches_jax_fp32_trunk(nets, frames, case):
    kind, kw = CASES[case]
    (jkp, jdesc, jscore, jvalid), tf = _extract_both(
        nets, frames[kind], max_kp=200, compute_dtype="float32", **kw)
    assert tf.desc.dtype == torch.bfloat16 and tf.desc.shape == (2, 200, 128)
    valid = tf.valid.numpy()
    np.testing.assert_array_equal(valid, jvalid)
    assert 0 < valid.sum() < valid.size            # the thresholds keep some and cut some
    np.testing.assert_array_equal(tf.kp.numpy(), jkp)
    np.testing.assert_allclose(tf.score.numpy(), jscore, rtol=0, atol=1e-5)
    jd, td = np.asarray(jdesc, np.float32), tf.desc.float().numpy()
    assert (np.abs(td - jd) <= np.abs(jd) * 2.0 ** -7 + 1e-6).all()
    assert (td[~valid] == 0).all() and (tf.kp.numpy()[~valid] == 0).all()


def test_extractor_bf16_trunk_keypoint_sets(nets, frames):
    (jkp, jdesc, _, jvalid), tf = _extract_both(nets, frames["rgb"], max_kp=200,
                                                rel_thr=0.0, rep_thr=0.0, score_thr=0.0)
    for b in range(2):
        jset = {tuple(p): i for i, p in enumerate(jkp[b][jvalid[b]])}
        tvalid = tf.valid[b].numpy()
        tset = {tuple(p): i for i, p in enumerate(tf.kp[b].numpy()[tvalid])}
        shared = set(jset) & set(tset)
        assert len(shared) >= 0.9 * max(len(jset), len(tset)) > 0
        jd = np.asarray(jdesc[b], np.float32)[jvalid[b]]
        td = tf.desc[b].float().numpy()[tvalid]
        for p in shared:
            np.testing.assert_allclose(td[tset[p]], jd[jset[p]], rtol=0, atol=2e-2)


def test_quad_extractor_matches_jax(frames):
    params = seeded_params(jpatchnet.QUAD_L2NET_CONFCFS, 8)
    jf = JR2D2Extractor.from_params(jpatchnet.QUAD_L2NET_CONFCFS,
                                    jax.tree_util.tree_map(jnp.asarray, params),
                                    max_kp=128, compute_dtype="float32")(frames["gray"][:1])
    tf = R2D2Extractor.from_params(patchnet.QUAD_L2NET_CONFCFS,
                                   patchnet_params_from_jax(params, device="cpu"),
                                   max_kp=128, compute_dtype="float32")(frames["gray"][:1],
                                                                         device="cpu")
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(tf.kp.numpy(), np.asarray(jf.kp))


def test_pyramid_scales_match_jax():
    for hw in ((128, 96), (96, 128), (376, 1232), (512, 2048), (61, 83)):
        for cfg in (dict(), CFG, dict(min_size=32, max_size=1024, scale_f=2 ** 0.5)):
            assert multiscale.pyramid_scales(*hw, multiscale.MultiscaleConfig(**cfg)) == \
                jms.pyramid_scales(*hw, jms.MultiscaleConfig(**cfg))
            for s in jms.pyramid_scales(*hw, jms.MultiscaleConfig(**cfg)):
                assert multiscale._level_hw(*hw, s) == jms._level_hw(*hw, s)


def _assert_same_keypoints(j, t):
    """``j`` and ``t``: (kp (N, 3), desc (N, D), score (N,)) of the valid rows. Equal
    scores to 1e-5 (each sorted); the same keypoints but where near-tied scores (within
    1e-5) swap places or straddle the budget's cut; at each shared keypoint the same
    score and descriptor."""
    (jkp, jd, jscore), (tkp, td, tscore) = j, t
    assert len(jkp) == len(tkp) > 0
    np.testing.assert_allclose(np.sort(tscore), np.sort(jscore), rtol=0, atol=1e-5)
    jk = {tuple(k): i for i, k in enumerate(jkp)}
    tk = {tuple(k): i for i, k in enumerate(tkp)}
    cut = jscore.min()
    for k in jk.keys() - tk.keys():
        assert jscore[jk[k]] <= cut + 1e-5, k
    for k in tk.keys() - jk.keys():
        assert tscore[tk[k]] <= cut + 1e-5, k
    for k in jk.keys() & tk.keys():
        assert abs(jscore[jk[k]] - tscore[tk[k]]) <= 1e-5
        np.testing.assert_allclose(td[tk[k]], jd[jk[k]], rtol=0, atol=1e-5)


def _assert_multiscale_equal(jf, tf):
    jvalid = np.asarray(jf.valid)
    np.testing.assert_array_equal(tf.valid.numpy(), jvalid)
    for b, v in enumerate(jvalid):
        _assert_same_keypoints([np.asarray(x[b])[v] for x in (jf.kp, jf.desc, jf.score)],
                               [x[b].numpy()[v] for x in (tf.kp, tf.desc, tf.score)])


@pytest.mark.parametrize("shape", [(2, 96, 128, 3), (1, 63, 81)])
def test_extract_multiscale_matches_jax(nets, shape, tmp_path):
    jparams, tparams = nets
    imgs = np.random.default_rng(12).uniform(0, 255, shape).astype(np.float32)
    jf = jms.extract_multiscale(jparams, SPEC[0], imgs, jms.MultiscaleConfig(**CFG))
    tf = multiscale.extract_multiscale(tparams, SPEC[1], imgs,
                                       multiscale.MultiscaleConfig(**CFG), device="cpu")
    assert tf.kp.shape == (shape[0], 256, 3) and tf.desc.shape == (shape[0], 256, 128)
    _assert_multiscale_equal(jf, tf)
    scales = {np.float32(32.0 / s) for s in multiscale.pyramid_scales(
        shape[1], shape[2], multiscale.MultiscaleConfig(**CFG))}
    kp = tf.kp.numpy()[tf.valid.numpy()]
    assert set(np.unique(kp[:, 2])) <= scales and len(np.unique(kp[:, 2])) >= 2
    # the reference's .r2d2 npz layout, written by both packages
    size = (shape[2], shape[1])
    jpath = jms.save_r2d2_npz(str(tmp_path / "j.r2d2"), jf, imsize=size)
    tpath = multiscale.save_r2d2_npz(str(tmp_path / "t.r2d2"), tf, imsize=size)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(j.files) == sorted(t.files)
        np.testing.assert_array_equal(t["imsize"], j["imsize"])
        _assert_same_keypoints(*([f["keypoints"], f["descriptors"], f["scores"]]
                                 for f in (j, t)))
        assert (np.diff(t["scores"]) >= 0).all()


@pytest.mark.parametrize("model, arch", [
    ("faster2d2_WASF_N16", "Fast_Quad_L2Net_ConfCFS()"),
    ("r2d2_WASF_N16", "Quad_L2Net_ConfCFS()"),
])
def test_extract_cli_matches_jax(tmp_path, monkeypatch, model, arch):
    """Both CLIs on the same PNGs (two sizes, one listed in a .txt), each reading the
    same seeded checkpoint of the published network ``arch`` in the published layout
    (the port's from ``port_weights.MODELS_DIR``); the port's features are also
    ``extract_multiscale``'s, and it writes the kapture tree."""
    spec = jport_weights.ARCH_TO_SPEC[arch]
    tspec = port_weights.ARCH_TO_SPEC[arch]
    tparams = patchnet_params_from_jax(seeded_params(spec, 9, heads=False), device="cpu")
    weights = tmp_path / "weights"
    weights.mkdir()
    state = patchnet.PatchNet(tspec, tparams).state_dict()
    torch.save({"net": arch, "state_dict": {f"module.{k}": v for k, v in state.items()}},
               weights / f"{model}.pt")
    monkeypatch.setattr(port_weights, "MODELS_DIR", str(weights))
    monkeypatch.setattr("vo_tpu.models.port_weights.load_pretrained",
                        lambda name: jport_weights.load_torch_checkpoint(
                            str(weights / f"{name}.pt")))
    rng = np.random.default_rng(13)
    paths = []
    for i, hw in enumerate([(64, 80), (64, 80), (57, 71)]):
        p = tmp_path / "imgs" / f"im{i}.png"
        p.parent.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths[1:]) + "\n\n")
    assert extract.expand_image_list([paths[0], str(lst)]) == paths
    flags = ["--images", paths[0], str(lst), "--min-size", "32", "--top-k", "64",
             "--reliability-thr", "0", "--repeatability-thr", "0", "--batch", "2"]
    flags += ["--model", model]
    assert jextract.main(flags + ["--tag", "jax"]) == 0
    kroot = str(tmp_path / "kapture")
    assert extract.main(flags + ["--tag", "port", "--device", "cpu", "--kapture-root",
                                 kroot, "--kapture-image-root", str(tmp_path)]) == 0
    cfg = multiscale.MultiscaleConfig(min_size=32, top_k=64, rel_thr=0.0, rep_thr=0.0)
    for group in ([0, 1], [2]):     # the CLI's batches: one size, --batch 2
        imgs = np.stack([_read_png_rgb(paths[i]) for i in group])
        feats = multiscale.extract_multiscale(tparams, tspec, imgs, cfg, device="cpu")
        for b, i in enumerate(group):
            multiscale.save_r2d2_npz(paths[i] + ".direct", feats,
                                     (imgs.shape[2], imgs.shape[1]), frame=b)
    for p in paths:
        with np.load(p + ".jax") as j, np.load(p + ".port") as t:
            np.testing.assert_array_equal(t["imsize"], j["imsize"])
            _assert_same_keypoints(*([f["keypoints"], f["descriptors"], f["scores"]]
                                     for f in (j, t)))
            with np.load(p + ".direct") as d:
                for k in ("imsize", "keypoints", "descriptors", "scores"):
                    np.testing.assert_array_equal(t[k], d[k], err_msg=k)
            rel = os.path.relpath(p, tmp_path)
            kp, desc = extract.load_kapture_features(kroot, "port", rel)
            np.testing.assert_array_equal(kp, t["keypoints"][np.argsort(-t["scores"],
                                                                        kind="stable")])
            assert desc.shape == t["descriptors"].shape


def test_kapture_round_trip_matches_jax(nets, tmp_path):
    """The port's kapture tree is byte-equal to the JAX package's for the same features,
    both readers parse it, and a path outside the image root is refused."""
    jparams, tparams = nets
    imgs = np.random.default_rng(14).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    tf = multiscale.extract_multiscale(tparams, SPEC[1], imgs,
                                       multiscale.MultiscaleConfig(**CFG), device="cpu")
    jf = jax.tree_util.tree_map(lambda t: np.asarray(t.numpy()), tuple(tf))
    jf = jms.MultiscaleFeatures(*jf)
    image = str(tmp_path / "seq" / "cam0" / "000001.png")
    for root, save in ((tmp_path / "t", extract.save_kapture_features),
                       (tmp_path / "j", jextract.save_kapture_features)):
        feats = tf if save is extract.save_kapture_features else jf
        save(str(root), "r2d2", image, feats, 1, image_root=str(tmp_path / "seq"))
    for sub in ("reconstruction/keypoints/r2d2/cam0/000001.png.kpt",
                "reconstruction/descriptors/r2d2/cam0/000001.png.desc",
                "reconstruction/keypoints/r2d2/keypoints.txt",
                "reconstruction/descriptors/r2d2/descriptors.txt"):
        assert (tmp_path / "t" / sub).read_bytes() == (tmp_path / "j" / sub).read_bytes()
    kp, desc = extract.load_kapture_features(str(tmp_path / "t"), "r2d2",
                                             "cam0/000001.png")
    jkp, jdesc = jextract.load_kapture_features(str(tmp_path / "t"), "r2d2",
                                                "cam0/000001.png")
    v = tf.valid[1].numpy()
    np.testing.assert_array_equal(kp, tf.kp[1].numpy()[v])
    np.testing.assert_array_equal(desc, tf.desc[1].numpy()[v])
    np.testing.assert_array_equal(kp, jkp)
    np.testing.assert_array_equal(desc, jdesc)
    with pytest.raises(ValueError, match="not under"):
        extract.save_kapture_features(str(tmp_path / "t"), "r2d2", "/elsewhere/x.png", tf, 0,
                                      image_root=str(tmp_path / "seq"))
    (tmp_path / "t/reconstruction/keypoints/r2d2/keypoints.txt").write_text("name\n")
    with pytest.raises(ValueError, match="kapture format"):
        extract.load_kapture_features(str(tmp_path / "t"), "r2d2", "cam0/000001.png")
