"""The port's I/O layer against the JAX package's: the native loader (built by the port
from ``native/vo_loader.cpp``), the PIL reader, pose files and the config reader.

The frames are those of tests/test_torch_engine.py (rendered, 240 x 320), written to a
directory as RGB PNG + fp32 metre npy, and as 8-bit gray PNG + ``<u2`` millimetre npy
(the port's standard-library writer). Batches, files and configs must be equal.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from vo_tpu import config as jconfig
from vo_tpu.io import dataset as jdataset
from vo_tpu.io import native as jnative
from vo_tpu.io import poses as jposes
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch import config as tconfig
from vo_tpu_torch.io import dataset as tdataset
from vo_tpu_torch.io import native as tnative
from vo_tpu_torch.io import poses as tposes
from vo_tpu_torch.ops import kernels as tkernels
from vo_tpu_torch.port_state import config_from_jax

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def frames():
    imgs, deps, gt = render_sequence(10, K, H=240, W=320, step=0.8, yaw_rate=0.01)
    return imgs, deps, gt


@pytest.fixture(scope="module")
def rgb_dir(frames, tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("rgb_seq")
    imgs, deps, _ = frames
    for i, (g, dep) in enumerate(zip(imgs, deps)):
        rgb = np.stack([g, g * 0.9, g * 0.8], -1).clip(0, 255).astype(np.uint8)
        Image.fromarray(rgb).save(d / f"{i:06d}.png")
        np.save(d / f"{i:06d}_depth.npy", dep)
    return str(d)


@pytest.fixture(scope="module")
def gray_dir(frames, tmp_path_factory):
    d = tmp_path_factory.mktemp("gray_seq")
    imgs, deps, _ = frames
    tdataset.write_gray_u16mm_dir(str(d), imgs, deps)
    return str(d)


def _all_batches(it):
    return [(s, np.array(a), np.array(b)) for s, a, b in it]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (s1, a1, b1), (s2, a2, b2) in zip(got, want):
        assert s1 == s2
        assert a1.dtype == a2.dtype and b1.dtype == b2.dtype
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)


@pytest.mark.parametrize("fmt", [dict(gray=False, depth="f32"),
                                 dict(gray=True, depth="u16mm")], ids=["rgb_f32", "gray_u16mm"])
@pytest.mark.parametrize("which", ["rgb_dir", "gray_dir"])
def test_native_batches_equal_jax(request, fmt, which):
    d = request.getfixturevalue(which)
    assert jnative.native_available()
    for batch, limit in ((4, 0), (3, 7)):
        t = tnative.NativeRGBDSequence.try_open(d)
        j = jnative.NativeRGBDSequence.try_open(d)
        assert (len(t), t.H, t.W) == (len(j), j.H, j.W) == (10, 240, 320)
        _assert_batches_equal(_all_batches(t.iter_batches(batch, limit=limit, **fmt)),
                              _all_batches(j.iter_batches(batch, limit=limit, **fmt)))
        t.close()
        j.close()


def test_native_next_frame_and_cursor(rgb_dir):
    """next_frame() advances the shared cursor, and iter_batches starts from it with
    absolute frame indices (the JAX loader's contract)."""
    t = tnative.NativeRGBDSequence.try_open(rgb_dir)
    j = jnative.NativeRGBDSequence.try_open(rgb_dir)
    for _ in range(3):
        (a1, b1), (a2, b2) = t.next_frame(), j.next_frame()
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)
    _assert_batches_equal(_all_batches(t.iter_batches(4)), _all_batches(j.iter_batches(4)))
    assert t.next_frame() is None


@pytest.mark.parametrize("which", ["rgb_dir", "gray_dir"])
def test_python_reader_equal_jax_and_native(request, which):
    d = request.getfixturevalue(which)
    t = tdataset.RGBDSequence.from_dir(d)
    j = jdataset.RGBDSequence.from_dir(d)
    assert len(t) == len(j) == 10
    got = _all_batches(t.iter_batches(4))
    _assert_batches_equal(got, _all_batches(j.iter_batches(4)))
    nat = _all_batches(tnative.NativeRGBDSequence.try_open(d).iter_batches(4))
    _assert_batches_equal(got, nat)


def test_gray_writer_round_trip(frames, gray_dir):
    """The standard-library PNG writer's frames decode (PIL and the native loader) to
    the truncated uint8 image, and the depth to the rounded millimetres."""
    imgs, deps, _ = frames
    _, rgb, dep = next(tdataset.RGBDSequence.from_dir(gray_dir).iter_batches(10))
    want = np.clip(imgs, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(rgb[..., 0], want)
    np.testing.assert_array_equal(rgb[..., 2], want)
    mm = np.round(np.clip(deps, 0.0, 65.535) * 1000.0).astype(np.uint16)
    np.testing.assert_array_equal(dep, mm.astype(np.float32) * 1e-3)
    _, g, d16 = next(tnative.NativeRGBDSequence.try_open(gray_dir).iter_batches(
        10, gray=True, depth="u16mm"))
    np.testing.assert_array_equal(g, want)
    np.testing.assert_array_equal(d16, mm)


def test_try_open_none_only_where_vol_open_fails(tmp_path):
    assert tnative.NativeRGBDSequence.try_open(str(tmp_path)) is None   # no pairs
    (tmp_path / "000000.png").write_bytes(b"not a png at all")
    np.save(tmp_path / "000000_depth.npy", np.zeros((4, 4), np.float32))
    assert tnative.NativeRGBDSequence.try_open(str(tmp_path)) is None   # bad first PNG


def test_decode_failure_raises(gray_dir, tmp_path):
    d = tmp_path / "seq"
    shutil.copytree(gray_dir, d)
    (d / "000005.png").write_bytes(b"corrupt")
    t = tnative.NativeRGBDSequence.try_open(str(d))
    with pytest.raises(RuntimeError, match="decode failure rc=-3 at frame 5"):
        _all_batches(t.iter_batches(4))


def test_loader_builds_into_build_dir_and_rebuilds(tmp_path, monkeypatch):
    """The port builds its own library (never native/'s), named by its source's
    content, rebuilds it when the source changes, and raises with the compiler's output
    when the build fails."""
    lib = tnative.build_loader()
    assert os.path.exists(lib) and os.path.basename(os.path.dirname(lib)) == "_build"
    assert os.path.basename(lib).startswith("libvoloader_")

    src = tmp_path / "vo_loader.cpp"
    shutil.copy(tnative._SRC, src)
    monkeypatch.setattr(tnative, "_SRC", str(src))
    monkeypatch.setattr(tkernels, "BUILD_DIR", str(tmp_path / "build"))
    first = tnative.build_loader()
    stamp = os.path.getmtime(first)
    assert tnative.build_loader() == first and os.path.getmtime(first) == stamp
    src.write_text(src.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="building libvoloader failed(.|\n)*error"):
        tnative.build_loader()
    assert os.path.getmtime(first) == stamp          # the old library is left in place
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".tmp")]


def test_pose_files_equal_jax(frames, tmp_path):
    _, _, gt = frames
    poses = gt.astype(np.float32)
    for mod, tag in ((jposes, "j"), (tposes, "t")):
        mod.save_poses_npy(str(tmp_path / f"{tag}.npy"), poses)
        mod.write_kitti_txt(str(tmp_path / f"{tag}12.txt"), poses)
        mod.poses_npy_to_kitti_txt(str(tmp_path / f"{tag}.npy"), str(tmp_path / f"{tag}16.txt"))
        mod.kitti_gt_to_modified_txt(str(tmp_path / f"{tag}12.txt"))
    for name in ("{}.npy", "{}12.txt", "{}16.txt", "{}12_modified.txt"):
        a = (tmp_path / name.format("j")).read_bytes()
        assert a == (tmp_path / name.format("t")).read_bytes(), name
    np.testing.assert_array_equal(tposes.load_poses_npy(str(tmp_path / "t.npy")), poses)


YAMLS = {
    "orb_flow": """# the reference's keys, a flow list
vo_method: rgbd
feature_extractor: orb
image_path: /data/kitti/03   # trailing comment
camera_intrinsic_matrix: [721.53, 0.0, 609.55, 0.0, 721.53, 172.85, 0.0, 0.0, 1.0]
output_filename: global_poses
visualize_results: False
gt_txt_file_path:
poses_file_path: ~
""",
    "sift_block_pnp": """---
feature_extractor: sift
camera_intrinsic_matrix:
  - 718.856
  - 0
  - 607.1928
  - 0
  - 718.856
  - 185.2157
  - 0
  - 0
  - 1
max_keypoints: 2_048
extraction_batch: 8
octaves: 4
oriented: true
pnp_n_hypotheses: 512
pnp_min_inliers: 15
pnp_not_a_field: 3
kf_min_matches: 60
""",
    "r2d2_overrides": """feature_extractor: 'r2d2'
image_path: "/data/seq 05"
ratio: .8
matcher: ratio_mutual_nn
max_speed: 2.5
bad_pnp_limit: 5
output_filename: out's
""",
    "surf_multiline_flow": """feature_extractor: surf
camera_intrinsic_matrix: [260.0, 0.0, 160.0,
                          0.0, 260.0, 120.0,   # row 2
                          0.0, 0.0, 1.0]
pnp_reproj_thresh: 2.0
min_displacement_px: 2
visualize_results: yes
""",
    "empty": "# nothing but a comment\n",
}


@pytest.mark.parametrize("name", list(YAMLS))
def test_config_equal_jax(name, tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAMLS[name])
    j = jconfig.RunConfig.from_yaml(str(path))
    t = tconfig.RunConfig.from_yaml(str(path))
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name == "camera_intrinsic_matrix":
            assert tv.dtype == jv.dtype and tv.shape == (3, 3)
            np.testing.assert_array_equal(tv, jv)
        elif f.name == "vo":
            assert tv == config_from_jax(dataclasses.asdict(jv))
        else:
            assert tv == jv and type(tv) is type(jv), f.name
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


@pytest.mark.parametrize("text", ["pnp:\n  n_hypotheses: 512\n", "a: {b: 1}\n",
                                  "a: [1, [2, 3]]\n", "a: b: c\n", "- 1\n", "a: &x 1\n",
                                  "a: |\n  text\n"])
def test_config_reader_rejects_other_yaml(text):
    with pytest.raises(ValueError):
        tconfig.read_flat_yaml(text)
