"""Port parity: the public functions of the ported modules that the main path does not
call (camera model, SE(3) helpers, image ops, ``matches_to_pairs``,
``native_available``), the JAX package against the port on the same seeded numpy
inputs, on the CPU; and the port's API against the JAX package's, read from both
source trees with ``ast``: every module has its counterpart, every public name is
there, every public signature extends JAX's positional parameters (three deliberate
departures), and each of the 14 subpackages re-exports what JAX's does.

Tolerances and their reasons:
- elementwise formulas (projection, normalisation, distortion, visibility, dense
  back-projection, pose composition, point transforms, the box filter): 1e-6 relative
  (XLA's jitted CPU code contracts multiply-adds; the port's eager ops do not).
- ``chain_relative_poses``: 1e-5 (the prefix products are grouped in another order
  than ``lax.associative_scan``'s; 32 products of rotations).
- ``undistort_points``: 1e-4 px (8 fixed-point iterations of the above).
- ``avgpool2d``: 1e-6 relative (window sums in another order).
- ``bilinear_sample``, ``matches_to_pairs``, the masks: exact.
"""

import ast
import functools
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.geometry import camera as jcam
from vo_tpu.geometry import se3 as jse3
from vo_tpu.matching import matchers as jmatch
from vo_tpu.ops import image as jimg
from vo_tpu_torch.geometry import camera as tcam
from vo_tpu_torch.geometry import se3 as tse3
from vo_tpu_torch.geometry.so3 import so3_exp
from vo_tpu_torch.matching import matchers as tmatch
from vo_tpu_torch.ops import image as timg

K = np.array([[500.0, 0.0, 320.0], [0.0, 480.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
Kj, Kt = jnp.asarray(K), torch.from_numpy(K)


def _close(got, ref, rtol=1e-6, atol=0.0):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol or rtol * max(np.abs(ref).max(), 1e-30))


def _poses(rng, n):
    w = torch.from_numpy(rng.normal(0, 0.3, (n, 3)).astype(np.float32))
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = so3_exp(w).numpy()
    T[:, :3, 3] = rng.normal(0, 2.0, (n, 3))
    return T


ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "vo_tpu", ROOT / "vo_tpu_torch"
# JAX modules whose counterpart has another path, or none (ROADMAP queue 1, "Not to
# port": JAX's matmul-precision decorator is TF32 off in device.py).
COUNTERPART = {"ops/pallas_match.py": "ops/match.py", "ops/precision.py": None}
# The Pallas wrappers' names in ops/match.py. Their ``interpret`` (Pallas's interpret
# mode) has no counterpart: the port's wrappers take the plain version on CPU tensors.
RENAMED = {"top2_mutual_pallas": "top2_mutual",
           "ratio_mutual_nn_match_pallas": "ratio_mutual_nn_match_fused",
           "ratio_match_pallas": "ratio_match_fused"}
# Signatures that depart on purpose (ROADMAP section 3, "Deliberate departures").
SIGNATURE_DEPARTURES = {
    ("parallel/mesh.py", "make_mesh"),      # no devices: the mesh spans the process group
    ("utils/debug.py", "display_image"),    # out_dir required: there is no window
    ("utils/seg.py", "seg_train_step"),     # a torch.optim optimizer holds its own state
}
MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))
PORTED = [m for m in MODULES if COUNTERPART.get(m, m) is not None]
SUBPACKAGES = sorted(p.parent.name for p in JAX_PKG.glob("*/__init__.py"))


@functools.lru_cache(maxsize=None)
def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _port_path(module: str) -> pathlib.Path:
    return PORT_PKG / COUNTERPART.get(module, module)


def _is_public(name: str) -> bool:
    return not name.startswith("_") or name == "__version__"


def _defined(tree: ast.Module) -> dict:
    """Top-level names a module defines (functions, classes, assignments) -> node."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            out.update((t.id, node) for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return out


def _imported(tree: ast.Module) -> set:
    return {(a.asname or a.name).split(".")[0] for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom)) for a in node.names} - {
                "annotations"}


def _functions(tree: ast.Module) -> dict:
    """Public functions and public methods (with ``__init__`` and ``__call__``) of
    public classes -> their positional parameter names, ``self``/``cls`` dropped."""
    def positional(fn):
        names = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        return names[1:] if names[:1] in (["self"], ["cls"]) else names

    out = {}
    for name, node in _defined(tree).items():
        if not _is_public(name):
            continue
        if isinstance(node, ast.FunctionDef):
            out[name] = positional(node)
        elif isinstance(node, ast.ClassDef):
            out.update((f"{name}.{m.name}", positional(m)) for m in node.body
                       if isinstance(m, ast.FunctionDef)
                       and (_is_public(m.name) or m.name in ("__init__", "__call__")))
    return out


@pytest.mark.parametrize("module", MODULES)
def test_every_jax_module_has_its_counterpart(module):
    if COUNTERPART.get(module, module) is None:
        assert module == "ops/precision.py"
    else:
        assert _port_path(module).is_file(), module


@pytest.mark.parametrize("module", PORTED)
def test_public_names_are_ported(module):
    """Every public top-level name of a JAX module is bound in its counterpart."""
    port = _tree(_port_path(module))
    port_names = set(_defined(port)) | _imported(port)
    missing = [n for n in _defined(_tree(JAX_PKG / module))
               if _is_public(n) and RENAMED.get(n, n) not in port_names]
    assert not missing, missing


@pytest.mark.parametrize("module", PORTED)
def test_signatures_extend_the_jax_ones(module):
    """JAX's positional parameter names are a prefix of the port's, for every public
    function and method (a positional call written for JAX means the same), except
    the deliberate departures, which must still depart."""
    port = _functions(_tree(_port_path(module)))
    departs = set()
    for name, params in _functions(_tree(JAX_PKG / module)).items():
        got = port.get(RENAMED.get(name, name))
        if name in RENAMED:
            params = [p for p in params if p != "interpret"]
        if got is None or got[:len(params)] != params:
            departs.add((module, name))
    assert departs == {d for d in SIGNATURE_DEPARTURES if d[0] == module}


def test_version_is_the_jax_packages():
    import vo_tpu_torch

    jax_version = next(ast.literal_eval(n.value) for n in _tree(JAX_PKG / "__init__.py").body
                       if isinstance(n, ast.Assign) and n.targets[0].id == "__version__")
    assert vo_tpu_torch.__version__ == jax_version == "0.1.0"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports(sub):
    """Each subpackage re-exports every name the JAX package's ``__init__`` imports,
    defined in the port, and importing it builds no kernel."""
    from vo_tpu_torch.ops import kernels

    names = _imported(_tree(JAX_PKG / sub / "__init__.py"))
    tmod = importlib.import_module(f"vo_tpu_torch.{sub}")
    for name in names:
        assert hasattr(tmod, name), name
        assert getattr(tmod, name).__module__.startswith("vo_tpu_torch."), name
    assert len(SUBPACKAGES) == 14
    assert kernels._lib is None


def test_apply_patchnet_train_by_position():
    """``apply_patchnet(params, spec, images, True)`` is the train-mode forward in both
    packages (the JAX parameter order: ``train`` before ``compute_dtype``)."""
    import jax

    from vo_tpu.models import patchnet as jpatchnet
    from vo_tpu_torch.models import patchnet as tpatchnet
    from vo_tpu_torch.port_state import patchnet_params_from_jax

    jspec = jpatchnet.PatchNetSpec("t", jpatchnet._fast_quad_specs(1, 8), out_dim=8,
                                   upsample=2)
    tspec = tpatchnet.PatchNetSpec("t", tpatchnet._fast_quad_specs(1, 8), out_dim=8,
                                   upsample=2)
    params = jpatchnet.init_patchnet_params(jax.random.key(3), jspec)
    x = np.random.default_rng(92).normal(size=(2, 32, 48, 3)).astype(np.float32)
    jout = jpatchnet.apply_patchnet(params, jspec, jnp.asarray(x), True)
    tout = tpatchnet.apply_patchnet(
        patchnet_params_from_jax(jax.tree.map(np.asarray, params), "cpu"), tspec,
        torch.from_numpy(x), True)
    assert len(tout["bn_stats"]) == len(jout["bn_stats"]) > 0
    for k in ("descriptors", "reliability", "repeatability"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=0, atol=2e-5)


def test_project_normalize_unproject(rng):
    pts = np.concatenate([rng.uniform([-5, -3, 1], [5, 3, 40], (64, 3)),
                          [[1.0, 2.0, 0.0], [1.0, 2.0, -3.0]]]).astype(np.float32)
    (juv, jz), (tuv, tz) = jcam.project(jnp.asarray(pts), Kj), tcam.project(
        torch.from_numpy(pts), Kt)
    _close(tuv.numpy()[:-2], np.asarray(juv)[:-2])
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert np.isfinite(tuv.numpy()).all()
    kp = rng.uniform([0, 0], [640, 480], (3, 50, 2)).astype(np.float32)
    _close(tcam.normalize_kp(torch.from_numpy(kp), Kt).numpy(),
           jcam.normalize_kp(jnp.asarray(kp), Kj))
    back = tcam.unproject(tuv, tz, Kt).numpy()
    _close(back[:-2], pts[:-2], rtol=1e-5)


def test_depth_to_3d(rng):
    depth = rng.uniform(0.5, 30.0, (24, 32)).astype(np.float32)
    got = tcam.depth_to_3d(torch.from_numpy(depth), Kt).numpy()
    assert got.shape == (24, 32, 3)
    _close(got, jcam.depth_to_3d(jnp.asarray(depth), Kj))


def test_pinhole_camera():
    jc, tc = jcam.PinholeCamera.from_K(Kj), tcam.PinholeCamera.from_K(K)
    np.testing.assert_array_equal(tc.K.numpy(), np.asarray(jc.K))
    assert float(tc.fy) == float(jc.fy) == 480.0


def test_distortion_round_trip_and_parity(rng):
    coeffs = [-0.28, 0.07, 1e-4, -2e-4, 0.01]
    jd, td = jcam.Distortion.from_coeffs(coeffs), tcam.Distortion.from_coeffs(coeffs)
    kp = rng.uniform([80, 60], [560, 420], (200, 2)).astype(np.float32)
    jkd = jcam.distort_points(jnp.asarray(kp), Kj, jd)
    tkd = tcam.distort_points(torch.from_numpy(kp), Kt, td)
    _close(tkd.numpy(), jkd)
    xy = torch.from_numpy(rng.uniform(-0.5, 0.5, (50, 2)).astype(np.float32))
    _close(tcam.distort_normalized(xy, td).numpy(),
           jcam.distort_normalized(jnp.asarray(xy.numpy()), jd), rtol=1e-6, atol=1e-6)
    _close(tcam.undistort_normalized(xy, td, iters=5).numpy(),
           jcam.undistort_normalized(jnp.asarray(xy.numpy()), jd, iters=5), atol=1e-5)
    tku = tcam.undistort_points(tkd, Kt, td)
    _close(tku.numpy(), jcam.undistort_points(jkd, Kj, jd), atol=1e-4)
    np.testing.assert_allclose(tku.numpy(), kp, atol=5e-2)    # test_aux_utils.py's bar
    assert bool(tcam.Distortion.from_coeffs([0.0]).is_zero) and not bool(td.is_zero)
    assert tcam.Distortion.from_coeffs([0.1, 0.2]).k3 == 0.0


def test_visibility(rng):
    pts = np.array([[0.0, 0.0, 5.0], [0.0, 0.0, -5.0], [10.0, 0.0, 5.0],
                    [0.0, 0.0, 100.0]], np.float32)
    pts = np.concatenate([pts, rng.uniform([-20, -20, -5], [20, 20, 80], (200, 3))
                          .astype(np.float32)])
    for kw in ({}, {"z_near": 1.0, "z_far": 50.0}):
        got = tcam.are_visible(torch.from_numpy(pts), Kt, 640, 480, **kw).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcam.are_visible(
            jnp.asarray(pts), Kj, 640, 480, **kw)))
    assert got[:4].tolist() == [True, False, False, False]
    uv = rng.uniform(-20, 660, (300, 2)).astype(np.float32)
    for margin in (0.0, 10.0):
        np.testing.assert_array_equal(
            tcam.is_in_frame(torch.from_numpy(uv), 640, 480, margin).numpy(),
            np.asarray(jcam.is_in_frame(jnp.asarray(uv), 640, 480, margin)))


def test_se3_helpers(rng):
    A, B = _poses(rng, 5), _poses(rng, 5)
    np.testing.assert_array_equal(tse3.identity_pose().numpy(), np.asarray(jse3.identity_pose()))
    assert tse3.identity_pose(torch.float64).dtype == torch.float64
    _close(tse3.pose_compose(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
           jse3.pose_compose(jnp.asarray(A), jnp.asarray(B)))
    pts = rng.normal(0, 5, (5, 30, 3)).astype(np.float32)
    _close(tse3.transform_points(torch.from_numpy(pts), torch.from_numpy(A)).numpy(),
           jse3.transform_points(jnp.asarray(pts), jnp.asarray(A)), atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 7, 32])
def test_chain_relative_poses(rng, n):
    rel = _poses(rng, n)
    rel[:, :3, 3] *= 0.1
    init = _poses(rng, 1)[0]
    for kw in ({}, {"initial": init}):
        got = tse3.chain_relative_poses(torch.from_numpy(rel),
                                        **{k: torch.from_numpy(v) for k, v in kw.items()})
        ref = jse3.chain_relative_poses(jnp.asarray(rel),
                                        **{k: jnp.asarray(v) for k, v in kw.items()})
        _close(got.numpy(), ref, atol=1e-5)


def test_box_filter_avgpool_bilinear(rng):
    img = rng.uniform(0, 255, (2, 37, 50)).astype(np.float32)
    for size in (3, 5):
        _close(timg.box_filter(torch.from_numpy(img), size).numpy(),
               jimg.box_filter(jnp.asarray(img), size))
    for size in (2, 4):
        got = timg.avgpool2d(torch.from_numpy(img), size).numpy()
        assert got.shape == (2, 37 // size, 50 // size)
        _close(got, jimg.avgpool2d(jnp.asarray(img), size))
    xy = rng.uniform(-3, 53, (2, 100, 2)).astype(np.float32)
    xy[0, :4] = [[0, 0], [49, 36], [10.5, 7.25], [60, -5]]
    for f in range(2):
        np.testing.assert_array_equal(
            timg.bilinear_sample(torch.from_numpy(img[f]), torch.from_numpy(xy[f])).numpy(),
            np.asarray(jimg.bilinear_sample(jnp.asarray(img[f]), jnp.asarray(xy[f]))))


def test_matches_to_pairs(rng):
    a = np.sign(rng.normal(size=(60, 64))).astype(np.float32)
    b = np.concatenate([a[:40], np.sign(rng.normal(size=(30, 64)))]).astype(np.float32)
    j = jmatch.ratio_match(jnp.asarray(a), jnp.asarray(b), binary_dim=64)
    t = tmatch.ratio_match(torch.from_numpy(a), torch.from_numpy(b), binary_dim=64)
    pairs = tmatch.matches_to_pairs(t)
    np.testing.assert_array_equal(pairs, jmatch.matches_to_pairs(j))
    assert ((pairs[:, 0] == pairs[:, 1]) & (pairs[:, 0] < 40)).sum() == 40
    none = tmatch.MatchResult(torch.zeros(3, dtype=torch.int64), torch.zeros(3, dtype=torch.bool),
                              torch.zeros(3))
    assert tmatch.matches_to_pairs(none).shape == (0, 2)


def test_native_available():
    from vo_tpu.io.native import native_available as jnative
    from vo_tpu_torch.io.native import native_available

    assert native_available() is True       # the port builds the loader here (g++)
    assert isinstance(jnative(), bool)
