"""The port's R2D2 patchnet and checkpoint reader against the JAX package's on the CPU.

Both published architectures at full width (mchan 4, 128-d descriptors, all 9
convolutions) on a (2, 48, 64, 3) input, with the JAX package's seeded parameters
carried across by ``port_state.patchnet_params_from_jax``. The BatchNorm running
statistics and the biases are perturbed first (mean ~ N(0, 0.1), var ~ U(0.5, 2)):
at initialisation BN is nearly the identity, and a missing or swapped BN layer would
pass.

Tolerances: fp32, every output within 2e-5 (measured: 5e-6). bf16 trunk: each
package rounds every layer's output to bf16, and a value on a rounding boundary can
round either way (measured on 1e-5 of the first layer's outputs); the heads amplify
what propagates (each package's bf16 run is up to 0.05 from its fp32 run), so
descriptors are held within 1e-2, reliability and repeatability within 6e-2, and
the mean absolute differences within one bf16 ulp at 1.0 (2^-8; measured: up to
1.9e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.models import patchnet as jpatchnet
from vo_tpu.models import port_weights as jport_weights
from vo_tpu_torch import prng
from vo_tpu_torch.models import patchnet, port_weights
from vo_tpu_torch.port_state import patchnet_params_from_jax

SPECS = {"fast": (jpatchnet.FAST_QUAD_L2NET_CONFCFS, patchnet.FAST_QUAD_L2NET_CONFCFS),
         "quad": (jpatchnet.QUAD_L2NET_CONFCFS, patchnet.QUAD_L2NET_CONFCFS)}
ARCH = {"fast": "Fast_Quad_L2Net_ConfCFS()", "quad": "Quad_L2Net_ConfCFS()"}


def perturbed_jax_params(spec, seed):
    """The JAX package's He-initialised parameters as numpy arrays, with non-trivial
    biases and BatchNorm running statistics."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray,
                                    jpatchnet.init_patchnet_params(jax.random.key(seed), spec))
    for layer in params["convs"]:
        layer["b"] = rng.normal(0, 0.05, layer["b"].shape).astype(np.float32)
        if "bn_mean" in layer:
            layer["bn_mean"] = rng.normal(0, 0.1, layer["bn_mean"].shape).astype(np.float32)
            layer["bn_var"] = rng.uniform(0.5, 2.0, layer["bn_var"].shape).astype(np.float32)
    for head in ("clf", "sal"):
        params[head]["b"] = rng.normal(0, 0.1, params[head]["b"].shape).astype(np.float32)
    return params


def jax_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module", params=list(SPECS))
def net(request):
    jspec, tspec = SPECS[request.param]
    params = perturbed_jax_params(jspec, seed=len(request.param))
    x = np.random.default_rng(3).normal(size=(2, 48, 64, 3)).astype(np.float32)
    return request.param, jspec, tspec, params, x


def _outputs_close(jout, tout, tol):
    for k in ("descriptors", "reliability", "repeatability"):
        a, b = np.asarray(jout[k], np.float32), tout[k].numpy()
        assert a.shape == b.shape, k
        np.testing.assert_allclose(b, a, rtol=0, atol=tol[k], err_msg=k)
        if "mean" in tol:
            assert np.abs(a - b).mean() < tol["mean"], k


def test_layer_specs_equal():
    for jspec, tspec in SPECS.values():
        assert (tspec.name, tspec.out_dim, tspec.upsample) == \
            (jspec.name, jspec.out_dim, jspec.upsample)
        assert [(c.in_ch, c.out_ch, c.k, c.dilation, c.bn, c.relu, c.pool_after, c.pad)
                for c in tspec.convs] == \
            [(c.in_ch, c.out_ch, c.k, c.dilation, c.bn, c.relu, c.pool_after, c.pad)
             for c in jspec.convs]
    assert patchnet.BN_EPS == jpatchnet.BN_EPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_patchnet_matches_jax(net, dtype):
    name, jspec, tspec, params, x = net
    jout = jpatchnet.apply_patchnet(jax_tree(params), jspec, jnp.asarray(x),
                                    compute_dtype=jnp.dtype(dtype))
    tparams = patchnet_params_from_jax(params, device="cpu")
    tout = patchnet.apply_patchnet(tparams, tspec, torch.from_numpy(x), compute_dtype=dtype)
    assert tout["descriptors"].shape == (2, 48, 64, 128)    # Fast: pool by 2, upsample by 2
    if dtype == "float32":
        _outputs_close(jout, tout, dict.fromkeys(["descriptors", "reliability",
                                                  "repeatability"], 2e-5))
    else:
        _outputs_close(jout, tout, {"descriptors": 1e-2, "reliability": 6e-2,
                                    "repeatability": 6e-2, "mean": 2.0 ** -8})
    # the module runs the same forward on the same tensors
    mout = patchnet.PatchNet(tspec, tparams)(torch.from_numpy(x), compute_dtype=dtype)
    for k in tout:
        assert torch.equal(mout[k], tout[k]), k


def test_descriptors_unit_norm_and_heads_in_range(net):
    _, _, tspec, params, x = net
    out = patchnet.apply_patchnet(patchnet_params_from_jax(params, device="cpu"), tspec,
                                  torch.from_numpy(x))
    norms = torch.linalg.vector_norm(out["descriptors"], dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    for k in ("reliability", "repeatability"):
        assert 0.0 <= float(out[k].min()) and float(out[k].max()) <= 1.0


def test_odd_sizes_keep_shapes():
    """Even kernels with dilation keep H and W through the symmetric padding; the Fast
    variant's VALID pool floors an odd size, and the upsample doubles the result."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 21, 35, 3, generator=g)
    for tspec, hw in ((patchnet.QUAD_L2NET_CONFCFS, (21, 35)),
                      (patchnet.FAST_QUAD_L2NET_CONFCFS, (20, 34))):
        out = patchnet.apply_patchnet(patchnet.init_patchnet_params(prng.key(5), tspec),
                                      tspec, x)
        assert out["reliability"].shape == (1, *hw)


def test_init_params_shapes_and_scale():
    for jspec, tspec in SPECS.values():
        tp = patchnet.init_patchnet_params(prng.key(0), tspec)
        jp = jax.tree_util.tree_map(np.asarray,
                                    jpatchnet.init_patchnet_params(jax.random.key(0), jspec))
        for t, j, cs in zip(tp["convs"], jp["convs"], tspec.convs):
            assert sorted(t) == sorted(j)
            assert tuple(t["w"].shape) == np.transpose(j["w"], (3, 2, 0, 1)).shape
            std = float(t["w"].std())
            assert 0.7 < std / (2.0 / (cs.k * cs.k * cs.in_ch)) ** 0.5 < 1.3
            if cs.bn:
                assert float(t["bn_var"].min()) == 1.0 and float(t["bn_mean"].abs().max()) == 0
        for h in ("clf", "sal"):
            assert tuple(tp[h]["w"].shape) == np.transpose(jp[h]["w"], (3, 2, 0, 1)).shape


def write_reference_checkpoint(path, spec, params, arch):
    """A ``.pt`` in the published checkpoints' layout, built from the JAX parameters
    with numpy alone: ``module.ops.{i}`` for conv -> [bn] -> [relu] -> [pool], OIHW."""
    sd, idx = {}, 0
    for cs, layer in zip(spec.convs, params["convs"]):
        sd[f"module.ops.{idx}.weight"] = torch.tensor(np.transpose(layer["w"], (3, 2, 0, 1)))
        sd[f"module.ops.{idx}.bias"] = torch.tensor(layer["b"])
        idx += 1
        if cs.bn:
            sd[f"module.ops.{idx}.running_mean"] = torch.tensor(layer["bn_mean"])
            sd[f"module.ops.{idx}.running_var"] = torch.tensor(layer["bn_var"])
            sd[f"module.ops.{idx}.num_batches_tracked"] = torch.tensor(100)
            idx += 1
        idx += cs.relu + (cs.pool_after > 1)
    for h in ("clf", "sal"):
        sd[f"module.{h}.weight"] = torch.tensor(np.transpose(params[h]["w"], (3, 2, 0, 1)))
        sd[f"module.{h}.bias"] = torch.tensor(params[h]["b"])
    torch.save({"net": arch, "state_dict": sd}, path)
    return sd


def test_checkpoint_reader_matches_jax(net, tmp_path):
    name, jspec, tspec, params, x = net
    path = str(tmp_path / f"{name}.pt")
    sd = write_reference_checkpoint(path, jspec, params, ARCH[name] + " ")
    if name == "fast":     # the layout the JAX package's porter documents
        convs = sorted(int(k.split(".")[2]) for k in sd
                       if k.startswith("module.ops.") and k.endswith(".weight"))
        assert convs == [0, 3, 6, 10, 13, 16, 19, 21, 23]
    jspec2, jparams = jport_weights.load_torch_checkpoint(path)
    tspec2, tparams = port_weights.load_torch_checkpoint(path)
    assert jspec2 == jspec and tspec2 == tspec
    for t, j in zip(tparams["convs"], jparams["convs"]):
        assert sorted(t) == sorted(j)
        for k in t:
            want = np.asarray(j[k])
            if k == "w":
                want = np.transpose(want, (3, 2, 0, 1))
            np.testing.assert_array_equal(t[k].numpy(), want, err_msg=k)
    jout = jpatchnet.apply_patchnet(jparams, jspec, jnp.asarray(x))
    tout = patchnet.apply_patchnet(tparams, tspec, torch.from_numpy(x))
    _outputs_close(jout, tout, dict.fromkeys(["descriptors", "reliability",
                                              "repeatability"], 2e-5))
    # the carried-across parameters give the same bits as the checkpoint's
    carried = patchnet.apply_patchnet(patchnet_params_from_jax(params, device="cpu"),
                                      tspec, torch.from_numpy(x))
    for k in tout:
        assert torch.equal(carried[k], tout[k]), k
    # load_pretrained reads <models_dir>/<name>.pt
    spec3, params3 = port_weights.load_pretrained(name, models_dir=str(tmp_path))
    assert spec3 == tspec and torch.equal(params3["clf"]["w"], tparams["clf"]["w"])


def test_checkpoint_errors(tmp_path):
    jspec = SPECS["fast"][0]
    params = jax.tree_util.tree_map(
        np.asarray, jpatchnet.init_patchnet_params(jax.random.key(1), jspec))
    bad = str(tmp_path / "bad_arch.pt")
    write_reference_checkpoint(bad, jspec, params, "Quad_L2Net_ConfCFS_v2()")
    for load in (jport_weights.load_torch_checkpoint, port_weights.load_torch_checkpoint):
        with pytest.raises(ValueError, match="unsupported architecture"):
            load(bad)
    # a checkpoint that lacks a layer of its architecture
    short = str(tmp_path / "short.pt")
    sd = write_reference_checkpoint(short, jspec, params, ARCH["fast"])
    del sd["module.sal.bias"]
    torch.save({"net": ARCH["fast"], "state_dict": sd}, short)
    with pytest.raises(ValueError, match="sal.bias"):
        port_weights.load_torch_checkpoint(short)
    # a missing file raises and names its path; nothing falls back to random weights
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nothere" / "r2d2_WASF_N16.pt")):
        port_weights.load_pretrained("r2d2_WASF_N16", models_dir=str(tmp_path / "nothere"))
