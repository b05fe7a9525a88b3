"""The port's road segmentation, profiling and debug helpers against the JAX package's.

``apply_segnet`` with the JAX parameters carried across by
``port_state.segnet_params_from_jax`` within 1e-5 of the logits' scale; one
``seg_train_step`` (``torch.optim.Adam``) against the JAX step with ``optax.adam`` at
the same lr: the loss within 1e-5 relative and the parameters within 2.5 x lr (Adam's
first step is +-lr per weight); the heuristic road mask equal; ``StageTimer``'s table,
``trace``'s file and ``display_image``'s PNG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from vo_tpu.utils import debug as jdebug
from vo_tpu.utils import profiling as jprofiling
from vo_tpu.utils import seg as jseg
from vo_tpu_torch.port_state import segnet_params_from_jax
from vo_tpu_torch.utils import debug, profiling, seg

SPEC_J, SPEC_T = jseg.SegNetSpec(width=8), seg.SegNetSpec(width=8)


@pytest.fixture(scope="module")
def net():
    params = jax.tree.map(np.asarray, jseg.init_segnet_params(jax.random.key(4), SPEC_J))
    rng = np.random.default_rng(110)
    for layer in params.values():
        layer["b"] = rng.normal(0, 0.05, layer["b"].shape).astype(np.float32)
    images = rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    return params, images


def test_init_layout_matches():
    want = jseg.init_segnet_params(jax.random.key(0), SPEC_J)
    got = seg.init_segnet_params(torch.Generator().manual_seed(0), SPEC_T)
    assert got.keys() == want.keys()
    for k in want:
        kh, kw, cin, cout = want[k]["w"].shape
        assert tuple(got[k]["w"].shape) == (cout, cin, kh, kw)
        assert got[k]["b"].shape == want[k]["b"].shape
        assert float(got[k]["w"].std()) == pytest.approx(float(jnp.std(want[k]["w"])), rel=0.3)


def test_apply_segnet(net):
    params, images = net
    want = np.asarray(jseg.apply_segnet(jax.tree.map(jnp.asarray, params), jnp.asarray(images),
                                        SPEC_J))
    got = seg.apply_segnet(segnet_params_from_jax(params, "cpu"), images, SPEC_T, device="cpu")
    assert got.shape == want.shape == (2, 32, 48, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_auto_park_vision_with_and_without_weights(net):
    params, images = net
    jmask = np.asarray(jseg.auto_park_vision(jnp.asarray(images[0]),
                                             jax.tree.map(jnp.asarray, params), SPEC_J))
    tmask = seg.auto_park_vision(images[0], segnet_params_from_jax(params, "cpu"), SPEC_T,
                                 device="cpu").numpy()
    logits = np.asarray(jseg.apply_segnet(jax.tree.map(jnp.asarray, params),
                                          jnp.asarray(images[:1]), SPEC_J))[0]
    sure = np.abs(logits[..., 1] - logits[..., 0]) > 1e-4
    assert np.array_equal(tmask[sure], jmask[sure])
    img = np.random.default_rng(111).uniform(0, 255, (20, 30, 3)).astype(np.float32)
    img[:10] = 120.0
    for x in (img, img[..., 0]):
        want = np.asarray(jseg.heuristic_road_mask(jnp.asarray(x)))
        assert np.array_equal(seg.auto_park_vision(x, device="cpu").numpy(), want)
        assert np.array_equal(seg.heuristic_road_mask(torch.from_numpy(x)).numpy(), want)
    assert want.any() and not want.all()


def test_seg_train_step_against_optax_adam(net):
    params, images = net
    labels = (images[..., 0] > 128).astype(np.int32)
    lr = 1e-3
    opt = optax.adam(lr)
    jp = jax.tree.map(jnp.asarray, params)
    jp1, _, jloss = jseg.seg_train_step(jp, opt.init(jp), jnp.asarray(images),
                                        jnp.asarray(labels), opt, SPEC_J)
    tp = segnet_params_from_jax(params, "cpu")
    leaves = [t.requires_grad_(True) for layer in tp.values() for t in layer.values()]
    tp1, tloss = seg.seg_train_step(tp, torch.from_numpy(images), labels,
                                    torch.optim.Adam(leaves, lr=lr), SPEC_T)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    want = segnet_params_from_jax(jax.tree.map(np.asarray, jp1), "cpu")
    init = segnet_params_from_jax(params, "cpu")
    for k in want:
        for n in ("w", "b"):
            assert float((tp1[k][n].detach() - want[k][n]).abs().max()) <= 2.5 * lr, (k, n)
            assert not torch.equal(tp1[k][n].detach(), init[k][n]), (k, n)


def test_stage_timer_and_report():
    timer = profiling.StageTimer()
    with timer.stage("a"):
        sum(range(1000))
    out = timer.timed("b", lambda x: x * 2, torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert timer.counts == {"a": 1, "b": 1} and all(v >= 0 for v in timer.totals.values())
    jt = jprofiling.StageTimer(totals=dict(timer.totals), counts=dict(timer.counts))
    assert timer.report() == jt.report()
    assert timer.report().splitlines()[0].split() == ["stage", "total_s", "calls", "ms/call"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("kind", ["float01", "uint8", "gray", "tensor"])
def test_display_image(tmp_path, kind):
    rng = np.random.default_rng(112)
    img = {"float01": rng.uniform(0, 1, (12, 16, 3)).astype(np.float32),
           "uint8": rng.integers(0, 255, (12, 16, 3)).astype(np.uint8),
           "gray": rng.uniform(0, 300, (12, 16)).astype(np.float32),
           "tensor": rng.uniform(0, 1, (12, 16)).astype(np.float32)}[kind]
    want = jdebug.display_image(img, name="j", out_dir=str(tmp_path))
    got = debug.display_image(torch.from_numpy(img) if kind == "tensor" else img, name="t",
                              out_dir=str(tmp_path))
    assert got == str(tmp_path / "t.png")
    assert np.array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))
    assert debug.breakpoint_prompt("x") == ""          # stdin is not a TTY under pytest
