"""The rest of a run with the timed path broken underneath: ``correct`` has to come
out false for every fault a cell can have, and true for the sound program. The
harness's look for a card is skipped: the drivers run the program on the CPU at a
small size. The cells run on one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

import pytest
import torch

from conftest import context, shrink
from vobench import harness, r2d2_extract, rgbd_replay


def _correct(run) -> bool:
    return all(c.ok for c in run.checks)


def _replay(seed: int = 5):
    return rgbd_replay.run(context(shrink("orb_kitti.replay"), seed))


def _extract(seed: int = 5):
    return r2d2_extract.run(context(shrink("r2d2_fast.extract"), seed))


def test_sound_runs_are_correct():
    for run in (_replay(), _extract()):
        assert _correct(run), [(c.name, c.value, c.limit) for c in run.checks]


def test_replay_step_that_returns_its_state_unchanged(monkeypatch):
    from vo_tpu_torch.engine.vo import VOEngine

    orig = VOEngine._step

    def frozen(self, K, state, *args):
        _, _, diag = orig(self, K, state, *args)
        return state, state.cur_pose, diag

    monkeypatch.setattr(VOEngine, "_step", frozen)
    run = _replay()
    assert not _correct(run)
    failed = {c.name for c in run.checks if not c.ok}
    assert "pose_gap_m" in failed


def test_replay_half_the_batch_left_out(monkeypatch):
    from vo_tpu_torch.features.extractor import Features, OrbLikeExtractor

    orig = OrbLikeExtractor.__call__

    def half(self, images, device=None):
        f = orig(self, images[: images.shape[0] // 2], device=device)
        return Features(*(torch.cat([x, x]) for x in f))

    monkeypatch.setattr(OrbLikeExtractor, "__call__", half)
    assert not _correct(_replay())


def test_replay_matches_altered_where_produced(monkeypatch):
    import vo_tpu_torch.engine.vo as vo
    from vo_tpu_torch.matching.matchers import MatchResult

    orig = vo.ratio_match_fused

    def altered(*args, **kw):
        m = orig(*args, **kw)
        drop = torch.zeros_like(m.mask)
        drop[::10] = True
        return MatchResult(idx=m.idx, mask=m.mask & ~drop, sim=m.sim)

    monkeypatch.setattr(vo, "ratio_match_fused", altered)
    run = _replay()
    assert not _correct(run)
    assert "step_flags_off" in {c.name for c in run.checks if not c.ok}


def test_extract_half_the_batch_left_out(monkeypatch):
    import vo_tpu_torch.models.multiscale as ms

    orig = ms.extract_multiscale

    def half(params, spec, images, *args, **kw):
        f = orig(params, spec, images[: images.shape[0] // 2], *args, **kw)
        return type(f)(*(torch.cat([x, x]) for x in f))

    monkeypatch.setattr(ms, "extract_multiscale", half)
    assert not _correct(_extract())


def test_extract_descriptor_altered_where_produced(monkeypatch):
    import vo_tpu_torch.models.multiscale as ms

    orig = ms.extract_multiscale

    def altered(*args, **kw):
        f = orig(*args, **kw)
        desc = f.desc.clone()
        desc[:, 0, 0] += 1e-3
        return f._replace(desc=desc)

    monkeypatch.setattr(ms, "extract_multiscale", altered)
    run = _extract()
    assert not _correct(run)
    assert "desc_gap" in {c.name for c in run.checks if not c.ok}


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    """The control (the reference one precision down in the program's place) against
    the limits, at a size a test run holds; the program's own readings pass them."""
    for name in ("orb_kitti.replay", "r2d2_fast.extract"):
        w = shrink(name, frames=32)
        drv = harness.driver(w["traffic"])
        limits = w["config"]["correctness"]["limits"]
        for seed in (31, 32, 33):
            sound = drv.readings(w["config"], w["traffic"], seed, card)
            assert all(sound[k] <= v for k, v in limits.items()), (name, seed, sound)
            control = drv.readings(w["config"], w["traffic"], seed, card, control=True)
            assert any(control[k] > v for k, v in limits.items()), (name, seed, control)
