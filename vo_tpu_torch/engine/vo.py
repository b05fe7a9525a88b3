"""The keyframe-relative VO state machine. Port of ``vo_tpu/engine/vo.py``.

The JAX package runs the per-frame step as one ``lax.scan``; here it is a Python loop
over frames with all state on the device and no host sync per frame. Every gate of
the JAX step is kept:

- >= 3 px keypoint displacement to carry motion signal;
- keyframe depth validity 0 < z < 50 m;
- PnP acceptance (PnPConfig.min_inliers, or the ratio rule);
- physical-motion gate |t| <= max_speed x frame gap;
- pose hold on a rejected frame;
- keyframe promotion iff matches < kf_min_matches or inliers < kf_min_inliers or
  |t| > kf_max_step, and the lost-tracking refresh after bad_pnp_limit rejections.

The keyframe swap (a ``lax.cond`` there) is a ``torch.where`` per state field.

On a CUDA device the step is launch-bound: ~10,900 small kernels, each issued by the
host. So ``VOEngine.steps`` replays it as one CUDA graph per input signature (the
engine's class, the config's fields that the step reads, the device, and the shape and
dtype of every input), captured once per process and kept at module level: every engine
with that signature replays the same graph. Elsewhere it calls ``_step``. Both run the
same kernels in the same order, so their results are equal bit for bit. The graphs
share one memory pool and their static buffers, so their replays are serialised: a
replay on another stream than the last one waits for that stream first. Calls from
several threads at once are not supported. An engine's ``replay_timer``, when set to a
``ReplayTimer``, times each replay on the device with CUDA events.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from vo_tpu_torch import prng
from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.estimation.pnp import PnPConfig, pnp_ransac
from vo_tpu_torch.geometry.se3 import orthonormalize_pose, pose_inverse
from vo_tpu_torch.matching.matchers import mutual_nn_match, ratio_match, ratio_mutual_nn_match
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops.match import ratio_match_fused, ratio_mutual_nn_match_fused
from vo_tpu_torch.ops.pnp_bank import launch_bank
from vo_tpu_torch.ops.pnp_gn import launch_gn
from vo_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class VOConfig:
    """The JAX package's VOConfig; ``use_pallas_match`` is ``use_match_kernel``."""

    matcher: str = "ratio_binary"  # 'ratio_binary' | 'ratio_float' | 'ratio_mutual_nn' | 'mutual_nn'
    ratio: float = 0.85
    mnn_threshold: float = 0.9
    min_displacement_px: float = 3.0
    min_point_depth: float = 0.0
    max_point_depth: float = 50.0
    max_speed: float = 1.5
    kf_min_matches: int = 200
    kf_min_inliers: int = 100
    kf_max_step: float = 1.5
    bad_pnp_limit: int = 3
    pnp: PnPConfig = PnPConfig()
    seed: int = 8214
    use_match_kernel: bool = True   # ratio matchers through ops.match.top2_mutual


class VOState(NamedTuple):
    """Loop carry: the active keyframe + chain bookkeeping (fixed shapes)."""

    ref_kp: torch.Tensor        # (K, 2)
    ref_desc: torch.Tensor      # (K, D)
    ref_valid: torch.Tensor     # (K,)
    ref_3d: torch.Tensor        # (K, 3)
    ref_3d_valid: torch.Tensor  # (K,)
    ref_pose: torch.Tensor      # (4, 4)
    ref_id: torch.Tensor        # () int32
    bad_pnp: torch.Tensor       # () int32
    cur_pose: torch.Tensor      # (4, 4)


class VOStepDiagnostics(NamedTuple):
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    accepted: torch.Tensor
    promoted_keyframe: torch.Tensor
    step_norm: torch.Tensor


# Counters of the process, beside the kernels' ``launches``: CUDA graphs of
# the step captured, steps replayed from one, steps run eagerly through ``_step`` (every
# step off CUDA; on CUDA the step before each capture), and the captures' host seconds.
step_counts = {"graph_captures": 0, "graph_replays": 0, "eager_steps": 0,
               "capture_s": 0.0}

def _counts() -> dict:
    return {"graph_replays": step_counts["graph_replays"],
            "eager_steps": step_counts["eager_steps"],
            "gn_kernel_solves": launch_gn.launches, "bank_kernel_calls": launch_bank.launches}


# The captured steps by input signature, for the life of the process: the streaming
# entry makes a new engine per call, and every engine with a signature shares its graph.
_graphs: dict = {}

# Per device: the stream the captures run on and the memory pool the graphs share (one
# graph's temporaries reuse another's, as no two replays overlap); the stream of the
# last replay, which the next replay on another stream waits for.
_capture_home: dict = {}
_last_replay: dict = {}


def _signature(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype


def _graph_key(engine: "VOEngine", K, state: VOState, per_frame) -> tuple:
    """What a captured step depends on: the engine's class; the config without the
    fields ``_step`` does not read (the seed makes the keys and the depth limits make
    ``kp3d_valid``, both inputs); the device; each input's shape and dtype."""
    cfg = replace(engine.config, seed=0, min_point_depth=0.0, max_point_depth=0.0)
    return (type(engine), cfg, K.device, _signature(K), *map(_signature, state),
            *(_signature(x[0]) for x in per_frame))


class ReplayTimer:
    """Device time of the step graph's replays: a pair of CUDA events around each on
    the current stream. ``mark()`` numbers the replays recorded so far; ``read(mark)``,
    called once the host knows those replays have run (after a synchronisation that
    waits for work queued after them), adds their time to ``seconds`` and drops their
    events. Reading never waits on the device."""

    def __init__(self):
        self.seconds = 0.0
        self._events: deque = deque()
        self._recorded = self._read = 0

    def record(self, fn) -> None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        self._events.append((start, end))
        self._recorded += 1

    def mark(self) -> int:
        return self._recorded

    def read(self, mark: int) -> None:
        while self._read < mark:
            start, end = self._events.popleft()
            self.seconds += start.elapsed_time(end) / 1e3
            self._read += 1


class _StepGraph:
    """One captured ``_step``: static buffers for K, the carry and one frame's inputs;
    the graph, which reads them and writes the new carry back into the carry's buffers;
    and its pose and diagnostics, in the graphs' memory pool."""

    @classmethod
    def capture(cls, engine: "VOEngine", K, state: VOState, inputs, frame):
        """-> (the graph, the (state, pose, diag) of ``inputs``' frame).

        The frame's step first runs eagerly on the device's capture stream, so that the
        kernels' per-stream state and cuBLAS's workspace for that stream exist before
        the capture; its results are the frame's. The graph then keeps what
        ``kernels.end_capture`` hands it: the launches it recorded, counted at each
        replay, and that per-stream state. The capture is thread-local: a loader thread
        may upload meanwhile."""
        dev = K.device
        cur = torch.cuda.current_stream(dev)
        if dev not in _capture_home:
            _capture_home[dev] = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
        stream, pool = _capture_home[dev]
        g = cls()
        g.K = torch.empty(K.shape, dtype=K.dtype, device=dev)
        g.state = VOState(*(torch.empty(t.shape, dtype=t.dtype, device=dev) for t in state))
        g.inputs = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in inputs]
        stream.wait_stream(cur)
        kernels.begin_capture(dev, stream.cuda_stream)
        with torch.cuda.stream(stream):
            with span("engine.step", frame=frame):
                first = engine._step(K, state, *inputs)
        step_counts["eager_steps"] += 1
        g.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with span("engine.capture", frame=frame):
            with torch.cuda.graph(g.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                new_state, g.pose, g.diag = engine._step(g.K, g.state, *g.inputs)
                for dst, src in zip(g.state, new_state):
                    dst.copy_(src)
        step_counts["capture_s"] += time.perf_counter() - t0
        step_counts["graph_captures"] += 1
        g.kernels = kernels.end_capture(dev, stream.cuda_stream)
        cur.wait_stream(stream)
        for t in (*first[0], first[1], *first[2]):
            t.record_stream(cur)
        return g, first

    def load(self, K, state: VOState) -> None:
        """Copy K and the carry into the graph's buffers."""
        self.K.copy_(K)
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    def replay(self, inputs, timer: ReplayTimer | None = None) -> None:
        """One step from the carry in the buffers, on this frame's inputs; ``timer``
        records events around the graph's replay."""
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        if timer is None:
            self.graph.replay()
        else:
            timer.record(self.graph.replay)
        step_counts["graph_replays"] += 1
        self.kernels.replayed()


class VOEngine:
    """Offline sequence VO over pre-extracted features on ``device`` (default cuda)."""

    def __init__(self, config: VOConfig = VOConfig(), device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.replay_timer: ReplayTimer | None = None
        self._counts0 = _counts()

    def counts(self) -> dict:
        """Since the engine was made, in the process: the steps replayed from a CUDA
        graph (``graph_replays``) and run eagerly (``eager_steps``), PnP's Gauss-Newton
        solves through its kernel (``gn_kernel_solves``) and its hypothesis banks through
        the bank kernel (``bank_kernel_calls``)."""
        return {k: v - self._counts0[k] for k, v in _counts().items()}

    def _match(self, desc_a, desc_b, valid_a, valid_b):
        cfg = self.config
        fused = cfg.use_match_kernel
        if cfg.matcher == "ratio_binary":
            fn = ratio_match_fused if fused else ratio_match
            return fn(desc_a, desc_b, valid_a, valid_b, ratio=cfg.ratio,
                      binary_dim=desc_a.shape[-1])
        if cfg.matcher == "ratio_float":
            fn = ratio_match_fused if fused else ratio_match
            return fn(desc_a, desc_b, valid_a, valid_b, ratio=cfg.ratio)
        if cfg.matcher == "ratio_mutual_nn":
            fn = ratio_mutual_nn_match_fused if fused else ratio_mutual_nn_match
            return fn(desc_a, desc_b, valid_a, valid_b, ratio=cfg.ratio)
        if cfg.matcher == "mutual_nn":
            return mutual_nn_match(desc_a, desc_b, valid_a, valid_b,
                                   threshold=cfg.mnn_threshold)
        raise ValueError(f"unknown matcher {cfg.matcher!r}")

    def _depth_valid(self, valid, kp3d):
        z = kp3d[..., 2]
        cfg = self.config
        return valid & (z > cfg.min_point_depth) & (z < cfg.max_point_depth)

    def _step(self, K, state: VOState, kp, desc, valid, kp3d, kp3d_valid, frame_id, key):
        cfg = self.config
        with span("engine.match"):
            m = self._match(state.ref_desc, desc, state.ref_valid, valid)

        cur_kp_m = kp[m.idx]
        cur_3d_m = kp3d[m.idx]
        cur_3d_valid_m = kp3d_valid[m.idx]
        disp = torch.linalg.vector_norm(state.ref_kp - cur_kp_m, dim=-1)
        corr_valid = m.mask & (disp >= cfg.min_displacement_px) & state.ref_3d_valid
        n_matches = corr_valid.sum().to(torch.int32)

        pnp = pnp_ransac(key, state.ref_3d, cur_kp_m, corr_valid, K, cfg.pnp,
                         points_3d_cur=cur_3d_m, valid_cur=cur_3d_valid_m)

        rel = pose_inverse(pnp.pose)
        step_norm = torch.linalg.vector_norm(rel[:3, 3])
        frame_gap = (frame_id - state.ref_id).to(torch.float32)
        motion_ok = step_norm <= cfg.max_speed * torch.clamp(frame_gap, min=1.0)
        accepted = pnp.ok & motion_ok

        chained = orthonormalize_pose(state.ref_pose @ rel)
        cur_pose = torch.where(accepted, chained, state.ref_pose)
        bad_pnp = torch.where(accepted, torch.zeros_like(state.bad_pnp), state.bad_pnp + 1)

        promote = accepted & ((n_matches < cfg.kf_min_matches)
                              | (pnp.n_inliers < cfg.kf_min_inliers)
                              | (step_norm > cfg.kf_max_step))
        # Refresh on repeated rejections only when tracking is lost (match collapse),
        # or after 4x the limit as the last resort (vo_tpu/engine/vo.py explains why).
        lost = n_matches < cfg.kf_min_matches
        force_refresh = (bad_pnp > cfg.bad_pnp_limit) & (
            lost | (bad_pnp > 4 * cfg.bad_pnp_limit))
        new_kf = promote | force_refresh

        def pick(new, old):
            cond = new_kf.reshape((1,) * old.ndim) if old.ndim else new_kf
            return torch.where(cond, new, old)

        new_state = VOState(
            ref_kp=pick(kp, state.ref_kp), ref_desc=pick(desc, state.ref_desc),
            ref_valid=pick(valid, state.ref_valid), ref_3d=pick(kp3d, state.ref_3d),
            ref_3d_valid=pick(kp3d_valid, state.ref_3d_valid),
            ref_pose=pick(cur_pose, state.ref_pose), ref_id=pick(frame_id, state.ref_id),
            bad_pnp=bad_pnp, cur_pose=cur_pose,
        )
        diag = VOStepDiagnostics(n_matches=n_matches, n_inliers=pnp.n_inliers,
                                 accepted=accepted, promoted_keyframe=new_kf,
                                 step_norm=step_norm)
        return new_state, cur_pose, diag

    def initial_state(self, kp0, desc0, valid0, kp3d0, init_pose=None) -> VOState:
        """Frame-0 keyframe state."""
        dev = kp0.device
        pose0 = (torch.eye(4, device=dev) if init_pose is None
                 else torch.as_tensor(init_pose, dtype=torch.float32, device=dev))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return VOState(ref_kp=kp0, ref_desc=desc0, ref_valid=valid0, ref_3d=kp3d0,
                       ref_3d_valid=self._depth_valid(valid0, kp3d0), ref_pose=pose0,
                       ref_id=zero, bad_pnp=zero.clone(), cur_pose=pose0)

    def steps(self, K, state: VOState, kp, desc, valid, kp3d, kp3d_valid, frame_ids, keys,
              frames=None):
        """The step entry: step over C frames from ``state`` -> (state, poses (C, 4, 4),
        diagnostics of (C,) tensors).

        The frames' inputs are (C, ...): ``frame_ids`` (C,) int32, ``keys`` (C, 2) their
        threefry keys; ``frames``, when given, the host's frame numbers (the ``frame``
        of each ``engine.step`` span). On a CUDA device each step replays the step's
        CUDA graph on the current stream (its span has ``graph=True``), after the work
        queued on the stream of the last replay: the carry is copied in once, each
        frame's inputs before its replay, and the poses, diagnostics and final state
        are copied out, never aliases of the graph's memory. Elsewhere each step calls
        ``_step``.
        """
        per_frame = (kp, desc, valid, kp3d, kp3d_valid, frame_ids, keys)
        n = kp.shape[0]
        frame = (lambda i: None) if frames is None else frames.__getitem__
        if kp.device.type != "cuda":
            poses, diags = [], []
            for i in range(n):
                with span("engine.step", frame=frame(i)):
                    state, pose, diag = self._step(K, state, *(x[i] for x in per_frame))
                step_counts["eager_steps"] += 1
                poses.append(pose)
                diags.append(diag)
            diag = VOStepDiagnostics(*(torch.stack(x) for x in zip(*diags)))
            return state, torch.stack(poses), diag

        sig = _graph_key(self, K, state, per_frame)
        g = _graphs.get(sig)
        first = None
        if g is None:
            g, first = _StepGraph.capture(self, K, state, [x[0] for x in per_frame],
                                          frame(0))
            _graphs[sig] = g
        dev = kp.device
        poses = torch.empty((n,) + g.pose.shape, dtype=g.pose.dtype, device=dev)
        diag = VOStepDiagnostics(*(torch.empty((n,) + d.shape, dtype=d.dtype, device=dev)
                                   for d in g.diag))
        outs = (poses, *diag)
        start = 0
        if first is not None:
            state, start = first[0], 1
            for out, x in zip(outs, (first[1], *first[2])):
                out[0].copy_(x)
        if start < n:
            cur = torch.cuda.current_stream(dev)
            last = _last_replay.get(dev)
            if last is not None and last != cur:
                cur.wait_stream(last)
            _last_replay[dev] = cur
            g.load(K, state)
            for i in range(start, n):
                with span("engine.step", frame=frame(i), graph=True):
                    g.replay([x[i] for x in per_frame], self.replay_timer)
                    for out, x in zip(outs, (g.pose, *g.diag)):
                        out[i].copy_(x)
            state = VOState(*(t.clone() for t in g.state))
        return state, poses, diag

    def run_chunk(self, state: VOState, kp, desc, valid, kp3d, frame_ids, K):
        """Step over a chunk of frames with an explicit carry (through ``steps``).

        ``frame_ids``: (C,) ints, or a ``range`` (made on the device, and the host
        knows each step's frame: the ``frame`` of its ``engine.step`` span).
        Returns (state, poses (C, 4, 4), diagnostics of (C,) tensors).
        """
        kp3d_valid = self._depth_valid(valid, kp3d)
        if isinstance(frame_ids, range):
            frames = frame_ids
            frame_ids = torch.arange(frames.start, frames.stop, dtype=torch.int32,
                                     device=kp.device)
        else:
            frames = None
            frame_ids = torch.as_tensor(frame_ids, device=kp.device).to(torch.int32)
        keys = prng.fold_in(prng.key(self.config.seed, device=kp.device), frame_ids)
        return self.steps(K, state, kp, desc, valid, kp3d, kp3d_valid, frame_ids, keys,
                          frames)

    def run_sequence(self, kp, desc, valid, kp3d, K, init_pose=None):
        """Run VO over a pre-extracted sequence -> ((F, 4, 4) poses, diagnostics).

        Frame 0 seeds the keyframe; its emitted pose is ``init_pose`` (identity).
        """
        state = self.initial_state(kp[0], desc[0], valid[0], kp3d[0], init_pose)
        _, poses, diag = self.run_chunk(state, kp[1:], desc[1:], valid[1:], kp3d[1:],
                                        range(1, kp.shape[0]), K)
        return torch.cat([state.cur_pose[None], poses]), diag
