"""The engine's own counters: the share of its steps in the window that replayed the
step's CUDA graph (``stats["graph_replays"]``) rather than running eagerly
(``stats["eager_steps"]``) in ``run_offline_vo_streaming``, in percent. A program
without the counters reads nothing."""


def read(run):
    stats = run.stats
    if "graph_replays" not in stats or "eager_steps" not in stats:
        return None
    steps = stats["graph_replays"] + stats["eager_steps"]
    if not steps:
        return None
    return 100.0 * stats["graph_replays"] / steps
