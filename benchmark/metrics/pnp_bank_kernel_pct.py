"""The share of the engine's steps whose PnP hypothesis bank ran through the
hand-written kernel: the streaming entry's ``stats["bank_kernel_calls"]`` over one bank
per engine step, ``stats["graph_replays"] + stats["eager_steps"]``, in percent. A
program without the counter, or a window without steps, reads nothing."""


def read(run):
    stats = run.stats
    if any(k not in stats for k in ("bank_kernel_calls", "graph_replays", "eager_steps")):
        return None
    steps = stats["graph_replays"] + stats["eager_steps"]
    if not steps:
        return None
    return 100.0 * stats["bank_kernel_calls"] / steps
