"""The share of PnP's Gauss-Newton solves that ran through the hand-written kernel: the
streaming entry's ``stats["gn_kernel_solves"]`` over two solves (the annealed candidate
and the polish) per engine step, ``stats["graph_replays"] + stats["eager_steps"]``, in
percent. A program without the counter, or a window without steps, reads nothing."""


def read(run):
    stats = run.stats
    if any(k not in stats for k in ("gn_kernel_solves", "graph_replays", "eager_steps")):
        return None
    steps = stats["graph_replays"] + stats["eager_steps"]
    if not steps:
        return None
    return 100.0 * stats["gn_kernel_solves"] / (2 * steps)
