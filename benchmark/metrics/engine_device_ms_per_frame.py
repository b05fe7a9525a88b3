"""The engine's device time per replayed step: the streaming entry's own counter
``stats["engine_device_s"]`` (CUDA events around each replay of the step's CUDA graph,
summed over the window's passes) over its ``stats["graph_replays"]``, in ms. A program
without the counter, or a window without replays, reads nothing."""


def read(run):
    stats = run.stats
    if "engine_device_s" not in stats or not stats.get("graph_replays"):
        return None
    return 1e3 * stats["engine_device_s"] / stats["graph_replays"]
