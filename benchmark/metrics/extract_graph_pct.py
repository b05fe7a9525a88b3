"""The extraction's own counters: the share of ``OrbLikeExtractor``'s calls in the
window that replayed the extraction's CUDA graph (``stats["extract_graph_replays"]``)
rather than running eagerly (``stats["extract_eager_calls"]``) in
``run_offline_vo_streaming``, in percent. A program without the counters, or a window
without calls, reads nothing."""


def read(run):
    stats = run.stats
    if "extract_graph_replays" not in stats or "extract_eager_calls" not in stats:
        return None
    calls = stats["extract_graph_replays"] + stats["extract_eager_calls"]
    if not calls:
        return None
    return 100.0 * stats["extract_graph_replays"] / calls
