"""The streaming entry's own counter: seconds its consumer waited on the loader's
queue (``stats["queue_wait_s"]`` of ``run_offline_vo_streaming``), per frame."""


def read(run):
    if "queue_wait_s" not in run.stats:
        return None
    return 1e3 * run.stats["queue_wait_s"] / run.frames
