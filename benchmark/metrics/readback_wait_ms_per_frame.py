"""The streaming entry's own counter: seconds its consumer blocked on the device's
readbacks, the keypoint pixels of each chunk and the last chunk's packed results
(``stats["sync_wait_s"]`` of ``run_offline_vo_streaming``, the sum of its
``stream.sync_wait`` spans), per frame."""


def read(run):
    if "sync_wait_s" not in run.stats:
        return None
    return 1e3 * run.stats["sync_wait_s"] / run.frames
