"""The streaming entry's own counter: host seconds spent issuing the engine's steps
(``stats["engine_s"]``; the engine makes no host sync), per frame."""


def read(run):
    if "engine_s" not in run.stats:
        return None
    return 1e3 * run.stats["engine_s"] / run.frames
