"""Kernel launches the host made in the profiled sub-window (the CUDA runtime and
driver launch calls in the trace; a CUDA graph's launch counts once), per frame."""


def read(run):
    if run.trace is None or not run.trace.launches:
        return None
    return run.trace.launches / run.trace.frames
