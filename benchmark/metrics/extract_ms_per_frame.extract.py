"""Device milliseconds per frame between CUDA events that the benchmark records around
every call of ``extract_multiscale`` (the upload of the host batch and the copies of
its features back to the host inside), over the whole window of a traced run."""


def read(run):
    if run.extract_ms is None or not run.extract_frames:
        return None
    return run.extract_ms / run.extract_frames
