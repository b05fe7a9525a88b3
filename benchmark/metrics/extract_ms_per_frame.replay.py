"""Device milliseconds per frame between CUDA events that the benchmark records around
every call of the extractor it hands the streaming entry, over the whole window of a
traced run (the events also count any wait of the stream for the host inside a
call)."""


def read(run):
    if run.extract_ms is None or not run.extract_frames:
        return None
    return run.extract_ms / run.extract_frames
