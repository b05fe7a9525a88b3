"""Frames whose features reached the host in the window, over the window's length
(host clock): every frame of every batch."""


def read(run):
    return run.frames / run.window_s
