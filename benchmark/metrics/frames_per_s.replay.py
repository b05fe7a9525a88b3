"""Frames whose pose reached the host in the window, over the window's length (host
clock): every frame of every whole pass of the drive."""


def read(run):
    return run.frames / run.window_s
