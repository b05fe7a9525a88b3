"""Seconds from the start of the process to the start of the window (host clock):
imports, the card's start, the inputs, the weights, the warm-up and any build."""


def read(run):
    return run.setup_s
