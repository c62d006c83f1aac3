"""Pixels of every frame encoded in the window's encode phase, over the
phase's span from the first call's start to the last call's return, in
Mpix/s (host clock)."""
from portbench.window import mpix_s


def read(run):
    return mpix_s(run.phases["encode"])
