"""Pixels of every frame decoded in the window's decode phase, over the
phase's span, in Mpix/s (host clock); a call ends with the frame in host
memory, or on the card for device output."""
from portbench.window import mpix_s


def read(run):
    return mpix_s(run.phases["decode"])
