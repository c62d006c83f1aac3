"""The encode calls' self time: each root span (``gpujpeg.enc``) less
the part of it that its child spans cover, over every call of the encode
phase, ms a frame (program spans). Work added outside every span shows
here."""
from portbench.spans import untraced_ms


def read(run):
    return untraced_ms(run, "encode")
