"""The decode calls' self time: each root span (``gpujpeg.dec``) less
the part of it that its child spans cover, over every call of the decode
phase, ms a frame (program spans). Work added outside every span shows
here."""
from portbench.spans import untraced_ms


def read(run):
    return untraced_ms(run, "decode")
