"""The rounds the Huffman lanes took to settle on each decode call of the
decode phase (the program's counter ``gpujpeg.dec.rounds``), mean a call
(program counter). None where the program records no such counter."""
from portbench.spans import phase_spans


def read(run):
    got = phase_spans(run, "decode")
    if got is None:
        return None
    s, names, inside, roots = got
    sel = inside & (names == "gpujpeg.dec.rounds")
    if not sel.any():
        return None
    return float(s["bytes"][sel].sum()) / int(roots.sum())
