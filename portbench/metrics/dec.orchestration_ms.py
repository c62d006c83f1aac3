"""The decode's per-call orchestration on the host: the plan and
Huffman tables of the stream (``gpujpeg.dec.plan``), the decode
context's lookup or build (``gpujpeg.dec.context``) and the kernels'
enqueue (``gpujpeg.dec.launch``), over every call of the decode phase, ms
a frame (program spans)."""
from portbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "decode", ("gpujpeg.dec.plan",
                                        "gpujpeg.dec.context",
                                        "gpujpeg.dec.launch"))
