"""The encode's per-call orchestration on the host: the plan and tables
(``gpujpeg.enc.plan``), the encode context's lookup or build
(``gpujpeg.enc.context``) and the kernels' enqueue
(``gpujpeg.enc.launch``), over every call of the encode phase, ms a frame
(program spans)."""
from portbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "encode", ("gpujpeg.enc.plan",
                                        "gpujpeg.enc.context",
                                        "gpujpeg.enc.launch"))
