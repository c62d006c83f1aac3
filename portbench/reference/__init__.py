"""The benchmark's plain reference JPEG coder, in plain torch and NumPy.

It imports nothing of the program under test (``gpujpeg_tpu_torch``), of
the JAX package or of JAX, and takes nothing the program made: it makes
the decode phase's streams from the benchmark's frames, and after the
window it judges the program's streams and frames against its own
float64 arithmetic (:mod:`portbench.judge`).
"""
