"""``enc.stream_ms``, read the same way, in the cells that hold their
encode by its tail (``encode_p95_ms``) rather than by its rate."""
from portbench.spec import reader

read = reader("enc.stream_ms")
