"""Runnable examples of the port, the counterparts of the JAX package's
``examples/``: ``python -m gpujpeg_tpu_torch.examples.<name> [--device
cuda|cpu] ...``. Each runs on ``cuda`` unless asked for ``cpu``."""
