"""The system under test: ``gpujpeg_tpu_torch``'s public entry points,
``Encoder.encode``, ``Decoder.decode`` and ``Decoder.decode_to_device``,
set up for one configuration and traffic mix.

Every object that the judge or the window calls a coder has the methods
of :class:`Program`: ``encode(frame) -> bytes``, ``decode(stream) ->
frame``, the per-call ``encode_stats()`` and ``decode_stats()``, and
``close()``. The control and the planted faults (``control.py``) stand
in its place.
"""
from __future__ import annotations


class Program:
    def __init__(self, cfg: dict, traffic: dict, device, perf_stats: bool,
                 dep=None):
        """``dep``, the reference's view of the deployment, is for the
        stand-ins; the program takes nothing of the reference."""
        from gpujpeg_tpu_torch.models.decoder import Decoder
        from gpujpeg_tpu_torch.models.encoder import Encoder
        from gpujpeg_tpu_torch.params import ImageParameters, Parameters
        from gpujpeg_tpu_torch.types import (ColorSpace, PixelFormat,
                                             SamplingFactor)
        samp = tuple(SamplingFactor(h, v) for h, v in cfg["sampling"])
        self.params = Parameters(
            quality=cfg["quality"], restart_interval=cfg["restart_interval"],
            interleaved=cfg["interleaved"],
            sampling_factor=samp + (SamplingFactor(1, 1),) * (4 - len(samp)),
            color_space_internal=ColorSpace[cfg["color_space_internal"]],
            perf_stats=perf_stats)
        self.image = ImageParameters(
            width=cfg["width"], height=cfg["height"],
            color_space=ColorSpace[cfg["color_space"]],
            pixel_format=PixelFormat[cfg["pixel_format"]])
        self.encoder = Encoder(backend="torch", device=device)
        self.decoder = Decoder(backend="torch", device=device,
                               perf_stats=perf_stats)
        self.decoder.set_output_format(
            ColorSpace[cfg["output_color_space"]],
            PixelFormat[cfg["output_pixel_format"]])
        self.to_device = traffic["output"] == "device"

    def encode(self, frame) -> bytes:
        return self.encoder.encode(frame, self.params, self.image)

    def decode(self, stream: bytes):
        if self.to_device:
            return self.decoder.decode_to_device(stream)[0]
        return self.decoder.decode(stream)[0]

    def encode_stats(self) -> dict:
        st = self.encoder.stats
        return {"stream_ms": st.duration_stream,
                "memory_to_ms": st.duration_memory_to}

    def decode_stats(self) -> dict:
        st = self.decoder.stats
        return {"stream_ms": st.duration_stream,
                "memory_from_ms": st.duration_memory_from}

    def close(self) -> None:
        self.encoder._contexts.clear()
        self.decoder._contexts.clear()
