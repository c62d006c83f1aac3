"""gpujpeg_tpu_torch — the PyTorch/CUDA port of gpujpeg_tpu, a baseline JPEG
(ITU-T T.81) encoder/decoder.

The JAX package ``gpujpeg_tpu`` is the reference; this package mirrors
its public API and is held against it on the same inputs. Encode and
decode run on a torch device (``Encoder(backend="torch",
device="cuda")``, ``Decoder(backend="torch", device="cuda")``) through
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use; on ``device="cpu"`` the same paths run the kernels' plain
torch versions. ``backend="golden"`` is the host NumPy/C++ coder.
``parallel`` shards encode and decode over several devices (bands of
one image, frames of a batch) and over processes (``torch.distributed``).

Importing the package compiles nothing and never imports JAX.
"""
from __future__ import annotations

from .models.decoder import Decoder
from .models.encoder import Encoder
from . import parallel
from .params import ImageParameters, Parameters, suggest_restart_interval
from .stream.reader import JpegParseError, get_image_info, read_image
from .types import (
    ColorSpace,
    ComponentType,
    GpujpegError,
    HuffmanType,
    PixelFormat,
    SamplingFactor,
    SUBSAMPLING_420,
    SUBSAMPLING_422,
    SUBSAMPLING_444,
    YCBCR_JPEG,
)

__version__ = "0.1.0"

__all__ = [
    "ColorSpace", "ComponentType", "Decoder", "Encoder", "GpujpegError",
    "HuffmanType", "ImageParameters", "JpegParseError", "Parameters",
    "PixelFormat",
    "SamplingFactor", "SUBSAMPLING_420", "SUBSAMPLING_422", "SUBSAMPLING_444",
    "YCBCR_JPEG", "get_image_info", "read_image", "suggest_restart_interval",
]
