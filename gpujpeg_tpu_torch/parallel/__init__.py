"""Multi-device and multi-process parallelism of the port: band sharding
of one image over a :class:`Mesh` of torch devices, frame sharding of a
batch, and the multi-process coders over ``torch.distributed``. The
counterpart of the JAX package's ``gpujpeg_tpu/parallel`` with the same
public names, plus :class:`Mesh`, which stands for ``jax.sharding.Mesh``.
"""
from .multihost import (
    MultiHostDecoder,
    MultiHostEncoder,
    MultiHostSingleImageEncoder,
    global_mesh,
    init_distributed,
)
from .sharded import (
    BandLayout,
    Mesh,
    ShardedDecoder,
    ShardedEncoder,
    choose_restart_interval,
    plan_bands,
    split_raw_bands,
)

__all__ = [
    "BandLayout",
    "Mesh",
    "MultiHostDecoder",
    "MultiHostEncoder",
    "MultiHostSingleImageEncoder",
    "global_mesh",
    "init_distributed",
    "ShardedDecoder",
    "ShardedEncoder",
    "choose_restart_interval",
    "plan_bands",
    "split_raw_bands",
]
