"""Multi-device layer of the port: the wideband scan sharded over a
("ch", "time") mesh of ``torch.distributed`` ranks (btle_tpu.dist's
counterpart; NCCL on cards, gloo on CPUs)."""

from .shard import ShardedWidebandScan, make_mesh  # noqa: F401
from .multihost import MultiHostWidebandScan, init_distributed  # noqa: F401
