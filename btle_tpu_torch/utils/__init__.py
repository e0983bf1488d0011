"""Host-side utilities of the port: the waterfall / occupancy IQ
inspection and the per-stage golden vector export (copies of
btle_tpu.utils.spectrum and btle_tpu.utils.vectors), block timing and
torch.profiler traces (utils.profiling)."""

from .profiling import BlockStats, device_trace  # noqa: F401
from .spectrum import occupancy, waterfall, waterfall_extent  # noqa: F401
from .vectors import (  # noqa: F401
    dump_rx_vectors,
    dump_tx_vectors,
    instantaneous_freq,
    tx_stage_vectors,
)
