"""Host-side utilities of the port: the waterfall / occupancy IQ
inspection (a copy of btle_tpu.utils.spectrum)."""

from .spectrum import occupancy, waterfall, waterfall_extent  # noqa: F401
