"""Receive pipeline of the port: dense block decode and the candidate
decode kernel."""

from .decode_kernel import decode_candidates, decode_candidates_reference  # noqa: F401
from .pipeline import (  # noqa: F401
    decode_block,
    decode_from_lattice,
    earliest_hits,
    required_halo,
    rssi_dbm_from_mag,
    scan_block,
)
