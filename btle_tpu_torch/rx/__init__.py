"""Receive pipeline of the port: dense block decode, the candidate
decode kernel and the host-side decode semantics (stream_decode,
golden_decode)."""

from .decode_kernel import decode_candidates, decode_candidates_reference  # noqa: F401
from .decoder import (  # noqa: F401
    BlockDecodeResult,
    DecodedPacket,
    GoldenDecodeResult,
    golden_decode,
    stream_decode,
)
from .pipeline import (  # noqa: F401
    decode_block,
    decode_from_lattice,
    earliest_hits,
    required_halo,
    rssi_dbm_from_mag,
    scan_block,
)
