"""PHY pieces of the port: phase-difference demodulation and the
narrowband scan kernel."""

from .demodulator import aa_match_counts, decisions, phase_diff  # noqa: F401
from .scan_kernel import scan_block, scan_block_kernel, scan_block_reference  # noqa: F401
