"""PHY pieces of the port: phase-difference demodulation."""

from .demodulator import aa_match_counts, decisions, phase_diff  # noqa: F401
