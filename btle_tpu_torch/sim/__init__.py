"""Channel simulation and batched BER sweeps (BASELINE config 3) on the
card: impairments, the dense golden receiver and the Monte-Carlo
harness."""

from .ber import BerHarness, golden_rx_dense, reference_max_snr  # noqa: F401
from .channel import apply_ppm, awgn, quantize_int16  # noqa: F401
