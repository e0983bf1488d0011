"""Numpy golden model of the BLE baseband chain (a copy of
btle_tpu.golden): the test oracle of the port's TX and receive paths."""

from .model import (  # noqa: F401
    GoldenRxResult,
    add_freq_sampling_error,
    add_noise,
    assemble_phy_bits,
    btle_rx,
    btle_tx,
    c_flavor_pulse,
    c_flavor_taps,
    demod_symbol_lag,
    gauss_fir,
    gfsk_modulate_c,
    gfsk_modulate_float,
    gfsk_modulate_python,
    search_bit_sequence,
    sin_cos_tables,
)
