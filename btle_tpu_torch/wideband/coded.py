"""Wideband LE Coded scan: all 40 channels of Coded-PHY airspace at once.

Port of btle_tpu/wideband/coded.py. The Coded PHY keeps 1 Msym/s, so the
channelizer's 4 Msps output carries 4 samples per symbol as at LE 1M:
the 80 Msps capture is channelized ONCE (true FP32) and all 40 channels
run the coded receiver (rx.coded.coded_sync_and_decode) as one (40, K)
batch — where the JAX package vmaps over channels. All 40 x
max_candidates trellises of a block go through one Viterbi call (one V1
launch on a card).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..rx.coded import (MAX_PDU_BITS, _aa_pattern_pm, _ci_patterns_pm,
                        coded_sync_and_decode, packets_from)
from ..spec import crc24 as C
from ..spec import whitening as W
from .channelizer import DEFAULT_TAPS, M, bin_to_channel, channelize
from .sniffer import cutoff_for_phy


def wideband_scan_coded(i_wb, q_wb, aa_pm, ci_pm, whiten_rows, crc_init_bits,
                        sps: int = 4, max_candidates: int = 4,
                        num_taps: int = DEFAULT_TAPS,
                        has_context: bool = False, cutoff_mhz: float = 1.0,
                        device=None):
    """80 Msps block -> per-channel coded candidate arrays (40, K, ...), on
    ``device`` (cuda unless the caller passes another)."""
    dev = resolve_device(device)
    y_i, y_q = channelize(i_wb, q_wb, num_taps=num_taps,
                          has_context=has_context, cutoff_mhz=cutoff_mhz,
                          device=dev)
    return coded_sync_and_decode(y_i, y_q, as_tensor(aa_pm, dev),
                                 as_tensor(ci_pm, dev),
                                 as_tensor(whiten_rows, dev),
                                 as_tensor(crc_init_bits, dev), sps=sps,
                                 max_candidates=max_candidates)


def coded_scan_tables(access_address_hex: str = "d6be898e",
                      crc_init_hex: str = "555555", device=None):
    """(aa_pm (256,) float32, ci_pm (2, 40) float32, whiten_rows (40, 360)
    int8, crc_init int32) for the 40-bin scan, on ``device``."""
    dev = resolve_device(device)
    whiten = np.stack([W.whitening_bits(bin_to_channel(m), MAX_PDU_BITS + 24)
                       for m in range(M)])
    return (torch.as_tensor(_aa_pattern_pm(access_address_hex), device=dev),
            torch.as_tensor(_ci_patterns_pm(access_address_hex), device=dev),
            torch.as_tensor(whiten, device=dev),
            torch.tensor(C.lfsr_init_to_table_init(crc_init_hex),
                         dtype=torch.int32, device=dev))


def scan_coded_capture(i_wb, q_wb, max_candidates: int = 4,
                       access_address_hex: str = "d6be898e",
                       crc_init_hex: str = "555555", device=None):
    """Host convenience: whole capture -> list of coded packet dicts, on
    ``device`` (cuda unless the caller passes another)."""
    dev = resolve_device(device)
    aa_pm, ci_pm, whiten, crc_init = coded_scan_tables(
        access_address_hex, crc_init_hex, dev)
    out = wideband_scan_coded(
        as_tensor(i_wb, dev, torch.float32), as_tensor(q_wb, dev, torch.float32),
        aa_pm, ci_pm, whiten, crc_init, max_candidates=max_candidates,
        cutoff_mhz=cutoff_for_phy("1m"), device=dev)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    pkts = []
    for m in range(M):
        for p in packets_from({k: v[m] for k, v in out.items()}, max_candidates):
            pkts.append({"channel": bin_to_channel(m), **p})
    return pkts
