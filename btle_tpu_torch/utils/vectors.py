"""Per-stage golden test-vector export + instantaneous-frequency analysis.

The reference's validation methodology exchanges per-module vectors
between its C, Python, and Verilog implementations via text files
(SAVE_FOR_VERILOG hooks in btlelib.py:165-187,502-515; testbenches read
them back, SURVEY.md §4). This module is the framework's equivalent: every
TX/RX stage of the golden chain can be dumped to the same style of
one-value-per-line text files, so downstream hardware/DSP implementations
can check themselves against this framework the way the Verilog chip
checks itself against btlelib.

``instantaneous_freq`` ports check_realtime_fo (btlelib.py:103-129) — the
metric the C<->Python alignment test compares (test_alignment_with_
btle_sdr.py:40-92).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..golden import model as G
from ..spec import bits as B
from ..spec import crc24 as C
from ..spec import whitening as W


def instantaneous_freq(i, q, sps: int):
    """Normalized instantaneous frequency trajectory (cycles/symbol).

    Port of check_realtime_fo (btlelib.py:103-129): angle of the
    one-sample conjugate product scaled by the oversampling.
    Zero samples are treated as +1+1j (deterministic, unlike the
    reference's random replacement — only affects exact-zero samples).
    """
    z = np.asarray(i, dtype=np.double) + 1j * np.asarray(q, dtype=np.double)
    z = np.where(z == 0, 1 + 1j, z)
    d = z[2:] / z[1:-1]
    return sps * np.angle(d) / (2 * np.pi)


@dataclass
class TxStageVectors:
    """Every intermediate of the golden TX chain for one packet."""

    info_bits: np.ndarray        # preamble+AA+PDU (crc24 input)
    info_crc_bits: np.ndarray    # + CRC24 (whitener input)
    phy_bits: np.ndarray         # whitened on-air bits
    upsampled: np.ndarray        # modulator NRZ/impulse input
    i: np.ndarray                # int8 I
    q: np.ndarray                # int8 Q
    files: dict = field(default_factory=dict)


def tx_stage_vectors(pdu_bits, channel: int = 37, crc_init_hex: str = "555555",
                     access_address_hex: str = "D6BE898E", sps: int = 8,
                     flavor: str = "python") -> TxStageVectors:
    aa_bits = B.hex_to_bits(access_address_hex)
    if channel in (37, 38, 39):
        preamble = "aa"
    else:
        preamble = "55" if aa_bits[0] == 1 else "aa"
    head = B.hex_to_bits(preamble + access_address_hex)
    info = np.concatenate([head, np.asarray(pdu_bits, dtype=np.int8)])
    crc = C.crc24_bits(info[40:], B.hex_to_bits(crc_init_hex))
    info_crc = np.concatenate([info, crc])
    phy = info_crc.copy()
    phy[40:] = W.whiten_bits(info_crc[40:], channel)
    if flavor == "python":
        i8, q8, _ = G.gfsk_modulate_python(phy, sps)
        up = np.repeat(phy * 2 - 1, sps)
    else:
        i8, q8 = G.gfsk_modulate_c(phy, sps)
        up = np.zeros(len(phy) * sps, dtype=np.int8)
        up[:: sps] = phy * 2 - 1
    return TxStageVectors(info, info_crc, phy, up, i8, q8)


def dump_tx_vectors(pdu_bits, out_dir: str, prefix: str = "btle_tx", **kwargs) -> dict:
    """Write the TX stage vectors as text files; returns {stage: path}."""
    os.makedirs(out_dir, exist_ok=True)
    v = tx_stage_vectors(pdu_bits, **kwargs)
    files = {
        "crc24_input": v.info_bits,
        "crc24_output_ref": v.info_crc_bits,
        "whiten_input": v.info_crc_bits,
        "whiten_output_ref": v.phy_bits,
        "modulator_input": v.upsampled,
        "modulator_output_i_ref": v.i,
        "modulator_output_q_ref": v.q,
    }
    out = {}
    for stage, arr in files.items():
        path = os.path.join(out_dir, f"{prefix}_{stage}.txt")
        np.savetxt(path, np.asarray(arr, dtype=np.int64), fmt="%d")
        out[stage] = path
    v.files = out
    return out


def dump_rx_vectors(i, q, out_dir: str, channel: int = 37, sps: int = 8,
                    crc_init_hex: str = "555555",
                    access_address_hex: str = "D6BE898E",
                    prefix: str = "btle_rx") -> dict:
    """Decode with the golden receiver and write per-stage vectors
    (demod input/decisions, selected-phase bit stream, de-whitened PDU
    octets, crc verdict) — the btle_rx_* file set of the reference."""
    os.makedirs(out_dir, exist_ok=True)
    res = G.btle_rx(np.asarray(i), np.asarray(q), channel,
                    crc_init_hex=crc_init_hex,
                    access_address_hex=access_address_hex, sps=sps)
    p = res.best_phase
    files = {
        "demod_input_i": np.asarray(i)[p::sps],
        "demod_input_q": np.asarray(q)[p::sps],
        "demod_output_bits_ref": res.bits_all_phases[p],
        "demod_decision_ref": res.decision_all_phases[p],
        "pdu_bits_ref": res.pdu_bits,
        "crc_ok_ref": np.array([int(res.crc_ok)]),
    }
    out = {}
    for stage, arr in files.items():
        path = os.path.join(out_dir, f"{prefix}_{stage}.txt")
        np.savetxt(path, np.asarray(arr, dtype=np.int64), fmt="%d")
        out[stage] = path
    if res.crc_ok:
        octet_path = os.path.join(out_dir, f"{prefix}_pdu_octets_ref.txt")
        with open(octet_path, "w") as fh:
            for byte in B.bits_to_bytes(res.pdu_bits):
                fh.write(f"{byte:02x}\n")
        out["pdu_octets_ref"] = octet_path
    return out


# --------------------------------------------------------------------------
# Complete per-module handoff: one file set per reference testbench
# --------------------------------------------------------------------------

# Every self-checking testbench of the reference chip (verilog/*_tb.v,
# SURVEY.md §4) mapped to the golden-chain signals its DUT consumes and
# produces. dump_module_vectors() emits one input/ref-output file set per
# row; docs/FORMATS.md documents the mapping.
MODULE_TBS = (
    "crc24",
    "scramble",
    "bit_repeat_upsample",
    "gauss_filter",
    "vco",
    "gfsk_modulation",
    "btle_tx",
    "gfsk_demodulation",
    "search_unique_bit_sequence",
    "btle_rx_core",
    "btle_rx",
    "btle_controller",
)


def _writes(out_dir, prefix, arrays, fmt="%d"):
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for role, arr in arrays.items():
        path = os.path.join(out_dir, f"{prefix}_{role}.txt")
        np.savetxt(path, np.asarray(arr, dtype=np.int64), fmt=fmt)
        out[role] = path
    return out


def dump_module_vectors(pdu_bits, out_dir: str, channel: int = 37,
                        crc_init_hex: str = "555555",
                        access_address_hex: str = "D6BE898E",
                        sps: int = 8) -> dict:
    """One input/ref-output vector set per reference testbench.

    Returns {module: {role: path}} and writes vector_manifest.json; the
    TX intermediates come from the python-flavor fixed-point chain
    (btlelib semantics — what the Verilog TBs consume), the RX side from
    the golden receiver on the clean modulated signal.
    """
    import json

    pdu_bits = np.asarray(pdu_bits, dtype=np.int8)
    v = tx_stage_vectors(pdu_bits, channel=channel,
                         crc_init_hex=crc_init_hex,
                         access_address_hex=access_address_hex, sps=sps)
    cos_i8, sin_i8, freq_words = G.gfsk_modulate_python(v.phy_bits, sps)
    res = G.btle_rx(cos_i8.astype(np.int16), sin_i8.astype(np.int16),
                    channel, crc_init_hex=crc_init_hex,
                    access_address_hex=access_address_hex, sps=sps)
    p = res.best_phase
    aa_bits = B.hex_to_bits(access_address_hex)
    hit_k = G.search_bit_sequence(res.bits_all_phases[p], aa_bits)

    modules = {
        # TX bit chain
        "crc24": {"input_bits": v.info_bits[40:],
                  "output_ref": v.info_crc_bits[40:]},
        "scramble": {"input_bits": v.info_crc_bits[40:],
                     "output_ref": v.phy_bits[40:]},
        # TX DSP chain (python-flavor: NRZ repeat, int8 taps, table VCO)
        "bit_repeat_upsample": {"input_bits": v.phy_bits,
                                "output_ref": np.repeat(
                                    v.phy_bits * 2 - 1, sps)},
        "gauss_filter": {"input_nrz": np.repeat(v.phy_bits * 2 - 1, sps),
                         "output_ref": freq_words},
        "vco": {"input_freq_words": freq_words,
                "output_cos_ref": cos_i8, "output_sin_ref": sin_i8,
                "table_cos": G.sin_cos_tables(64, sps)[0],
                "table_sin": G.sin_cos_tables(64, sps)[1]},
        "gfsk_modulation": {"input_bits": v.phy_bits,
                            "output_i_ref": cos_i8, "output_q_ref": sin_i8},
        "btle_tx": {"input_pdu_bits": pdu_bits,
                    "output_i_ref": cos_i8, "output_q_ref": sin_i8},
        # RX chain (selected phase = what btle_rx_core decodes)
        "gfsk_demodulation": {"input_i": cos_i8.astype(np.int16)[p::sps],
                              "input_q": sin_i8.astype(np.int16)[p::sps],
                              "output_bits_ref": res.bits_all_phases[p]},
        "search_unique_bit_sequence": {
            "input_bits": res.bits_all_phases[p],
            "input_pattern": aa_bits,
            "output_position_ref": np.array([hit_k])},
        "btle_rx_core": {"input_i": cos_i8.astype(np.int16)[p::sps],
                         "input_q": sin_i8.astype(np.int16)[p::sps],
                         "output_pdu_octets_ref": B.bits_to_bytes(res.pdu_bits),
                         "output_crc_ok_ref": np.array([int(res.crc_ok)])},
        "btle_rx": {"input_i": cos_i8.astype(np.int16),
                    "input_q": sin_i8.astype(np.int16),
                    "output_best_phase_ref": np.array([p]),
                    "output_payload_len_ref": np.array([res.payload_len]),
                    "output_crc_ok_ref": np.array([int(res.crc_ok)])},
        # full chain: same end-to-end signals, plus the config manifest
        "btle_controller": {"input_pdu_bits": pdu_bits,
                            "output_pdu_octets_ref":
                                B.bits_to_bytes(res.pdu_bits),
                            "output_crc_ok_ref":
                                np.array([int(res.crc_ok)])},
    }
    out = {name: _writes(out_dir, name, arrays)
           for name, arrays in modules.items()}
    config = {
        "channel": channel, "sps": sps, "crc_init": crc_init_hex,
        "access_address": access_address_hex,
        "pdu_hex": B.bits_to_bytes(pdu_bits).tobytes().hex(),
        "modules": {k: sorted(p_.keys()) for k, p_ in out.items()},
    }
    cfg_path = os.path.join(out_dir, "vector_manifest.json")
    with open(cfg_path, "w") as fh:
        json.dump(config, fh, indent=1)
    out["btle_controller"]["config"] = cfg_path
    return out
