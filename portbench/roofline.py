"""The yardstick of the scan program: the peaks of the card, and the
operations and bytes one block's scan needs, counted from its shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM),
as btle_tpu_torch/tools/_measure.py states them. The per-kernel bounds
(``k1_bound_ms``, ``k2_bound_ms``) are copies of chip_smoke.py's
``hilo_bound`` and ``tail_bound``; ``scan_least_ms`` is what
``scan_roofline`` divides by the device's busy time a block: it counts
the work whatever implements it, so merging kernels or capturing a graph
leaves it valid.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# tensor-core products per weight term and column, by numerics class
PRODUCTS = {"bf16": 1, "bf16x2w": 2, "f32x2": 4}

M, D, AA_BITS = 40, 20, 32
SLOTS_KEYS_INT32 = 7       # pos, valid, payload_len, len_ok, crc_ok, mag, + 42 octets


def geometry(scan_len: int, num_taps: int = 1280, sps: int = 4, lag: int = 4,
             slots: int = 16) -> dict:
    """The shapes of one wideband block's scan: wideband samples in
    (history + territory + halo), frames J, filter width, baseband
    columns ky, decisions n_bits and hit positions n_hit a channel."""
    halo = (AA_BITS + 336) * sps + lag
    n_wb = num_taps - 1 + (scan_len + halo) * D
    j = -(-(n_wb + 1) // D)
    width = num_taps // D + 1
    k_out = j - (width - 1)
    n_bits = k_out - lag
    n_hit = n_bits - (AA_BITS - 1) * sps
    ky = max(k_out, n_hit + AA_BITS * sps - 1)
    return {"scan_len": scan_len, "n_wb": n_wb, "frames": j, "width": width,
            "ky": ky, "n_bits": n_bits, "n_hit": n_hit, "slots": slots}


def filterbank_ops(g: dict, numerics: str) -> float:
    """Tensor-core operations of the folded filterbank: 80 outputs x 40
    frame rows x width shifts x ky columns, 2 a product."""
    return PRODUCTS[numerics] * 2 * 2 * M * 2 * D * g["width"] * g["ky"]


def tail_ops(g: dict) -> float:
    """Float32 operations of the demod tail: 3 a decision; |y_i|+|y_q|,
    the window tree and a scale (10) and 2 integer ones per AA tap (64)
    per hit position."""
    return M * (3 * g["n_bits"] + (10 + 2 * AA_BITS) * g["n_hit"])


def k1_bound_ms(g: dict, numerics: str = "bf16x2w") -> tuple[float, str]:
    """chip_smoke.py's hilo_bound: the bf16 frames (J + ky pad rows of
    40), the (K_pad, 80 * halves) weight table and y moved once."""
    halves = 2 if numerics == "bf16x2w" else 1
    k_pad = -(-(g["width"] * 2 * D) // 64) * 64
    frame_rows = g["ky"] + g["width"] - 1
    nbytes = frame_rows * 2 * D * 2 + k_pad * 2 * M * halves * 2 + 2 * M * g["ky"] * 4
    return _bound(nbytes, filterbank_ops(g, numerics), BF16_FLOPS)


def k2_bound_ms(g: dict) -> tuple[float, str]:
    """chip_smoke.py's tail_bound: y, the AA tables and the decisions,
    hits and RSSI sums moved once."""
    nbytes = (2 * M * g["ky"] * 4 + M * (AA_BITS + 1) + M * g["n_bits"]
              + M * g["n_hit"] * 5)
    return _bound(nbytes, tail_ops(g), FP32_FLOPS)


def scan_bytes(g: dict) -> float:
    """Each input once (the block's int16 I and Q) and each output once
    (decisions, hits, RSSI sums, the packed candidates)."""
    packed = (SLOTS_KEYS_INT32 * M * g["slots"] + 42 * M * g["slots"] + M) * 4
    return (g["n_wb"] * 2 * 2 + M * g["n_bits"] + M * g["n_hit"]
            + M * g["n_hit"] * 4 + packed)


def scan_least_ms(g: dict, numerics: str) -> tuple[float, str]:
    """The least time of one block's scan: its operations at the
    numerics' peaks, or its bytes at the memory's rate, the larger."""
    t_ops = filterbank_ops(g, numerics) / BF16_FLOPS + tail_ops(g) / FP32_FLOPS
    t_bytes = scan_bytes(g) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
