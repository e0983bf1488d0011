"""BLE LE-1M PHY constants shared across the framework.

Semantics mirror the reference implementations (cited per item):
  - reference python golden model: python/btlelib.py:13-16
  - reference C tools:             host/btle-tools/src/btle_tx.c:80-90,
                                   host/btle-tools/src/btle_rx.c:219-248
"""

from __future__ import annotations

# Symbol rate is always 1 Msym/s for the LE-1M PHY.
SYMBOL_RATE_HZ = 1_000_000

# Gaussian pulse shaping (btlelib.py:14-16)
BT = 0.5
MODULATION_INDEX = 0.5
GAUSS_FILTER_SPAN_SYMBOLS = 2

# Oversampling factors used by the two reference implementations.
# The python/Verilog/FPGA chain runs at 8 Msps (btlelib.py:13); the C SDR
# tools run at 4 Msps (btle_rx.c:219, btle_tx.c:80-84).
SPS_GOLDEN = 8
SPS_C = 4

# Advertising access address. In standard byte order it is 0x8E89BED6
# (btle_rx.c DEFAULT_ACCESS_ADDR); as an over-the-air hex string it is
# "D6BE898E" (btlelib.py:346).
ADV_ACCESS_ADDRESS = 0x8E89BED6
ADV_ACCESS_ADDRESS_HEX = "D6BE898E"

# Advertising-channel CRC init (btle_rx.c DEFAULT_CRC_INIT). Bit-LFSR form
# corresponds to hex string "555555" (btlelib.py:349); the byte-table form
# uses the bit-reversed value 0xAAAAAA (btle_tx.c:1896-1897).
ADV_CRC_INIT_HEX = "555555"

# Preambles (btlelib.py:345-374): advertising channels always use 0xAA;
# data channels use 0xAA or 0x55 depending on the access address LSB.
PREAMBLE_ADV = 0xAA

# Packet geometry (btle_rx.c:241-246, btle_tx.c:91-92)
NUM_PREAMBLE_BYTE = 1
NUM_ACCESS_ADDR_BYTE = 4
NUM_PDU_HEADER_BYTE = 2
NUM_CRC_BYTE = 3
MAX_PAYLOAD_BYTE = 37          # ADV payload limit enforced at btle_rx.c:2293
MAX_LL_PAYLOAD_BYTE = 31       # 5-bit data-channel length field
MAX_NUM_INFO_BYTE = 43         # preamble+AA+header+payload  (btle_tx.c:91)
MAX_NUM_PHY_BYTE = 47          # ... + CRC                   (btle_tx.c:92)

# Bytes demodulated per access-address hit: header + max payload + CRC
# (tmp_byte layout, btle_rx.c:1485)
MAX_PDU_CRC_BYTE = NUM_PDU_HEADER_BYTE + MAX_PAYLOAD_BYTE + NUM_CRC_BYTE  # 42
MAX_PDU_CRC_BITS = MAX_PDU_CRC_BYTE * 8                                   # 336

NUM_CHANNELS = 40
ADV_CHANNELS = (37, 38, 39)
NUM_DATA_CHANNELS = 37

# Fixed-point modulator parameters.
# Golden (python/Verilog) flavor, btlelib.py:151-154: taps = round(128*h),
# output >> 1, VCO gain 64, cos/sin table size 64*SPS/(h/2).
GOLDEN_TAP_SCALE = 128
GOLDEN_POST_SHIFT = 1
# C flavor, btle_tx.c gauss_cos_sin_table.h: taps = round(64*h) over a
# 4-symbol window at SPS=4 (16 taps), phase accumulator masked to 1024.
C_TAP_SCALE = 64
C_PHASE_TABLE_SIZE = 1024
C_LEN_GAUSS_FILTER = 4  # symbols of filter span (btle_tx.c:90)

IQ_AMPLITUDE = 127  # int8 full scale used by every fixed-point table
