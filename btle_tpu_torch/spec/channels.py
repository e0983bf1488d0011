"""BLE 40-channel frequency plan and channel-map helpers.

Mirrors get_freq_by_channel_number (btle_rx.c:1006-1022, duplicated at
btle_tx.c:278-291) and chm_is_full_map (btle_rx.c:2395-2400).
"""

from __future__ import annotations

import numpy as np


def channel_to_freq_hz(channel: int) -> int:
    if channel == 37:
        return 2_402_000_000
    if channel == 38:
        return 2_426_000_000
    if channel == 39:
        return 2_480_000_000
    if 0 <= channel <= 10:
        return 2_404_000_000 + channel * 2_000_000
    if 11 <= channel <= 36:
        return 2_428_000_000 + (channel - 11) * 2_000_000
    raise ValueError(f"invalid BLE channel {channel}")


def freq_hz_to_channel(freq_hz: int) -> int:
    for ch in range(40):
        if channel_to_freq_hz(ch) == freq_hz:
            return ch
    raise ValueError(f"no BLE channel at {freq_hz} Hz")


# All 40 channel centres lie on the uniform 2-MHz grid 2402+2k MHz, k=0..39.
# This is what makes a uniform 40-branch polyphase channelizer exact.
def grid_index(channel: int) -> int:
    """Position of ``channel`` on the uniform 2402+2k MHz grid."""
    return (channel_to_freq_hz(channel) - 2_402_000_000) // 2_000_000


GRID_TO_CHANNEL = np.full(40, -1, dtype=np.int32)
for _ch in range(40):
    GRID_TO_CHANNEL[grid_index(_ch)] = _ch
CHANNEL_TO_GRID = np.array([grid_index(c) for c in range(40)], dtype=np.int32)


def chm_is_full_map(chm) -> bool:
    """True iff the CONNECT_REQ channel map covers all 37 data channels.

    ``chm`` is the 5-byte display-order map as parsed by
    parse_adv_pdu_payload_byte (btle_rx.c:1676-1681): chm[0]=0x1F..chm[4]=0xFF.
    """
    chm = [int(x) for x in chm]
    return chm[0] == 0x1F and chm[1:] == [0xFF] * 4


def chm_used_channels(chm) -> tuple[int, ...]:
    """Ascending data channels marked used by a CONNECT_REQ channel map.

    ``chm`` is the 5-byte display-order map (0x1F first, as
    parse_adv_pdu_payload_byte renders it, btle_rx.c:1676-1681); on air
    the map is little-endian with bit j of byte k = channel 8k+j, so the
    display order is reversed here.  This is the usedChannels list of
    the BLE channel-selection algorithm #1 remapping step (Core 5.3
    Vol 6 Part B 4.5.8.2) — capability the reference never implements
    (it refuses any non-full map, btle_rx.c:2417-2425).
    """
    b = [int(x) for x in chm][::-1]
    return tuple(ch for ch in range(37) if (b[ch // 8] >> (ch % 8)) & 1)


def data_channel_hop(current: int, hop: int) -> int:
    """hop_chan = (hop_chan + hop) % 37 (btle_rx.c:2434)."""
    return (current + hop) % 37


def csa1_channel(unmapped: int, used: tuple) -> int:
    """CSA#1 remap: the unmapped channel itself when used, else
    usedChannels[unmapped mod numUsed] (Core 5.3 Vol 6 Part B 4.5.8.2)."""
    return unmapped if unmapped in used else used[unmapped % len(used)]
