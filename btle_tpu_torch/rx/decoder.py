"""Host-side decode semantics on top of the dense device pipeline (torch).

Port of btle_tpu/rx/decoder.py. Two parity personalities of the
reference, driven by the device-computed decision lattice / hit mask:

* ``golden_decode`` — btlelib.btle_rx (btlelib.py:414-541): per sampling
  phase, first AA match, first phase with CRC OK wins; symbol-lag demod.
* ``stream_decode`` — the C real-time receiver loop (btle_rx.c:2188-2391):
  single scan over the full-rate lattice with 1-sample-lag demod, packets
  consumed in order, each hit eating its samples before the search resumes.

The heavy math runs on ``device`` (cuda unless the caller passes another:
the narrowband scan and candidate decode kernels there, their plain twins
on the CPU); the candidate bookkeeping below is O(#hits) host work on one
device-to-host copy per ``decode_block`` call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from .._device import resolve_device
from ..spec import bits as B
from ..spec import crc24 as C
from ..spec import whitening as W
from ..spec.constants import ADV_ACCESS_ADDRESS_HEX, ADV_CRC_INIT_HEX, MAX_PDU_CRC_BYTE
from ..utils.profiling import count, span
from .pipeline import (AA_BITS, decode_block, pack_candidates, rssi_dbm_from_mag,
                       scan_block, unpack_candidates)

HDR_BITS = 16


@dataclass
class DecodedPacket:
    """One decoded packet candidate (header + payload + CRC verdict)."""

    sample_pos: int          # full-rate lattice index where the AA starts
    phase: int               # sample_pos % sps
    payload_len: int
    crc_ok: bool
    pdu_bytes: np.ndarray    # 2 + payload_len bytes (header + payload)
    crc_bytes: np.ndarray    # 3 received CRC octets
    rssi_dbm: int | None = None


@dataclass
class BlockDecodeResult:
    packets: list[DecodedPacket] = field(default_factory=list)
    bad_headers: list[DecodedPacket] = field(default_factory=list)  # ADV len out of range
    num_hits: int = 0
    consumed: int = 0        # lattice samples consumed by the scan


@dataclass
class GoldenDecodeResult:
    pdu_bits: np.ndarray
    crc_ok: bool
    payload_len: int
    best_phase: int
    aa_found: bool


def golden_decode(
    i,
    q,
    channel: int = 37,
    crc_init_hex: str = ADV_CRC_INIT_HEX,
    access_address_hex: str = ADV_ACCESS_ADDRESS_HEX,
    sps: int = 8,
    device=None,
) -> GoldenDecodeResult:
    """btlelib.btle_rx-equivalent decode, device-accelerated.

    The per-phase demod + AA search of the reference collapses to one
    dense lag=sps scan; phase selection (first CRC-OK phase wins,
    btlelib.py:459-518) happens here on the tiny hit list.
    """
    dev = resolve_device(device)
    i = np.asarray(i, dtype=np.int16)
    q = np.asarray(q, dtype=np.int16)
    aa_bits = B.hex_to_bits(access_address_hex)
    aa_mask = np.ones(32, dtype=np.int8)
    hit, bits = scan_block(
        torch.as_tensor(i, device=dev)[None], torch.as_tensor(q, device=dev)[None],
        torch.as_tensor(aa_bits, device=dev), torch.as_tensor(aa_mask, device=dev),
        sps=sps, lag=sps,
    )
    hit = hit[0].cpu().numpy()
    bits = bits[0].cpu().numpy()

    crc_init_bits = B.hex_to_bits(crc_init_hex)
    adv = channel in (37, 38, 39)
    num_bit = int(round(len(i) / sps)) - 1

    result = GoldenDecodeResult(np.array([], dtype=np.int8), False, 0, 0, False)
    found_any = False
    for phase in range(sps):
        # first AA match within this phase's symbol stream, bounded the way
        # the reference bounds its per-phase array (num_bit entries)
        ks = np.arange(num_bit)
        lattice_idx = phase + ks * sps
        ok = lattice_idx < len(hit)
        cand = ks[ok & np.where(ok, hit[np.minimum(lattice_idx, len(hit) - 1)], False)]
        if len(cand) == 0:
            continue
        found_any = True
        start_k = int(cand[0])

        # golden truncation semantics: only bits up to this phase's num_bit
        # exist; CRC window clamps to the end (btlelib.py:488-490)
        if phase + (num_bit - 1) * sps < len(bits):
            phase_bits = bits[phase + np.arange(num_bit) * sps]
        else:
            navail = (len(bits) - 1 - phase) // sps + 1
            phase_bits = bits[phase + np.arange(navail) * sps]
        stream = phase_bits[start_k:]
        phy = np.concatenate([np.zeros(8, dtype=np.int8), stream])
        dew = phy.copy()
        dew[40:] = W.whiten_bits(phy[40:], channel)
        nlen = 6 if adv else 5
        plen = B.bits_to_uint(dew[48 : 48 + nlen])
        crc_start = 40 + HDR_BITS + plen * 8
        if crc_start + 24 > len(dew):
            crc_start = len(dew) - 24
        pdu_bits = dew[40:crc_start]
        crc_calc = C.crc24_bits(pdu_bits, crc_init_bits)
        crc_rx = dew[crc_start : crc_start + 24]
        crc_ok = bool(np.array_equal(crc_calc, crc_rx))
        result = GoldenDecodeResult(pdu_bits, crc_ok, plen, phase, True)
        if crc_ok:
            break
    result.aa_found = found_any
    return result


@lru_cache(maxsize=64)
def _scan_tables(aa_hex: str, aa_mask_hex: str | None, channel: int, raw: bool,
                 crc_init_table: int, device: torch.device):
    """One channel's decode tables on ``device`` — AA bits (32,), care mask
    (32,), whitening row (1, 336), CRC init (1,), adv flag (1,) — built
    once per receive configuration, not once per block."""
    count("h2d_copies", 5)
    aa_bits = B.hex_to_bits(aa_hex)
    if aa_mask_hex:
        aa_mask = B.hex_to_bits(aa_mask_hex)
    else:
        aa_mask = np.ones(32, dtype=np.int8)
    # raw mode dumps the demodulated 42 bytes WITHOUT de-whitening
    # (btle_rx.c:2269-2272 skips scramble_byte when raw)
    whiten_seq = (np.zeros(MAX_PDU_CRC_BYTE * 8, np.int8) if raw
                  else W.whitening_bits(channel, MAX_PDU_CRC_BYTE * 8))
    return (torch.tensor(aa_bits, dtype=torch.int8, device=device),
            torch.tensor(aa_mask, dtype=torch.int8, device=device),
            torch.tensor(whiten_seq[None], dtype=torch.int8, device=device),
            torch.tensor([crc_init_table], dtype=torch.int32, device=device),
            torch.tensor([channel in (37, 38, 39)], device=device))


def stream_decode(
    i,
    q,
    channel: int,
    access_address: int | None = None,
    crc_init_table: int | None = None,
    aa_mask_hex: str | None = None,
    sps: int = 4,
    scan_limit: int | None = None,
    raw: bool = False,
    rssi: bool = False,
    start: int = 0,
    max_candidates: int | None = None,
    device=None,
) -> BlockDecodeResult:
    """C-receiver-equivalent scan of one IQ block (btle_rx.c:2188-2391).

    Packets are found in stream order; each access-address hit consumes
    AA + header (+ payload + CRC when the header is sane) samples before
    the search resumes — identical packet sets to the reference's
    sequential scan, computed from the dense hit mask.

    ``scan_limit``: only hits starting before this lattice index are
    reported (the block's own territory); later samples are halo for
    packets that start inside the territory.

    ``start``: lattice positions before this were consumed by the previous
    block's packets (the reference resumes its search exactly at the
    consumed boundary); hits before it neither emit nor eat samples.
    """
    dev = resolve_device(device)
    with span("stream_decode.stage"):
        i = np.asarray(i, dtype=np.int16)
        q = np.asarray(q, dtype=np.int16)
        if access_address is None:
            aa_hex = ADV_ACCESS_ADDRESS_HEX
        else:
            aa_hex = int(access_address).to_bytes(4, "little").hex()
        if crc_init_table is None:
            crc_init_table = C.lfsr_init_to_table_init(ADV_CRC_INIT_HEX)
        tables = _scan_tables(aa_hex, aa_mask_hex, int(channel), bool(raw),
                              int(crc_init_table), dev)
        # Dense device decode: only the tiny candidate arrays come back to
        # the host (the bit lattice and hit mask stay on device), in one
        # copy per call.
        count("h2d_copies", 2)
        ti = torch.as_tensor(i, device=dev)[None]
        tq = torch.as_tensor(q, device=dev)[None]

    adv = channel in (37, 38, 39)
    n_lattice = len(i) - 1
    # candidate slots scale with block size: real packets are >= ~500
    # samples apart after span-eating, and strong packets burn a few
    # adjacent-phase duplicate slots each
    if max_candidates is None:
        max_candidates = max(16, n_lattice // 2048)

    # When a block has more AA hits than candidate slots (loose
    # --access-mask, dense air), the scan continues from the consumed
    # cursor until the territory is covered.
    limit = scan_limit if scan_limit is not None else n_lattice
    res = BlockDecodeResult()
    cursor = start
    done = False
    while not done:
        with span("stream_decode.launch"):
            packed, layout = pack_candidates(decode_block(
                ti, tq, *tables, sps=sps, lag=1, max_candidates=max_candidates,
                with_mag=rssi, min_pos=cursor))
        with span("stream_decode.wait"):
            out = {k: v[0] for k, v in
                   unpack_candidates(packed.cpu().numpy(), layout).items()}
        pos_a = out["pos"]
        valid_a = out["valid"]
        plen_a = out["payload_len"]
        crc_a = out["crc_ok"]
        pdu_a = out["pdu_bytes"].astype(np.uint8)
        mag_a = out["mag_mean"]
        res.num_hits = max(res.num_hits, int(out["num_hits"]))
        exhausted_slots = bool(valid_a.all())
        done = True
        for k in range(len(pos_a)):
            if not valid_a[k]:
                break
            pos = int(pos_a[k])
            if pos < cursor:
                continue  # consumed by a previous packet (btle_rx.c:2226-2232)
            if pos >= limit:
                break
            rssi_dbm = rssi_dbm_from_mag(float(mag_a[k])) if rssi else None
            plen = int(plen_a[k])
            if raw:
                pkt = DecodedPacket(pos, pos % sps, plen, False,
                                    pdu_a[k, :42], np.zeros(3, np.uint8), rssi_dbm)
                res.packets.append(pkt)
                cursor = pos + (AA_BITS + 42 * 8) * sps
                continue
            if adv and not (6 <= plen <= 37):
                # header consumed, packet rejected (btle_rx.c:2290-2298)
                res.bad_headers.append(
                    DecodedPacket(pos, pos % sps, plen, False,
                                  pdu_a[k, :2], np.zeros(3, np.uint8), rssi_dbm)
                )
                cursor = pos + (AA_BITS + HDR_BITS) * sps
                continue
            plen_c = min(plen, 37)
            # the packet's last bit lives at pos + (32 + nbits - 1)*sps
            last_bit = pos + (AA_BITS + (plen_c + 5) * 8 - 1) * sps
            if last_bit >= n_lattice:
                # packet runs past the lattice; the C loop breaks here and
                # the stream layer re-presents these samples next block
                break
            pkt = DecodedPacket(
                pos, pos % sps, plen, bool(crc_a[k]),
                pdu_a[k, : 2 + plen_c].copy(),
                pdu_a[k, 2 + plen_c : 5 + plen_c].copy(), rssi_dbm,
            )
            res.packets.append(pkt)
            cursor = pos + (AA_BITS + HDR_BITS) * sps + (plen_c + 3) * 8 * sps
        else:
            # every slot examined without hitting the territory end: if
            # slots were exhausted there may be unseen hits past the
            # cursor — rescan from it
            if exhausted_slots and cursor < limit:
                last_seen = int(pos_a[len(pos_a) - 1])
                if cursor <= last_seen:
                    # no progress past the seen window is impossible since
                    # every processed hit advances the cursor; but guard
                    # against a stall anyway
                    cursor = max(cursor, last_seen + 1)
                done = False
    res.consumed = cursor
    return res
