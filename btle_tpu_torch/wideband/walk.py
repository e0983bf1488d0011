"""The host walk both wideband stream engines share.

The one-card ``WidebandSniffer`` and the mesh's ``ShardedWidebandScan``
scan 40 channels a block on the device and walk the candidate rows on
the host. Their common decisions live here once: the channel geometry,
the scan keys (``ScanKeys``), the span-eating rule (``consume_row``),
the slot-overflow rescan decode (``Rescan``), PDU parsing and the
single-connection follower's re-key. Which packets are parsed, following,
when a re-key applies and how a round's rescans are gathered stay with
each engine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device, upload
from ..convert import scan_tables_from_numpy
from ..ll.pdu import parse_adv_header, parse_adv_payload, parse_ll_header, parse_ll_payload
from ..rx.pipeline import decode_block
from ..spec import bits as B
from ..spec import crc24 as C
from ..spec import whitening as W
from .channelizer import M, bin_to_channel, channelize

CH_SPS = 4  # channelizer output is 4 Msps = 4 samples/symbol
# Symbol-lag phase-difference decisions (the golden model's demod,
# btlelib.py:395-400): after the channelizer's 1 MHz lowpass this reaches
# the reference BER anchors (~11 dB @ 0 ppm), ~2 dB better than the C
# tool's 1-sample lag.
CH_LAG = 4

# Per-phy channel-filter passband default (prototype_filter cutoff, MHz):
# the interference-robust 1.0 MHz at both PHYs; CUTOFF_MHZ_2M_SENS is the
# AWGN-sensitivity-optimized 2M option (see btle_tpu's sniffer and
# BER_CURVES.md for the measurements behind the choice).
CUTOFF_MHZ_1M = 1.0
CUTOFF_MHZ_2M = 1.0
CUTOFF_MHZ_2M_SENS = 1.2

ADV_CHANNELS = (37, 38, 39)


def cutoff_for_phy(phy: str) -> float:
    """Default channel-filter cutoff (MHz) for an LE PHY."""
    ch_sps_for_phy(phy)
    return CUTOFF_MHZ_2M if phy == "2m" else CUTOFF_MHZ_1M


def ch_sps_for_phy(phy: str) -> int:
    """Samples per SYMBOL in the 4 Msps channelizer output for an LE
    PHY — 4 at 1M, 2 at 2M (BLE 5 keeps the 2 MHz channel grid, so only
    the symbol rate changes)."""
    if phy not in ("1m", "2m"):
        raise ValueError(f"unknown phy {phy!r} (want '1m'|'2m')")
    return 2 if phy == "2m" else CH_SPS


@dataclass
class WidebandPacket:
    channel: int
    sample_pos: int                  # absolute per-channel sample index
    payload_len: int
    crc_ok: bool
    pdu_bytes: np.ndarray
    rssi_mag: float
    header: object | None = None
    payload: object | None = None
    # the access address whose correlator row decoded this packet
    access_addr: int = 0x8E89BED6


def _default_scan_arrays():
    aa_bits = B.hex_to_bits("d6be898e")
    aa_mask = np.ones(32, np.int8)
    whiten_rows = np.stack(
        [W.whitening_bits(bin_to_channel(m), 336) for m in range(M)])
    crc_inits = np.full(M, C.lfsr_init_to_table_init("555555"), np.int32)
    adv_flags = np.array([bin_to_channel(m) in ADV_CHANNELS for m in range(M)])
    return aa_bits, aa_mask, whiten_rows, crc_inits, adv_flags


def default_scan_tables(device=None):
    """Standard advertising-scan tables for the 40-bin wideband scan, as
    tensors on ``device``: (aa_bits (32,), aa_mask (32,), whiten_rows
    (40, 336), crc_inits (40,), adv_flags (40,)) — ADV access address,
    all-care mask, per-channel whitening, 0x555555 CRC init, adv flags on
    37/38/39."""
    return scan_tables_from_numpy(*_default_scan_arrays(),
                                  device=resolve_device(device))


class ScanKeys:
    """The keys of a 40-channel scan. ``tables``: (aa_rows (40, 32),
    aa_mask (32,) all-care, whiten_rows (40, 336), crc_inits (40,) table
    form, adv_flags (40,)) on the device, in ``decode_block``'s order;
    host copies of the AA rows, CRC inits and advertising flags; ``aas``
    each channel's access address as an integer (the pcap PHDR's). A
    re-key makes new keys, so the keys a scan was given stay its
    snapshot."""

    def __init__(self, tables, aa_host, crc_host, adv):
        self.tables = tables
        self.aa_host, self.crc_host, self.adv = aa_host, crc_host, adv
        self.aas = [int.from_bytes(B.bits_to_bytes(r).tobytes(), "little")
                    for r in aa_host]

    @classmethod
    def advertising(cls, access_address_hex: str, crc_init_hex: str, device,
                    data_crc_init_table: int | None = None) -> ScanKeys:
        """Every channel keyed to ``access_address_hex``; the advertising
        channels to ``crc_init_hex``, the data channels to
        ``data_crc_init_table`` (table form; None: the same init)."""
        _, mask, whiten, _, adv = _default_scan_arrays()
        aa = np.tile(B.hex_to_bits(access_address_hex), (M, 1))
        crc_adv = C.lfsr_init_to_table_init(crc_init_hex)
        crc_data = crc_adv if data_crc_init_table is None else data_crc_init_table
        crc = np.where(adv, crc_adv, crc_data).astype(np.int32)
        return cls(scan_tables_from_numpy(aa, mask, whiten, crc, adv, device=device),
                   aa, crc, adv)

    def rekey(self, aa_rows, crc_inits) -> ScanKeys:
        """These keys with new AA rows and CRC inits (host arrays),
        uploaded for the scans dispatched from now on."""
        aa_host = np.asarray(aa_rows, np.int8).copy()
        crc_host = np.asarray(crc_inits, np.int32).copy()
        _, mask, whiten, _, adv = self.tables
        return ScanKeys((upload(aa_host, mask.device), mask, whiten,
                         upload(crc_host, mask.device), adv),
                        aa_host, crc_host, self.adv)


def try_track_connection(hop_tracker, pkt, now_us, aa_rows, crc_inits):
    """CONNECT_REQ handling of the single-connection follower: book the
    connection with the hop tracker and, iff the tracker ACCEPTED it
    (state 0 -> tracking), return (conn, new_aa_rows, new_crc_inits) as
    numpy arrays with every data channel keyed to the connection;
    otherwise None. A later CONNECT_REQ while already tracking is
    ignored, like the reference's controller which only consumes
    receiver_status in state 0 (btle_rx.c:2414-2457)."""
    from ..ll.hop import ConnectionInfo
    from ..ll.pdu import AdvPduType

    if not (pkt.crc_ok and pkt.channel in ADV_CHANNELS):
        return None
    try:
        hdr = parse_adv_header(pkt.pdu_bytes[:2])
        if hdr.pdu_type != AdvPduType.CONNECT_REQ:
            return None
        payload = parse_adv_payload(pkt.pdu_bytes[2:], hdr.pdu_type)
    except ValueError:
        return None
    conn = ConnectionInfo(payload.aa, payload.crc_init, payload.hop,
                          payload.interval, payload.chm)
    prev_state = hop_tracker.state
    hop_tracker.on_connect_req(conn, now_us)
    if not (prev_state == 0 and hop_tracker.state != 0):
        return None
    aa_bits = B.hex_to_bits(int(conn.access_addr).to_bytes(4, "little").hex())
    crc_tab = C.crc_init_reorder(conn.crc_init)
    new_aa = np.asarray(aa_rows).copy()
    new_crc = np.asarray(crc_inits).copy()
    for m in range(M):
        if bin_to_channel(m) not in ADV_CHANNELS:
            new_aa[m] = aa_bits
            new_crc[m] = crc_tab
    return conn, new_aa, new_crc


def parse_packet(pkt: WidebandPacket):
    """Attach the parsed header and payload of an advertising or data
    PDU to ``pkt`` (payload None where the PDU does not parse)."""
    try:
        if pkt.channel in ADV_CHANNELS:
            pkt.header = parse_adv_header(pkt.pdu_bytes[:2])
            pkt.payload = parse_adv_payload(pkt.pdu_bytes[2:], pkt.header.pdu_type)
        else:
            pkt.header = parse_ll_header(pkt.pdu_bytes[:2])
            pkt.payload = parse_ll_payload(pkt.pdu_bytes[2:], pkt.header.llid)
    except ValueError:
        pkt.payload = None


def consume_row(row: dict, m: int, lo: int, cursor: int, limit: int, sps: int,
                aa: int, packets: list) -> tuple[int, bool]:
    """Span-eating over channel bin m's candidate row (numpy arrays of
    its slots, in stream order), whose positions count from ``lo``, the
    block's first per-channel sample: a slot at or past ``limit`` is the
    next block's (its halo) and one before ``cursor`` lies inside a
    packet already taken; a bad advertising header skips 48 symbols, a
    packet its length. Appends the packets (unparsed, ``aa`` their
    access address) and returns (the cursor after them, whether every
    slot filled AND more hits exist past them: the caller rescans from
    the cursor)."""
    ch = bin_to_channel(m)
    adv = ch in ADV_CHANNELS
    pos, valid = row["pos"], row["valid"]
    for k in range(len(pos)):
        if not valid[k]:
            return cursor, False
        p = int(pos[k])
        abs_p = lo + p
        if p >= limit or abs_p < cursor:
            continue
        if adv and not row["len_ok"][k]:
            cursor = abs_p + (32 + 16) * sps
            continue
        pl = int(row["payload_len"][k])
        packets.append(WidebandPacket(
            ch, abs_p, pl, bool(row["crc_ok"][k]),
            row["pdu_bytes"][k, : 2 + pl].astype(np.uint8),
            float(row["mag_mean"][k]), access_addr=aa))
        cursor = abs_p + (32 + 16 + (pl + 3) * 8) * sps
    return cursor, int(row["num_hits"]) > len(pos)


def _rows(t, rows):
    """Rows ``rows`` of ``t`` as one tensor, stacked from row views (no
    index upload)."""
    return torch.stack([t[m] for m in rows])


class Rescan:
    """The slot-overflow rescans of one scan window (the wideband block
    with its filter context): the plain true-FP32 channelization, made by
    the first round and kept for the later ones, and one ``decode_block``
    a round over the channel rows still pending, with ``tables``, the
    keys the scan used."""

    def __init__(self, xi, xq, tables, *, sps: int, lag: int,
                 max_candidates: int, num_taps: int, has_context: bool,
                 cutoff_mhz: float, device):
        self._window = (xi, xq)
        self._y = None
        self.tables = tables
        self._decode = dict(sps=sps, lag=lag, max_candidates=max_candidates)
        self._channelize = dict(num_taps=num_taps, has_context=has_context,
                                cutoff_mhz=cutoff_mhz, device=device)

    def decode(self, rows, starts) -> dict:
        """Candidate arrays (len(rows), ...) of channel bins ``rows``, row
        j's scan continued past per-channel sample ``starts[j]``."""
        if self._y is None:
            self._y = channelize(*self._window, **self._channelize)
        y_i, y_q = self._y
        # fill kernels take each value as an argument: no host-to-device
        # copy (an item assignment makes one)
        min_pos = torch.empty(len(rows), dtype=torch.int32, device=y_i.device)
        for j, p in enumerate(starts):
            min_pos[j].fill_(p)
        aa, mask, whiten, crc, adv = self.tables
        return decode_block(_rows(y_i, rows), _rows(y_q, rows), _rows(aa, rows), mask,
                            _rows(whiten, rows), _rows(crc, rows), _rows(adv, rows),
                            min_pos=min_pos, **self._decode)
