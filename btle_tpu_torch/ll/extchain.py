"""Extended-advertising AUX chain linking on the wideband path.

A BLE 5 extended advertiser sends a bare ADV_EXT_IND on a primary
channel whose AuxPtr points at an AUX_ADV_IND on a SECONDARY (data)
channel at a time offset; scanners must retune there in time (Core
Vol 6 Part B 4.4.2.2). A single-radio sniffer (the reference) must
chase that pointer and miss everything else meanwhile. The 40-channel
wideband sniffer already HEARS the secondary channel — AUX PDUs ride
the advertising access address, which keys every data channel until a
connection re-keys it — so linking is pure bookkeeping: match the
AuxPtr's (channel, time window) and the ADI (DID/SID) of a later
packet. No retune, no miss.

``AuxChainLinker`` consumes WidebandPackets in stream order and yields
``AuxLink`` records; chains deeper than one hop (AUX_CHAIN_IND — an
AUX PDU whose own AuxPtr points onward) link the same way since every
ADV_EXT_IND-format PDU carries the same payload structure.
"""

from __future__ import annotations

from dataclasses import dataclass

from .pdu import AdvPduType, parse_adv_header, parse_adv_payload

ADV_AA = 0x8E89BED6
# spec timing: aux offset has 30 us or 300 us granularity; allow one
# unit of quantization either way plus scheduling slack
AUX_WINDOW_SLACK_US = 600


@dataclass
class AuxLink:
    """One followed AuxPtr: primary (or upstream chain) packet -> aux."""

    primary: object                  # WidebandPacket carrying the AuxPtr
    aux: object                      # the pointed-at packet
    offset_error_us: int             # measured arrival vs AuxPtr offset
    did: int
    sid: int


def _ext_payload(pkt):
    """The ExtAdvFields of a packet if it is extended-advertising-shaped.

    Secondary-channel AUX PDUs arrive through the sniffer's data-channel
    walk (parsed as LL PDUs there); re-parse the raw octets as ADV when
    the channel was keyed by the advertising access address."""
    try:
        hdr = parse_adv_header(bytes(pkt.pdu_bytes[:2]))
        if hdr.pdu_type != AdvPduType.ADV_EXT_IND:
            return None
        return parse_adv_payload(bytes(pkt.pdu_bytes[2:]), hdr.pdu_type)
    except (ValueError, IndexError):
        return None


class AuxChainLinker:
    """Feed wideband packets in stream order; collect AuxPtr links.

    ``ch_sps`` converts WidebandPacket.sample_pos (per-channel samples)
    to microseconds (4 at LE 1M's 4 Msps channels, 2 at 2M... the
    PRIMARY use is 1M/coded advertising, where sample_pos/4 = us).
    """

    def __init__(self, ch_sps: int = 4, slack_us: int = AUX_WINDOW_SLACK_US):
        self.ch_sps = ch_sps
        self.slack_us = slack_us
        self._pending: list = []     # (pkt, ext, t_us)
        self.links: list[AuxLink] = []

    def on_packet(self, pkt) -> AuxLink | None:
        if not getattr(pkt, "crc_ok", False):
            return None
        if getattr(pkt, "access_addr", ADV_AA) != ADV_AA:
            return None               # connection traffic, not advertising
        ext_pl = _ext_payload(pkt)
        if ext_pl is None or ext_pl.ext is None:
            return None
        ext = ext_pl.ext
        t_us = pkt.sample_pos // self.ch_sps

        link = None
        if ext.adi_did is not None:
            # try to match a pending AuxPtr: channel + ADI + time window
            for k, (src, src_ext, src_t) in enumerate(self._pending):
                expect = src_t + src_ext.aux_offset_us
                unit = 300 if src_ext.aux_offset_us % 300 == 0 else 30
                if (src_ext.aux_chan == pkt.channel
                        and src_ext.adi_did in (None, ext.adi_did)
                        and abs(t_us - expect) <= unit + self.slack_us):
                    link = AuxLink(src, pkt, int(t_us - expect),
                                   ext.adi_did, ext.adi_sid or 0)
                    self.links.append(link)
                    del self._pending[k]
                    break
        if ext.aux_chan is not None:
            # this packet itself points onward (ADV_EXT_IND or
            # AUX_CHAIN_IND) — park it for the next hop
            self._pending.append((pkt, ext, t_us))
        # age out stale pointers (aux offset caps at ~2.4 ms per unit
        # range; keep a generous horizon)
        horizon = t_us - 1_000_000
        self._pending = [e for e in self._pending if e[2] >= horizon]
        return link

    def feed(self, packets) -> list[AuxLink]:
        """Convenience: consume an iterable, return links in order."""
        out = []
        for p in sorted(packets, key=lambda p: p.sample_pos):
            lk = self.on_packet(p)
            if lk is not None:
                out.append(lk)
        return out
