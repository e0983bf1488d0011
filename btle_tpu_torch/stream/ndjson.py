"""NDJSON event emitter — schema v1, byte-compatible with the reference.

The reference defines the machine-readable observability contract in
btle_json.h:5-40 (emitted by btle_json.c): one JSON object per line,
``{"v":1,"t":"pkt"|"hop"|"status",...}``. The application layer (btle_cli
events) consumes exactly this schema; we keep it verbatim as the app-layer
ABI.
"""

from __future__ import annotations

import json
import sys
from typing import IO

SCHEMA_VERSION = 1


def _hex_aa(aa: int) -> str:
    return f"{aa & 0xFFFFFFFF:08x}"


def _mac(adv_a: bytes | None) -> str | None:
    if adv_a is None:
        return None
    return ":".join(f"{b:02x}" for b in adv_a)


class NdjsonEmitter:
    def __init__(self, fh: IO[str] | None = None, enabled: bool = True):
        self.fh = fh or sys.stdout
        self.enabled = enabled

    def _emit(self, obj: dict):
        if not self.enabled:
            return
        json.dump(obj, self.fh, separators=(",", ":"))
        self.fh.write("\n")
        self.fh.flush()

    def pkt_adv(self, ts: float, pkt: int, ch: int, aa: int, crc_ok: bool,
                pdu_type: int, pdu_name: str, tx_add: int, rx_add: int,
                plen: int, adv_a: bytes | None, payload: bytes,
                rssi_dbm: int | None):
        self._emit({
            "v": SCHEMA_VERSION, "t": "pkt", "ts": ts, "pkt": pkt, "ch": ch,
            "aa": _hex_aa(aa), "crc_ok": bool(crc_ok), "kind": "adv",
            "pdu_type": pdu_type, "pdu_name": pdu_name,
            "tx_add": tx_add, "rx_add": rx_add, "plen": plen,
            "adv_a": _mac(adv_a),
            "payload_hex": bytes(payload).hex(), "rssi_est": rssi_dbm,
        })

    def pkt_data(self, ts: float, pkt: int, ch: int, aa: int, crc_ok: bool,
                 ll_pdu_type: int, ll_pdu_name: str, nesn: int, sn: int,
                 md: int, plen: int, payload: bytes, rssi_dbm: int | None,
                 plain_hex: str | None = None):
        obj = {
            "v": SCHEMA_VERSION, "t": "pkt", "ts": ts, "pkt": pkt, "ch": ch,
            "aa": _hex_aa(aa), "crc_ok": bool(crc_ok), "kind": "data",
            "ll_pdu_type": ll_pdu_type, "ll_pdu_name": ll_pdu_name,
            "nesn": nesn, "sn": sn, "md": md, "plen": plen,
            "payload_hex": bytes(payload).hex(), "rssi_est": rssi_dbm,
        }
        if plain_hex is not None:
            # additive schema field (the v1 contract allows additions):
            # AES-CCM-authenticated plaintext when a session decrypted
            # this PDU (wideband --ltk)
            obj["plain_hex"] = plain_hex
        self._emit(obj)

    def hop(self, ts: float, event: str, state_from: int, state_to: int,
            ch: int, freq_mhz: int, aa: int, crc_init: int,
            interval_us: int, hop: int, chm: bytes | None):
        self._emit({
            "v": SCHEMA_VERSION, "t": "hop", "ts": ts, "event": event,
            "state_from": state_from, "state_to": state_to, "ch": ch,
            "freq_mhz": freq_mhz, "aa": _hex_aa(aa),
            "crc_init": f"{crc_init & 0xFFFFFF:06x}",
            "interval_us": interval_us, "hop": hop,
            "chm": bytes(chm).hex() if chm is not None else None,
        })

    def status(self, ts: float, event: str, board: str, ch: int,
               freq_hz: int, gain: int = 0, lna: int = 0, amp: int = 0,
               filter_adva: bytes | None = None, msg: str | None = None):
        self._emit({
            "v": SCHEMA_VERSION, "t": "status", "ts": ts, "event": event,
            "board": board, "ch": ch, "freq_hz": freq_hz,
            "gain": gain, "lna": lna, "amp": amp,
            "filter_adva": _mac(filter_adva), "msg": msg,
        })
