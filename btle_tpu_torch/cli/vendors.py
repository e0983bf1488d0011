"""Vendor identification: BLE manufacturer IDs and MAC OUI prefixes.

Resolution order: the bundled full IEEE registry snapshot
(``data/oui.tsv.gz``, ~39k assignments, built by tools/build_oui_db.py —
the counterpart of the reference's bundled database, btle_cli
oui.py:1-54), overlaid by the compact built-in table below, overlaid by
an optional external TSV (``BTLE_OUI_TSV`` env or ``load_oui_tsv``).
"""

from __future__ import annotations

import gzip
import os
from functools import lru_cache
from typing import Optional

# Bluetooth SIG company identifiers (subset; assigned numbers document)
MANUFACTURER_IDS = {
    0x0000: "Ericsson",
    0x0006: "Microsoft",
    0x000A: "Qualcomm",
    0x000F: "Broadcom",
    0x0059: "Nordic Semiconductor",
    0x004C: "Apple",
    0x0075: "Samsung",
    0x00E0: "Google",
    0x0087: "Garmin",
    0x0157: "Xiaomi (Anhui Huami)",
    0x038F: "Xiaomi",
    0x0171: "Amazon",
    0x00D2: "Dialog Semiconductor",
    0x0030: "ST Microelectronics",
    0x000D: "Texas Instruments",
    0x0131: "Cypress Semiconductor",
    0x02E5: "Espressif",
    0x018E: "Fitbit",
    0x012D: "Sony",
    0x0499: "Ruuvi Innovations",
    0x0001: "Nokia",
    0x03DA: "Tile",
    0x0310: "SGL Italia",
    0x004F: "APT",
}

# Small built-in OUI prefixes seen commonly on BLE devices.
_BUILTIN_OUI = {
    "00:18:30": "Texas Instruments",
    "90:D7:EB": "Texas Instruments",
    "A4:C1:38": "Telink Semiconductor",
    "D0:37:45": "TP-Link",
    "F4:5C:89": "Apple",
    "AC:BC:32": "Apple",
    "F0:18:98": "Apple",
    "5C:F3:70": "CC&C Technologies",
    "B8:27:EB": "Raspberry Pi Foundation",
    "DC:A6:32": "Raspberry Pi Trading",
    "E4:5F:01": "Raspberry Pi Trading",
    "00:1A:7D": "cyber-blue (HK)",
    "C8:69:CD": "Apple",
    "38:81:D7": "Texas Instruments",
    "EC:11:27": "Texas Instruments",
}


def manufacturer_name(mid: int) -> Optional[str]:
    return MANUFACTURER_IDS.get(mid)


_BUNDLED_DB = os.path.join(os.path.dirname(__file__), "data", "oui.tsv.gz")


@lru_cache(maxsize=1)
def _oui_table() -> dict[str, str]:
    table: dict[str, str] = {}
    if os.path.exists(_BUNDLED_DB):
        table.update(_load_tsv(_BUNDLED_DB))
    table.update(_BUILTIN_OUI)
    path = os.environ.get("BTLE_OUI_TSV")
    if path and os.path.exists(path):
        table.update(_load_tsv(path))
    return table


def _load_tsv(path: str) -> dict[str, str]:
    opener = gzip.open if path.endswith(".gz") else open
    out: dict[str, str] = {}
    with opener(path, "rt", errors="replace") as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and len(parts[0]) >= 8:
                out[parts[0][:8].upper()] = parts[1]
    return out


def load_oui_tsv(path: str) -> None:
    """Load an external OUI table (tsv: 'AA:BB:CC<TAB>Vendor')."""
    os.environ["BTLE_OUI_TSV"] = path
    _oui_table.cache_clear()


def normalize_mac_prefix(mac: str) -> Optional[str]:
    s = mac.replace("-", ":").upper()
    parts = s.split(":")
    if len(parts) < 3:
        if len(s) >= 6 and ":" not in s:
            parts = [s[0:2], s[2:4], s[4:6]]
        else:
            return None
    return ":".join(parts[:3])


def oui_lookup(mac: str) -> Optional[str]:
    prefix = normalize_mac_prefix(mac)
    if prefix is None:
        return None
    return _oui_table().get(prefix)
