"""Typed builders for transmitter packet descriptors.

Role parity with the reference's tx_builder
(host/python/btle_cli/src/btle_cli/tx_builder.py): dataclass packet
types that serialize to the descriptor-DSL lines consumed by
btle_tpu_torch.tx (byte-compatible with the reference btle_tx
packets.txt grammar), plus TxPlan grouping with a repeat count and a
JSON plan loader. A copy of btle_tpu.cli.tx_builder whose
``TxPlan.synthesize`` also takes the modulator's ``device``.

Structure here: each packet type declares a table of _Row specs
(DSL token, attribute, renderer); one generic serializer walks the
table, so adding a packet type is data, not code.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, ClassVar

# ---------------- field rendering ----------------


def _mac(v: str) -> str:
    """Hex blob / MAC: drop separators, lowercase."""
    return str(v).replace(":", "").replace("-", "").lower()


def _u8(v: int) -> str:
    return format(int(v), "02x")


def _u16(v: int) -> str:
    return format(int(v), "04x")


def _plain(v) -> str:
    return str(v)


def _cat16(v: list[str]) -> str:
    return "".join(_mac(u) for u in v)


def _svc_data(v: tuple[str, str]) -> str:
    return _mac(v[0]) + _mac(v[1])


@dataclass(frozen=True)
class _Row:
    """One descriptor field: DSL token name ('' = bare value), source
    attribute, renderer. Optional rows are skipped when the attribute is
    None (or empty, for collections)."""

    token: str
    attr: str
    render: Callable = _plain
    optional: bool = False


# ---------------- packet types ----------------


# The demo station address / iBeacon UUID the reference tools use in
# their README examples; kept as the builder defaults.
_DEMO_ADV_A = "010203040506"
_DEMO_UUID = "B9407F30F5F8466EAFF925556B57FE6D"


@dataclass
class Packet:
    channel: int = 37
    space_ms: int = 0
    packet_type: ClassVar[str] = "RAW"
    ROWS: ClassVar[tuple[_Row, ...]] = ()

    def to_line(self) -> str:
        """Serialize to one descriptor line: chan-TYPE-Field-Value-...
        ('-' inside rendered values becomes '_', the DSL separator rule)."""
        toks = [str(self.channel), self.packet_type]
        for row in type(self).ROWS:
            value = getattr(self, row.attr)
            if row.optional and not value and value != 0:
                continue
            rendered = row.render(value).replace("-", "_")
            toks.extend((row.token, rendered) if row.token else (rendered,))
        if self.space_ms > 0:
            toks.extend(("Space", str(self.space_ms)))
        return "-".join(toks)


@dataclass
class _AdvPacket(Packet):
    """Packets that start with TxAdd/RxAdd header bits and an AdvA."""

    adv_a: str = _DEMO_ADV_A
    tx_add: int = 1
    rx_add: int = 0


@dataclass
class AdvInd(_AdvPacket):
    adv_data_hex: str = ""
    packet_type: ClassVar[str] = "ADV_IND"
    ROWS: ClassVar[tuple[_Row, ...]] = (
        _Row("TxAdd", "tx_add"),
        _Row("RxAdd", "rx_add"),
        _Row("AdvA", "adv_a", _mac),
        _Row("AdvData", "adv_data_hex", _mac),
    )


@dataclass
class IBeacon(Packet):
    adv_a: str = _DEMO_ADV_A
    uuid: str = _DEMO_UUID
    major: int = 8
    minor: int = 9
    tx_power: int = 0xC5
    packet_type: ClassVar[str] = "IBEACON"
    ROWS: ClassVar[tuple[_Row, ...]] = (
        _Row("AdvA", "adv_a", _mac),
        _Row("UUID", "uuid", _mac),
        _Row("Major", "major", _u16),
        _Row("Minor", "minor", _u16),
        _Row("TxPower", "tx_power", _u8),
    )


@dataclass
class Discovery(_AdvPacket):
    """Discoverable broadcaster; unset optional AD fields are omitted."""

    flags: int | None = 0x06
    local_name: str | None = None
    tx_power: int | None = None
    services_16: list[str] = field(default_factory=list)
    service_data_16: tuple[str, str] | None = None
    manuf_data_hex: str | None = None
    conn_interval: int | None = None
    packet_type: ClassVar[str] = "DISCOVERY"
    ROWS: ClassVar[tuple[_Row, ...]] = (
        _Row("TxAdd", "tx_add"),
        _Row("RxAdd", "rx_add"),
        _Row("AdvA", "adv_a", _mac),
        _Row("FLAGS", "flags", _u8, optional=True),
        _Row("LOCAL_NAME09", "local_name", optional=True),
        _Row("TXPOWER", "tx_power", _u8, optional=True),
        _Row("SERVICE03", "services_16", _cat16, optional=True),
        _Row("SERVICE_DATA", "service_data_16", _svc_data, optional=True),
        _Row("MANUF_DATA", "manuf_data_hex", _mac, optional=True),
        _Row("CONN_INTERVAL", "conn_interval", _u16, optional=True),
    )


@dataclass
class Raw(Packet):
    hex_payload: str = ""
    ROWS: ClassVar[tuple[_Row, ...]] = (_Row("", "hex_payload", _mac),)


PACKET_TYPES: dict[str, type[Packet]] = {
    name: cls
    for cls in (AdvInd, IBeacon, Discovery, Raw)
    for name in (cls.packet_type, cls.__name__, cls.__name__.upper())
}
PACKET_TYPES["iBeacon"] = IBeacon


# ---------------- plans ----------------


@dataclass
class TxPlan:
    packets: list[Packet] = field(default_factory=list)
    repeat: int = 1

    def to_packets_txt(self) -> str:
        """The packets.txt body: one descriptor line per packet, with a
        trailing rN repeat directive when repeat != 1."""
        lines = [p.to_line() for p in self.packets]
        if self.repeat != 1:
            lines += [f"r{self.repeat}"]
        return "".join(f"{ln}\n" for ln in lines)

    def specs(self):
        """Parse back into synthesizable PacketSpecs."""
        from ..tx.descriptor import parse_descriptor

        return [parse_descriptor(p.to_line()) for p in self.packets]

    def synthesize(self, flavor: str = "c", sps: int | None = None,
                   device=None):
        """The plan's packets through the fixed-point modulator on
        ``device`` (cuda unless the caller passes another)."""
        from ..tx.synth import synthesize

        return synthesize(self.specs(), flavor=flavor, sps=sps, device=device)


def load_plan(plan_path) -> TxPlan:
    """Load a JSON plan:
    {"packets": [{"type", "channel", "fields", "space_ms"}...],
     "repeat": N}."""
    spec = json.loads(Path(plan_path).read_text())
    built = []
    for entry in spec.get("packets", []):
        type_name = entry.get("type")
        try:
            cls = PACKET_TYPES[type_name]
        except KeyError:
            raise ValueError(f"unknown packet type {type_name!r}") from None
        kwargs = dict(entry.get("fields", {}),
                      channel=entry.get("channel", 37))
        if "space_ms" in entry:
            kwargs["space_ms"] = entry["space_ms"]
        built.append(cls(**kwargs))
    return TxPlan(built, int(spec.get("repeat", 1)))
