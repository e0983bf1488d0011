"""NDJSON schema-v1 event models (the app-layer ABI).

Port of btle_tpu/cli/events.py without pydantic: the three events are
dataclasses with the same fields and defaults, validated on construction
by the rules of pydantic's lax mode (``"37"``, ``37.0`` and ``True`` are
an int, ``"yes"`` is a bool, ``1`` is a float) and keeping unknown keys
(``extra="allow"``: kept as attributes, dumped after the declared
fields). ``model_dump_json`` writes what pydantic writes (see ``dumps``),
so the reports of recon.py print the same bytes as the JAX package's.
``parse_line`` never raises: malformed input returns None.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import types
import typing
from dataclasses import dataclass
from decimal import Decimal
from typing import Literal, Union

# --------------------------------------------------------------------------
# the JSON writer
# --------------------------------------------------------------------------


def _float_json(x: float) -> str:
    """A finite float as pydantic writes it: the shortest digits that
    round-trip (Python's repr gives the same digits), laid out as the
    ryu crate lays them out: positional while 1e-5 <= |x| < 1e16 (with
    ``.0`` when whole), else ``d.ddde<exp>`` with no ``+`` and no zero
    padding in the exponent. Non-finite floats are null."""
    if not math.isfinite(x):
        return "null"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    sign, digits, exp = Decimal(repr(x)).normalize().as_tuple()
    mant = "".join(map(str, digits))
    kk = len(mant) + exp             # 10**(kk-1) <= |x| < 10**kk
    head = "-" if sign else ""
    if 0 <= exp and kk <= 16:
        return f"{head}{mant}{'0' * exp}.0"
    if 0 < kk <= 16:
        return f"{head}{mant[:kk]}.{mant[kk:]}"
    if -5 < kk <= 0:
        return f"{head}0.{'0' * -kk}{mant}"
    frac = f".{mant[1:]}" if len(mant) > 1 else ""
    return f"{head}{mant[0]}{frac}e{kk - 1}"


def _write(obj, indent: int | None, level: int, out: list) -> None:
    if obj is None:
        out.append("null")
    elif obj is True or obj is False:
        out.append("true" if obj else "false")
    elif isinstance(obj, int):
        out.append(str(int(obj)))
    elif isinstance(obj, float):
        out.append(_float_json(obj))
    elif isinstance(obj, str):
        obj.encode("utf-8")          # a lone surrogate cannot be written
        out.append(json.dumps(obj, ensure_ascii=False))
    elif isinstance(obj, (dict, list, tuple)):
        items = list(obj.items()) if isinstance(obj, dict) else list(obj)
        opener, closer = ("{", "}") if isinstance(obj, dict) else ("[", "]")
        if not items:
            out.append(opener + closer)
            return
        pad = "" if indent is None else "\n" + " " * (indent * (level + 1))
        out.append(opener)
        for k, item in enumerate(items):
            out.append(("," if k else "") + pad)
            if isinstance(obj, dict):
                _write(str(item[0]), indent, level + 1, out)
                out.append(":" if indent is None else ": ")
                item = item[1]
            _write(item, indent, level + 1, out)
        out.append("" if indent is None else "\n" + " " * (indent * level))
        out.append(closer)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as JSON")


def dumps(obj, indent: int | None = None) -> str:
    """JSON as pydantic's ``model_dump_json`` writes it: declared order,
    non-ASCII as is, control characters escaped, floats in the shortest
    round-trip form of ``_float_json``; ``indent`` spaces per level with
    ``,`` ending a line and ``: `` after a key (compact without)."""
    out: list = []
    _write(obj, indent, 0, out)
    return "".join(out)


# --------------------------------------------------------------------------
# lax validation (pydantic 2's lax mode on the values json.loads yields)
# --------------------------------------------------------------------------

# Unicode White_Space: what a Rust str trim removes (Python's strip also
# removes \x1c-\x1f)
_WS = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
       "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_INT_PLAIN = re.compile(r"[+-]?[0-9]+(_[0-9]+)*\Z")
_INT_JSON = re.compile(r"-?(0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"[+-]?(inf|infinity|nan|([0-9]+\.?[0-9]*|\.[0-9]+)(e[+-]?[0-9]+)?)\Z",
                    re.IGNORECASE)
_BOOL_STR = {"0": False, "off": False, "f": False, "false": False, "n": False,
             "no": False, "1": True, "on": True, "t": True, "true": True,
             "y": True, "yes": True}
_I64 = 2.0 ** 63


class _Invalid(ValueError):
    pass


def _strip_underscores(s: str) -> str | None:
    if "__" in s or s.startswith("_") or s.endswith("_"):
        return None
    return s.replace("_", "")


def _int_text(s: str) -> int | None:
    if _INT_PLAIN.match(s):
        return int(s.replace("_", ""))
    # leading zeros (and underscores among them) go, keeping the sign
    sign = s[:1] if s[:1] in ("+", "-") else ""
    rest = s[len(sign):]
    if not rest.startswith("0"):
        return None
    tail = rest.lstrip("0_")
    if not tail:
        return 0 if rest.endswith("0") else None
    body = _strip_underscores(("-" if sign == "-" else "") + tail)
    return int(body) if body is not None and _INT_JSON.match(body) else None


def _int_from_str(s: str) -> int | None:
    s = s.strip(_WS)
    if len(s) > 4300:
        return None
    got = _int_text(s)
    dot = s.find(".")
    if got is None and dot >= 0 and s[dot + 1:] and not s[dot + 1:].strip("0"):
        got = _int_text(s[:dot])
    return got


def _float_from_str(s: str) -> float | None:
    t = s.strip(_WS)
    if _FLOAT.match(t):
        return float(t)
    t = _strip_underscores(s)
    return float(t) if t is not None and _FLOAT.match(t) else None


def _as_int(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if math.isfinite(v) and v == int(v) and -_I64 < v < _I64:
            return int(v)
    elif isinstance(v, str):
        got = _int_from_str(v)
        if got is not None:
            return got
    raise _Invalid(f"not an int: {v!r}")


def _as_float(v):
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, int):
        try:
            return float(v)
        except OverflowError:
            pass
    elif isinstance(v, float):
        return v
    elif isinstance(v, str):
        got = _float_from_str(v)
        if got is not None:
            return got
    raise _Invalid(f"not a float: {v!r}")


def _as_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _BOOL_STR:
        return _BOOL_STR[v.lower()]
    raise _Invalid(f"not a bool: {v!r}")


def _as_str(v):
    if isinstance(v, str):
        return v
    raise _Invalid(f"not a str: {v!r}")


_COERCE = {int: _as_int, float: _as_float, bool: _as_bool, str: _as_str}


def _validator(tp):
    """The lax-mode check of one annotation: int, float, bool, str, an
    Optional of one of those, a Literal of strings, or a list of
    report models / plain values (recon.py's reports)."""
    origin = typing.get_origin(tp)
    if origin in (Union, types.UnionType):
        (inner,) = [a for a in typing.get_args(tp) if a is not type(None)]
        check = _validator(inner)
        return lambda v: None if v is None else check(v)
    if origin is Literal:
        allowed = typing.get_args(tp)

        def literal(v):
            if isinstance(v, str) and v in allowed:
                return v
            raise _Invalid(f"not one of {allowed}: {v!r}")
        return literal
    if origin in (list, dict):
        return lambda v: v
    return _COERCE.get(tp, lambda v: v)


@dataclass(init=False)
class Model:
    """A pydantic-like dataclass: keyword construction with lax
    validation of every declared field (a bad value raises ValueError),
    ``model_dump`` / ``model_dump_json``. Subclasses set ``_EXTRA`` to
    "allow" (unknown keys kept, as attributes and in dumps) or "forbid"
    (they raise)."""

    _EXTRA: typing.ClassVar[str] = "forbid"

    def __init__(self, **data):
        checks = _checks(type(self))
        extra = {k: v for k, v in data.items() if k not in checks}
        if extra and self._EXTRA != "allow":
            raise _Invalid(f"unexpected fields {sorted(extra)}")
        for name, (check, default) in checks.items():
            if name in data:
                value = check(data[name])
            elif default is not dataclasses.MISSING:
                value = default()
            else:
                raise _Invalid(f"missing field {name!r}")
            object.__setattr__(self, name, value)
        object.__setattr__(self, "model_extra", extra)
        for k, v in extra.items():
            # an extra named like a method or model_extra stays in
            # model_extra only (as pydantic keeps extras beside its API)
            if k != "model_extra" and not hasattr(type(self), k):
                object.__setattr__(self, k, v)

    @classmethod
    def model_validate(cls, obj: dict):
        if not isinstance(obj, dict):
            raise _Invalid(f"{cls.__name__} needs a dict")
        return cls(**obj)

    def model_dump(self, exclude_none: bool = False) -> dict:
        out = {f.name: _dump_value(getattr(self, f.name), exclude_none)
               for f in dataclasses.fields(self)}
        out.update(self.model_extra)
        if exclude_none:
            out = {k: v for k, v in out.items() if v is not None}
        return out

    def model_dump_json(self, indent: int | None = None,
                        exclude_none: bool = False) -> str:
        return dumps(self.model_dump(exclude_none=exclude_none), indent)


def _dump_value(v, exclude_none: bool):
    if isinstance(v, Model):
        return v.model_dump(exclude_none=exclude_none)
    if isinstance(v, list):
        return [_dump_value(x, exclude_none) for x in v]
    return v


@functools.cache
def _checks(cls) -> dict:
    """{field: (lax check, default factory or MISSING)} of a Model."""
    hints = typing.get_type_hints(cls)
    table = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = (lambda d=f.default: d)
        else:
            default = f.default_factory
        table[f.name] = (_validator(hints[f.name]), default)
    return table


# --------------------------------------------------------------------------
# the events
# --------------------------------------------------------------------------


@dataclass(init=False)
class _Base(Model):
    _EXTRA: typing.ClassVar[str] = "allow"

    v: int
    t: str
    ts: float


@dataclass(init=False)
class PktEvent(_Base):
    t: Literal["pkt"]
    pkt: int
    ch: int
    aa: str
    crc_ok: bool
    kind: Literal["adv", "data"]
    plen: int
    payload_hex: str
    rssi_est: int | None = None

    # ADV branch
    pdu_type: int | None = None
    pdu_name: str | None = None
    tx_add: int | None = None
    rx_add: int | None = None
    adv_a: str | None = None

    # DATA branch
    ll_pdu_type: int | None = None
    ll_pdu_name: str | None = None
    nesn: int | None = None
    sn: int | None = None
    md: int | None = None


@dataclass(init=False)
class HopEvent(_Base):
    t: Literal["hop"]
    event: str
    state_from: int
    state_to: int
    ch: int
    freq_mhz: int
    aa: str
    crc_init: str
    interval_us: int
    hop: int
    chm: str | None = None


@dataclass(init=False)
class StatusEvent(_Base):
    t: Literal["status"]
    event: str
    board: str = ""
    ch: int = 0
    freq_hz: int = 0
    gain: int = 0
    lna: int = 0
    amp: int = 0
    filter_adva: str | None = None
    msg: str | None = None


Event = Union[PktEvent, HopEvent, StatusEvent]

_BY_TYPE = {"pkt": PktEvent, "hop": HopEvent, "status": StatusEvent}


def parse_line(line: str) -> Event | None:
    s = line.strip()
    if not s or s[0] != "{":
        return None
    try:
        obj = json.loads(s)
    except (ValueError, RecursionError):
        return None
    kind = obj.get("t") if isinstance(obj, dict) else None
    model = _BY_TYPE.get(kind) if isinstance(kind, str) else None
    if model is None:
        return None
    try:
        return model.model_validate(obj)
    except ValueError:
        return None


def packet_event_to_model(ev, ts: float | None = None) -> PktEvent:
    """Convert an in-process stream.sniffer.PacketEvent to the wire model
    (lets the aggregator consume in-process decodes without JSON)."""
    from ..ll.pdu import extract_adv_a

    base = dict(
        v=1, t="pkt", ts=ts if ts is not None else ev.ts_us / 1e6,
        pkt=ev.pkt_count, ch=ev.channel, aa=f"{ev.access_addr:08x}",
        crc_ok=ev.crc_ok, plen=ev.header.payload_len,
        payload_hex=bytes(ev.payload_bytes).hex(), rssi_est=ev.rssi_dbm,
    )
    if ev.is_adv:
        adv_a = None
        if ev.payload is not None:
            a = extract_adv_a(ev.payload, ev.header.pdu_type)
            if a is not None:
                adv_a = ":".join(f"{b:02x}" for b in a)
        return PktEvent(
            kind="adv", pdu_type=int(ev.header.pdu_type),
            pdu_name=ev.header.pdu_type.display_name,
            tx_add=ev.header.tx_add, rx_add=ev.header.rx_add,
            adv_a=adv_a, **base,
        )
    return PktEvent(
        kind="data", ll_pdu_type=int(ev.header.llid),
        ll_pdu_name=ev.header.llid.display_name,
        nesn=ev.header.nesn, sn=ev.header.sn, md=ev.header.md, **base,
    )
