"""Link-layer PDU codecs and the hop-following FSM (copies of
btle_tpu.ll.pdu and btle_tpu.ll.hop)."""

from .hop import ConnectionInfo, HopEvent, HopTracker  # noqa: F401
from .pdu import (  # noqa: F401
    AdvHeader,
    AdvPayload,
    AdvPduType,
    LlCtrlOpcode,
    LlCtrlPayload,
    LlHeader,
    LlPayload,
    LlPduType,
    extract_adv_a,
    parse_adv_header,
    parse_adv_payload,
    parse_ll_header,
    parse_ll_payload,
)
