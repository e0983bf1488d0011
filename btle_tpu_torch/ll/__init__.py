"""Link-layer PDU codecs (a copy of btle_tpu.ll.pdu)."""

from .pdu import (  # noqa: F401
    AdvHeader,
    AdvPayload,
    AdvPduType,
    LlHeader,
    LlPayload,
    parse_adv_header,
    parse_adv_payload,
    parse_ll_header,
    parse_ll_payload,
)
