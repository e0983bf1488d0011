"""TX synthesis: the btle_tx descriptor DSL, the fixed-point modulators
on the device, plan and wideband-scene composition, UDP playback."""

from .descriptor import (  # noqa: F401
    ALL_PKT_TYPES,
    DescriptorError,
    PacketSpec,
    parse_descriptor,
    parse_descriptor_sequence,
    read_packet_file,
)
from .synth import (  # noqa: F401
    SynthesizedPacket,
    plan_to_stream,
    plan_to_wideband,
    synthesize,
)
