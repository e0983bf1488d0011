"""Streaming runtime of the port: overlap-save blocks, sample sources,
NDJSON and pcap outputs, control transports and the narrowband Sniffer
(copies of btle_tpu.stream's pure modules; the Sniffer runs its scan on
the port's device pipeline)."""

from .blocks import Block, OverlapBlockIterator  # noqa: F401
from .ndjson import NdjsonEmitter  # noqa: F401
from .pcap import PcapRecord, PcapWriter, read_pcap  # noqa: F401
from .sniffer import PacketEvent, Sniffer, SnifferConfig, sniff_file  # noqa: F401
from .sources import array_source, iq_file_source, stdin_source  # noqa: F401
from .sources import ila_csv_source  # noqa: F401
from .control import ControlServer, encode_reg_writes, parse_register_file, send_command  # noqa: F401
from .hci import (HciFrameCodec, SerialControlServer, UartFramer,  # noqa: F401
                  send_command_serial)
