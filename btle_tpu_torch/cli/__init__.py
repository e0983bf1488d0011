"""Command-line interface and app layer of the port (``python -m
btle_tpu_torch.cli``): schema-v1 events, scan aggregation, the pcap
loader, recon reports, vendor lookup, the typed TX plan builder, the
receiver/transmitter subprocess wrappers, the curses TUI and the MCP
tool bodies (btle_tpu.cli's modules, each ported)."""

from .aggregate import DeviceRecord, HopState, ParsedAd, ScanAggregator, parse_ad_structures  # noqa: F401
from .events import Event, HopEvent, PktEvent, StatusEvent, packet_event_to_model, parse_line  # noqa: F401
from .pcap_loader import CaptureFile, PcapPkt, load  # noqa: F401
from .recon import (  # noqa: F401
    DiffReport,
    PayloadEntropyReport,
    ScanSummary,
    TargetProfile,
    diff,
    fingerprint,
    payload_entropy,
    profile,
    quickscan,
)
from .tx_builder import AdvInd, Discovery, IBeacon, Packet, Raw, TxPlan, load_plan  # noqa: F401
from .vendors import manufacturer_name, oui_lookup  # noqa: F401
from .rx_proc import RxOptions, RxProcess, collect_events, receiver_command  # noqa: F401
from .rx_proc import TxOptions, run_tx  # noqa: F401
