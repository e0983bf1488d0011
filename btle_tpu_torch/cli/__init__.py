"""Command-line interface and app layer of the port (``python -m
btle_tpu_torch.cli``): schema-v1 events, scan aggregation, the pcap
loader, recon reports and vendor lookup (btle_tpu.cli's modules; its
tx_builder and rx_proc are not ported yet)."""

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
from .vendors import manufacturer_name, oui_lookup  # noqa: F401
