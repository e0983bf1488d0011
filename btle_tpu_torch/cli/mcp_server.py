"""MCP server exposing the recon layer as Model Context Protocol tools.

Same tool surface as the reference btle-cli-mcp (docs/MCP.md of btle_cli):
ble_quickscan / ble_profile / ble_capture_to_pcap / ble_diff_pcaps /
ble_payload_entropy — operating on IQ capture files (this framework's
front-end) instead of a live HackRF.

Requires the optional ``mcp`` package (FastMCP); import is deferred so the
rest of the CLI works without it.

Port of btle_tpu.cli.mcp_server: the tools that decode a capture run the
port's narrowband Sniffer (the scan kernel K7 and the candidate decode
K4) on the CUDA card unless given ``device`` (``"cpu"`` runs the plain
PyTorch twins); the pcap and spectrum tools are host-side.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional


def _decode_capture(iq_file: str, fmt: str, channel: int, sps: int,
                    adv_a_filter: Optional[str] = None, pcap_out: Optional[str] = None,
                    device: Optional[str] = None):
    from ..spec.bits import mac_str_to_bytes
    from ..stream import PcapWriter, Sniffer, SnifferConfig, iq_file_source
    from .events import packet_event_to_model

    cfg = SnifferConfig(
        channel=channel, sps=sps, rssi=True,
        filter_adva=bytes(mac_str_to_bytes(adv_a_filter)) if adv_a_filter else None,
    )
    pcap = PcapWriter(pcap_out) if pcap_out else None
    sniffer = Sniffer(cfg, pcap=pcap, quiet_text=True, device=device)
    events = sniffer.run(iq_file_source(iq_file, fmt))
    if pcap:
        pcap.close()
    return [packet_event_to_model(e) for e in events if e.header is not None]


# -- tool implementations -------------------------------------------------
# Plain functions so they are directly callable (and testable) without the
# FastMCP transport; build_server() only registers them.


def ble_quickscan(iq_file: str, fmt: str = "i16", channel: int = 37,
                  sps: int = 4, top_n: int = 15,
                  device: Optional[str] = None) -> dict[str, Any]:
    """Decode a capture and summarize the devices seen."""
    from . import recon

    events = _decode_capture(iq_file, fmt, channel, sps, device=device)
    return recon.quickscan(events, top=top_n).model_dump(exclude_none=True)


def ble_profile(adv_a: str, iq_file: str | None = None, fmt: str = "i16",
                channel: int = 37, sps: int = 4,
                pcap: str | None = None,
                device: Optional[str] = None) -> dict[str, Any]:
    """Profile one device from a capture file or pcap."""
    from . import recon

    if pcap:
        return recon.profile(pcap, adv_a).model_dump(exclude_none=True)
    events = _decode_capture(iq_file, fmt, channel, sps, device=device)
    return recon.profile(events, adv_a).model_dump(exclude_none=True)


def ble_capture_to_pcap(iq_file: str, output_path: str, fmt: str = "i16",
                        channel: int = 37, sps: int = 4,
                        adv_a: str | None = None,
                        device: Optional[str] = None) -> dict[str, Any]:
    """Decode a capture to a Wireshark-compatible pcap (DLT 256)."""
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    events = _decode_capture(iq_file, fmt, channel, sps,
                             adv_a_filter=adv_a, pcap_out=output_path,
                             device=device)
    return {
        "pcap": output_path,
        "n_packets": len(events),
        "n_crc_ok": sum(1 for e in events if e.crc_ok),
    }


def ble_diff_pcaps(pcap_a: str, pcap_b: str) -> dict[str, Any]:
    """What changed between two pcaps."""
    from . import recon

    return recon.diff(pcap_a, pcap_b).model_dump(exclude_none=True)


def ble_payload_entropy(pcap: str, adv_a: str) -> dict[str, Any]:
    """Which manufacturer-data bytes vary: counter, random, static."""
    from . import recon

    return recon.payload_entropy(pcap, adv_a).model_dump(exclude_none=True)


def ble_iq_occupancy(iq_file: str, fmt: str = "i16",
                     rate_hz: float = 8e6, fft_size: int = 256,
                     center_hz: float | None = None,
                     threshold_db: float = 12.0,
                     max_samples: int = 4_000_000) -> dict[str, Any]:
    """Spectral occupancy of an IQ capture without decoding: which
    frequency offsets carry energy, how strong, what duty cycle (the
    waterfall view of `iq-show`, machine-readable). Beyond the
    reference's 5-tool surface — its waterfall exists only as a plot."""
    from ..stream.sources import load_iq_capped
    from ..utils.spectrum import occupancy, waterfall

    i, q = load_iq_capped(iq_file, fmt, max_samples)
    power = waterfall(i, q, fft_size=fft_size)
    occ = occupancy(power, rate_hz, threshold_db=threshold_db)
    if center_hz is not None:
        for row in occ:
            row["freq_hz"] = center_hz + row["freq_offset_hz"]
    return {
        "n_samples": int(len(i)),
        "duration_ms": len(i) / rate_hz * 1e3,
        "fft_size": fft_size,
        "occupied_bins": occ[:64],
        "n_occupied": len(occ),
    }


def ble_gatt_report(pcap: str, ltk_hex: str | None = None) -> dict[str, Any]:
    """Reconstruct the GATT conversation from a capture's connection
    traffic: L2CAP reassembly over the LL fragments + ATT parse; with
    ltk_hex the LL_ENC_REQ/RSP exchange in the same capture keys the
    session and encrypted PDUs decrypt first. Beyond the reference's
    5-tool surface — its app layer stops at advertising AD structures."""
    from . import recon

    return recon.gatt(pcap, ltk_hex=ltk_hex).model_dump(exclude_none=True)


TOOLS = (ble_quickscan, ble_profile, ble_capture_to_pcap, ble_diff_pcaps,
         ble_payload_entropy, ble_iq_occupancy, ble_gatt_report)


def build_server():
    from mcp.server.fastmcp import FastMCP

    mcp = FastMCP("btle-tpu")
    for tool in TOOLS:
        mcp.tool()(tool)
    return mcp


def main() -> int:
    try:
        server = build_server()
    except ImportError:
        import sys

        print("mcp package not installed; `pip install mcp` to use the server",
              file=sys.stderr)
        return 1
    server.run()
    return 0
