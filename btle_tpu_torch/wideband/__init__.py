"""40-channel wideband sniffing on the card: channelizer, fused front
end (hand-written CUDA kernels), sniffer and known-answer self-test."""

from .channelizer import (  # noqa: F401
    CENTER_FREQ_HZ,
    D,
    FS_MSPS,
    M,
    bin_to_channel,
    channel_to_bin,
    channelize,
    compose_wideband,
    prototype_filter,
    synthesize_wideband,
)
from .fused import fused_frontend, wideband_scan_fused  # noqa: F401
from .selftest import WidebandSelfTestError, fused_selftest  # noqa: F401
from .sniffer import WidebandConfig, WidebandPacket, WidebandSniffer, wideband_scan  # noqa: F401
