"""The one span-eating rule of the wideband walk (``wideband.walk.
consume_row``), which the port's WidebandSniffer and ShardedWidebandScan
both call, on hand-made candidate rows: one case for each branch, each
held against the JAX package's ``WidebandSniffer._consume_channel`` on
the same row, cursor and block offset (the packets and the cursor after
them)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.wideband import WidebandConfig as JConfig
from btle_tpu.wideband import WidebandSniffer as JSniffer

from btle_tpu_torch.wideband.channelizer import channel_to_bin
from btle_tpu_torch.wideband.walk import ScanKeys, consume_row

K = 4
LIMIT = 2048
ADV_AA = "D6BE898E"

# slot: (pos, valid, payload_len, len_ok); ``want``: (packets, exhausted)
CASES = {
    "an invalid slot stops the walk": dict(
        ch=12, lo=8192, cursor=8192, num_hits=9, want=(1, False),
        slots=[(10, True, 5, True), (30, False, 0, False), (900, True, 7, True),
               (1500, True, 7, True)]),
    "a slot at or past the limit is skipped": dict(
        ch=3, lo=0, cursor=0, num_hits=3, want=(1, False),
        slots=[(20, True, 9, True), (LIMIT, True, 4, True),
               (LIMIT + 100, True, 4, True), (0, False, 0, False)]),
    "a slot before the cursor is skipped": dict(
        ch=22, lo=4096, cursor=4096 + 500, num_hits=3, want=(1, False),
        slots=[(100, True, 3, True), (499, True, 3, True), (500, True, 3, True),
               (0, False, 0, False)]),
    "a bad advertising header advances 48 symbols": dict(
        ch=37, lo=0, cursor=0, num_hits=3, want=(1, False),
        slots=[(40, True, 2, False), (40 + 48 * 4 - 1, True, 20, True),
               (40 + 48 * 4, True, 20, True), (0, False, 0, False)]),
    "a bad data-channel length is a packet": dict(
        ch=5, lo=0, cursor=0, num_hits=1, want=(1, False),
        slots=[(40, True, 33, False), (0, False, 0, False), (0, False, 0, False),
               (0, False, 0, False)]),
    "a packet advances by its length": dict(
        ch=39, lo=2048, cursor=2000, num_hits=3, want=(2, False),
        slots=[(0, True, 10, True), (100, True, 6, True), (700, True, 37, True),
               (0, False, 0, False)]),
    "overflow: slots full and more hits past them": dict(
        ch=38, lo=0, cursor=0, num_hits=K + 3, want=(4, True),
        slots=[(0, True, 6, True), (500, True, 6, True), (1000, True, 6, True),
               (1500, True, 6, True)]),
    "full slots and no more hits: no overflow": dict(
        ch=8, lo=0, cursor=0, num_hits=K, want=(4, False),
        slots=[(0, True, 6, True), (500, True, 6, True), (1000, True, 6, True),
               (1500, True, 6, True)]),
    "2M symbols: 2 samples each": dict(
        ch=37, lo=6144, cursor=6144, num_hits=4, want=(2, False), phy="2m",
        slots=[(10, True, 2, False), (10 + 48 * 2, True, 8, True),
               (150, True, 8, True), (10 + 48 * 2 + 152 * 2, True, 8, True)]),
}


def _row(case, rng):
    pos, valid, plen, len_ok = (np.array(v) for v in zip(*case["slots"]))
    return {"pos": pos.astype(np.int32), "valid": valid, "payload_len": plen.astype(np.int32),
            "len_ok": len_ok, "crc_ok": rng.integers(0, 2, K).astype(bool) & len_ok,
            "pdu_bytes": rng.integers(0, 256, (K, 42)).astype(np.int32),
            "mag_mean": rng.uniform(0, 4000, K).astype(np.float32),
            "num_hits": np.int32(case["num_hits"])}


def _fields(p):
    return (p.channel, p.sample_pos, p.payload_len, p.crc_ok, p.pdu_bytes.tolist(),
            p.rssi_mag, p.access_addr)


@pytest.mark.parametrize("name", list(CASES))
def test_consume_row_equals_jax(name):
    case = CASES[name]
    phy = case.get("phy", "1m")
    row = _row(case, np.random.default_rng(len(name)))
    m = channel_to_bin(case["ch"])

    jsn = JSniffer(JConfig(phy=phy))
    jsn._offset_ch = case["lo"]
    jsn._cursors[m] = case["cursor"]
    jpkts = []
    j_exhausted = jsn._consume_channel(m, row, LIMIT, jpkts)

    aa = ScanKeys.advertising(ADV_AA, "555555", "cpu").aas[m]
    pkts = []
    cursor, exhausted = consume_row(row, m, case["lo"], case["cursor"], LIMIT,
                                    2 if phy == "2m" else 4, aa, pkts)

    assert (len(pkts), exhausted) == case["want"]
    assert exhausted == j_exhausted
    assert cursor == jsn._cursors[m]
    assert [_fields(p) for p in pkts] == [_fields(p) for p in jpkts]
