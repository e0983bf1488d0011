"""The plain reference decodes the scenes' packets, as the port does."""

import json

import numpy as np

from portbench import core
from portbench.reference import ble
from portbench.reference import narrowband as nref
from portbench.reference import wideband as wref
from portbench.scenes import ble_air


def _scene(traffic, seed, salt, **kw):
    p = {**json.loads((core.HERE / "traffic" / f"{traffic}.json").read_text())["scene"], **kw}
    return ble_air.generate(p, seed, salt)


def test_narrowband_reference_decodes_every_packet():
    s = _scene("live4m_8k", 2**31 + 3, 2, air_s=0.3)
    scan, halo = 8192, nref.halo(4, 1)
    w = nref.NarrowbandWalker(37, ble.ADV_AA, ble.ADV_CRC_INIT_TABLE, 4, scan, 16, True, 4)
    events = []
    for k in range(s.n_pairs // scan - 2):
        idx = (k * scan + np.arange(scan + halo)) % s.n_pairs
        events += w.block(s.iq[2 * idx].astype(np.int16), s.iq[2 * idx + 1].astype(np.int16),
                          k * scan)[0]
    got = {(e.sample_pos, e.pdu) for e in events if e.crc_ok}
    placed = [p for p in s.packets_on(ble.ADV_AA)
              if p.aa_start < (s.n_pairs // scan - 2) * scan]
    assert len(placed) > 40
    for p in placed:
        assert any(abs(pos - p.aa_start) <= 4 and pdu == p.pdu for pos, pdu in got), p


def test_wideband_reference_equals_the_port_and_decodes_the_scene():
    from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer

    s = _scene("replay_8k", 7, 1, air_s=0.02, advertisers=100)
    scan = 2048
    step, ctx_len = scan * wref.D, 1279
    halo = 1476 * wref.D
    sn = WidebandSniffer(WidebandConfig(scan_len_ch=scan, fused=True), device="cpu")
    walker = wref.Walker(scan, 4, 16, ble.ADV_AA, ble.ADV_CRC_INIT_TABLE)
    i, q = s.iq[0::2], s.iq[1::2]
    port, ref = [], []
    for k in range((s.n_pairs - halo) // step):
        blk = slice(k * step, k * step + step + halo)
        port += sn.process(i[blk], q[blk])
        idx = np.arange(k * step - ctx_len, k * step + step + halo)
        xi = np.where(idx >= 0, i[np.maximum(idx, 0)], 0)
        xq = np.where(idx >= 0, q[np.maximum(idx, 0)], 0)
        bits, hit, mag = wref.block_lattice(xi, xq, 1280, 1.0, "bf16", ble.ADV_AA, 4, 4, "cpu")
        ref += walker.block(bits.numpy(), hit.numpy(), mag.numpy())
    key = lambda p: (p.channel, int(p.sample_pos), bool(p.crc_ok))  # noqa: E731
    assert sorted(map(key, port)) == sorted(map(key, ref))
    assert sorted(bytes(p.pdu_bytes.astype(np.uint8)) for p in port) == \
        sorted(p.pdu for p in ref)
    ok = {(p.channel, p.pdu) for p in ref if p.crc_ok}
    placed = [p for p in s.packets_on(ble.ADV_AA)
              if p.aa_start < len(range((s.n_pairs - halo) // step)) * step]
    exact = sum((p.channel, p.pdu) in ok for p in placed)
    # the receiver decodes from the earliest AA hit, whose phase loses a
    # few clean packets; the reference and the port lose the same ones
    assert exact >= 0.95 * len(placed) and len(placed) > 40
