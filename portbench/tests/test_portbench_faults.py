"""The comparison that decides ``correct`` rejects a broken timed path:
the harness's look for a card is skipped (the port's plain twins run on
the CPU, at a small size) and the rest of a run is driven with the path
broken underneath. The controls run here too; on the card the control
runs at the cell's own size (test_portbench_control.py)."""

import contextlib

import pytest

from portbench import controls, core

from . import smallrun


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _stale(orig):
    """A scan that returns its previous block's outputs: its state
    unchanged."""
    last = {}

    def f(*a, **k):
        out = orig(*a, **k)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return f


def _half_frontend(orig):
    """Half the channels left out: their decisions, hits and RSSI zero."""
    def f(*a, **k):
        bits, hit, mag = orig(*a, **k)
        bits, hit, mag = bits.clone(), hit.clone(), mag.clone()
        bits[20:] = 0
        hit[20:] = False
        mag[20:] = 0
        return bits, hit, mag
    return f


def _altered_octet(orig):
    """One decoded octet altered where the decode produces it."""
    def f(*a, **k):
        pkt_bytes, plen, match, len_ok = orig(*a, **k)
        pkt_bytes = pkt_bytes.clone()
        pkt_bytes[..., 0, 5] ^= 1
        return pkt_bytes, plen, match, len_ok
    return f


def _half_hits(orig):
    """Half the block left out: hits in the second half dropped."""
    def f(*a, **k):
        hit, bits = orig(*a, **k)
        hit = hit.clone()
        hit[..., hit.shape[-1] // 2:] = False
        return hit, bits
    return f


def _altered_candidate(orig):
    def f(*a, **k):
        out = dict(orig(*a, **k))
        out["pdu_bytes"] = out["pdu_bytes"].clone()
        out["pdu_bytes"][..., 4] ^= 1
        return out
    return f


@pytest.mark.parametrize("workload,scene", [
    ("wb1m_8k_replay", {}), ("nb37_8k_live", {}),
    # ten times the advertisers: channels overflow their slots, so the
    # walk rescans, on the rescan's own lattice
    ("wb1m_8k_replay", {"advertisers": 1000})])
def test_sound_runs_are_correct(workload, scene):
    rec = smallrun.run(workload, seed=2**31 + 5, scene=scene)
    assert rec.correct, (workload, rec.checks, rec.notes)
    if scene:
        assert "rescans 0;" not in rec.notes[-2] and "reference rescans 0)" not in rec.notes[-1]


@pytest.mark.parametrize("fault", ["stale", "half", "octet"])
def test_wideband_faults_are_caught(fault):
    from btle_tpu_torch.rx import decode_kernel
    from btle_tpu_torch.wideband import fused

    target = {"stale": (fused, "fused_frontend", _stale),
              "half": (fused, "fused_frontend", _half_frontend),
              "octet": (decode_kernel, "decode_candidates", _altered_octet)}[fault]
    with patched(*target):
        rec = smallrun.run("wb1m_8k_replay", seed=11)
    assert not rec.correct, rec.checks


@pytest.mark.parametrize("fault", ["stale", "half", "octet"])
def test_narrowband_faults_are_caught(fault):
    from btle_tpu_torch.rx import decoder, pipeline

    target = {"stale": (pipeline, "scan_block", _stale),
              "half": (pipeline, "scan_block", _half_hits),
              "octet": (decoder, "decode_block", _altered_candidate)}[fault]
    with patched(*target):
        rec = smallrun.run("nb37_8k_live", seed=12)
    assert not rec.correct, rec.checks


@pytest.mark.parametrize("workload", ["wb1m_8k_replay", "nb37_8k_live"])
def test_control_fails_on_the_cpu(workload):
    settings = core.load_json("workloads", workload)
    with controls.applied(settings["control"]) as overrides:
        rec = smallrun.run(workload, seed=13, config=overrides)
    assert not rec.correct, rec.checks


def test_air_the_ring_refused_is_caught():
    """A live loop that falls behind the wire: the ring refuses samples,
    and every block still compares equal on what it was given."""
    rec = smallrun.run("wb1m_128k_live80", seed=14,
                       traffic={"feed": {"write_pairs": 65536, "rate_msps": 80.0}})
    assert rec.checks["ring_refused"].value > 0 and not rec.checks["ring_refused"].ok
    assert not rec.correct, rec.checks


def test_narrowband_window_accounting_is_checked():
    """A packet left out where the sniffer hands it on fails the
    comparison, whichever blocks the lattice check reads: the packets
    of every block of the window are compared."""
    from btle_tpu_torch.stream import sniffer

    def drop_one(orig):
        def f(self, *a, **k):
            out = orig(self, *a, **k)
            if len(self.packets) >= 3 and not getattr(self, "dropped_one", False):
                self.dropped_one = self.packets.pop()
            return out
        return f

    with patched(sniffer.Sniffer, "_process_block", drop_one):
        rec = smallrun.run("nb37_8k_live", seed=15)
    assert rec.checks["pkt_diff"].value >= 1 and not rec.correct, rec.checks


def test_closed_loop_accounting_is_fixed_work():
    """A closed-loop cell counts the operations of a fixed span of air
    from the seed, so two runs of one seed that reach different depths
    of the looped air count the same ``attempted`` and ``failed``."""
    a = smallrun.run("wb1m_128k_replay", seed=2**31 + 77, seconds=2.0)
    b = smallrun.run("wb1m_128k_replay", seed=2**31 + 77, seconds=4.0)
    assert a.blocks < b.blocks
    assert a.attempted > 0 and (a.attempted, a.failed) == (b.attempted, b.failed)
