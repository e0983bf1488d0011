"""The controls of ``correct``: the program with the nearest lower
precision switched on, which each cell's comparison has to reject.

A cell's settings name its control: ``{"kind": "config", "overrides":
{...}}`` runs the program with those configuration keys (the wideband
scan at "bf16" in place of "bf16x2w"); ``{"kind": "iq_bits", "bits":
4}`` hands the narrowband scan its IQ cut to that many bits (int4 for
int8), the program's arithmetic being exact integers.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def applied(control: dict):
    """Yields the configuration overrides of ``control``, with any patch
    it needs in place until the block ends."""
    if control["kind"] == "config":
        yield dict(control["overrides"])
        return
    if control["kind"] != "iq_bits":
        raise ValueError(f"unknown control {control['kind']!r}")
    from btle_tpu_torch.rx import pipeline

    orig = pipeline.scan_block
    shift = 8 - control["bits"]

    def scan_block(i, q, *a, **k):
        return orig(i.div(1 << shift, rounding_mode="floor"),
                    q.div(1 << shift, rounding_mode="floor"), *a, **k)

    pipeline.scan_block = scan_block
    try:
        yield {}
    finally:
        pipeline.scan_block = orig
