"""Rank functions that the dist tests run on spawned gloo groups
(``btle_tpu_torch.dist.dryrun.spawn``). A spawned rank imports this
module by name, so it imports nothing of JAX; the tests hold what the
ranks return against the JAX package.

``scan_steps`` is the sharded scan over given streams, ``scan_jobs``
several of them read from one file, ``stream_steps`` the per-process
stream, ``packet_tuple`` a packet as a comparable tuple. This file holds
no tests.
"""

from __future__ import annotations


def packet_tuple(p) -> tuple:
    """(channel, sample_pos, payload_len, crc_ok, pdu bytes, access address)."""
    return (p.channel, int(p.sample_pos), p.payload_len, bool(p.crc_ok),
            bytes(p.pdu_bytes), int(p.access_addr))


def scan_steps(mesh_shape, steps, scan_kwargs: dict, device_type: str = "cpu",
               follow: bool = False, multihost: bool = False) -> dict:
    """Run inside each rank: the sharded scan on a ``mesh_shape`` mesh over
    ``steps`` [(i_wb, q_wb)] in turn, the scan built with ``scan_kwargs``
    (``block_wb`` and the rest of ShardedWidebandScan's keywords). With
    ``multihost``, MultiHostWidebandScan(n_ch=mesh_shape[0]) and each
    rank is fed only its own time block. Returns {"candidates": per step {key: numpy
    (n_time, M, ...)}, "packets": per step [packet_tuple], "truncated",
    "truncations" [(t, m, hits)], "connection_aa", "block_wb"}."""
    from btle_tpu_torch.dist.multihost import MultiHostWidebandScan
    from btle_tpu_torch.dist.shard import ShardedWidebandScan, make_mesh

    n_ch, n_time = mesh_shape
    if multihost:
        scan = MultiHostWidebandScan(n_ch, device_type=device_type, **scan_kwargs)
    else:
        scan = ShardedWidebandScan(make_mesh(n_ch, n_time, device_type), **scan_kwargs)
    if follow:
        scan.enable_connection_following()
    events = []
    scan.on_truncate = lambda t, m, hits: events.append((t, m, hits))
    cands, pkts = [], []
    for wi, wq in steps:
        if multihost:
            own = slice(scan.t_idx * scan.block_wb, (scan.t_idx + 1) * scan.block_wb)
            out = scan(wi[own], wq[own])
        else:
            out = scan(wi, wq)
        cands.append({k: v.cpu().numpy() for k, v in out.items()})
        pkts.append([packet_tuple(p) for p in scan.gather_packets(out)])
    conn = scan.connection
    return {"candidates": cands, "packets": pkts, "truncated": scan.truncated_cells,
            "truncations": events, "block_wb": scan.block_wb,
            "connection_aa": None if conn is None else int(conn.access_addr)}


def scan_jobs(jobs_path: str) -> list:
    """Run inside each rank: scan_steps(*job) for each job of the pickled
    list at ``jobs_path`` (one file every rank reads, so large streams
    are not sent to each rank). Rank 0 returns every result; the other
    ranks return their packets only."""
    import pickle

    import torch.distributed as dist

    with open(jobs_path, "rb") as fh:
        jobs = pickle.load(fh)
    out = [scan_steps(*job) for job in jobs]
    if dist.get_rank():
        out = [{"packets": r["packets"]} for r in out]
    return out


def stream_steps(stream_path: str, n_steps: int, scan_kwargs: dict,
                 trace: bool = False, exit_at: tuple | None = None) -> dict:
    """Run inside each rank: the per-process sharded stream, n_ch 1 and a
    time shard a rank, over the stream pickled at ``stream_path`` ((i, q)
    host arrays): step k of rank t feeds the stream's block k * n_time +
    t and, on the last time shard, the lookahead after it. With
    ``trace``, under a tracer; ``exit_at`` (rank, step): that rank exits
    with code 3 as the step starts. Returns {"packets": per step
    [packet_tuple], "rssi": per step [RSSI statistic], "truncated",
    "events" [(step, t, m, hits)], "steps", and with ``trace`` "spans"
    [(name, step, parent's name)] and "counters"}."""
    import contextlib
    import os
    import pickle

    import torch.distributed as dist

    from btle_tpu_torch.dist.multihost import MultiHostWidebandScan
    from btle_tpu_torch.utils import profiling as P

    with open(stream_path, "rb") as fh:
        wi, wq = pickle.load(fh)
    scan = MultiHostWidebandScan(1, device_type="cpu", **scan_kwargs)
    events = []
    scan.on_truncate = lambda t, m, hits: events.append((scan.steps - 1, t, m, hits))
    tracer = P.Tracer(1 << 16)
    pkts, rssi = [], []
    with P.tracing(tracer) if trace else contextlib.nullcontext():
        for k in range(n_steps):
            if exit_at == (dist.get_rank(), k):
                os._exit(3)
            s = (k * scan.n_time + scan.t_idx) * scan.block_wb
            e = s + scan.block_wb + scan.lookahead_wb
            got = scan.gather_packets(scan(wi[s:e], wq[s:e]))
            pkts.append([packet_tuple(p) for p in got])
            rssi.append([float(p.rssi_mag) for p in got])
    out = {"packets": pkts, "rssi": rssi, "truncated": scan.truncated_cells,
           "events": events, "steps": scan.steps}
    if trace:
        spans = tracer.spans()
        out["spans"] = [(r.name, r.block, spans[r.parent].name if r.parent >= 0 else None)
                        for r in spans]
        out["counters"] = dict(tracer.counters)
    return out

