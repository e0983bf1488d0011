"""Rank functions that the dist tests run on spawned gloo groups
(``btle_tpu_torch.dist.dryrun.spawn``). A spawned rank imports this
module by name, so it imports nothing of JAX; the tests hold what the
ranks return against the JAX package.

``scan_steps`` is the sharded scan over given streams, ``scan_jobs``
several of them read from one file, ``packet_tuple`` a packet as a
comparable tuple. This file holds no tests.
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
