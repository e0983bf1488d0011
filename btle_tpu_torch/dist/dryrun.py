"""Spawned rank groups and the multi-device dry run of the sharded scan.

``spawn`` runs one function on N fresh processes that form one
``torch.distributed`` group (gloo on the CPU, or NCCL on cards — the
caller names the backend and the device type) and returns what each rank
returned. ``dryrun_multichip(n, backend, device_type)`` is the port of
``__graft_entry__.dryrun_multichip``: it sets up n ranks and runs one
full sharded step on tiny shapes (the channel-split all_reduce and the
time-halo exchange), then the production time-parallel fused layout with
a CONNECT_REQ re-keying the next step and an LE 2M row.
"""

from __future__ import annotations

import socket
import time
import traceback

import numpy as np

from .multihost import GROUP_TIMEOUT


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device_type, fn, args, queue):
    import torch
    import torch.distributed as dist

    # one intra-op thread a rank: N ranks share the host's cores
    torch.set_num_threads(1)
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank, timeout=GROUP_TIMEOUT)
        try:
            queue.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        # the parent raises with this traceback; the rank exits failed
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn(world_size: int, fn, *args, backend: str, device_type: str,
          timeout: float = 600.0) -> list:
    """fn(*args) on ``world_size`` spawned ranks of one group over
    ``backend`` ("nccl" or "gloo"), each rank on ``device_type`` ("cuda"
    or "cpu"); returns the results by rank. A rank that raises (or a group that outlives
    ``timeout`` seconds) raises here after every process is stopped, naming
    first every rank that exited without a result and its exit code (the
    others' errors are then often only that they lost it)."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, backend, device_type, fn, args,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, errors, reported, stopped = [None] * world_size, [], set(), set()
    deadline = time.monotonic() + timeout

    def dead() -> list:
        """Ranks that exited non-zero without a result (not those stopped
        here)."""
        return [r for r, p in enumerate(procs) if r not in reported | stopped
                and p.exitcode not in (None, 0)]

    def take(rank, ok, value):
        reported.add(rank)
        if ok:
            out[rank] = value
        else:
            errors.append(f"rank {rank}:\n{value}")

    try:
        while len(reported) < world_size and not errors:
            try:
                take(*results.get(timeout=1.0))
            except queue_mod.Empty:
                # a rank that died before it could report (e.g. in start-up)
                if dead():
                    break
                if time.monotonic() > deadline:
                    errors.append(f"the group did not finish within {timeout} s")
    finally:
        # read what the others still report while they end (a process
        # that wrote to the queue may not exit before it is read)
        end = time.monotonic() + (5 if errors or dead() else 60)
        while any(p.is_alive() for p in procs) and time.monotonic() < end:
            try:
                take(*results.get(timeout=0.1))
            except queue_mod.Empty:
                pass
        for r, p in enumerate(procs):
            if p.is_alive():
                stopped.add(r)
                p.terminate()
            p.join()
        while True:
            try:
                take(*results.get(timeout=0.1))
            except queue_mod.Empty:
                break
    # a rank that dies takes the group's rendezvous or connections with
    # it, so a peer may report that loss before the dead rank's exit is
    # seen: the dead are named first, once every process has ended
    gone = dead()
    if gone:
        errors.insert(0, f"ranks {gone} exited {[procs[r].exitcode for r in gone]} "
                      "without a result")
    if errors:
        raise RuntimeError("spawned ranks failed: " + "\n".join(errors))
    return out


def _factor(n_devices: int) -> tuple[int, int]:
    """(n_ch, n_time) with n_ch the largest of 8, 5, 4, 2 dividing both
    n_devices and 40 (else 1)."""
    for c in (8, 5, 4, 2):
        if n_devices % c == 0 and 40 % c == 0:
            return c, n_devices // c
    return 1, n_devices


CONN_AA, CONN_CRC_HEX = 0x60850A1B, "a77b22"


def _connect_req_bits() -> np.ndarray:
    """CONNECT_REQ (pdu_type 5) to CONN_AA, CRCInit CONN_CRC_HEX, hop 9."""
    from ..spec import bits as B

    payload = (
        bytes.fromhex("001830EA965F")[::-1]            # InitA
        + bytes.fromhex("90D7EBB19299")[::-1]          # AdvA
        + CONN_AA.to_bytes(4, "little")
        + bytes.fromhex(CONN_CRC_HEX)
        + bytes([0x02])                                # WinSize
        + (0x000F).to_bytes(2, "little")               # WinOffset
        + (16).to_bytes(2, "little")                   # Interval
        + (0).to_bytes(2, "little")                    # Latency
        + (0x07D0).to_bytes(2, "little")               # Timeout
        + bytes.fromhex("1FFFFFFFFF")[::-1]            # ChM (all)
        + bytes([(1 << 5) | 9])                        # SCA | hop
    )
    return B.bytes_to_bits(np.frombuffer(bytes([0x45, len(payload)]) + payload, np.uint8))


def check_rekey(scan, n: int) -> None:
    """Two steps of n samples through a sharded scan that follows
    connections: a CONNECT_REQ on 37 in step 1 books the connection and
    re-keys the data channels, so step 2's data packet on channel 9
    decodes with the connection's access address and CRC init. Raises on
    a miss."""
    from ..golden import model as G
    from ..spec import bits as B
    from ..wideband.channelizer import synthesize_wideband

    def burst(pdu_bits, ch, **kw):
        return G.gfsk_modulate_float(G.assemble_phy_bits(pdu_bits, ch, **kw), 80)

    si, sq = synthesize_wideband({37: burst(_connect_req_bits(), 37)}, n, {37: 30_000})
    if not any(p.crc_ok and p.channel == 37 for p in scan.gather_packets(scan(si, sq))):
        raise AssertionError("no CONNECT_REQ")
    if scan.connection is None or scan.connection.access_addr != CONN_AA:
        raise AssertionError("connection not booked")
    data = B.bytes_to_bits(np.frombuffer(b"\x01\x05hello", np.uint8))
    si, sq = synthesize_wideband(
        {9: burst(data, 9, crc_init_hex=CONN_CRC_HEX,
                  access_address_hex=CONN_AA.to_bytes(4, "little").hex())}, n, {9: 30_000})
    got = [p for p in scan.gather_packets(scan(si, sq)) if p.crc_ok]
    if not (len(got) == 1 and got[0].channel == 9 and bytes(got[0].pdu_bytes[2:]) == b"hello"
            and got[0].access_addr == CONN_AA):
        raise AssertionError("re-keyed data channel did not decode")


def _dryrun_rank(n_devices: int, device_type: str) -> bool:
    """One rank of dryrun_multichip: the branch-split step on tiny shapes,
    then the production layout's checks. Raises on a miss."""
    from ..tx.descriptor import parse_descriptor
    from ..tx.synth import scene_to_wideband
    from .shard import ShardedWidebandScan, make_mesh

    n_ch, n_time = _factor(n_devices)
    block_wb = 4000                    # tiny per-device time block (50 us of air)
    scan = ShardedWidebandScan(make_mesh(n_ch, n_time, device_type), block_wb=block_wb,
                               num_taps=640, max_candidates=4)
    rng = np.random.default_rng(0)
    n = n_time * block_wb
    out = scan(rng.normal(0, 30, n).astype(np.float32),
               rng.normal(0, 30, n).astype(np.float32))
    if not isinstance(scan.gather_packets(out), list):
        raise AssertionError("gather_packets returned no list")

    # the production layout: the fused time-parallel mesh with full
    # traffic semantics — a CONNECT_REQ decoded in step 1 re-keys the
    # data channels for step 2, and an LE 2M row runs the same mesh
    mesh = make_mesh(1, n_devices, device_type)
    block_wb = 40960                   # 0.5 ms of air per device
    n = n_devices * block_wb
    scan = ShardedWidebandScan(mesh, block_wb=block_wb, fused=True, fused_dtype="bf16x2w")
    scan.enable_connection_following()
    check_rekey(scan, n)
    scan2m = ShardedWidebandScan(mesh, block_wb=block_wb, fused=True,
                                 fused_dtype="bf16x2w", phy="2m")
    spec = parse_descriptor("37-ADV_NONCONN_IND-TxAdd-0-RxAdd-0-AdvA-0A0B0C0D0E0F"
                            "-AdvData-0011-Space-1").to_2m()
    si, sq = scene_to_wideband([(spec, 30_000)], n, noise_std=0.01, seed=1)
    if not any(p.crc_ok and p.channel == 37 for p in scan2m.gather_packets(scan2m(si, sq))):
        raise AssertionError("2M decode")
    return True


def dryrun_multichip(n_devices: int, backend: str, device_type: str) -> None:
    """Set up ``n_devices`` ranks of one group over ``backend`` on
    ``device_type`` (gloo and "cpu", or NCCL and "cuda": the caller
    names both), factor them into a (ch, time) mesh
    with ch dividing 40, and run one FULL sharded step (channel-split
    all_reduce + time-halo exchange) on tiny shapes, then the production
    time-parallel fused layout with connection re-keying and an LE 2M
    row. Raises if any rank fails."""
    spawn(n_devices, _dryrun_rank, n_devices, device_type, backend=backend,
          device_type=device_type)
