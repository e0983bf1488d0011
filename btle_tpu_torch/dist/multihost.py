"""Multi-host deployment of the sharded wideband scan.

Port of btle_tpu/dist/multihost.py (BASELINE config 5 at N >= 2 hosts):
each process ingests its own slice of the wideband stream (its digitizer
/ its time-block range); the ranks of all processes form one
``torch.distributed`` group and one ("ch", "time") mesh, and the same
per-rank program runs everywhere (NCCL between cards, gloo between CPU
processes — the caller names the backend).

Usage in each process (one process per device), as a stream: step k of
the process at time shard t feeds the stream's samples [(k * n_time + t)
* block_wb, ...): its own block and, on the last time shard, the
lookahead that follows it (``lookahead_wb`` samples, as ``run_live``'s
ring read takes territory plus halo):

    from btle_tpu_torch.dist.multihost import init_distributed, MultiHostWidebandScan
    init_distributed(coordinator="host0:1234", num_processes=N, process_id=k,
                     backend="nccl")
    scan = MultiHostWidebandScan(n_ch=1, block_wb=2_621_440, fused=True)
    while True:
        out = scan(local_i, local_q)     # this process's slice of the step
        packets = scan.gather_packets(out)

The steps decode as one unsharded stream of block_wb-sample blocks:
packets across step boundaries, stream-absolute positions, every
overflowing cell rescanned, and every process hands on the same packets.
``init_distributed`` is a no-op when a group already exists or when there
is one process; the group's collectives time out after
``GROUP_TIMEOUT``, so a dead process fails the others instead of hanging
them.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from .._device import upload
from ..utils.profiling import span
from .shard import ShardedWidebandScan, make_mesh

# the time limit of the group's rendezvous and of every collective on it
GROUP_TIMEOUT = timedelta(seconds=60)


def init_distributed(coordinator: str | None = None, num_processes: int = 1,
                     process_id: int = 0, backend: str = "nccl"):
    """Bring up the default process group when running multi-process
    (``coordinator`` is "host:port" of rank 0's TCP store); a no-op when a
    group already exists or for one process. Returns (process count, this
    process's index)."""
    if num_processes > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=GROUP_TIMEOUT)
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class MultiHostWidebandScan(ShardedWidebandScan):
    """ShardedWidebandScan over every rank of the default group, with
    per-process input feeding.

    The time axis is laid out so each process holds contiguous time
    blocks (one rank a process: its own block); a process supplies only
    the samples of its own range.
    """

    def __init__(self, n_ch: int, block_wb: int, device_type: str = "cuda",
                 **kwargs):
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        if n_dev % n_ch:
            raise ValueError(f"{n_dev} devices not divisible by n_ch={n_ch}")
        mesh = make_mesh(n_ch, n_dev // n_ch, device_type)
        super().__init__(mesh, block_wb, **kwargs)

    @property
    def local_time_blocks(self) -> int:
        """Time blocks this process is responsible for feeding."""
        return max(1, self.n_time // dist.get_world_size())

    @property
    def lookahead_wb(self) -> int:
        """Samples past its block that the last time shard feeds each step
        (the next step's first halo_wb samples); 0 on the other shards."""
        return self.halo_wb if self.t_idx == self.n_time - 1 else 0

    def __call__(self, i_local, q_local):
        """Run one step. In multi-process mode, pass only this process's
        slice of the step: its block_wb samples, and on the last time
        shard up to ``lookahead_wb`` more (fewer at the stream's end); a
        single process passes the full n_time * block_wb stream."""
        if dist.get_world_size() == 1:
            return super().__call__(i_local, q_local)
        with span("shard.ingest", block=self.steps):
            extra = len(i_local) - self.block_wb
            if not 0 <= extra <= self.lookahead_wb or len(q_local) != len(i_local):
                raise ValueError(f"expected {self.block_wb} samples"
                                 + (f" and up to {self.lookahead_wb} more"
                                    if self.lookahead_wb else "")
                                 + f", got {len(i_local)}")
            # integer wire formats cross the link as they are: the cast to
            # float32 runs on the device
            x = [upload(v, self.device).to(torch.float32) for v in (i_local, q_local)]
        head = tuple(v[self.block_wb:] for v in x) if extra else None
        return self.run_placed(x[0][: self.block_wb], x[1][: self.block_wb], head)
