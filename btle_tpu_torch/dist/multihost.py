"""Multi-host deployment of the sharded wideband scan.

Port of btle_tpu/dist/multihost.py (BASELINE config 5 at N >= 2 hosts):
each process ingests its own slice of the wideband stream (its digitizer
/ its time-block range); the ranks of all processes form one
``torch.distributed`` group and one ("ch", "time") mesh, and the same
per-rank program runs everywhere (NCCL between cards, gloo between CPU
processes — the caller names the backend).

Usage in each process (one process per device):

    from btle_tpu_torch.dist.multihost import init_distributed, MultiHostWidebandScan
    init_distributed(coordinator="host0:1234", num_processes=N, process_id=k,
                     backend="nccl")
    scan = MultiHostWidebandScan(n_ch=4, block_wb=2_621_440)
    out = scan(local_i, local_q)     # this process's time shards only
    packets = scan.gather_packets(out)

``init_distributed`` is a no-op when a group already exists or when there
is one process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .shard import ShardedWidebandScan, make_mesh


def init_distributed(coordinator: str | None = None, num_processes: int = 1,
                     process_id: int = 0, backend: str = "nccl"):
    """Bring up the default process group when running multi-process
    (``coordinator`` is "host:port" of rank 0's TCP store); a no-op when a
    group already exists or for one process. Returns (process count, this
    process's index)."""
    if num_processes > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
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

    def __call__(self, i_local, q_local):
        """Run one step. In multi-process mode, pass only this process's
        local_time_blocks * block_wb samples; a single process passes the
        full n_time * block_wb stream."""
        if dist.get_world_size() == 1:
            return super().__call__(i_local, q_local)
        x = [torch.as_tensor(np.asarray(v, np.float32), device=self.device)
             for v in (i_local, q_local)]
        if x[0].shape[0] != self.block_wb:
            raise ValueError(f"expected {self.block_wb} samples, got {x[0].shape[0]}")
        return self.run_placed(*x)
