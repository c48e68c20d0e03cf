"""Multi-host execution plan of the port.

The liftover distributes by input sharding: each host owns a disjoint subset
of assembly contigs, lifts only the reads whose primary alignment starts on
them, and writes its own unsorted output shard; ``tools.merge`` joins
the shards.  ``HostShardPlan``, ``plan_host_shards`` and
``shard_output_path`` are copies of ``portello_tpu.parallel.distributed``'s
(importing that module imports ``portello_tpu.parallel``, which imports jax);
the tests hold them equal.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

# How long a host waits at the rendezvous for the others.
INIT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(
    coordinator_address: str | None,
    num_processes: int,
    process_id: int,
) -> bool:
    """Join the hosts' rendezvous at ``coordinator_address`` (host:port,
    served by process 0) over gloo; returns whether a group was formed.

    No collective runs on the hot path: the hosts meet again at the output
    files, so a rendezvous is all there is, as in the JAX package.  A no-op
    for a single process or without a coordinator.  The caller ends the
    group with ``torch.distributed.destroy_process_group()``."""
    if num_processes <= 1 or coordinator_address is None:
        return False
    import torch.distributed as dist

    from portello_tpu_torch.logger import setup_logger

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=INIT_TIMEOUT,
    )
    setup_logger().info(
        f"torch.distributed initialized: process {dist.get_rank()}"
        f"/{dist.get_world_size()} (gloo, {coordinator_address})"
    )
    return True


@dataclass
class HostShardPlan:
    """Contig ownership for one host."""

    host_id: int
    num_hosts: int
    contig_indices: list[int]

    def owns(self, contig_index: int) -> bool:
        return contig_index in self._owned

    def __post_init__(self):
        self._owned = set(self.contig_indices)


def plan_host_shards(contig_lengths: list[int], num_hosts: int, host_id: int) -> HostShardPlan:
    """Greedy longest-first balanced partition of contigs across hosts.

    Work is proportional to contig length (reads distribute ~uniformly over
    the assembly), so balance total owned length.
    """
    order = sorted(range(len(contig_lengths)), key=lambda i: -contig_lengths[i])
    loads = [0] * num_hosts
    owner = [0] * len(contig_lengths)
    for ci in order:
        h = loads.index(min(loads))
        owner[ci] = h
        loads[h] += contig_lengths[ci]
    return HostShardPlan(
        host_id=host_id,
        num_hosts=num_hosts,
        contig_indices=[i for i, h in enumerate(owner) if h == host_id],
    )


def shard_output_path(path: str, host_id: int, num_hosts: int) -> str:
    """Per-host output shard naming ('out.bam' -> 'out.shard03of08.bam')."""
    if num_hosts <= 1 or path == "-":
        return path
    if "." in path.rsplit("/", 1)[-1]:
        stem, ext = path.rsplit(".", 1)
        return f"{stem}.shard{host_id:02d}of{num_hosts:02d}.{ext}"
    return f"{path}.shard{host_id:02d}of{num_hosts:02d}"
