"""Multi-process support: process-group init and the cross-process count merge.

Counterpart of ``svjedi_tpu/dist/multihost.py`` on ``torch.distributed``.
The pipeline's only cross-read reduction is the per-(SV, allele) count, an
associative integer sum, so every process runs the align stage on its block
of the read set (:func:`process_read_block`), the count tables merge across
processes (:func:`allreduce_counts`), and process 0 genotypes
(``pipeline.py``). The tables are host dicts of a few KB whose key sets
differ per process, so the merge gathers them serialized and sums; it rides
a gloo group, which also serves several processes on one card (NCCL refuses
two ranks on one GPU). Process ``r`` runs on ``cuda:{r % device_count()}``
(:func:`rank_device`).
"""

from __future__ import annotations

import datetime
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

#: How long a process waits for the others: at the group's start, and at
#: the barrier before the count merge, which processes reach as far apart
#: as their align stages ran (minutes at genome scale).
TIMEOUT = datetime.timedelta(hours=1)
#: The environment that configures a group, as ``torchrun`` sets it.
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the gloo process group; return (rank, world size).

    Explicit arguments (``host:port``, the process count, this process's
    rank) give a ``tcp://`` init; what they leave out is taken from the
    environment, and what is still missing raises. Without arguments the
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` environment
    configures the group (``env://``); with none of it set this is a single
    process and (0, 1) is returned with a note. A group that cannot be
    joined raises; nothing falls back to a single process.
    """
    explicit = any(
        v is not None
        for v in (coordinator_address, num_processes, process_id)
    )
    if dist.is_initialized():
        # An earlier initialize() (ours or the caller's) joined the group;
        # joining again is an error, so only report the membership.
        if explicit:
            raise RuntimeError(
                "--multihost coordination parameters given but the process "
                "group was already initialized earlier in this process"
            )
        return dist.get_rank(), dist.get_world_size()
    present = [k for k in ENV if os.environ.get(k)]
    if explicit:
        if coordinator_address is None and {"MASTER_ADDR", "MASTER_PORT"} \
                <= set(present):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}")
        if num_processes is None and "WORLD_SIZE" in present:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None and "RANK" in present:
            process_id = int(os.environ["RANK"])
        missing = [name for name, v in (
            ("coordinator_address", coordinator_address),
            ("num_processes", num_processes),
            ("process_id", process_id)) if v is None]
        if missing:
            raise ValueError(
                f"cannot join a process group: {', '.join(missing)} given "
                f"neither as an argument nor in the environment ({', '.join(ENV)})"
            )
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=TIMEOUT,
        )
    elif present:
        if len(present) != len(ENV):
            raise ValueError(
                f"incomplete process-group environment: "
                f"{', '.join(k for k in ENV if k not in present)} unset "
                f"({', '.join(present)} set)"
            )
        dist.init_process_group("gloo", init_method="env://", timeout=TIMEOUT)
    else:
        print(
            "[multihost] no cluster configuration; running single-process",
            file=sys.stderr,
        )
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _membership() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device: torch.device) -> torch.device:
    """This process's device: ``cuda:{rank % device_count()}`` for a CUDA
    device, ``device`` otherwise."""
    if device.type != "cuda":
        return device
    rank, _ = _membership()
    return torch.device("cuda", rank % torch.cuda.device_count())


# The arithmetic is svjedi_tpu/dist/multihost.py:process_read_block's.
def process_read_block(n_reads: int) -> Tuple[int, int]:
    """This process's contiguous [lo, hi) block of the global read stream."""
    i, n = _membership()
    return n_reads * i // n, n_reads * (i + 1) // n


def allreduce_counts(
    counts: Dict[str, List[int]]
) -> Dict[str, List[int]]:
    """Sum per-(SV, allele) count tables across all processes.

    Identity on a single process. Every process first waits at a barrier
    (timeout :data:`TIMEOUT`): processes arrive with whatever skew their
    align stages had, and after the barrier they enter the gather within
    milliseconds. A barrier that fails is reported on stderr and raised.
    Tables are serialized (key sets differ per process), all-gathered and
    summed, order-independent by associativity.
    """
    rank, world = _membership()
    if world == 1:
        return counts
    try:
        dist.monitored_barrier(timeout=TIMEOUT)
    except RuntimeError as exc:
        print(
            f"[multihost] process {rank}/{world}: the barrier before the "
            f"count allreduce failed: {exc}",
            file=sys.stderr, flush=True,
        )
        raise
    parts: List[Optional[str]] = [None] * world
    dist.all_gather_object(parts, json.dumps(counts, sort_keys=True))
    merged: Dict[str, List[int]] = {}
    for part in parts:
        for tag, pair in json.loads(part).items():
            entry = merged.setdefault(tag, [0, 0])
            entry[0] += pair[0]
            entry[1] += pair[1]
    return merged


def shutdown() -> None:
    """Leave the process group, if one was joined: a barrier (no peer is
    still receiving this process's part of the merge), then the group's
    teardown, whose threads would otherwise abort the interpreter's exit."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
