"""Device-mesh construction: a (data, graph) grid of ``torch.device``s.

Counterpart of ``svjedi_tpu/dist/mesh.py``. PyTorch has no SPMD mesh: a
:class:`Mesh` only names which device each (data, graph) shard runs on, and
the sharded steps (``dist/engine.py``, ``dist/count_merge.py``) run one
shard after another on the calling thread and sum on ``devices[0, 0]``.
A device list may repeat a device: several logical shards then share one
card (or the CPU), which is how the one-card machine and the CPU tests
check that the shards' sum is exact.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


class Mesh(NamedTuple):
    """A (data, graph) grid of devices."""

    devices: np.ndarray  # (data, graph) object array of torch.device

    @property
    def shape(self) -> Dict[str, int]:
        d, g = self.devices.shape
        return {"data": d, "graph": g}


def local_devices(device: torch.device) -> List[torch.device]:
    """The default device list: every visible card for a CUDA device,
    ``[device]`` for the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def make_mesh(
    data_shards: Optional[int] = None,
    graph_shards: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Build a (data, graph) mesh over ``devices`` (default: every visible
    card). ``data`` carries read-batch parallelism, ``graph`` the SV-table
    split. Defaults to all devices on ``data``."""
    if devices is None:
        devices = local_devices(torch.device("cuda"))
        if not devices:
            raise RuntimeError("no CUDA device is visible: pass devices=")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data_shards is None:
        data_shards = n // graph_shards
    if data_shards * graph_shards != n:
        raise ValueError(
            f"mesh {data_shards}x{graph_shards} != {n} devices"
        )
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data_shards, graph_shards))
