"""Device-side owned-link table for the sharded count step.

Counterpart of ``svjedi_tpu/dist/count_step.py``. The count step itself
lives in ``dist/engine.py``; this module holds the padded per-path
owned-link table that the engine and the entry points
(``svjedi_tpu_torch/entry.py``) consume.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch


class OwnedTable(NamedTuple):
    """Per-path owned-link table, padded to K columns (host-built)."""

    junction: torch.Tensor  # (n_paths, K) int32 path-space junction offsets
    tag: torch.Tensor  # (n_paths, K) int32 tag ids
    allele: torch.Tensor  # (n_paths, K) int32 0/1
    valid: torch.Tensor  # (n_paths, K) bool
    #: crossed graph-link ids (cluster.PanelPath.owned[..][3]); the count
    #: step ignores them.
    link: Optional[torch.Tensor] = None  # (n_paths, K) int32

    def to(self, device: torch.device) -> "OwnedTable":
        """The table on ``device`` (no copy where it already lies there)."""
        return OwnedTable(*(None if t is None else t.to(device) for t in self))


def build_owned_table(
    panel,
    tag_to_id: Dict[str, int],
    k_max: int = 0,
    device: torch.device = torch.device("cpu"),
) -> OwnedTable:
    """Pad each panel path's owned-link list into the table, on ``device``."""
    K = max([len(p.owned) for p in panel.paths] + [1, k_max])
    n = len(panel.paths)
    junction = np.zeros((n, K), dtype=np.int32)
    tag = np.zeros((n, K), dtype=np.int32)
    allele = np.zeros((n, K), dtype=np.int32)
    link = np.zeros((n, K), dtype=np.int32)
    valid = np.zeros((n, K), dtype=bool)
    for pid, path in enumerate(panel.paths):
        for col, (t, a, j, li) in enumerate(path.owned):
            junction[pid, col] = j
            tag[pid, col] = tag_to_id[t]
            allele[pid, col] = a
            link[pid, col] = li
            valid[pid, col] = True
    return OwnedTable(
        junction=torch.from_numpy(junction).to(device),
        tag=torch.from_numpy(tag).to(device),
        allele=torch.from_numpy(allele).to(device),
        valid=torch.from_numpy(valid).to(device),
        link=torch.from_numpy(link).to(device),
    )
