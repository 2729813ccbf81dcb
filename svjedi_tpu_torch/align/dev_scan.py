"""On-device minimizer scan: the seed stage's scan runs on the uploaded reads.

Counterpart of ``svjedi_tpu/align/dev_scan.py``. The scan (rolling 2-bit
k-mers, the fmix32 hash, the run-length leftmost-argmin emission rule) runs
over the read buffer that already lives on the device for the DP kernels
(``kernels/dev_scan.py``: the CUDA kernel on a card, its plain version on
the CPU) and leaves the device as a packed emission bitmask, n_cap / 8
bytes. The host keeps the lookup and the chaining: native ``svt_chain5``
iterates the set bits, recomputes hash and strand from the codes it holds,
and chains, exactly as after its own scan. Reads with fewer than w k-mers
keep their bits clear and ``svt_chain5`` scans them itself.

On a card the bitmask's copy to the host starts on the calling thread right
after the scan (a pinned buffer, a non-blocking copy and an event), so the
seeder thread only waits for that event: a copy started there would queue
behind the DP kernels enqueued since.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.dev_scan import dev_scan

#: Sentinel hash for invalid (N-containing / palindromic / cross-read)
#: k-mer positions — sorts after every real hash (matches native kInvalid).
INVALID = np.uint32(0xFFFFFFFF)


# Copied verbatim from svjedi_tpu/align/dev_scan.py:_scan_cap.
def _scan_cap(n_codes: int, n_cap: int) -> int:
    """Static scan length: n_codes rounded up to a quarter-octave class
    ({1, 1.25, 1.5, 1.75} x 2^k, multiple-of-8), capped at the buffer's
    n_cap. The DP kernels need n_cap's coarse power-of-two classes (every
    distinct shape is a 20-60 s Mosaic compile), but the scan is plain XLA
    (seconds to compile), so finer classes are affordable — and the
    power-of-two padding is real device time at big chunks (a 17 Mb chunk
    pads to 33.6 M: the scan runs 2x the useful volume)."""
    if n_codes <= 32:
        return min(32, n_cap)
    base = 1 << max((n_codes - 1).bit_length() - 1, 5)
    for num in (4, 5, 6, 7, 8):
        cap = base * num // 4  # base >= 32: always a multiple of 8
        if cap >= n_codes:
            return min(cap, n_cap)
    return n_cap


@dataclass
class PendingBitmask:
    """A dispatched scan's bitmask: on the host (pinned) once ``ready``, an
    event on a card, has completed; None when it was computed on the CPU."""

    host: torch.Tensor  # (n_cap // 8,) uint8
    ready: Optional[torch.cuda.Event] = None


def dispatch_scan(device_data, k: int, w: int) -> PendingBitmask:
    """Enqueue the scan for an uploaded chunk and start the bitmask's copy
    to the host.

    ``device_data`` must come from ``device.upload(..., offsets=...)`` so
    the boundary table is on the device. Call it from the thread that
    enqueues the chunk's device work.
    """
    if device_data.offsets32 is None:
        raise ValueError(
            "dispatch_scan needs device_data.offsets32: call "
            "device.upload(..., offsets=chunk.offsets)"
        )
    bits = dev_scan(
        device_data.reads2, device_data.offsets32, k, w,
        _scan_cap(device_data.n_codes, device_data.n_bases),
    )
    if bits.device.type != "cuda":
        return PendingBitmask(bits)
    # The copy and its event on the scan's device, whichever card that is.
    with torch.cuda.device(bits.device):
        host = torch.empty(bits.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(bits, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(bits.device))
    return PendingBitmask(host, ready)


def fetch_bitmask(scan_out: PendingBitmask) -> np.ndarray:
    """The bitmask as a host uint8 array; waits for its copy on a card."""
    if scan_out.ready is not None:
        scan_out.ready.synchronize()
    return scan_out.host.numpy()


# Copied verbatim from svjedi_tpu/align/dev_scan.py:bitmask_positions.
def bitmask_positions(
    bitmask: np.ndarray, offsets: np.ndarray
) -> tuple:
    """(read_id, local_pos) of every set bit — test/debug helper; the
    production path hands the bitmask straight to native svt_chain5."""
    bits = np.unpackbits(bitmask, bitorder="little")
    pos_g = np.flatnonzero(bits).astype(np.int64)
    rid = (np.searchsorted(offsets, pos_g, side="right") - 1).astype(
        np.int32
    )
    return rid, (pos_g - offsets[rid]).astype(np.int32)
