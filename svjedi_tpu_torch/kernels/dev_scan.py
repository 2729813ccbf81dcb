"""The device minimizer scan: every read's minimizer emission bitmask.

PyTorch counterpart of ``svjedi_tpu/align/dev_scan.py:_scan_kernel`` (an
XLA program in the JAX package). :func:`dev_scan` runs the hand-written CUDA
kernel (``csrc/dev_scan.cu``) on CUDA tensors and :func:`dev_scan_ref`, its
plain PyTorch version, on CPU tensors; any other device raises.

The plain version follows the JAX program step for step, in int64 masked
to 32 bits after every shift and multiply (PyTorch lacks several uint32
operations on the CPU), so it equals JAX's uint32 arithmetic bit for bit.
"""

from __future__ import annotations

import torch

#: Sentinel hash of an invalid k-mer (an N, a palindrome, or one leaving its
#: read); it sorts after every real hash.
INVALID = 0xFFFFFFFF
_MASK32 = 0xFFFFFFFF
#: The CUDA kernel's limits: a k-mer's 2k bits fit 32, and its halo w - 1.
MAX_K = 16
MAX_W = 64

#: Kernel launches since import (or since a caller reset it to 0). Counted
#: only where the CUDA kernel is launched, never by the plain version.
launches = 0
#: None, or a list to which each launch appends its (start, end) CUDA
#: events, recorded on the launch's stream just around it (the seed
#: profiler, ``profile_seed5.py``, reads the kernel's own time from them).
launch_events = None


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x < 2^32, in int64 without overflow: the two
    16-bit halves of c, each product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def scan_runs(reads2: torch.Tensor, offsets32: torch.Tensor, k: int, w: int,
              n_cap: int):
    """The scan's intermediates, as ``_scan_kernel`` computes them: per
    k-mer start p < nk = n_cap - k + 1, the hash ``h`` (int64, INVALID where
    the k-mer holds an N, is a palindrome or leaves its read), ``krid``
    (its read id, -1 where it leaves its read or lies in the padding) and
    the two run lengths ``a`` (predecessors of the same read with a greater
    hash) and ``b`` (successors with a greater or equal one), each <= w - 1.
    """
    dev = reads2.device
    codes = reads2[:n_cap].to(torch.int64)
    c = codes & 3
    comp = 3 - c
    nk = n_cap - k + 1
    # Base-level read ids: read_id[p] = (#offsets <= p) - 1; offsets past
    # n_cap are dropped, as the JAX scatter's mode="drop" drops them.
    off = offsets32.to(torch.int64)
    off = off[(off >= 0) & (off <= n_cap)]
    marks = torch.zeros(n_cap + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, off, torch.ones_like(off))
    read_id = torch.cumsum(marks, 0)[:n_cap] - 1

    # Rolling 2-bit packing: fwd = sum_j c[p+j] << 2(k-1-j); rc from the
    # complemented mirror.
    fwd = torch.zeros(nk, dtype=torch.int64, device=dev)
    rc = torch.zeros(nk, dtype=torch.int64, device=dev)
    valid = torch.ones(nk, dtype=torch.bool, device=dev)
    for j in range(k):
        fwd = ((fwd << 2) & _MASK32) | c[j : j + nk]
        rc = ((rc << 2) & _MASK32) | comp[k - 1 - j : k - 1 - j + nk]
        valid &= codes[j : j + nk] < 4
    n_reads = offsets32.shape[0] - 1
    krid = torch.where(
        (read_id[:nk] == read_id[k - 1 : k - 1 + nk])
        & (read_id[:nk] < n_reads),
        read_id[:nk],
        -1,
    )
    h = torch.where(valid & (fwd != rc) & (krid >= 0),
                    _mix32(torch.minimum(fwd, rc)), INVALID)

    # Runs: a(p) = predecessors j = p-1, p-2, .. of the same krid with
    # h[j] > h[p]; b(p) = successors with h[j] >= h[p]; both capped at w-1.
    a = torch.zeros(nk, dtype=torch.int32, device=dev)
    b = torch.zeros(nk, dtype=torch.int32, device=dev)
    run_a = torch.ones(nk, dtype=torch.bool, device=dev)
    run_b = torch.ones(nk, dtype=torch.bool, device=dev)
    for d in range(1, w):
        ok_a = torch.zeros(nk, dtype=torch.bool, device=dev)
        ok_b = torch.zeros(nk, dtype=torch.bool, device=dev)
        if d < nk:
            ok_a[d:] = (h[:-d] > h[d:]) & (krid[:-d] == krid[d:])
            ok_b[:-d] = (h[d:] >= h[:-d]) & (krid[d:] == krid[:-d])
        run_a &= ok_a
        run_b &= ok_b
        a += run_a
        b += run_b
    return h, krid, a, b


def dev_scan_ref(reads2: torch.Tensor, offsets32: torch.Tensor, k: int,
                 w: int, n_cap: int) -> torch.Tensor:
    """Plain PyTorch scan: the (n_cap // 8,) uint8 emission bitmask, bit
    p & 7 of byte p >> 3 set iff k-mer start p is a minimizer of its read
    (``h != INVALID`` and ``a + b >= w - 1``)."""
    _check(reads2, offsets32, k, w, n_cap)
    h, _, a, b = scan_runs(reads2, offsets32, k, w, n_cap)
    emitted = torch.zeros(n_cap, dtype=torch.int64, device=reads2.device)
    emitted[: h.shape[0]] = ((h != INVALID) & (a + b >= w - 1)).to(torch.int64)
    weights = 1 << torch.arange(8, dtype=torch.int64, device=reads2.device)
    return (emitted.view(n_cap // 8, 8) * weights).sum(1).to(torch.uint8)


def _check(reads2: torch.Tensor, offsets32: torch.Tensor, k: int, w: int,
           n_cap: int) -> None:
    if reads2.dtype != torch.int8 or reads2.dim() != 1:
        raise TypeError(f"reads2 must be 1-D int8, got {reads2.dtype} "
                        f"{tuple(reads2.shape)}")
    if offsets32.dtype != torch.int32 or offsets32.dim() != 1 \
            or offsets32.shape[0] < 1:
        raise TypeError("offsets32 must be a non-empty 1-D int32 tensor")
    if offsets32.device != reads2.device:
        raise ValueError(f"reads2 on {reads2.device} but offsets32 on "
                         f"{offsets32.device}")
    if not (n_cap % 8 == 0 and 1 <= k <= n_cap <= reads2.shape[0] and w >= 1):
        raise ValueError(f"dev_scan needs n_cap % 8 == 0, 1 <= k <= n_cap <= "
                         f"len(reads2) and w >= 1 (got k={k}, w={w}, "
                         f"n_cap={n_cap}, len(reads2)={reads2.shape[0]})")


def dev_scan(reads2: torch.Tensor, offsets32: torch.Tensor, k: int, w: int,
             n_cap: int) -> torch.Tensor:
    """Emission bitmask of every read's minimizers: (n_cap // 8,) uint8.

    ``reads2`` is the uploaded read buffer (its first ``n_cap`` codes are
    scanned), ``offsets32`` the (n_reads + 1,) int32 read boundaries. CUDA
    tensors launch the kernel (k <= 16, w <= 64); CPU tensors take
    :func:`dev_scan_ref`.
    """
    global launches
    _check(reads2, offsets32, k, w, n_cap)
    if reads2.device.type == "cpu":
        return dev_scan_ref(reads2, offsets32, k, w, n_cap)
    if reads2.device.type != "cuda":
        raise ValueError(f"dev_scan: unsupported device {reads2.device}")
    if k > MAX_K or w > MAX_W:
        raise ValueError(f"dev_scan kernel needs k <= {MAX_K} and w <= "
                         f"{MAX_W}, got k={k}, w={w}")
    if not (reads2.is_contiguous() and offsets32.is_contiguous()):
        raise ValueError("dev_scan kernel needs contiguous reads2/offsets32")
    from . import build

    lib = build.load_library()
    out = torch.empty(n_cap // 8, dtype=torch.uint8, device=reads2.device)
    with torch.cuda.device(reads2.device):
        stream = torch.cuda.current_stream(reads2.device)
        events = launch_events
        if events is not None:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(stream)
        rc = lib.dev_scan_launch(
            reads2.data_ptr(), offsets32.data_ptr(), offsets32.shape[0] - 1,
            n_cap, k, w, out.data_ptr(), stream.cuda_stream,
        )
        if events is not None:
            end.record(stream)
            events.append((start, end))
    build.check(lib, rc, "dev_scan kernel launch")
    launches += 1
    return out
