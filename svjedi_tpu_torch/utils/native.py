# Copied from svjedi_tpu/utils/native.py; only where load_native looks for
# the library differs (kernels/build.py:build_native builds it there).
"""ctypes binding to the native C++ I/O library (``native/fastio.cpp``).

The reference's only native component is minigraph (SURVEY §2.1); our compute
path is JAX/Pallas, and the native runtime piece is the I/O hot loop: zlib
decompression + FASTQ parsing + 2-bit encoding. Falls back to ``None`` when
the shared library has not been built (``make -C native``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_LIB = None
_LIB_SEARCHED = False


class _NativeIO:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        if hasattr(lib, "svt_minimizers"):
            lib.svt_minimizers.restype = ctypes.c_void_p
            lib.svt_minimizers.argtypes = [
                ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32,
            ]
            if hasattr(lib, "svt_chain"):
                lib.svt_chain.restype = ctypes.c_void_p
                lib.svt_chain.argtypes = [
                    ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int8),
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32,
                ]
                if hasattr(lib, "svt_chain2"):
                    lib.svt_chain2.restype = ctypes.c_void_p
                    lib.svt_chain2.argtypes = (
                        lib.svt_chain.argtypes[:-1]
                        + [ctypes.c_int32, ctypes.c_int32]
                    )
                if hasattr(lib, "svt_chain3"):
                    lib.svt_chain3.restype = ctypes.c_void_p
                    lib.svt_chain3.argtypes = (
                        lib.svt_chain2.argtypes + [ctypes.c_void_p]
                    )
                if hasattr(lib, "svt_chain4"):
                    lib.svt_chain4.restype = ctypes.c_void_p
                    lib.svt_chain4.argtypes = [
                        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                        ctypes.c_int64,
                        ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_uint32),
                        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
                        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                        ctypes.POINTER(ctypes.c_int64),
                        ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_int8),
                        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_void_p,
                    ]
                if hasattr(lib, "svt_chain5"):
                    lib.svt_chain5.restype = ctypes.c_void_p
                    lib.svt_chain5.argtypes = [
                        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
                        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                        ctypes.c_int32, ctypes.c_int32,
                        ctypes.POINTER(ctypes.c_uint8),
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                        ctypes.POINTER(ctypes.c_int64),
                        ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_int8),
                        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_void_p,
                    ]
                if hasattr(lib, "svt_chain6"):
                    lib.svt_chain6.restype = ctypes.c_void_p
                    lib.svt_chain6.argtypes = (
                        lib.svt_chain5.argtypes
                        + [ctypes.POINTER(ctypes.c_uint64)]
                    )
                if hasattr(lib, "svt_lookup_build"):
                    lib.svt_lookup_build.restype = ctypes.c_void_p
                    lib.svt_lookup_build.argtypes = [
                        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                    ]
                    lib.svt_lookup_free.restype = None
                    lib.svt_lookup_free.argtypes = [ctypes.c_void_p]
                lib.svt_seed_count.restype = ctypes.c_int64
                lib.svt_seed_count.argtypes = [ctypes.c_void_p]
                lib.svt_chain_copy.restype = None
                lib.svt_chain_copy.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int8),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                ]
                lib.svt_seed_free.restype = None
                lib.svt_seed_free.argtypes = [ctypes.c_void_p]
            if hasattr(lib, "svt_minimizers2"):
                lib.svt_minimizers2.restype = ctypes.c_void_p
                lib.svt_minimizers2.argtypes = [
                    ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                    ctypes.c_int32,
                ]
            lib.svt_minimizers_count.restype = ctypes.c_int64
            lib.svt_minimizers_count.argtypes = [ctypes.c_void_p]
            lib.svt_minimizers_copy.restype = None
            lib.svt_minimizers_copy.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_int8),
            ]
            lib.svt_minimizers_free.restype = None
            lib.svt_minimizers_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "svt_suppress"):
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.svt_suppress.restype = None
            lib.svt_suppress.argtypes = [
                ctypes.c_int64, i32p, i32p, i64p, i64p, i32p,
                ctypes.c_int64, i32p, i32p,
                ctypes.POINTER(ctypes.c_int8), i32p, i64p, i64p, i64p, i64p,
                i64p, i64p,
                ctypes.c_int32, ctypes.c_double, ctypes.c_int64,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
            ]
            if hasattr(lib, "svt_suppress2"):
                lib.svt_suppress2.restype = None
                lib.svt_suppress2.argtypes = (
                    lib.svt_suppress.argtypes + [i32p, i32p]
                )
        lib.svt_read_sequences.restype = ctypes.c_void_p
        lib.svt_read_sequences.argtypes = [ctypes.c_char_p]
        lib.svt_result_n_reads.restype = ctypes.c_int64
        lib.svt_result_n_reads.argtypes = [ctypes.c_void_p]
        lib.svt_result_total_bases.restype = ctypes.c_int64
        lib.svt_result_total_bases.argtypes = [ctypes.c_void_p]
        lib.svt_result_copy.restype = None
        lib.svt_result_copy.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.svt_result_name.restype = ctypes.c_char_p
        lib.svt_result_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.svt_result_free.restype = None
        lib.svt_result_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "svt_seed_headdiag_copy"):
            lib.svt_seed_headdiag_copy.restype = None
            lib.svt_seed_headdiag_copy.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ]
        if hasattr(lib, "svt_stream_open"):
            lib.svt_stream_open.restype = ctypes.c_void_p
            lib.svt_stream_open.argtypes = [ctypes.c_char_p]
            lib.svt_stream_next.restype = ctypes.c_void_p
            lib.svt_stream_next.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.svt_stream_close.restype = None
            lib.svt_stream_close.argtypes = [ctypes.c_void_p]

    def minimizers(
        self,
        codes: np.ndarray,
        offsets: np.ndarray,
        k: int,
        w: int,
        bitmap: Optional[np.ndarray] = None,
        bitmap_log2: int = 0,
        n_threads: int = 0,
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Native minimizer extraction; returns (read_id, pos, hash, strand).

        With ``bitmap`` (uint8 array of 2**bitmap_log2 bits, one bit set per
        panel-index hash), minimizers that cannot hit the panel are dropped
        inside the scan; the scan is thread-parallel over reads.
        """
        lib = self._lib
        if not hasattr(lib, "svt_minimizers"):
            return None
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        if hasattr(lib, "svt_minimizers2"):
            bm = (
                bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                if bitmap is not None
                else None
            )
            handle = lib.svt_minimizers2(
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                ctypes.c_int64(len(codes)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(len(offsets) - 1),
                ctypes.c_int32(k),
                ctypes.c_int32(w),
                bm,
                ctypes.c_int32(bitmap_log2),
                ctypes.c_int32(n_threads),
            )
        else:
            handle = lib.svt_minimizers(
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                ctypes.c_int64(len(codes)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(len(offsets) - 1),
                ctypes.c_int32(k),
                ctypes.c_int32(w),
            )
        if not handle:
            return None
        try:
            n = lib.svt_minimizers_count(handle)
            read_id = np.empty(n, dtype=np.int32)
            pos = np.empty(n, dtype=np.int32)
            hashes = np.empty(n, dtype=np.uint32)
            strand = np.empty(n, dtype=np.int8)
            if n:
                lib.svt_minimizers_copy(
                    handle,
                    read_id.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                    strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                )
            return read_id, pos, hashes, strand
        finally:
            lib.svt_minimizers_free(handle)

    def _seed_result(self, handle):
        """Copy a native SeedResult handle into numpy arrays and free it.

        Shared tail of every svt_chain* entry point: (read, path, strand,
        d0, support, chain_local, q_lo, q_hi, a_lo, a_hi, head_diag) —
        head_diag is all-zero when the library predates its export.
        """
        lib = self._lib
        try:
            n = lib.svt_seed_count(handle)
            read = np.empty(n, dtype=np.int32)
            path = np.empty(n, dtype=np.int32)
            strand = np.empty(n, dtype=np.int8)
            d0 = np.empty(n, dtype=np.int32)
            support = np.empty(n, dtype=np.int32)
            chain_local = np.empty(n, dtype=np.int32)
            q_lo = np.empty(n, dtype=np.int32)
            q_hi = np.empty(n, dtype=np.int32)
            a_lo = np.empty(n, dtype=np.int32)
            a_hi = np.empty(n, dtype=np.int32)
            if n:
                i32 = ctypes.POINTER(ctypes.c_int32)
                lib.svt_chain_copy(
                    handle,
                    read.ctypes.data_as(i32),
                    path.ctypes.data_as(i32),
                    strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    d0.ctypes.data_as(i32),
                    support.ctypes.data_as(i32),
                    chain_local.ctypes.data_as(i32),
                    q_lo.ctypes.data_as(i32),
                    q_hi.ctypes.data_as(i32),
                    a_lo.ctypes.data_as(i32),
                    a_hi.ctypes.data_as(i32),
                )
            head_diag = np.zeros(n, dtype=np.int32)
            if n and hasattr(lib, "svt_seed_headdiag_copy"):
                lib.svt_seed_headdiag_copy(
                    handle,
                    head_diag.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)
                    ),
                )
            return (read, path, strand, d0, support, chain_local, q_lo,
                    q_hi, a_lo, a_hi, head_diag)
        finally:
            lib.svt_seed_free(handle)

    def lookup_build(self, uniq_hash: np.ndarray) -> int:
        """Prebuild the exact-hash lookup table for :meth:`chain`.

        Returns an opaque handle (0 when the library predates svt_chain3);
        free with :meth:`lookup_free`. The table is read-only after build
        and shared safely across chain threads and chunks.
        """
        lib = self._lib
        if not hasattr(lib, "svt_lookup_build"):
            return 0
        uniq_hash = np.ascontiguousarray(uniq_hash, dtype=np.uint32)
        handle = lib.svt_lookup_build(
            uniq_hash.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(len(uniq_hash)),
        )
        return handle or 0

    def lookup_free(self, handle: int) -> None:
        if handle and hasattr(self._lib, "svt_lookup_free"):
            self._lib.svt_lookup_free(ctypes.c_void_p(handle))

    def chain(
        self,
        codes: np.ndarray,
        offsets: np.ndarray,
        k: int,
        w: int,
        bitmap: np.ndarray,
        bitmap_log2: int,
        uniq_hash: np.ndarray,
        hit_start: np.ndarray,
        hit_path: np.ndarray,
        hit_pos: np.ndarray,
        hit_strand: np.ndarray,
        params,
        n_threads: int = 0,
        panel_path_limit: int = 0,
        lookup: int = 0,
    ):
        """Full native seeding (minimizers -> lookup -> chaining -> blocks).

        ``params`` is an align.seed.ChainParams. Returns (read, path,
        strand, d0, support, chain_local, q_lo, q_hi) block arrays with the
        same ordering/semantics as the numpy seed_candidates stage, or None
        when the library predates svt_chain. ``panel_path_limit`` > 0 skips
        reads with no anchor on a path id below it (merged panel+decoy
        seeding: panel-less reads can never contribute).
        """
        lib = self._lib
        if not hasattr(lib, "svt_chain"):
            return None
        if panel_path_limit > 0 and not hasattr(lib, "svt_chain2"):
            return None  # stale library: fall back to the numpy path
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        uniq_hash = np.ascontiguousarray(uniq_hash, dtype=np.uint32)
        hit_start = np.ascontiguousarray(hit_start, dtype=np.int64)
        hit_path = np.ascontiguousarray(hit_path, dtype=np.int32)
        hit_pos = np.ascontiguousarray(hit_pos, dtype=np.int32)
        hit_strand = np.ascontiguousarray(hit_strand, dtype=np.int8)
        if bitmap is not None:
            bitmap = np.ascontiguousarray(bitmap, dtype=np.uint8)
        bm_ptr = (
            bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if bitmap is not None
            else None
        )
        common = (
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int64(len(codes)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(offsets) - 1),
            ctypes.c_int32(k),
            ctypes.c_int32(w),
            bm_ptr,
            ctypes.c_int32(bitmap_log2),
            uniq_hash.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(len(uniq_hash)),
            hit_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            hit_path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hit_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hit_strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int32(params.min_anchors),
            ctypes.c_int32(params.max_chains),
            ctypes.c_int32(params.max_gap),
            ctypes.c_int32(params.drift_abs),
            ctypes.c_int32(params.drift_permille),
            ctypes.c_int32(params.block_rows),
            ctypes.c_int32(params.ext_min_anchors),
        )
        if lookup and hasattr(lib, "svt_chain3"):
            handle = lib.svt_chain3(
                *common,
                ctypes.c_int32(panel_path_limit),
                ctypes.c_int32(n_threads),
                ctypes.c_void_p(lookup),
            )
        elif hasattr(lib, "svt_chain2"):
            handle = lib.svt_chain2(
                *common,
                ctypes.c_int32(panel_path_limit),
                ctypes.c_int32(n_threads),
            )
        else:
            handle = lib.svt_chain(*common, ctypes.c_int32(n_threads))
        if not handle:
            return None
        return self._seed_result(handle)

    def chain_from_minimizers(
        self,
        offsets: np.ndarray,
        m_read: np.ndarray,
        m_pos: np.ndarray,
        m_hash: np.ndarray,
        m_strand: np.ndarray,
        k: int,
        uniq_hash: np.ndarray,
        hit_start: np.ndarray,
        hit_path: np.ndarray,
        hit_pos: np.ndarray,
        hit_strand: np.ndarray,
        params,
        n_threads: int = 0,
        panel_path_limit: int = 0,
        lookup: int = 0,
    ):
        """Lookup + chaining from a precomputed minimizer list (svt_chain4).

        The minimizer arrays are read-major and position-sorted within each
        read — the emission order of both the native scan and the on-device
        scan (align/dev_scan.py). Same output tuple as :meth:`chain`, or
        None when the library predates svt_chain4.
        """
        lib = self._lib
        if not hasattr(lib, "svt_chain4"):
            return None
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        m_read = np.ascontiguousarray(m_read, dtype=np.int32)
        m_pos = np.ascontiguousarray(m_pos, dtype=np.int32)
        m_hash = np.ascontiguousarray(m_hash, dtype=np.uint32)
        m_strand = np.ascontiguousarray(m_strand, dtype=np.int8)
        uniq_hash = np.ascontiguousarray(uniq_hash, dtype=np.uint32)
        hit_start = np.ascontiguousarray(hit_start, dtype=np.int64)
        hit_path = np.ascontiguousarray(hit_path, dtype=np.int32)
        hit_pos = np.ascontiguousarray(hit_pos, dtype=np.int32)
        hit_strand = np.ascontiguousarray(hit_strand, dtype=np.int8)
        handle = lib.svt_chain4(
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(offsets) - 1),
            ctypes.c_int64(len(m_read)),
            m_read.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            m_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            m_hash.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            m_strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int32(k),
            uniq_hash.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(len(uniq_hash)),
            hit_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            hit_path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hit_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hit_strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int32(params.min_anchors),
            ctypes.c_int32(params.max_chains),
            ctypes.c_int32(params.max_gap),
            ctypes.c_int32(params.drift_abs),
            ctypes.c_int32(params.drift_permille),
            ctypes.c_int32(params.block_rows),
            ctypes.c_int32(params.ext_min_anchors),
            ctypes.c_int32(panel_path_limit),
            ctypes.c_int32(n_threads),
            ctypes.c_void_p(lookup),
        )
        if not handle:
            return None
        return self._seed_result(handle)

    def chain_from_bitmask(
        self,
        codes: np.ndarray,
        offsets: np.ndarray,
        emit_bits: np.ndarray,
        k: int,
        w: int,
        bitmap: np.ndarray,
        bitmap_log2: int,
        uniq_hash: np.ndarray,
        hit_start: np.ndarray,
        hit_path: np.ndarray,
        hit_pos: np.ndarray,
        hit_strand: np.ndarray,
        params,
        n_threads: int = 0,
        panel_path_limit: int = 0,
        lookup: int = 0,
        hit_packed: Optional[np.ndarray] = None,
    ):
        """Lookup + chaining from the on-device scan's emission bitmask
        (``svt_chain5``/``svt_chain6``; design in align/dev_scan.py).
        ``hit_packed``: interleaved uint64 hit stream (index.packed_hits)
        — one cache-miss stream instead of three in the expand phase;
        ignored when the library predates svt_chain6.

        ``emit_bits`` is the (n_bases // 8,) uint8 LSB-first bitmask of
        emitted k-mer start positions. The native side recomputes hash /
        strand from ``codes``, applies the panel ``bitmap`` + exact
        lookup, and chains; reads shorter than k+w-1 bases (whose bits
        the device leaves clear by design) are scanned natively per read.
        Same output tuple as :meth:`chain`, or None when the library
        predates svt_chain5.
        """
        lib = self._lib
        if not hasattr(lib, "svt_chain5"):
            return None
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        emit_bits = np.ascontiguousarray(emit_bits, dtype=np.uint8)
        if bitmap is not None:
            bitmap = np.ascontiguousarray(bitmap, dtype=np.uint8)
        uniq_hash = np.ascontiguousarray(uniq_hash, dtype=np.uint32)
        hit_start = np.ascontiguousarray(hit_start, dtype=np.int64)
        hit_path = np.ascontiguousarray(hit_path, dtype=np.int32)
        hit_pos = np.ascontiguousarray(hit_pos, dtype=np.int32)
        hit_strand = np.ascontiguousarray(hit_strand, dtype=np.int8)
        use6 = hit_packed is not None and hasattr(lib, "svt_chain6")
        if use6:
            hit_packed = np.ascontiguousarray(hit_packed, dtype=np.uint64)
        handle = (lib.svt_chain6 if use6 else lib.svt_chain5)(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int64(len(codes)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(offsets) - 1),
            ctypes.c_int32(k),
            ctypes.c_int32(w),
            emit_bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            (
                bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                if bitmap is not None
                else None
            ),
            ctypes.c_int32(bitmap_log2),
            uniq_hash.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(len(uniq_hash)),
            hit_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            hit_path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hit_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hit_strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int32(params.min_anchors),
            ctypes.c_int32(params.max_chains),
            ctypes.c_int32(params.max_gap),
            ctypes.c_int32(params.drift_abs),
            ctypes.c_int32(params.drift_permille),
            ctypes.c_int32(params.block_rows),
            ctypes.c_int32(params.ext_min_anchors),
            ctypes.c_int32(panel_path_limit),
            ctypes.c_int32(n_threads),
            ctypes.c_void_p(lookup),
            *(
                [hit_packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))]
                if use6
                else []
            ),
        )
        if not handle:
            return None
        return self._seed_result(handle)

    def suppress(
        self,
        p_read, p_sup, p_qlo, p_qhi, p_cluster,
        d_read, d_path, d_strand, d_sup, d_qlo, d_qhi, d_tlo, d_thi,
        span_lo, span_hi, n_chroms: int, overlap_frac: float, margin: int,
        n_threads: int = 0,
        return_margins: bool = False,
    ) -> Optional[np.ndarray]:
        """Native decoy-suppression inner loop (align/decoy.py semantics).

        Both chain tables must be sorted by read id. Returns a uint8
        suppressed flag per panel chain (with ``return_margins`` a
        (suppressed, best_other, best_same) triple), or None when the
        library predates svt_suppress / svt_suppress2.
        """
        lib = self._lib
        if not hasattr(lib, "svt_suppress"):
            return None
        if return_margins and not hasattr(lib, "svt_suppress2"):
            return None

        def arr(a, dt):
            return np.ascontiguousarray(a, dtype=dt)

        i32 = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.POINTER(ctypes.c_int64)
        p_read = arr(p_read, np.int32)
        d_read_chk = np.asarray(d_read)
        if (len(p_read) and (np.diff(p_read) < 0).any()) or (
            len(d_read_chk) and (np.diff(d_read_chk) < 0).any()
        ):
            raise ValueError("svt_suppress requires read-sorted chain tables")
        p_sup = arr(p_sup, np.int32)
        p_qlo, p_qhi = arr(p_qlo, np.int64), arr(p_qhi, np.int64)
        p_cluster = arr(p_cluster, np.int32)
        d_read = arr(d_read, np.int32)
        d_path = arr(d_path, np.int32)
        d_strand = arr(d_strand, np.int8)
        d_sup = arr(d_sup, np.int32)
        d_qlo, d_qhi = arr(d_qlo, np.int64), arr(d_qhi, np.int64)
        d_tlo, d_thi = arr(d_tlo, np.int64), arr(d_thi, np.int64)
        span_lo = arr(span_lo, np.int64)
        span_hi = arr(span_hi, np.int64)
        out = np.zeros(len(p_read), dtype=np.uint8)
        common = (
            ctypes.c_int64(len(p_read)),
            p_read.ctypes.data_as(i32), p_sup.ctypes.data_as(i32),
            p_qlo.ctypes.data_as(i64), p_qhi.ctypes.data_as(i64),
            p_cluster.ctypes.data_as(i32),
            ctypes.c_int64(len(d_read)),
            d_read.ctypes.data_as(i32), d_path.ctypes.data_as(i32),
            d_strand.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            d_sup.ctypes.data_as(i32),
            d_qlo.ctypes.data_as(i64), d_qhi.ctypes.data_as(i64),
            d_tlo.ctypes.data_as(i64), d_thi.ctypes.data_as(i64),
            span_lo.ctypes.data_as(i64), span_hi.ctypes.data_as(i64),
            ctypes.c_int32(n_chroms), ctypes.c_double(overlap_frac),
            ctypes.c_int64(margin), ctypes.c_int32(n_threads),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if return_margins:
            best_other = np.zeros(len(p_read), dtype=np.int32)
            best_same = np.zeros(len(p_read), dtype=np.int32)
            lib.svt_suppress2(
                *common,
                best_other.ctypes.data_as(i32),
                best_same.ctypes.data_as(i32),
            )
            return out, best_other, best_same
        lib.svt_suppress(*common)
        return out

    def read_sequences(
        self, path: str
    ) -> Optional[Tuple[List[str], np.ndarray, np.ndarray]]:
        handle = self._lib.svt_read_sequences(path.encode())
        if not handle:
            return None
        try:
            n = self._lib.svt_result_n_reads(handle)
            total = self._lib.svt_result_total_bases(handle)
            codes = np.empty(total, dtype=np.int8)
            offsets = np.empty(n + 1, dtype=np.int64)
            self._lib.svt_result_copy(
                handle,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            names = [self._lib.svt_result_name(handle, i).decode() for i in range(n)]
            return names, codes, offsets
        finally:
            self._lib.svt_result_free(handle)

    # -- streaming reader (bounded-memory chunked reads) --

    def stream_open(self, path: str) -> Optional[int]:
        """Open a FASTQ/FASTA(.gz) stream; None if unsupported/unopenable."""
        if not hasattr(self._lib, "svt_stream_open"):
            return None
        handle = self._lib.svt_stream_open(path.encode())
        return handle or None

    def stream_next(
        self, handle: int, max_reads: int, max_bases: int = 0
    ) -> Optional[Tuple[List[str], np.ndarray, np.ndarray]]:
        """Next chunk of up to max_reads records (None at EOF)."""
        res = self._lib.svt_stream_next(handle, max_reads, max_bases)
        if not res:
            return None
        try:
            n = self._lib.svt_result_n_reads(res)
            total = self._lib.svt_result_total_bases(res)
            codes = np.empty(total, dtype=np.int8)
            offsets = np.empty(n + 1, dtype=np.int64)
            self._lib.svt_result_copy(
                res,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            names = [
                self._lib.svt_result_name(res, i).decode() for i in range(n)
            ]
            return names, codes, offsets
        finally:
            self._lib.svt_result_free(res)

    def stream_close(self, handle: int) -> None:
        self._lib.svt_stream_close(handle)


def load_native() -> Optional[_NativeIO]:
    """Load the native I/O library if built; cache the result."""
    global _LIB, _LIB_SEARCHED
    if _LIB_SEARCHED:
        return _LIB
    _LIB_SEARCHED = True
    root = Path(__file__).resolve().parent.parent
    for candidate in [root / "kernels" / "_build" / "libsvtfastio.so"]:
        if candidate.exists():
            try:
                _LIB = _NativeIO(ctypes.CDLL(str(candidate)))
            except OSError:
                _LIB = None
            break
    return _LIB
