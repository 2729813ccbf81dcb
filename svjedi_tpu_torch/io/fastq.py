# Copied verbatim from svjedi_tpu/io/fastq.py.
"""FASTQ(.gz) reading.

The reference never reads FASTQ in Python — gzipped reads are decompressed
inside minigraph (SURVEY §2.1.2, svjedi-graph.py:104). Our aligner is
in-process, so we need a fast reader: the native C++ path
(``native/fastio.cpp``, zlib) is used when its shared library has been built,
else a pure-Python fallback. Both return identical results.

Multiple comma-separated FASTQ files are concatenated in order, matching the
orchestrator's sequential mapping into one GAF (svjedi-graph.py:95-105).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from ..utils.native import load_native


@dataclass
class ReadSet:
    """A batch of reads: names plus 2-bit-friendly int8 codes.

    ``codes`` is a flat ``int8`` array over all reads (A,C,G,T -> 0..3,
    anything else -> 4); ``offsets[i]:offsets[i+1]`` delimits read ``i``.
    """

    names: List[str]
    codes: np.ndarray  # int8, concatenated
    offsets: np.ndarray  # int64, len = n_reads + 1

    @property
    def n_reads(self) -> int:
        return len(self.names)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def seq(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i] : self.offsets[i + 1]]

    def slice(self, start: int, stop: int) -> "ReadSet":
        """Zero-copy view of reads [start, stop) with rebased offsets."""
        lo, hi = self.offsets[start], self.offsets[stop]
        return ReadSet(
            names=self.names[start:stop],
            codes=self.codes[lo:hi],
            offsets=self.offsets[start : stop + 1] - lo,
        )


# ASCII -> code lookup: A/a=0 C/c=1 G/g=2 T/t=3, everything else 4.
_LUT = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[_b + 32] = _i  # lowercase


def encode_ascii(seq: Union[bytes, str]) -> np.ndarray:
    """Encode an ASCII nucleotide string to int8 codes (N and others -> 4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def _read_fastq_python(path: Path) -> Iterable[tuple]:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fh:
        while True:
            header = fh.readline()
            if not header:
                break
            seq = fh.readline().rstrip()
            fh.readline()  # '+'
            fh.readline()  # quals
            name = header[1:].split()[0].decode()
            yield name, seq


def _read_fasta_reads_python(path: Path) -> Iterable[tuple]:
    opener = gzip.open if path.suffix == ".gz" else open
    name, parts = None, []
    with opener(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(parts)
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line.strip())
    if name is not None:
        yield name, b"".join(parts)


def _is_fasta(path: Path) -> bool:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fh:
        first = fh.read(1)
    return first == b">"


class ReadStream:
    """Lazy bounded-memory read source: the Gb-genome loader.

    ``read_reads`` keeps every base resident (~36 GB of codes for a 12x
    human genome — the r4 Gb blocker, PERF.md scale table). The reference
    never has this problem only because minigraph streams the FASTQ
    internally (svjedi-graph.py:104 passes the path straight through);
    this is the equivalent layer for our in-process aligner: reads are
    pulled from the native streaming parser (``svt_stream_*`` in
    native/fastio.cpp; pure-Python fallback with identical output) in
    fixed-size :class:`ReadSet` chunks, so reads-resident memory is
    O(chunk), not O(coverage x genome).

    Chunk boundaries reproduce ``align_and_count``'s eager slicing exactly
    (including the quarter-size pipeline-fill first chunk), so a streamed
    run is byte-identical to an eager one (tests/test_stream.py).

    Names and lengths ARE accumulated (~40 bytes/read — GAF export and
    audit rebasing need global read ids after the align stage); after full
    iteration the stream answers ``n_reads`` / ``lengths`` / ``names``
    like a ReadSet, minus ``codes``.

    Single-pass: ``chunks()`` may be called once.
    """

    def __init__(self, paths: Union[str, Sequence[Union[str, Path]]]):
        if isinstance(paths, (str, Path)):
            paths = [p for p in str(paths).split(",") if p]
        self.paths = [Path(p) for p in paths]
        self.names: List[str] = []
        self._lengths: List[int] = []
        self.total_bases = 0
        self._consumed = False

    @property
    def n_reads(self) -> int:
        return len(self.names)

    @property
    def lengths(self) -> np.ndarray:
        return np.asarray(self._lengths, dtype=np.int64)

    def _raw_chunks(self, max_reads: int) -> Iterable[tuple]:
        """Yield (names, per-read code arrays) batches of <= max_reads."""
        native = load_native()
        for p in self.paths:
            if native is not None:
                handle = native.stream_open(str(p))
                if handle is not None:
                    try:
                        while True:
                            res = native.stream_next(handle, max_reads)
                            if res is None:
                                break
                            f_names, f_codes, f_offsets = res
                            yield f_names, [
                                f_codes[f_offsets[i] : f_offsets[i + 1]]
                                for i in range(len(f_names))
                            ]
                    finally:
                        native.stream_close(handle)
                    continue
            it = (
                _read_fasta_reads_python(p)
                if _is_fasta(p)
                else _read_fastq_python(p)
            )
            batch_names: List[str] = []
            batch_codes: List[np.ndarray] = []
            for name, seq in it:
                batch_names.append(name)
                batch_codes.append(encode_ascii(seq))
                if len(batch_names) >= max_reads:
                    yield batch_names, batch_codes
                    batch_names, batch_codes = [], []
            if batch_names:
                yield batch_names, batch_codes

    def chunks(
        self, chunk_reads: int, first: Optional[int] = None
    ) -> Iterable[ReadSet]:
        """Yield ReadSets of ``chunk_reads`` reads (the last one shorter).

        With ``first``, the first chunk has ``first`` reads — but only when
        the stream holds MORE than ``chunk_reads`` total, matching the
        eager pipeline-fill ramp rule (a short stream stays one chunk).
        """
        if self._consumed:
            raise RuntimeError("ReadStream is single-pass; already consumed")
        self._consumed = True
        pend_names: List[str] = []
        pend_codes: List[np.ndarray] = []
        raw = self._raw_chunks(chunk_reads)

        def emit(k: int) -> ReadSet:
            names = pend_names[:k]
            per_read = pend_codes[:k]
            del pend_names[:k], pend_codes[:k]
            codes = (
                np.concatenate(per_read)
                if per_read
                else np.zeros(0, dtype=np.int8)
            )
            offsets = np.zeros(len(names) + 1, dtype=np.int64)
            np.cumsum([len(c) for c in per_read], out=offsets[1:])
            self.names.extend(names)
            self._lengths.extend(int(len(c)) for c in per_read)
            self.total_bases += int(codes.size)
            return ReadSet(names=names, codes=codes, offsets=offsets)

        def fill(target: int) -> bool:
            """Buffer until >= target reads pending; False once EOF."""
            while len(pend_names) < target:
                batch = next(raw, None)
                if batch is None:
                    return False
                pend_names.extend(batch[0])
                pend_codes.extend(batch[1])
            return True

        # Eager rule being replicated (align/pipeline.py): first chunk =
        # ``first`` when n_reads > chunk_reads else chunk_reads; then
        # chunk_reads each. Deciding needs max(chunk_reads, first)+1 reads
        # buffered (or EOF).
        first_sz = first if first else chunk_reads
        more = fill(max(chunk_reads, first_sz) + 1)
        if not more:
            n = len(pend_names)
            nxt = first_sz if n > chunk_reads else chunk_reads
            while pend_names:
                yield emit(min(nxt, len(pend_names)))
                nxt = chunk_reads
            return
        yield emit(first_sz)
        while True:
            fill(chunk_reads)
            if not pend_names:
                break
            yield emit(min(chunk_reads, len(pend_names)))


def read_reads(paths: Union[str, Sequence[Union[str, Path]]]) -> ReadSet:
    """Load long reads from FASTQ/FASTA(.gz) file(s).

    Accepts a single path, a comma-separated string (reference CLI contract,
    svjedi-graph.py:95-98), or a sequence of paths.
    """
    if isinstance(paths, (str, Path)):
        paths = [p for p in str(paths).split(",") if p]

    native = load_native()
    names: List[str] = []
    chunks: List[np.ndarray] = []
    lengths: List[int] = []

    for p in paths:
        p = Path(p)
        if native is not None:
            result = native.read_sequences(str(p))
            if result is not None:
                f_names, f_codes, f_offsets = result
                names.extend(f_names)
                chunks.append(f_codes)
                lengths.extend(np.diff(f_offsets).tolist())
                continue
        it = _read_fasta_reads_python(p) if _is_fasta(p) else _read_fastq_python(p)
        for name, seq in it:
            names.append(name)
            codes = encode_ascii(seq)
            chunks.append(codes)
            lengths.append(len(codes))

    codes = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int8)
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return ReadSet(names=names, codes=codes, offsets=offsets)
