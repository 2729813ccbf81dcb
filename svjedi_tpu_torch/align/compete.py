"""The decoy competition on the merged-index path, read off chain boundaries.

One scan of the merged panel + decoy index (``index.merge_indexes``) gives
``seed_candidates``' block rows for both sides at once. In those rows a
chain's blocks are contiguous, chain ids rise with the rows (a cumulative
sum of changes, ``seed._globalize_chains``), and a chain lies on one path
(the chainer groups anchors by path and strand). So:

- "panel or decoy" is a property of the chain, read at its first row;
- both chain tables that ``decoy.suppress_candidates`` builds with
  ``decoy._chain_table`` (after copying the rows into a panel and a decoy
  table) are gathers at the chains' first and last rows, in the order
  ``np.unique`` gives;
- the verdict, one flag per panel chain, removes runs of rows.

:func:`suppress_merged` makes the same native ``svt_suppress2`` call on
tables built that way and gathers the surviving panel rows once from the
merged rows. Its result equals the split, ``suppress_candidates(...,
return_margins=True)`` and ``take(keep)`` field for field, and it runs that
sequence itself where the native library lacks ``svt_suppress2`` (the numpy
pair path), where either side has no row, or where chain ids do not rise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..io.fastq import ReadSet
from ..utils.native import load_native
from .decoy import Decoy, suppress_candidates
from .index import PanelIndex
from .seed import Candidates, _expand_ranges


def suppress_merged(
    chunk: ReadSet,
    cands: Candidates,
    n_panel_paths: int,
    index: PanelIndex,
    decoy: Decoy,
    threads: int = 0,
    head: Optional[np.ndarray] = None,
) -> Tuple[Candidates, Dict[str, int]]:
    """Decoy-suppress the merged scan's rows ``cands`` of ``chunk``.

    Paths below ``n_panel_paths`` are ``index``'s panel paths, the rest
    ``decoy``'s chromosomes after them. ``head`` (optional) marks each
    chain's first row. Returns the surviving panel rows, with ``dec_other``
    and ``dec_same`` filled, and the counts ``decoy_chains`` (decoy rows
    competing), ``decoy_suppressed`` (panel rows removed) and
    ``decoy_panel_chains`` (panel chains judged from chain boundaries; 0
    where the row-copying sequence ran).
    """
    native = load_native()
    n = len(cands)
    if native is None or not n or not hasattr(native._lib, "svt_suppress2"):
        return _split_and_suppress(chunk, cands, n_panel_paths, index, decoy,
                                   threads)
    if head is None:
        head = np.ones(n, dtype=bool)
        head[1:] = cands.chain[1:] != cands.chain[:-1]
    first = np.flatnonzero(head)
    ids = cands.chain[first]
    if not (ids[1:] > ids[:-1]).all():
        # Boundary order would not be np.unique's order.
        return _split_and_suppress(chunk, cands, n_panel_paths, index, decoy,
                                   threads)
    last = np.empty_like(first)
    last[:-1] = first[1:] - 1
    last[-1] = n - 1
    on_panel = cands.path[first] < n_panel_paths
    p_first, p_last = first[on_panel], last[on_panel]
    d_first, d_last = first[~on_panel], last[~on_panel]
    if not len(p_first) or not len(d_first):
        return _split_and_suppress(chunk, cands, n_panel_paths, index, decoy,
                                   threads)

    # _chain_table's columns, each in the dtype _NativeIO.suppress takes.
    rlen = chunk.lengths
    p_read, _, _, p_qlo, p_qhi = _chain_columns(cands, p_first, rlen)
    d_read, a_lo, a_hi, d_qlo, d_qhi = _chain_columns(cands, d_first, rlen)
    d_tlo = cands.d0[d_first].astype(np.int64) + a_lo
    d_thi = cands.d0[d_last].astype(np.int64) + a_hi
    suppressed, best_other, best_same = native.suppress(
        p_read, cands.n_anchors[p_first], p_qlo, p_qhi,
        index.path_cluster[cands.path[p_first]],
        d_read, cands.path[d_first] - np.int32(n_panel_paths),
        cands.strand[d_first], cands.n_anchors[d_first],
        d_qlo, d_qhi, d_tlo, d_thi,
        decoy.span_lo, decoy.span_hi, len(decoy.chrom_of_path),
        decoy.overlap_frac, decoy.margin, n_threads=threads,
        return_margins=True,
    )

    kept = suppressed == 0
    blocks = p_last - p_first + 1
    rows, kept_blocks = _expand_ranges(p_first[kept], p_last[kept] + 1)
    survivors = Candidates(
        read=cands.read[rows],
        path=cands.path[rows],
        strand=cands.strand[rows],
        d0=cands.d0[rows],
        n_anchors=cands.n_anchors[rows],
        chain=cands.chain[rows],
        q_lo=cands.q_lo[rows],
        q_hi=cands.q_hi[rows],
        a_lo=cands.a_lo[rows],
        a_hi=cands.a_hi[rows],
        dec_other=np.repeat(best_other[kept], kept_blocks),
        dec_same=np.repeat(best_same[kept], kept_blocks),
        head_diag=cands.head_diag[rows],
    )
    return survivors, {
        "decoy_chains": int((d_last - d_first + 1).sum()),
        "decoy_suppressed": int(blocks[~kept].sum()),
        "decoy_panel_chains": len(p_first),
    }


def _chain_columns(cands: Candidates, first: np.ndarray, rlen: np.ndarray):
    """Per chain: its read (int32), its anchor extent (int64) and that
    extent in forward read coordinates, as ``_chain_table`` has them."""
    read = cands.read[first]
    a_lo = cands.a_lo[first].astype(np.int64)
    a_hi = cands.a_hi[first].astype(np.int64)
    rl = rlen[read]
    fwd = cands.strand[first] == 0
    q_lo = np.where(fwd, a_lo, rl - a_hi)
    q_hi = np.where(fwd, a_hi, rl - a_lo)
    return read, a_lo, a_hi, q_lo, q_hi


def _split_and_suppress(chunk, cands, n_panel_paths, index, decoy, threads):
    """The row-copying sequence: split the rows, run the verbatim
    ``suppress_candidates`` on the two copies, take the survivors."""
    is_panel = cands.path < n_panel_paths
    dec = cands.take(~is_panel, path_offset=-n_panel_paths)
    cands = cands.take(is_panel)
    # chain_params seeds the decoy only where ``dec`` is not given.
    keep, dec_other, dec_same = suppress_candidates(
        chunk, cands, index, decoy, None, threads=threads, dec=dec,
        return_margins=True,
    )
    cands.dec_other = dec_other
    cands.dec_same = dec_same
    counts = {"decoy_chains": len(dec),
              "decoy_suppressed": int((~keep).sum()),
              "decoy_panel_chains": 0}
    if not keep.all():
        cands = cands.take(keep)
    return cands, counts
