"""``count_support_flat`` (the port's counting step) against the JAX
package's ``count_support``, the rule it reproduces, on winners built to
hit each of its rules.

Every comparison takes ``list(counts.items())`` and ``list(audit.items())``,
so the dicts' key order is held too: ``run`` writes the audit as
``_informative_aln.json``, which must equal the JAX package's byte for byte.
The bundle's own winners are compared in ``tests/test_torch_align.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from svjedi_tpu.align import pipeline as jpipe
from svjedi_tpu_torch.align import pipeline as tpipe
from svjedi_tpu_torch.graph.build import FWD, REV
from svjedi_tpu_torch.graph.cluster import Panel, PanelPath
from svjedi_tpu_torch.io.fastq import ReadSet

D_OVER = 100

#: path -> owned (tag, allele, junction offset, link index). Path 0 owns two
#: links of one tag; paths 0 and 1 carry the two alleles of "sv1"; path 3
#: owns both alleles of "sv4" (each allele at its own link); path 4 owns
#: nothing.
OWNED = [
    [("sv1", 0, 400, 10), ("sv1", 0, 900, 11), ("sv2", 1, 1500, 20)],
    [("sv1", 1, 600, 12)],
    [("sv2", 0, 500, 21), ("sv3", 1, 700, 30)],
    [("sv4", 0, 300, 40), ("sv4", 1, 800, 41), ("sv1", 0, 1200, 10)],
    [],
]


def _panel(owned=OWNED):
    graph = SimpleNamespace(nodes=[
        SimpleNamespace(name=f"s{i}", chrom="c" if i < 6 else "d")
        for i in range(12)])
    paths = [
        PanelPath(cluster_id=p, states=[(p, FWD), (p + 5, REV), (11, FWD)],
                  seq=np.zeros(2000, np.int8), owned=list(own),
                  trim_left=7 * p, full_len=2100 + p)
        for p, own in enumerate(owned)
    ]
    return Panel(clusters=[], paths=paths, graph=graph)


def _reads(n=8, length=3000):
    offsets = np.arange(n + 1, dtype=np.int64) * length
    return ReadSet(names=[f"read{i}" for i in range(n)],
                   codes=np.zeros(n * length, np.int8), offsets=offsets)


def _winners(rows, stats=True):
    """rows: (read, path, strand, score, ts, te)."""
    a = np.array(rows, dtype=np.int64).reshape(-1, 6)
    n = len(a)
    w = tpipe.Winners(
        read=a[:, 0].astype(np.int32), cluster=a[:, 1].astype(np.int32),
        path=a[:, 1].astype(np.int32), strand=a[:, 2].astype(np.int8),
        score=a[:, 3].astype(np.int32), qs=(a[:, 4] % 97).astype(np.int32),
        qe=(a[:, 4] % 97 + a[:, 5] - a[:, 4]).astype(np.int32),
        ts=a[:, 4].astype(np.int32), te=a[:, 5].astype(np.int32))
    if stats:
        span_len = a[:, 5] - a[:, 4] + 1
        w.matches = (span_len * 9 // 10).astype(np.int32)
        w.blocklen = (span_len + np.arange(n) % 5).astype(np.int32)
        w.mapq = (np.arange(n) * 7 % 61).astype(np.int16)
    return w


def _check(panel, winners, reads, collect_audit=True, min_density=0.0):
    """The flat count equals JAX's counts, in order; returns its result and
    counters."""
    timings = {}
    ours = tpipe.count_support_flat(panel, winners, reads, D_OVER,
                                    collect_audit, min_density=min_density,
                                    timings=timings)
    theirs = jpipe.count_support(panel, winners, reads, D_OVER, collect_audit,
                                 min_density=min_density)
    assert list(ours[0].items()) == list(theirs[0].items())
    assert list(ours[1].items()) == list(theirs[1].items())
    assert timings["count_crossings"] == sum(a + b for a, b
                                             in ours[0].values())
    return ours, timings


#: Rule cases: (read, path, strand, score, ts, te) rows.
CASES = {
    # Read 0 crosses sv1 ref (path 0) and alt (path 1) at one best score:
    # the smaller row decides (ref); read 1 the same with alt first.
    "tied_alleles_smallest_row": [
        (0, 0, 0, 80, 200, 1000), (0, 1, 1, 80, 400, 800),
        (1, 1, 0, 90, 400, 800), (1, 0, 1, 90, 200, 1000),
    ],
    # The higher score wins over the smaller row.
    "best_score_wins": [
        (2, 1, 0, 70, 400, 800), (2, 0, 0, 95, 200, 1000),
        (2, 1, 1, 95, 300, 900),
    ],
    # Path 0 owns two sv1 links: one row counts both crossings, one line.
    "two_links_one_tag": [(3, 0, 1, 60, 100, 1300)],
    # Two rows of one read cross link 10 (paths 0 and 3): counted once;
    # another read's row counts again.
    "two_rows_same_link": [
        (4, 0, 0, 60, 250, 700), (4, 3, 0, 50, 1000, 1400),
        (5, 0, 0, 40, 250, 700),
    ],
    # j - ts == d_over and te - j + 1 == d_over exactly (counted), then one
    # base short on either side (not counted).
    "d_over_edges": [
        (0, 1, 0, 50, 500, 699), (1, 1, 0, 50, 501, 699),
        (2, 1, 0, 50, 500, 698), (3, 2, 1, 50, 400, 799),
    ],
    # One path owning both alleles of sv4: exclusivity inside one row.
    "both_alleles_one_path": [(6, 3, 0, 70, 100, 1400),
                              (7, 3, 1, 70, 100, 1000)],
    "empty": [],
    "nothing_crosses": [(0, 4, 0, 50, 0, 1999), (1, 0, 0, 50, 1600, 1900)],
}


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "no_stats"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_cases_match_verbatim_and_jax(case, stats):
    _check(_panel(), _winners(CASES[case], stats), _reads())


def test_rule_cases_count_as_described():
    panel, reads = _panel(), _reads()
    (counts, audit), _ = _check(panel, _winners(CASES["tied_alleles_smallest_row"]),
                                reads)
    assert counts["sv1"] == [2, 1]  # read 0: links 10 and 11; read 1: alt
    (counts, audit), t = _check(panel, _winners(CASES["two_links_one_tag"]),
                                reads)
    assert counts == {"sv1": [2, 0]} and audit["sv1"][0][0] == audit["sv1"][0][1]
    assert (t["count_crossings"], t["audit_line_rows"]) == (2, 1)
    (counts, _), _ = _check(panel, _winners(CASES["two_rows_same_link"]), reads)
    assert counts == {"sv1": [2, 0]}  # link 10 once for read 4, once for 5
    (counts, _), _ = _check(panel, _winners(CASES["d_over_edges"]), reads)
    assert counts["sv1"] == [0, 1]


@pytest.mark.parametrize("collect_audit", [True, False])
def test_density_gate_removing_every_winner(collect_audit):
    rows = CASES["tied_alleles_smallest_row"] + CASES["two_links_one_tag"]
    (counts, audit), t = _check(_panel(), _winners(rows), _reads(),
                                collect_audit=collect_audit, min_density=1.0)
    assert counts == {} and audit == {}
    assert t["count_entries"] == 0 and t["count_crossings"] == 0


def test_without_audit_counts_alone():
    rows = [r for c in sorted(CASES) for r in CASES[c]]
    (counts, audit), t = _check(_panel(), _winners(rows), _reads(),
                                collect_audit=False)
    assert counts and audit == {}
    assert t["audit_line_rows"] == 0


def _random_winners(seed, n_rows=300, n_reads=8):
    """Rows over the panel's paths at few scores (ties), spans around the
    junctions and often within a base of d_over, rows in read order as
    ``finalize_chunk`` gives them (and shuffled on odd seeds)."""
    rng = np.random.default_rng(seed)
    path = rng.integers(0, len(OWNED), n_rows)
    j = np.array([own[0][2] if own else 1000 for own in OWNED])[path]
    ts = j - rng.choice([99, 100, 101, 300, 700], n_rows) \
        + rng.integers(0, 3, n_rows) - 1
    te = j + rng.choice([98, 99, 100, 400, 900], n_rows)
    ts, te = np.clip(ts, 0, 1999), np.clip(te, 0, 1999)
    read = np.sort(rng.integers(0, n_reads, n_rows))
    rows = np.stack([read, path, rng.integers(0, 2, n_rows),
                     rng.choice([40, 60, 60, 80], n_rows), ts,
                     np.maximum(ts, te)], axis=1)
    if seed % 2:
        rows = rows[rng.permutation(n_rows)]
    return rows.tolist()


@pytest.mark.parametrize("density", [0.0, 0.04])
@pytest.mark.parametrize("seed", range(6))
def test_random_winners_match_verbatim_and_jax(seed, density):
    rows = _random_winners(seed)
    for stats in (True, False):
        (counts, _), t = _check(_panel(), _winners(rows, stats), _reads(),
                                min_density=density)
        assert counts and t["count_crossings"] > t["audit_line_rows"] > 0


@pytest.mark.parametrize("density", [0.0, 0.04])
def test_count_entries_is_owned_links_of_gated_winners(density):
    panel = _panel()
    w = _winners(_random_winners(3))
    (_, _), t = _check(panel, w, _reads(), min_density=density)
    ok = np.ones(len(w.read), bool)
    if density > 0:
        ok = w.score >= density * np.maximum(1, w.te - w.ts + 1)
    assert not ok.all() or density == 0
    assert t["count_entries"] == sum(len(panel.paths[p].owned)
                                     for p in w.path[ok])


def test_count_table_is_built_once_per_panel(monkeypatch):
    built = []
    real = tpipe._build_count_table
    monkeypatch.setattr(tpipe, "_build_count_table",
                        lambda panel: built.append(panel) or real(panel))
    panel, reads = _panel(), _reads()
    table = tpipe.count_table(panel)
    for seed in range(3):  # several chunks of one job, then another job
        _check(panel, _winners(_random_winners(seed)), reads)
    assert tpipe.count_table(panel) is table
    assert built == [panel]
    other = _panel()
    assert tpipe.count_table(other) is not table and len(built) == 2


def test_count_table_flattens_owned_in_walk_order():
    table = tpipe.count_table(_panel())
    assert table.offsets.tolist() == [0, 3, 4, 6, 9, 9]
    assert table.tag_names == ["sv1", "sv2", "sv3", "sv4"]
    assert [(table.tag_names[t], a, j, li) for t, a, j, li in zip(
        table.tag.tolist(), table.allele.tolist(), table.junction.tolist(),
        table.link.tolist())] == [o for own in OWNED for o in own]
    assert table.head[2] == ">s2<s7>s11\t2102"
    assert table.trim_left.tolist() == [0, 7, 14, 21, 28]
    # Tags of no SV type, so no path owns an INV or BND link; path 0's walk
    # (s0, s5, s11) holds nodes of chromosomes c and d, as every path's.
    assert table.tag_kind.tolist() == [len(tpipe.SV_KINDS)] * 4
    assert not table.path_inv_bnd.any() and table.path_cross_chrom.all()
