"""The decoy competition from chain boundaries (``align/compete.py``).

``suppress_merged`` must give what the seeder's earlier sequence gives on the
merged scan's rows: split the rows into panel and decoy copies, run the
verbatim ``decoy.suppress_candidates(..., return_margins=True)`` on them and
take the kept rows. Held field for field (all 13 ``Candidates`` fields, their
dtypes and the row order) and in the three counts, with the port's native
library built into a temporary directory: on the merged seeding of a small
repeat catalogue (``benchmark/gen_simgenome_repeats.py``), where most panel
rows are suppressed, and of a small all-types catalogue, where few are; and
on synthetic rows that reach each branch. Without the library the row-copying
sequence runs and equals the numpy pair path's result.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import cells
from svjedi_tpu_torch.align import compete
from svjedi_tpu_torch.align.decoy import Decoy, build_decoy, suppress_candidates
from svjedi_tpu_torch.align.index import build_panel_index, merge_indexes
from svjedi_tpu_torch.align.seed import Candidates, ChainParams, seed_candidates
from svjedi_tpu_torch.config import AlignConfig
from svjedi_tpu_torch.graph.build import build_graph
from svjedi_tpu_torch.graph.cluster import build_panel
from svjedi_tpu_torch.graph.svparse import parse_vcf_svs
from svjedi_tpu_torch.io.fasta import read_fasta, write_fasta
from svjedi_tpu_torch.io.fastq import read_reads
from svjedi_tpu_torch.utils import native as tnative
from test_torch_dev_scan import native_installed, port_native  # noqa: F401

FIELDS = ("read", "path", "strand", "d0", "n_anchors", "chain", "q_lo",
          "q_hi", "a_lo", "a_hi", "dec_other", "dec_same", "head_diag")
#: Five 40 kb chromosomes, 20 records, ~4x of 3 kb reads (the repeats and
#: all-types CPU tests' size).
TINY = {"chroms": {f"chr{i}": 40_000 for i in range(1, 6)},
        "genome_bp": 200_000, "n_svs": 20, "translocations_direct": 1,
        "translocations_inverted": 1}
TINY_MIX = {"coverage": 4, "mean_len": 3000, "sd_len": 1000,
            "max_len": 8000}
SEED = 2**31 + 1919


def split_then_suppress(chunk, cands, n_panel, index, decoy):
    """The seeder's sequence before ``suppress_merged``."""
    is_panel = cands.path < n_panel
    dec = cands.take(~is_panel, path_offset=-n_panel)
    panel = cands.take(is_panel)
    keep, dec_other, dec_same = suppress_candidates(
        chunk, panel, index, decoy, ChainParams(), dec=dec,
        return_margins=True)
    panel.dec_other = dec_other
    panel.dec_same = dec_same
    return panel.take(keep), {"decoy_chains": len(dec),
                              "decoy_suppressed": int((~keep).sum())}


def assert_same(got, want):
    assert len(got) == len(want)
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def n_chains(cands, n_panel, panel):
    head = np.ones(len(cands), dtype=bool)
    head[1:] = cands.chain[1:] != cands.chain[:-1]
    return int(((cands.path[head] < n_panel) == panel).sum())


def check(chunk, cands, n_panel, index, decoy, boundary):
    """``suppress_merged`` against the sequence; ``boundary``: whether the
    chain-boundary path must have run."""
    want, want_counts = split_then_suppress(chunk, cands, n_panel, index,
                                            decoy)
    got, counts = compete.suppress_merged(chunk, cands, n_panel, index,
                                          decoy)
    assert_same(got, want)
    assert counts["decoy_chains"] == want_counts["decoy_chains"]
    assert counts["decoy_suppressed"] == want_counts["decoy_suppressed"]
    assert counts["decoy_panel_chains"] == (
        n_chains(cands, n_panel, True) if boundary else 0)
    return got, counts


# -- the merged seeding of two small catalogues -----------------------------


def _catalogue(cell_name, tmp):
    """A small catalogue of ``cell_name``'s generator, built as
    ``run_pipeline`` builds it, and its reads."""
    cell = cells.load_cell(cell_name)
    cell.config.update(TINY)
    cell.mix.update(TINY_MIX)
    cat = cell.gen.make_catalogue(cell.config, SEED)
    cat.write_vcf(tmp / "catalogue.vcf")
    write_fasta(tmp / "ref.fasta", cat.fasta_dict())
    cell.gen.make_sample(cat, cell.mix, SEED, tmp / "reads.fastq")
    cfg = AlignConfig()
    chroms = read_fasta(tmp / "ref.fasta")
    parsed = parse_vcf_svs(tmp / "catalogue.vcf",
                           {c: len(s) for c, s in chroms.items()})
    panel = build_panel(
        build_graph(chroms, parsed), flank=cfg.flank,
        cluster_gap=cfg.cluster_gap,
        max_paths_per_cluster=cfg.max_paths_per_cluster,
        max_hops_per_path=cfg.max_hops_per_path)
    hits = cfg.max_hits_per_minimizer
    index = build_panel_index(panel, k=cfg.kmer, w=cfg.window,
                              max_hits_per_minimizer=hits)
    decoy = build_decoy(panel, k=cfg.kmer, w=cfg.window,
                        max_hits_per_minimizer=hits)
    chain_params = ChainParams(
        min_anchors=cfg.min_anchors, max_chains=cfg.max_chains,
        max_gap=cfg.chain_max_gap, drift_abs=cfg.chain_drift_abs,
        drift_permille=cfg.chain_drift_permille, block_rows=cfg.block_rows,
        ext_min_anchors=cfg.chain_ext_min_anchors)
    return SimpleNamespace(reads=tmp / "reads.fastq", index=index,
                           decoy=decoy, chain_params=chain_params)


@pytest.fixture(scope="module")
def merged(tmp_path_factory, port_native):  # noqa: F811
    """Per catalogue, its reads in two chunks and each chunk's merged rows,
    seeded through the native library as the seeder seeds them."""
    out = {}
    with native_installed(port_native, tnative):
        for name in ("simgenome-repeats.ont30x", "simgenome-alltypes.ont30x"):
            cat = _catalogue(name, tmp_path_factory.mktemp("compete"))
            reads = read_reads(str(cat.reads))
            n_panel = len(cat.index.path_len)
            seed_index = merge_indexes(cat.index, cat.decoy.index)
            half = reads.n_reads // 2
            chunks = []
            for chunk in (reads.slice(0, half),
                          reads.slice(half, reads.n_reads)):
                cands = seed_candidates(
                    chunk, seed_index, chain_params=cat.chain_params,
                    panel_path_limit=n_panel)
                chunks.append((chunk, cands))
            out[name] = SimpleNamespace(chunks=chunks, n_panel=n_panel,
                                        index=cat.index, decoy=cat.decoy)
    return out


@pytest.mark.parametrize("name, heavy", [
    ("simgenome-repeats.ont30x", True),
    ("simgenome-alltypes.ont30x", False),
])
def test_catalogue_survivors_equal_the_split_sequence(merged, port_native,  # noqa: F811
                                                      name, heavy):
    m = merged[name]
    suppressed = panel_rows = 0
    with native_installed(port_native, tnative):
        for chunk, cands in m.chunks:
            assert n_chains(cands, m.n_panel, True) > 0
            assert n_chains(cands, m.n_panel, False) > 0
            got, counts = check(chunk, cands, m.n_panel, m.index, m.decoy,
                                boundary=True)
            # Survivors carry their at-locus decoy (the reference allele);
            # over repeats also a weaker paralog.
            assert (got.dec_same > 0).any()
            assert (got.dec_other > 0).any() == heavy
            suppressed += counts["decoy_suppressed"]
            panel_rows += int((cands.path < m.n_panel).sum())
    # The repeats lose most panel rows to their paralogs; random sequence
    # few.
    if heavy:
        assert suppressed > panel_rows // 2
    else:
        assert 0 <= suppressed < panel_rows // 4


@pytest.mark.parametrize("name", ["simgenome-repeats.ont30x",
                                  "simgenome-alltypes.ont30x"])
def test_without_the_library_the_numpy_pair_path_gives_the_same(
        merged, port_native, name):  # noqa: F811
    m = merged[name]
    for chunk, cands in m.chunks:
        with native_installed(port_native, tnative):
            native_got, _ = compete.suppress_merged(
                chunk, cands, m.n_panel, m.index, m.decoy)
        with native_installed(None, tnative):
            got, counts = check(chunk, cands, m.n_panel, m.index, m.decoy,
                                boundary=False)
        assert counts["decoy_panel_chains"] == 0
        assert_same(got, native_got)


# -- synthetic rows -----------------------------------------------------------

N_PANEL = 6
N_CHROMS = 3


def _world():
    """A panel index of six paths in three clusters, and a decoy of three
    chromosomes with one span per cluster."""
    index = SimpleNamespace(path_cluster=np.array([0, 0, 1, 1, 2, 2],
                                                  dtype=np.int32))
    decoy = Decoy(index=None, chrom_of_path=["c0", "c1", "c2"],
                  cluster_spans=[{"c0": (2000, 4000)},
                                 {"c1": (10000, 12000), "c2": (500, 900)},
                                 {}])
    return index, decoy


def _synthetic(rng, n_reads=60, panel=(0, 3), dec=(0, 3), panel_sup=(2, 30),
               dec_sup=(1, 40), max_blocks=5):
    """Merged rows as the chainer emits them: reads in order, each read's
    chains contiguous with rising ids, a chain's blocks on one path and
    strand with the chain's anchors, extent and head diagonal on every
    block, and a diagonal of its own per block."""
    rlen = rng.integers(500, 6000, size=n_reads).astype(np.int64)
    cols = {k: [] for k in FIELDS if k not in ("dec_other", "dec_same")}
    chain = 0
    for r in range(n_reads):
        kinds = ([True] * int(rng.integers(*panel, endpoint=True))
                 + [False] * int(rng.integers(*dec, endpoint=True)))
        rng.shuffle(kinds)
        for on_panel in kinds:
            path = (rng.integers(0, N_PANEL) if on_panel
                    else N_PANEL + rng.integers(0, N_CHROMS))
            a_lo = int(rng.integers(0, rlen[r] // 2))
            a_hi = int(rng.integers(a_lo + 1, rlen[r] + 1))
            sup = int(rng.integers(*(panel_sup if on_panel else dec_sup),
                                   endpoint=True))
            d0 = int(rng.integers(0, 14000))
            blocks = int(rng.integers(1, max_blocks + 1))
            for b in range(blocks):
                cols["read"].append(r)
                cols["path"].append(path)
                cols["strand"].append(int(rng.integers(0, 2)) if b == 0
                                      else cols["strand"][-1])
                cols["d0"].append(d0 + 37 * b + int(rng.integers(0, 20)))
                cols["n_anchors"].append(sup)
                cols["chain"].append(chain)
                lo = a_lo + (a_hi - a_lo) * b // blocks
                cols["q_lo"].append(lo)
                cols["q_hi"].append(a_lo + (a_hi - a_lo) * (b + 1) // blocks)
                cols["a_lo"].append(a_lo)
                cols["a_hi"].append(a_hi)
                cols["head_diag"].append(d0 - a_lo)
            chain += 1
    dtypes = {"strand": np.int8, "chain": np.int64}
    cands = Candidates(**{k: np.array(v, dtype=dtypes.get(k, np.int32))
                          for k, v in cols.items()})
    # The rows as seeded carry no margins yet.
    assert not cands.dec_other.any() and not cands.dec_same.any()
    return SimpleNamespace(lengths=rlen), cands


CASES = {
    "mixed": {},
    "no_decoy_rows": {"dec": (0, 0)},
    "no_panel_rows": {"panel": (0, 0)},
    "nothing_suppressed": {"panel_sup": (5, 30), "dec_sup": (1, 4)},
    "decoy_only_reads": {"panel": (0, 1), "dec": (1, 4)},
    "one_block_chains": {"max_blocks": 1},
    "many_block_chains": {"max_blocks": 12},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_rows_equal_the_split_sequence(port_native, case):  # noqa: F811
    index, decoy = _world()
    rng = np.random.default_rng(sorted(CASES).index(case) + 2626)
    chunk, cands = _synthetic(rng, **CASES[case])
    n_panel_chains = n_chains(cands, N_PANEL, True)
    n_dec_chains = n_chains(cands, N_PANEL, False)
    with native_installed(port_native, tnative):
        got, counts = check(chunk, cands, N_PANEL, index, decoy,
                            boundary=n_panel_chains > 0 and n_dec_chains > 0)
    if case == "nothing_suppressed":
        assert counts["decoy_suppressed"] == 0
        assert len(got) == int((cands.path < N_PANEL).sum())
    if case in ("mixed", "many_block_chains"):
        assert 0 < counts["decoy_suppressed"] < int(
            (cands.path < N_PANEL).sum())
        assert (got.dec_same > 0).any() and (got.dec_other > 0).any()
    if case == "no_panel_rows":
        assert len(got) == 0 and counts["decoy_chains"] == len(cands)
    with native_installed(None, tnative):
        plain, plain_counts = check(chunk, cands, N_PANEL, index, decoy,
                                    boundary=False)
    assert_same(plain, got)
    assert plain_counts["decoy_suppressed"] == counts["decoy_suppressed"]


def test_everything_suppressed(port_native):  # noqa: F811
    """Every read with a panel chain carries a decoy chain over its whole
    length on a chromosome no cluster spans nearby, with more anchors."""
    index, _ = _world()
    decoy = Decoy(index=None, chrom_of_path=["c0", "c1", "c2"],
                  cluster_spans=[{}, {}, {}])
    rng = np.random.default_rng(7)
    chunk, cands = _synthetic(rng, panel=(1, 3), dec=(1, 2),
                              panel_sup=(2, 5), dec_sup=(50, 60))
    is_dec = cands.path >= N_PANEL
    cands.a_lo[is_dec] = 0
    cands.a_hi[is_dec] = chunk.lengths[cands.read[is_dec]]
    with native_installed(port_native, tnative):
        got, counts = check(chunk, cands, N_PANEL, index, decoy,
                            boundary=True)
    assert len(got) == 0
    assert counts["decoy_suppressed"] == int((~is_dec).sum())


@pytest.mark.parametrize("strand, kept", [(1, True), (0, False)])
def test_t_hi_comes_from_the_last_block(port_native, strand, kept):  # noqa: F811
    """One read, one panel chain of cluster 0 (span 2,000-4,000 on c0) and a
    decoy chain of two blocks on c0 over the whole read, with diagonals 0
    and 2,500. On the reverse strand the overlap's genomic interval is
    counted back from t_hi = 2,500 + 1,000, which lies at the locus: the
    panel chain stays, with the decoy as its at-locus margin. On the
    forward strand it runs from t_lo = 0, away from the locus, and the
    decoy wins."""
    index, decoy = _world()
    row = dict(read=[0, 0, 0], path=[0, N_PANEL, N_PANEL],
               strand=[0, strand, strand], d0=[2500, 0, 2500],
               n_anchors=[5, 20, 20], chain=[0, 1, 1], q_lo=[0, 0, 500],
               q_hi=[1000, 500, 1000], a_lo=[0, 0, 0],
               a_hi=[1000, 1000, 1000], head_diag=[2500, 0, 0])
    cands = Candidates(**{k: np.array(v, dtype={"strand": np.int8,
                                                "chain": np.int64}.get(
                                                    k, np.int32))
                          for k, v in row.items()})
    chunk = SimpleNamespace(lengths=np.array([1000], dtype=np.int64))
    with native_installed(port_native, tnative):
        got, counts = check(chunk, cands, N_PANEL, index, decoy,
                            boundary=True)
    assert counts["decoy_panel_chains"] == 1
    if kept:
        assert len(got) == 1 and got.dec_same[0] == 20
        assert got.dec_other[0] == 0
    else:
        assert len(got) == 0 and counts["decoy_suppressed"] == 1


def test_chain_ids_that_do_not_rise_take_the_split_sequence(port_native):  # noqa: F811
    """Ids falling within a read (still read-sorted, so the verbatim
    function accepts them) put np.unique's order apart from the rows'."""
    index, decoy = _world()
    chunk, cands = _synthetic(np.random.default_rng(11), panel=(1, 3),
                              dec=(1, 3))
    for r in np.unique(cands.read):
        rows = cands.read == r
        ids = cands.chain[rows]
        cands.chain[rows] = ids.max() + ids.min() - ids
    with native_installed(port_native, tnative):
        check(chunk, cands, N_PANEL, index, decoy, boundary=False)
