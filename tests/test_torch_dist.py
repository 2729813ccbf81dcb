"""The port's distribution layer (``svjedi_tpu_torch/dist``, ``entry.py``) vs the JAX package's.

On the CPU, with the plain versions of the kernels: the mesh, the owned
table, the production problem, the count step on each engine, the sharded
count step on a 2 x 2 list of CPU devices, the mesh count merge on lists
of up to 8 CPU devices, and the entry points of `entry.py`. JAX runs on the
conftest's 8 virtual CPU devices, its Pallas kernels in interpret mode
(``v3i``). Every integer output is exact.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from svjedi_tpu.align.extend import DPParams as JaxDPParams
from svjedi_tpu.dist import count_merge as jcm
from svjedi_tpu.dist import engine as jeng
from svjedi_tpu.dist import mesh as jmesh
from svjedi_tpu.dist.count_step import build_owned_table as jax_owned_table
from svjedi_tpu.io import sim
from svjedi_tpu_torch import entry
from svjedi_tpu_torch.dist import count_merge as tcm
from svjedi_tpu_torch.dist import engine as teng
from svjedi_tpu_torch.dist import mesh as tmesh
from svjedi_tpu_torch.dist.count_step import build_owned_table

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
OWNED = ("junction", "tag", "allele", "valid", "link")
OUTPUTS = ("counts", "score", "qs", "ts", "qe", "te", "is_winner")


@pytest.fixture(scope="module")
def problems():
    """Both packages' production problem, laid out for 1 and 2 data shards."""
    return {
        shards: (graft._production_problem(data_shards=shards),
                 entry.production_problem(data_shards=shards, device=CPU))
        for shards in (1, 2)
    }


def _step_args(p):
    """The count step's arguments from either package's problem."""
    return (*p["data"].packed_words(), p["meta"], p["path_start"],
            p["group"], p["cand_path"], p["owned"])


@pytest.mark.parametrize("d,g", [(None, 1), (None, 2), (2, 2), (4, 1),
                                 (1, 4), (3, 2)])
def test_make_mesh_shapes_and_errors(d, g):
    import jax

    devices = [CPU] * 4
    try:
        ours = tmesh.make_mesh(data_shards=d, graph_shards=g, devices=devices)
    except ValueError as exc:
        with pytest.raises(ValueError) as theirs:
            jmesh.make_mesh(data_shards=d, graph_shards=g,
                            devices=jax.devices()[:4])
        assert str(exc) == str(theirs.value)
        return
    theirs = jmesh.make_mesh(data_shards=d, graph_shards=g,
                             devices=jax.devices()[:4])
    assert ours.shape == dict(theirs.shape)
    assert ours.devices.shape == theirs.devices.shape
    assert all(dv == CPU for dv in ours.devices.ravel())


def test_local_devices():
    assert tmesh.local_devices(CPU) == [CPU]


def test_build_owned_table_matches_jax(problems):
    jp, tp = problems[1]
    tag_to_id = {t: i for i, t in enumerate(tp["tags"])}
    for k_max in (0, 7):
        ours = build_owned_table(tp["panel"], tag_to_id, k_max=k_max,
                                 device=CPU)
        theirs = jax_owned_table(jp["panel"], tag_to_id, k_max=k_max)
        for f in OWNED:
            np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                          np.asarray(getattr(theirs, f)), f)
        assert ours.valid.dtype == torch.bool
        assert ours.tag.dtype == torch.int32


@pytest.mark.parametrize("shards", [1, 2])
def test_production_problem_matches_jax(problems, shards):
    jp, tp = problems[shards]
    for k in ("meta", "group", "cand_path", "path_start"):
        np.testing.assert_array_equal(tp[k], jp[k], k)
    for f in OWNED:
        np.testing.assert_array_equal(getattr(tp["owned"], f).numpy(),
                                      np.asarray(getattr(jp["owned"], f)), f)
    for k in ("n_groups", "n_tags", "tags", "bucket", "band", "n_real",
              "real_per_shard"):
        assert tp[k] == jp[k], k
    assert tp["meta"].shape[1] % (128 * shards) == 0


@pytest.mark.parametrize("engine", ["xla", "v3i", "v3"])
@pytest.mark.parametrize("extra_groups", [0, 5])
def test_dp_filter_count_v3_matches_jax(problems, engine, extra_groups):
    """Every output, on the 2-shard layout (padding rows inside the batch)
    and with ``extra_groups`` empty segments. The port's ``v3`` runs the
    plain versions on CPU tensors, so it equals JAX's ``v3i`` too."""
    jp, tp = problems[2]
    kw = dict(bucket=tp["bucket"], band=tp["band"],
              n_groups=tp["n_groups"] + extra_groups, n_tags=tp["n_tags"])
    ours = teng.dp_filter_count_v3(*_step_args(tp), params=tp["params"],
                                   engine=engine, **kw)
    theirs = jeng.dp_filter_count_v3(
        *_step_args(jp), params=JaxDPParams(),
        engine="v3i" if engine == "v3" else engine, **kw)
    for k in OUTPUTS:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]),
                                      k)
    assert int(ours["counts"].sum()) > 0
    assert (tp["meta"][1] == 0).any()  # padding rows were scored too


def test_dp_filter_count_v3_tag_range(problems):
    jp, tp = problems[1]
    kw = dict(bucket=tp["bucket"], band=tp["band"], n_groups=tp["n_groups"],
              n_tags=tp["n_tags"], tag_lo=1, tag_hi=3)
    ours = teng.dp_filter_count_v3(*_step_args(tp), params=tp["params"],
                                   engine="xla", **kw)["counts"]
    theirs = jeng.dp_filter_count_v3(*_step_args(jp),
                                     params=JaxDPParams(), engine="xla",
                                     **kw)["counts"]
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert not ours[[0, 3]].any()


def test_segment_reduce_empty_segments_hold_the_identity():
    vals = torch.tensor([3, -2, 7], dtype=torch.int32)
    seg = torch.tensor([0, 0, 2])
    info = torch.iinfo(torch.int32)
    assert teng.segment_reduce("amax", vals, seg, 4).tolist() == \
        [3, info.min, 7, info.min]
    assert teng.segment_reduce("amin", vals, seg, 4).tolist() == \
        [-2, info.max, 7, info.max]
    assert teng.segment_reduce("sum", vals, seg, 4).tolist() == [1, 0, 7, 0]


def test_sharded_count_step_matches_single_and_jax(problems):
    """A 2 x 2 mesh of the CPU against the one-device step and against
    JAX's step on 4 virtual devices."""
    import jax

    jp, tp = problems[2]
    mesh = tmesh.make_mesh(data_shards=2, graph_shards=2, devices=[CPU] * 4)
    kw = dict(bucket=tp["bucket"], band=tp["band"], n_tags=tp["n_tags"])
    teng.assert_no_group_straddle(tp["group"], tp["meta"], 2)
    ours = teng.make_sharded_count_step_v3(
        mesh, params=tp["params"], n_groups_per_shard=tp["n_groups"],
        engine="v3i", **kw)(*_step_args(tp))
    single = teng.dp_filter_count_v3(
        *_step_args(tp), params=tp["params"], n_groups=tp["n_groups"],
        engine="v3i", **kw)["counts"]
    jmesh4 = jmesh.make_mesh(data_shards=2, graph_shards=2,
                             devices=jax.devices()[:4])
    theirs = jeng.make_sharded_count_step_v3(
        jmesh4, params=JaxDPParams(), n_groups_per_shard=jp["n_groups"],
        engine="v3i", **kw)(*_step_args(jp))
    assert ours.dtype == torch.int32 and ours.shape == (tp["n_tags"], 2)
    np.testing.assert_array_equal(ours.numpy(), single.numpy())
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert int(ours.sum()) > 0


def test_assert_no_group_straddle_raises_on_a_straddle(problems):
    _, tp = problems[2]
    teng.assert_no_group_straddle(tp["group"], tp["meta"], 2)
    half = tp["meta"].shape[1] // 2
    group = tp["group"].copy()
    group[half] = group[0]  # a real row of shard 1 joins a group of shard 0
    assert tp["meta"][1, half] > 0 and tp["meta"][1, 0] > 0
    with pytest.raises(AssertionError, match="straddle"):
        teng.assert_no_group_straddle(group, tp["meta"], 2)
    meta = tp["meta"].copy()
    meta[1, half] = 0  # the same row as padding: padding never wins
    teng.assert_no_group_straddle(group, meta, 2)


@pytest.fixture(scope="module")
def winner_setup(tmp_path_factory):
    """Winners of the port's align stage on a simulated bundle (several
    chunks), with the host counts."""
    from svjedi_tpu_torch.align.index import build_panel_index
    from svjedi_tpu_torch.align.pipeline import align_and_count
    from svjedi_tpu_torch.config import AlignConfig, GenotypeConfig
    from svjedi_tpu_torch.graph.build import build_graph
    from svjedi_tpu_torch.graph.cluster import build_panel
    from svjedi_tpu_torch.graph.svparse import parse_vcf_svs
    from svjedi_tpu_torch.io.fastq import read_reads

    tmp = tmp_path_factory.mktemp("torch_dist")
    s = sim.simulate(seed=8, chrom_lengths={"c1": 50_000}, n_svs=6)
    names, seqs = sim.simulate_reads(
        np.random.default_rng(2), s.haplotypes, coverage=6.0, mean_len=2500,
        sd_len=400)
    sim.write_truth_vcf(s, tmp / "t.vcf")
    sim.write_fastq(tmp / "reads.fq", names, seqs)
    cfg, gcfg = AlignConfig(), GenotypeConfig()
    parsed = parse_vcf_svs(tmp / "t.vcf",
                           {c: len(x) for c, x in s.chroms.items()})
    panel = build_panel(build_graph(s.chroms, parsed), flank=cfg.flank,
                        cluster_gap=cfg.cluster_gap,
                        max_paths_per_cluster=cfg.max_paths_per_cluster)
    index = build_panel_index(panel, k=cfg.kmer, w=cfg.window,
                              max_hits_per_minimizer=cfg.max_hits_per_minimizer)
    reads = read_reads(str(tmp / "reads.fq"))
    counts, _, winners = align_and_count(
        reads, panel, index, cfg, gcfg, device=CPU, collect_audit=False,
        chunk_reads=32)
    assert counts and len(winners.read) > 0
    return panel, winners, counts, gcfg


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_entry_table_counts_match_count_support(winner_setup, n_shards):
    panel, winners, counts, gcfg = winner_setup
    tags = sorted({t for p in panel.paths for t, *_ in p.owned})
    tag_to_id = {t: i for i, t in enumerate(tags)}
    et = tcm.build_entry_table(panel, winners, tag_to_id, n_shards=n_shards,
                               min_density=gcfg.min_count_density)
    mat = tcm.count_entries_np(et, len(tags), gcfg.d_over)
    got = {t: [int(mat[i, 0]), int(mat[i, 1])]
           for i, t in enumerate(tags) if mat[i].any()}
    assert got == counts


@pytest.mark.parametrize("d,g", [(1, 2), (3, 1), (4, 2), (8, 1)])
def test_mesh_count_support_matches_host_and_jax(winner_setup, d, g):
    """The port's mesh count on a d x g list of the CPU equals the host
    counts and JAX's on d x g virtual devices."""
    import jax

    panel, winners, counts, gcfg = winner_setup
    ours = tcm.mesh_count_support(
        panel, winners, tmesh.make_mesh(d, g, devices=[CPU] * (d * g)),
        d_over=gcfg.d_over, min_density=gcfg.min_count_density)
    theirs = jcm.mesh_count_support(
        panel, winners, jmesh.make_mesh(d, g, devices=jax.devices()[: d * g]),
        d_over=gcfg.d_over, min_density=gcfg.min_count_density)
    assert ours == counts
    assert ours == theirs


def test_mesh_count_step_matches_numpy_reference(winner_setup):
    panel, winners, _, gcfg = winner_setup
    tags = sorted({t for p in panel.paths for t, *_ in p.owned})
    et = tcm.build_entry_table(panel, winners,
                               {t: i for i, t in enumerate(tags)}, n_shards=4)
    step = tcm.make_mesh_count_step(
        tmesh.make_mesh(4, 2, devices=[CPU] * 8), n_rt=et.n_rt, n_dd=et.n_dd,
        n_tags=len(tags), d_over=gcfg.d_over)
    mat = step(*(getattr(et, f) for f in tcm.ENTRY_FIELDS))
    np.testing.assert_array_equal(
        mat.numpy(), tcm.count_entries_np(et, len(tags), gcfg.d_over))


def test_entry_runs_and_matches_jax():
    import jax

    fn, args = entry.entry(CPU)
    counts = fn(*args)
    jfn, jargs = graft.entry()
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jax.jit(jfn)(*jargs)))
    assert counts.shape[1] == 2 and (counts >= 0).all()


@pytest.mark.parametrize("n", [8, 1])
def test_dryrun_multichip(n):
    entry.dryrun_multichip(n, [CPU] * n)


def test_dryrun_multichip_needs_n_devices():
    with pytest.raises(ValueError, match="8 devices asked for, 2 given"):
        entry.dryrun_multichip(8, [CPU] * 2)


@pytest.mark.gpu
def test_sharded_step_on_the_card_launches_the_kernels(problems):
    """On the card, ``v3`` launches K1 and K1′ and equals ``v3i``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    from svjedi_tpu_torch.kernels import band_dp_v3

    dev = torch.device("cuda:0")
    p = entry.production_problem(data_shards=2, device=dev)
    mesh = tmesh.make_mesh(2, 2, devices=[dev] * 4)
    kw = dict(bucket=p["bucket"], band=p["band"], params=p["params"],
              n_tags=p["n_tags"])
    band_dp_v3.launches = band_dp_v3.rev_launches = 0
    got = teng.make_sharded_count_step_v3(
        mesh, n_groups_per_shard=p["n_groups"], engine="v3", **kw)(
        *_step_args(p))
    assert band_dp_v3.rev_launches > 0
    assert band_dp_v3.launches > band_dp_v3.rev_launches
    ref = teng.dp_filter_count_v3(*_step_args(p), n_groups=p["n_groups"],
                                  engine="v3i", **kw)["counts"]
    assert torch.equal(got, ref)
