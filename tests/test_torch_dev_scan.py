"""The port's device minimizer scan (plain version on the CPU) vs the JAX scan.

``dev_scan_ref`` must equal ``svjedi_tpu/align/dev_scan.py:_scan_kernel``
(XLA on the CPU) bit for bit; with the port's native library (built here
into a temporary directory), the bitmask must equal the native host
emission on reads with at least w k-mers, and ``seed_candidates`` from it
must equal the host scan's candidates. The CUDA kernel is held against the
plain version on the card (``chip_smoke.py`` phase 2d and the gpu-marked
test at the end).
"""

import contextlib
import ctypes
import os
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from svjedi_tpu.align import dev_scan as jscan
from svjedi_tpu.align import device as jdev
from svjedi_tpu_torch.align import dev_scan as tscan
from svjedi_tpu_torch.align import device as tdev
from svjedi_tpu_torch.kernels import dev_scan as kscan
from svjedi_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

CPU = torch.device("cpu")
KW = [(15, 10), (11, 5)]


def build_native_into(directory):
    """The port's native host library, built with its own flags into
    ``directory``; None where it cannot be built."""
    from svjedi_tpu_torch.kernels import build

    so = os.path.join(str(directory), "libsvtfastio.so")
    proc = subprocess.run(
        ["g++", *build.NATIVE_FLAGS, "-o", so, str(build.NATIVE_SRC), "-lz"],
        capture_output=True, text=True,
    )
    return so if proc.returncode == 0 else None


@contextlib.contextmanager
def native_installed(so, *modules):
    """Make each ``utils/native.py`` module's ``load_native`` return the
    library ``so`` (both packages' copies bind the same C interface), or
    None (the numpy host path) for ``so=None``."""
    saved = [(m, m._LIB, m._LIB_SEARCHED) for m in modules]
    try:
        for m in modules:
            m._LIB = None if so is None else m._NativeIO(ctypes.CDLL(so))
            m._LIB_SEARCHED = True
        yield
    finally:
        for m, lib, searched in saved:
            m._LIB, m._LIB_SEARCHED = lib, searched


@pytest.fixture(scope="module")
def port_native(tmp_path_factory):
    so = build_native_into(tmp_path_factory.mktemp("native"))
    if so is None:
        pytest.skip("the port's native library cannot be built here")
    return so


def _encode(seq: str) -> np.ndarray:
    lut = {b: i for i, b in enumerate("ACGT")}
    return np.array([lut.get(c, 4) for c in seq], dtype=np.int8)


class _FakePanel:
    paths = []


def _concat(reads):
    codes = np.concatenate(reads) if reads else np.zeros(0, np.int8)
    offsets = np.concatenate(
        [[0], np.cumsum([len(r) for r in reads])]
    ).astype(np.int64)
    return codes, offsets


def _read_set(k, w):
    """tests/test_dev_scan.py's reads (lengths 5 .. 7777, N runs, an
    all-N read, all-palindromic and periodic reads), with an empty read
    (a repeated offset) after the third."""
    rng = np.random.default_rng(11)
    reads = []
    for ln in [5, k - 1, k, k + 1, k + w - 2, k + w - 1, 200, 1999, 7777]:
        reads.append(rng.integers(0, 4, ln).astype(np.int8))
    nread = rng.integers(0, 4, 500).astype(np.int8)
    nread[:25] = 4
    nread[200:260] = 4
    nread[-3:] = 4
    reads.append(nread)
    reads.append(np.full(60, 4, dtype=np.int8))
    reads.append(_encode("AT" * 200))  # all-palindromic k-mers for odd k
    reads.append(_encode("ACGT" * 300))
    reads.insert(3, np.zeros(0, np.int8))
    return _concat(reads)


def _jax_bitmask(codes, offsets, k, w):
    dd = jdev.upload(codes, _FakePanel(), {}, offsets=offsets)
    return jscan.fetch_bitmask(jscan.dispatch_scan(dd, k, w))


def _port_bitmask(codes, offsets, k, w, device=CPU):
    dd = tdev.upload(codes, _FakePanel(), device, {}, offsets=offsets)
    return tscan.fetch_bitmask(tscan.dispatch_scan(dd, k, w))


@pytest.mark.parametrize("k,w", KW)
def test_ref_matches_jax_scan_kernel(k, w):
    codes, offsets = _read_set(k, w)
    launches = kscan.launches
    got = _port_bitmask(codes, offsets, k, w)
    assert kscan.launches == launches  # the plain version launches nothing
    ref = _jax_bitmask(codes, offsets, k, w)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    rid, _ = tscan.bitmask_positions(got, offsets)
    assert len(rid) > 100
    # Reads with fewer than w k-mers (and the empty read) keep every bit clear.
    n_kmers = np.diff(offsets) - k + 1
    assert not np.isin(rid, np.flatnonzero(n_kmers < w)).any()


def _tile_edge_set(seed):
    """Reads against the kernel's 1024-position tiles: the first ends on a
    tile edge, an empty read follows the second, the fifth straddles the
    edge at 2048, and the code count (3097) is not a multiple of 8, so the
    scan length (3584) is below the buffer's 4096."""
    rng = np.random.default_rng(seed)
    codes, offsets = _concat([rng.integers(0, 4, n).astype(np.int8)
                              for n in (1024, 1000, 0, 1, 1030, 37, 5)])
    assert offsets[1] == 1024 and offsets[4] < 2048 < offsets[5]
    assert len(codes) == 3097
    return codes, offsets


@pytest.mark.parametrize("k,w", KW)
def test_ref_matches_jax_at_tile_edges(k, w):
    codes, offsets = _tile_edge_set(k * 100 + w)
    np.testing.assert_array_equal(_port_bitmask(codes, offsets, k, w),
                                  _jax_bitmask(codes, offsets, k, w))


def test_scan_cap_and_bitmask_positions_match_jax():
    for n in [1, 7, 8, 9, 31, 32, 33, 100, 4095, 4096, 4097,
              1 << 20, (1 << 20) + 1, 5 << 18, 17_200_000]:
        n_cap = 1 << max(12, (max(n, 1) - 1).bit_length())
        assert tscan._scan_cap(n, n_cap) == jscan._scan_cap(n, n_cap)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 256, 512).astype(np.uint8)
    offsets = np.concatenate([[0], np.sort(rng.integers(0, 4096, 30)),
                              [4096]]).astype(np.int64)
    for a, b in zip(tscan.bitmask_positions(bits, offsets),
                    jscan.bitmask_positions(bits, offsets)):
        np.testing.assert_array_equal(a, b)
    assert int(tscan.INVALID) == int(jscan.INVALID) == kscan.INVALID


def test_upload_offsets_match_jax():
    codes, offsets = _read_set(15, 10)
    jd = jdev.upload(codes, _FakePanel(), {}, offsets=offsets)
    td = tdev.upload(codes, _FakePanel(), CPU, {}, offsets=offsets)
    assert td.offsets32.dtype == torch.int32
    np.testing.assert_array_equal(td.offsets32.numpy(), np.asarray(jd.offsets32))
    assert td.n_codes == jd.n_codes == len(codes)
    np.testing.assert_array_equal(td.reads2.numpy(), np.asarray(jd.reads2))
    plain = tdev.upload(codes, _FakePanel(), CPU, {})
    assert plain.offsets32 is None and plain.n_codes == len(codes)
    with pytest.raises(ValueError, match="offsets"):
        tscan.dispatch_scan(plain, 15, 10)


def test_wrapper_rejects_bad_inputs():
    reads2 = torch.zeros(64, dtype=torch.int8)
    off = torch.tensor([0, 10], dtype=torch.int32)
    with pytest.raises(ValueError):
        kscan.dev_scan(reads2, off, 15, 10, 60)  # n_cap % 8
    with pytest.raises(ValueError):
        kscan.dev_scan(reads2, off, 15, 10, 72)  # n_cap > len(reads2)
    with pytest.raises(TypeError):
        kscan.dev_scan(reads2.int(), off, 15, 10, 64)
    with pytest.raises(TypeError):
        kscan.dev_scan(reads2, off.long(), 15, 10, 64)
    assert kscan.dev_scan(reads2, off, 15, 10, 64).shape == (8,)


@pytest.mark.parametrize("k,w", KW)
def test_bitmask_matches_native_emission(port_native, k, w):
    """The set bits are the native scan's minimizers on every read with at
    least w k-mers, in read-major position order."""
    codes, offsets = _read_set(k, w)
    bits = _port_bitmask(codes, offsets, k, w)
    with native_installed(port_native, tnative):
        native = tnative.load_native()
        m_read, m_pos, _, _ = native.minimizers(codes, offsets, k, w,
                                                n_threads=2)
    n_kmers = np.diff(offsets) - k + 1
    keep = n_kmers[m_read] >= w
    got_read, got_pos = tscan.bitmask_positions(bits, offsets)
    np.testing.assert_array_equal(got_read, m_read[keep])
    np.testing.assert_array_equal(got_pos, m_pos[keep])


def test_seed_candidates_from_bitmask_match_host(port_native):
    """seed_candidates(bits=the port's bitmask) == the host scan + chain, on
    a merged panel + decoy index with the panel-path limit (the production
    device-seed configuration), short reads included."""
    from svjedi_tpu_torch.align.decoy import build_decoy
    from svjedi_tpu_torch.align.index import build_panel_index, merge_indexes
    from svjedi_tpu_torch.align.seed import ChainParams, seed_candidates
    from svjedi_tpu_torch.config import AlignConfig
    from svjedi_tpu_torch.graph.build import build_graph
    from svjedi_tpu_torch.graph.cluster import build_panel
    from svjedi_tpu_torch.graph.svparse import parse_vcf_svs
    from svjedi_tpu_torch.io import sim
    from svjedi_tpu_torch.io.fastq import ReadSet, encode_ascii

    cfg = AlignConfig()
    rng = np.random.default_rng(15)
    s = sim.simulate(seed=16, chrom_lengths={"c1": 120_000}, n_svs=6)
    names, seqs = sim.simulate_reads(
        rng, s.haplotypes, coverage=5.0, mean_len=3000, sd_len=800
    )
    seqs = list(seqs) + ["ACGTACGTACGTACGTACG", "A" * (cfg.kmer + 1)]
    names = list(names) + ["short1", "short2"]
    with tempfile.TemporaryDirectory() as tmp:
        vcf = os.path.join(tmp, "t.vcf")
        sim.write_truth_vcf(s, vcf)
        parsed = parse_vcf_svs(vcf, {c: len(x) for c, x in s.chroms.items()})
    panel = build_panel(build_graph(s.chroms, parsed), flank=cfg.flank,
                        cluster_gap=cfg.cluster_gap)
    index = build_panel_index(panel, k=cfg.kmer, w=cfg.window)
    decoy = build_decoy(panel, k=cfg.kmer, w=cfg.window)
    combo = merge_indexes(index, decoy.index)
    codes = np.concatenate([encode_ascii(x) for x in seqs])
    offsets = np.concatenate(
        [[0], np.cumsum([len(x) for x in seqs])]).astype(np.int64)
    reads = ReadSet(names=names, codes=codes, offsets=offsets)
    n_panel = len(index.path_len)
    bits = _port_bitmask(codes, offsets, cfg.kmer, cfg.window)
    cp = ChainParams()
    with native_installed(port_native, tnative):
        via_dev = seed_candidates(reads, combo, chain_params=cp,
                                  panel_path_limit=n_panel, bits=bits)
        via_host = seed_candidates(reads, combo, chain_params=cp,
                                   panel_path_limit=n_panel)
    assert len(via_host) > 0
    for f in ("read", "path", "strand", "d0", "n_anchors", "chain",
              "q_lo", "q_hi", "a_lo", "a_hi"):
        np.testing.assert_array_equal(getattr(via_dev, f),
                                      getattr(via_host, f), err_msg=f)


#: The CUDA kernel's tile: k-mer positions per block (csrc/dev_scan.cu).
KERNEL_TILE = 4096


def _funnel_l(lo, hi, sh):
    """CUDA __funnelshift_l: the top 32 bits of (hi:lo) << sh."""
    return (((hi << 32) | lo) << sh) >> 32 & 0xFFFFFFFF


def _funnel_r(lo, hi, sh):
    """CUDA __funnelshift_r: the low 32 bits of (hi:lo) >> sh."""
    return (((hi << 32) | lo) >> sh) & 0xFFFFFFFF


def _popc(x):
    return np.array([bin(int(v)).count("1") for v in x], dtype=np.int64)


def kernel_model(reads2, offsets, k, w, n_cap, tile=KERNEL_TILE):
    """The kernel's formulation in numpy, tile by tile: words of 16 bases
    (2-bit codes big-endian, complements little-endian, N and read-start
    bit masks), each k-mer from two funnel shifts, the N and boundary tests
    on the bit words, a segment tag from the start counts, van Herk/Gil-
    Werman prefix and suffix argmins in blocks of w, and every window whose
    two ends share a tag marking its argmin. Returns the bitmask."""
    codes = np.asarray(reads2[:n_cap]).astype(np.int64)
    offsets = np.asarray(offsets).astype(np.int64)
    n_reads = len(offsets) - 1
    nk = n_cap - k + 1
    halo = w - 1
    lo_base, hi_base = offsets[0], min(offsets[n_reads], n_cap)
    mask2k = (1 << (2 * k)) - 1
    bits = np.zeros(n_cap, dtype=bool)
    for tile0 in range(0, n_cap, tile):
        g0 = tile0 - halo
        n_hash = tile + 2 * halo
        g_end = g0 + n_hash + k - 1
        wb = g0 // 16
        n_words = (g_end - 1) // 16 - wb + 2
        pos = wb * 16 + np.arange(n_words * 16)
        inside = (pos >= 0) & (pos < n_cap)
        c16 = np.where(inside, codes[np.clip(pos, 0, n_cap - 1)], 4)
        c16 = c16.reshape(n_words, 16)
        j = np.arange(16)
        fw = ((c16 & 3) << (30 - 2 * j)).sum(1)
        cm = ((3 - (c16 & 3)) << (2 * j)).sum(1)
        nw = ((c16 >= 4).astype(np.int64) << j).sum(1)
        st = np.zeros(n_words, dtype=np.int64)
        for off in offsets[(offsets >= g0) & (offsets < g_end)] - wb * 16:
            st[off >> 4] |= 1 << (off & 15)
        cnt = np.concatenate([[0], np.cumsum(_popc(st))])[:n_words]

        p = g0 + np.arange(n_hash)
        pw = p - wb * 16
        i, o = pw >> 4, pw & 15
        fwd = _funnel_l(fw[i + 1], fw[i], 2 * o) >> (32 - 2 * k)
        rc = _funnel_r(cm[i], cm[i + 1], 2 * o) & mask2k
        n2 = nw[i] | (nw[i + 1] << 16)
        s2 = st[i] | (st[i + 1] << 16)
        in_read = ((p >= lo_base) & (p + k - 1 < hi_base)
                   & (((s2 >> (o + 1)) & ((1 << (k - 1)) - 1)) == 0))
        ok = in_read & (((n2 >> o) & ((1 << k) - 1)) == 0) & (fwd != rc)
        mixed = kscan._mix32(torch.from_numpy(np.minimum(fwd, rc))).numpy()
        h = np.where(ok, mixed, kscan.INVALID)
        seg = np.where(in_read, cnt[i] + _popc(st[i] & ((2 << o) - 1)), -1)

        pre = np.arange(n_hash)
        suf = np.arange(n_hash)
        for x0 in range(0, n_hash, w):
            x1 = min(x0 + w, n_hash)
            for x in range(x0 + 1, x1):
                pre[x] = x if h[x] < h[pre[x - 1]] else pre[x - 1]
            for x in range(x1 - 2, x0 - 1, -1):
                suf[x] = x if h[x] <= h[suf[x + 1]] else suf[x + 1]
        emit = np.zeros(n_hash, dtype=bool)
        s = np.arange(n_hash - w + 1)
        e = s + w - 1
        ms, me = suf[s], pre[e]
        m = np.where(h[ms] <= h[me], ms, me)
        good = (seg[s] >= 0) & (seg[s] == seg[e]) & (h[m] != kscan.INVALID)
        emit[m[good]] = True
        t = np.arange(min(tile, n_cap - tile0))
        bits[tile0 + t] = emit[t + halo] & (tile0 + t < nk)
    return np.packbits(bits, bitorder="little")


@pytest.mark.parametrize("k,w", KW)
@pytest.mark.parametrize("which", ["edge reads", "tile edges"])
def test_kernel_formulation_matches_plain_version_and_jax(k, w, which):
    """The kernel's formulation (funnel-shifted k-mers, bit-mask validity,
    sliding-window leftmost argmin) equals dev_scan_ref and JAX's
    _scan_kernel bit for bit: N runs, palindromes, empty and short reads,
    reads against the tiles' edges, a code count not a multiple of 8."""
    codes, offsets = (_read_set(k, w) if which == "edge reads"
                      else _tile_edge_set(k * 100 + w))
    dd = tdev.upload(codes, _FakePanel(), CPU, {}, offsets=offsets)
    n_cap = tscan._scan_cap(dd.n_codes, dd.n_bases)
    ref = kscan.dev_scan_ref(dd.reads2, dd.offsets32, k, w, n_cap).numpy()
    got = kernel_model(dd.reads2.numpy(), offsets, k, w, n_cap)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _jax_bitmask(codes, offsets, k, w))
    # Smaller tiles put more reads across tile edges.
    np.testing.assert_array_equal(
        kernel_model(dd.reads2.numpy(), offsets, k, w, n_cap, tile=64), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("k,w", KW)
def test_cuda_kernel_matches_plain_version(k, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    dev = torch.device("cuda:0")
    for codes, offsets in (_read_set(k, w), _tile_edge_set(w)):
        dd = tdev.upload(codes, _FakePanel(), dev, {}, offsets=offsets)
        n_cap = tscan._scan_cap(dd.n_codes, dd.n_bases)
        launches = kscan.launches
        got = kscan.dev_scan(dd.reads2, dd.offsets32, k, w, n_cap)
        ref = kscan.dev_scan_ref(dd.reads2, dd.offsets32, k, w, n_cap)
        torch.cuda.synchronize()
        assert kscan.launches == launches + 1
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
        np.testing.assert_array_equal(_port_bitmask(codes, offsets, k, w, dev),
                                      got.cpu().numpy())
