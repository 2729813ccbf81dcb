"""The port's copies of the JAX package's host code equal their originals.

``svjedi_tpu_torch`` imports nothing of ``svjedi_tpu``, so it holds verbatim
copies of the JAX-free host modules it runs (and of the native host
library's source), each at the same relative path and headed by a comment
naming its source. Each copy must equal its original by source text; the
only allowed differences are the package name and, in ``utils/native.py``,
where ``load_native`` looks for the library.
"""

import inspect
import re

import pytest

from svjedi_tpu import cli as jcli
from svjedi_tpu_torch import cli as tcli

from tests.conftest import REPO_ROOT

MODULES = (
    "utils/stats.py", "utils/native.py",
    "io/fasta.py", "io/fastq.py", "io/gaf.py", "io/gfa.py", "io/sim.py",
    "graph/svparse.py", "graph/build.py", "graph/cluster.py",
    "align/minimizer.py", "align/index.py", "align/seed.py", "align/decoy.py",
    "align/gaf_out.py",
    "dist/decoy_shard.py",
    "genotype/likelihood.py", "genotype/vcf_writer.py",
    "genotype/filter_gaf.py",
    "evals/contingency.py",
    "config.py",
)
#: The one allowed difference: the JAX package finds its library under
#: native/, the port under its kernel build directory.
NATIVE_PATH = (
    '    root = Path(__file__).resolve().parent.parent.parent\n'
    '    for candidate in [root / "native" / "libsvtfastio.so"]:\n',
    '    root = Path(__file__).resolve().parent.parent\n'
    '    for candidate in [root / "kernels" / "_build" / "libsvtfastio.so"]:\n',
)


def _header(ours: str, theirs: str, comment: str) -> str:
    """The comment lines a copy puts before its original's text."""
    assert ours.endswith(theirs)
    header = ours[: len(ours) - len(theirs)]
    assert header and all(ln.startswith(comment)
                          for ln in header.splitlines()), header
    return header


@pytest.mark.parametrize("rel", MODULES)
def test_host_module_copy_is_verbatim(rel):
    ours = (REPO_ROOT / "svjedi_tpu_torch" / rel).read_text()
    theirs = (REPO_ROOT / "svjedi_tpu" / rel).read_text()
    if rel == "utils/native.py":
        assert ours.count(NATIVE_PATH[1]) == 1
        ours = ours.replace(*NATIVE_PATH[::-1])
    header = _header(ours.replace("svjedi_tpu_torch", "svjedi_tpu"), theirs, "#")
    assert re.match(rf"# Copied (verbatim )?from svjedi_tpu/{re.escape(rel)}[.;]",
                    header), header


#: Functions copied verbatim into a module of the port, by module.
FUNCTIONS = {
    "dist/engine.py": ("packed_buffers", "assert_no_group_straddle"),
    "align/extend.py": ("smith_waterman_full",),
}
#: Regions copied verbatim: (module, first line, last function).
REGIONS = (("dist/count_merge.py", "_BIG = ", "_segment_np"),)


@pytest.mark.parametrize(
    "rel, name", [(rel, n) for rel, names in FUNCTIONS.items() for n in names])
def test_function_copy_is_verbatim(rel, name):
    import importlib

    mod = rel[:-3].replace("/", ".")
    ours = importlib.import_module(f"svjedi_tpu_torch.{mod}")
    theirs = importlib.import_module(f"svjedi_tpu.{mod}")
    assert inspect.getsource(getattr(ours, name)) == \
        inspect.getsource(getattr(theirs, name))
    assert f"# Copied verbatim from svjedi_tpu/{rel}:{name}.\n" in \
        inspect.getsource(ours)


@pytest.mark.parametrize("rel, first, last", REGIONS)
def test_region_copy_is_verbatim(rel, first, last):
    """The JAX module's text from the line starting ``first`` to the end of
    function ``last`` stands in the port's module, after its header."""
    theirs = (REPO_ROOT / "svjedi_tpu" / rel).read_text()
    start = theirs.index(f"\n{first}") + 1
    end = theirs.index(f"\ndef {last}(")
    end = theirs.index("\n\n", end + 1)
    region = theirs[start:end + 1]
    assert region.count("\ndef ") >= 4  # the whole numpy half
    ours = (REPO_ROOT / "svjedi_tpu_torch" / rel).read_text()
    assert (f"# Copied verbatim from svjedi_tpu/{rel}: {first.split()[0]} "
            f"through {last}.\n" + region) in ours


def test_native_source_copy_is_verbatim():
    ours = (REPO_ROOT / "svjedi_tpu_torch" / "native" / "fastio.cpp").read_text()
    theirs = (REPO_ROOT / "native" / "fastio.cpp").read_text()
    assert _header(ours, theirs, "//") == \
        "// Copied verbatim from native/fastio.cpp.\n"


@pytest.mark.parametrize("name", ["_add_run", "_add_stage_parsers", "build_parser"])
def test_cli_parser_copy_is_verbatim(name):
    assert inspect.getsource(getattr(tcli, name)) == \
        inspect.getsource(getattr(jcli, name))
    assert f"# Copied verbatim from svjedi_tpu/cli.py:{name}.\n" in \
        inspect.getsource(tcli)


def test_port_parser_adds_only_device():
    """Every flag of the JAX CLI, plus ``run --device {cuda,cpu}``."""
    def flags(parser):
        sub = parser._subparsers._group_actions[0].choices
        return {cmd: {a.dest: (a.option_strings, a.default) for a in p._actions}
                for cmd, p in sub.items()}

    ours, theirs = flags(tcli.port_parser()), flags(jcli.build_parser())
    assert ours["run"].pop("device") == (["--device"], "cuda")
    assert ours == theirs
    args = tcli.port_parser().parse_args(
        ["run", "-v", "a", "-r", "b", "-q", "c", "-p", "d", "--device", "cpu"])
    assert args.device == "cpu"
