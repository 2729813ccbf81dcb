"""No JAX and no JAX package: the check by whole top-level names, and the
imports of the harness and of every generator and reference that a
configuration names."""

import ast
import subprocess
import sys

from conftest import ROOT

from benchmark import run


def test_forbidden_by_whole_top_level_name():
    mods = {"svjedi_tpu_torch": 1, "svjedi_tpu_torch.align.pipeline": 1,
            "jaxtyping": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == []
    mods.update({"svjedi_tpu": 1, "svjedi_tpu.io.sim": 1, "jax.numpy": 1,
                 "jaxlib": 1, "flax.linen": 1})
    assert run.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "svjedi_tpu", "svjedi_tpu.io.sim"]


def imported_names(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def configuration_modules():
    """The module files that the configurations name as generator or
    reference, given or defaulted."""
    import json

    from benchmark import cells

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    stems = set()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        stems |= {cfg.get(k, d) for k, d in cells.DEFAULT_MODULES.items()}
    return sorted(f"{stem}.py" for stem in stems)


def test_reference_imports_neither_jax_nor_either_package():
    files = configuration_modules()
    assert {"reference.py", "gen.py"} <= set(files)
    for name in files:
        names = imported_names(ROOT / "benchmark" / name)
        assert not names & {"jax", "jaxlib", "flax", "svjedi_tpu",
                            "svjedi_tpu_torch"}, name


def test_harness_never_loads_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not imported_names(path) & {"jax", "jaxlib", "flax",
                                           "svjedi_tpu"}, path
    modules = ", ".join(f[:-3] for f in configuration_modules())
    code = (f"from benchmark import run, calibrate, {modules}; "
            "import svjedi_tpu_torch.align.pipeline, "
            "svjedi_tpu_torch.genotype.vcf_writer; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
