"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the repository's packages.  Names are
compared by their top-level part, whole: the port's name begins with the
JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, workload  # noqa: E402

JAX_PACKAGE = workload.PORT[: -len("_torch")]
FORBIDDEN = {"jax", "jaxlib", "flax", JAX_PACKAGE}
REPO_PACKAGES = {JAX_PACKAGE, workload.PORT, "conformance", "bench", "cli",
                 "chip_smoke", "kernel_ab"}
MODULES = sorted((ROOT / "portbench").rglob("*.py"))


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports, by its syntax,
    and of every literal module name it hands to ``import_module`` or
    ``__import__``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_top_level_names_compare_whole():
    assert JAX_PACKAGE != workload.PORT and workload.PORT.startswith(JAX_PACKAGE)
    assert workload.PORT.split(".")[0] not in FORBIDDEN
    assert set(harness.JAX_NAMES) == FORBIDDEN


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax(path):
    assert not imported(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_repository():
    ref = ROOT / "portbench" / "reference.py"
    assert imported(ref) <= {"__future__", "numpy", "torch"}
    assert not imported(ref) & REPO_PACKAGES
    assert workload.PORT not in ref.read_text()


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_loads_no_jax(trace):
    """A whole run on the CPU, in a fresh process, traced or not: after it,
    the per-layer readers loaded and the check made, no module of JAX or
    of the JAX package is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, manifest\n"
        "import dataclasses, json\n"
        "cell = manifest.cell('rk8-en1g.resident')\n"
        "conf = json.loads(json.dumps(cell.config)); conf['patterns']['pool'] = 2\n"
        "cell = dataclasses.replace(cell, config=conf)\n"
        "line = harness.run(cell, 3, 0.2, %d, device='cpu', n=600000)\n"
        "assert line['correct'], line\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % (str(ROOT), trace))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert workload.PORT in loaded
    assert not loaded & FORBIDDEN


def test_a_reader_that_loads_jax_stops_the_run(tmp_path, monkeypatch):
    """The look at the loaded modules comes last: a per-layer reader that
    imports a JAX module makes the run exit, naming it, with no line."""
    import dataclasses
    import shutil

    from portbench import manifest

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench/metrics/idle_share.resident.py").write_text(
        "import sys, types\n"
        "sys.modules['jax'] = types.ModuleType('jax')\n"
        "def read(view):\n    return None\n")
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    cell = manifest.cell("bm-dna100m.resident")
    conf = dict(cell.config, patterns=dict(cell.config["patterns"], pool=2))
    cell = dataclasses.replace(cell, config=conf, root=tmp_path)
    with pytest.raises(SystemExit, match="jax"):
        harness.run(cell, 3, 0.2, True, device="cpu", n=300_000)
    sys.modules.pop("jax", None)
