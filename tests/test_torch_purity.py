"""The port stands alone: no module of cimba_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package cimba_tpu, and no sampler
calls torch.erfinv (its values are not XLA's erf_inv; the port evaluates
XLA's polynomial itself)."""

import ast
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "cimba_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cimba_tpu")


def test_importing_every_module_loads_no_jax():
    """Every module of the port, imported in a fresh interpreter."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import cimba_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    cimba_tpu_torch.__path__, 'cimba_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps({'mods': mods, 'bad': bad}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "cimba_tpu_torch.random.block_kernels" in res["mods"]
    assert "cimba_tpu_torch.random.sampler_bench" in res["mods"]
    assert "cimba_tpu_torch.models.awacs" in res["mods"]
    for mod in ("models.mmc", "models.mg1", "models.tandem", "sweep.grid",
                "stats.timeseries", "tools.bisect_kernels",
                "tools.cuda_bisect", "tools.cuda_event_bisect",
                "examples.tut_2_park", "examples.tut_0_hello",
                "examples.spawn_shop", "tools.usergen", "runner.checkpoint",
                "examples.checkpointed_run", "examples.large_r_stream",
                "examples.mm1_experiment", "examples.tut_5_awacs",
                "utils.seed", "utils.dbc", "utils.logger", "utils.debug",
                "stats.dataset", "obs.trace", "obs.metrics", "obs.export",
                "obs.prof", "obs.audit", "tools.audit_diff",
                "examples.tut_1_mm1", "sweep.engine", "sweep.adaptive",
                "runner.dryrun", "examples.mg1_sweep", "serve",
                "serve.sched", "serve.cache", "serve.service",
                "serve.client", "core.fuse", "examples.serve_mm1"):
        assert f"cimba_tpu_torch.{mod}" in res["mods"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_import_statement_names_jax():
    """Also the imports inside functions, which importing never runs."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_no_sampler_uses_torch_erfinv():
    """No use of torch.erfinv, Tensor.erfinv or torch.special.erfinv."""
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            name = getattr(node, "attr", getattr(node, "id", ""))
            assert not str(name).startswith("erfinv"), path
