"""The port stands alone: it imports neither ``jax`` nor anything of ``repro``."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_no_jax_or_repro_import_lines():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if _IMPORT_RE.match(line):
                offenders.append(f"{path.relative_to(SRC)}:{i}: {line.strip()}")
    assert offenders == []


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = list(_modules())
    assert "repro_torch.core.adwise" in mods and "repro_torch.kernels.ops" in mods
    assert {"repro_torch.obs", "repro_torch.obs.tracer", "repro_torch.core.spotlight",
            "repro_torch.graph.stream", "repro_torch.core.oocore", "repro_torch.graph.io",
            "repro_torch.graph.io.format", "repro_torch.graph.io.ingest",
            "repro_torch.graph.io.shuffle", "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.compress", "repro_torch.checkpoint",
            "repro_torch.checkpoint.manager", "repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.runtime", "repro_torch.runtime.fault", "repro_torch.runtime.straggler",
            "repro_torch.runtime.elastic", "repro_torch.launch.train",
            "repro_torch.models.names", "repro_torch.models.ssm",
            "repro_torch.core.moe_balance", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding", "repro_torch.models.tp",
            "repro_torch.launch.serve", "repro_torch.launch.partition",
            "repro_torch.engine.gas", "repro_torch.engine.partitioned",
            "repro_torch.engine.algorithms", "repro_torch.core.driver",
            "repro_torch.dist"} <= set(mods)
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None  # any import of these now raises
        import importlib
        for mod in {mods!r}:
            importlib.import_module(mod)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro")
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("ok", len({mods!r}))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_models_import_nothing_of_the_launch_layer():
    """The model layer depends on no launcher: ``launch.sharding.shard_for``
    resolves a rank's layout and hands it to the models in the ``Shard``."""
    mods = [m for m in _modules() if m.startswith("repro_torch.models")]
    code = textwrap.dedent(
        f"""
        import importlib, sys
        for mod in {mods!r}:
            importlib.import_module(mod)
        print(sorted(m for m in sys.modules if m.startswith("repro_torch.launch")))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "repro_torch.models.tp" in mods and proc.stdout.strip() == "[]"



def test_core_and_engine_import_nothing_of_the_launch_layer():
    """The partitioner and the engine take their ranks from
    ``repro_torch.dist``; the launchers sit above them, and the LM side
    workload's modules are not theirs."""
    mods = [m for m in _modules()
            if m.startswith(("repro_torch.core", "repro_torch.engine"))]
    code = textwrap.dedent(
        f"""
        import importlib, sys
        for mod in {mods!r}:
            importlib.import_module(mod)
        print(sorted(m for m in sys.modules
                     if m.startswith(("repro_torch.launch", "repro_torch.models"))))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert {"repro_torch.core.driver", "repro_torch.engine.gas"} <= set(mods)
    assert proc.stdout.strip() == "[]"


ROOT = SRC.parent
CHIP_SCRIPTS = [
    "chip_smoke.py", "tools/time_flash_attention.py", "tools/time_segment_sum.py",
    "tools/time_partition.py", "tools/time_collectives.py", "tools/tp_readings.py",
    "tools/tp_family_readings.py", "tools/tp_train_readings.py", "tools/timed_smoke.py",
    "tools/time_profile_readers.py",
]


@pytest.mark.parametrize("script", CHIP_SCRIPTS)
def test_chip_scripts_import_no_jax_or_repro(script):
    """The scripts run on the card machine, which has no JAX: they import
    the port only."""
    lines = (ROOT / script).read_text().splitlines()
    assert [ln for ln in lines if _IMPORT_RE.match(ln)] == []
    assert any("repro_torch" in ln for ln in lines)


@pytest.mark.parametrize("helper", ["_tp_ranks", "_graph_ranks", "_train_ranks"])
def test_rank_helpers_import_with_jax_and_repro_blocked(helper):
    """The tests' rank functions run in spawned processes and on the card
    machine, which has no JAX: each helper imports, and runs its imports,
    with ``jax`` and ``repro`` blocked."""
    lines = (ROOT / "tests" / f"{helper}.py").read_text().splitlines()
    assert [ln for ln in lines if _IMPORT_RE.match(ln)] == []
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import importlib, re
        mod = importlib.import_module({helper!r})
        src = open(mod.__file__).read()
        for name in re.findall(r"^\\s+from (repro_torch[\\w.]*) import", src, re.M):
            importlib.import_module(name)
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT / "tests")])),
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
