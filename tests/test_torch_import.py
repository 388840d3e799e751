"""The port stands alone: it imports neither ``jax`` nor anything of ``repro``."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

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
