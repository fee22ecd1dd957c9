"""No run loads JAX or the JAX package, and the references load nothing of
the program. Module names are compared by their whole top-level name: the
port (``repro_torch``) begins with the JAX package's name (``repro``)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import run

HERE = Path(run.__file__).resolve().parent


def _python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=str(run.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_is_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_probe", object())
    assert "repro" not in run.forbidden_modules() or "repro" in {
        m.partition(".")[0] for m in sys.modules}


def test_a_run_loads_no_jax_nor_the_jax_package():
    got = _python(
        "import sys, json, pkgutil, importlib\n"
        f"sys.path[:0] = [{str(run.ROOT)!r}, {str(run.ROOT / 'src')!r}]\n"
        "import portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    importlib.import_module(m.name)\n"
        "from portbench import run\n"
        "for p in sorted((run.HERE / 'layer_metrics').glob('*.py')):\n"
        "    run.reader(p.stem)\n"
        "from portbench.tests import smoke\n"
        "for cell in ('ivim-slab-stream', 'lm-chat-open'):\n"
        "    smoke.run_small(cell, seconds=2.5)\n"
        "print(json.dumps({'forbidden': run.forbidden_modules(),\n"
        "    'port': 'repro_torch' in sys.modules}))\n")
    assert got == {"forbidden": [], "port": True}


def test_references_load_nothing_of_the_program():
    got = _python(
        "import sys, json\n"
        f"sys.path[:0] = [{str(run.ROOT)!r}]\n"
        "from portbench.reference import ivim, masks, qwen2\n"
        "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules}\n"
        "    & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'})))\n")
    assert got == []
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.partition(".")[0]
                assert top not in ("repro_torch", "repro", "jax", "flax"), \
                    f"{path.name} imports {name}"
                assert not name.startswith("portbench") or \
                    name.startswith("portbench.reference"), \
                    f"{path.name} imports {name}"
