"""The port's static checker (``repro_torch.analysis``): for each rule a
source that breaks it and one that keeps it, written to ``tmp_path`` as a
small ``repro_torch`` tree, and the gate over the port itself."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import checker, cli, rules

SRC = Path(__file__).resolve().parents[1] / "src"


def _tree(root: Path, files: dict[str, str]) -> Path:
    pkg = root / "repro_torch"
    for rel, text in {"__init__.py": "", **files}.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if rel.endswith(".py") and path.parent != pkg and \
                not (path.parent / "__init__.py").exists():
            (path.parent / "__init__.py").write_text("")
        path.write_text(text)
    return pkg


def _active(root: Path) -> list[rules.Finding]:
    return [f for f in checker.analyze(root) if not f.suppressed]


#: (rule, {path: source that breaks it}, {path: source that keeps it}).
CASES = [
    ("no-jax", {"core/a.py": "import jax\n"}, {"core/a.py": "import torch\n"}),
    ("no-jax", {"core/a.py": "import jax.numpy as jnp\n"},
     {"core/a.py": "import numpy as jnp\n"}),
    ("no-jax", {"core/a.py": "from jaxlib import xla_client\n"},
     {"core/a.py": "from repro_torch.core import tree\n"}),
    ("no-jax", {"core/a.py": "from repro.core import plan as p\n"},
     {"core/a.py": "from . import tree\n"}),
    ("no-jax", {"core/a.py": "import importlib\n"
                             "m = importlib.import_module('repro.obs')\n"},
     {"core/a.py": "import importlib\n"
                   "m = importlib.import_module('repro_torch.obs')\n"}),
    ("import-time-build",
     {"kernels/a.py": "from repro_torch.kernels import _build\n"
                      "LIB = _build.load('moments')\n"},
     {"kernels/a.py": "from repro_torch.kernels import _build\n"
                      "def lib():\n    return _build.load('moments')\n"}),
    ("import-time-build",
     {"kernels/a.py": "from .. import kernels as k\n"
                      "FN = k._build.bind('m', 'f', ())\n"},
     {"kernels/a.py": "from .. import kernels as k\n"
                      "@k.cached\ndef fn():\n"
                      "    return k._build.bind('m', 'f', ())\n"}),
    ("import-time-build",
     {"core/a.py": "import torch\nN = torch.cuda.device_count()\n"},
     {"core/a.py": "import torch\n"
                   "def n():\n    return torch.cuda.device_count()\n"}),
    ("import-time-build",
     {"core/a.py": "import torch\nZ = torch.zeros(4, device='cuda')\n"},
     {"core/a.py": "import torch\nZ = torch.zeros(4, device='cpu')\n"}),
    ("import-time-build",
     {"core/a.py": "import torch as t\nt.cuda.init()\n"},
     {"core/a.py": "import torch as t\nDEV = t.device('cuda')\n"}),
    ("import-time-build", {"kernels/a.py": "import triton.language as tl\n"},
     {"kernels/a.py": "def launch():\n    import triton.language as tl\n"
                      "    return tl\n"}),
    ("serving-clock", {"serving/a.py": "from time import perf_counter\n"},
     {"serving/a.py": "from repro_torch.obs.trace import default_clock\n"}),
    ("serving-clock",
     {"serving/a.py": "import time as t\n"
                      "def now():\n    return t.monotonic()\n"},
     {"core/a.py": "import time as t\n"
                   "def now():\n    return t.monotonic()\n"}),
    ("bare-assert", {"core/a.py": "def f(x):\n    assert x > 0\n"},
     {"core/a.py": "def f(x):\n    if not x > 0:\n"
                   "        raise ValueError(x)\n"}),
    ("cache-key-hazard",
     {"core/a.py": "import functools\n@functools.lru_cache(maxsize=4)\n"
                   "def f(model):\n    return model\n"},
     {"core/a.py": "import functools\n@functools.lru_cache(maxsize=4)\n"
                   "def f(cfg, device):\n    return cfg\n"}),
    ("cache-key-hazard",
     {"core/a.py": "from functools import cache\nimport torch\n@cache\n"
                   "def f(w: torch.Tensor):\n    return w\n"},
     {"core/a.py": "from functools import cache\n@cache\n"
                   "def f(spec: 'ModelConfig'):\n    return spec\n"}),
    ("parse-error", {"core/a.py": "def f(:\n"}, {"core/a.py": "def f():\n"
                                                             "    pass\n"}),
]


@pytest.mark.parametrize("rule,bad,good", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_rule_flags_the_bad_source_and_not_the_good(tmp_path, rule, bad,
                                                    good):
    got = _active(_tree(tmp_path / "bad", bad).parent)
    assert [f.rule for f in got] == [rule], [f.render() for f in got]
    assert cli.main([str(tmp_path / "bad")]) == 1
    assert _active(_tree(tmp_path / "good", good).parent) == []
    assert cli.main([str(tmp_path / "good")]) == 0


def _kernel(name: str, bound: str, *, ref=True, cu=True) -> dict:
    files = {f"kernels/{name}/__init__.py": "",
             f"kernels/{name}/ops.py":
                 "from repro_torch.kernels import _build\n"
                 "def launch(x):\n"
                 f"    return _build.bind({bound!r}, 'entry', ())\n"}
    if ref:
        files[f"kernels/{name}/ref.py"] = "def plain(x):\n    return x\n"
    if cu:
        files[f"kernels/csrc/{bound}.cu"] = "// kernel\n"
    return files


@pytest.mark.parametrize("case", ["no-ref", "no-source", "binds-nothing"])
def test_kernel_trio(tmp_path, case):
    bad = {"no-ref": _kernel("moments", "moments", ref=False),
           "no-source": _kernel("moments", "moments", cu=False),
           "binds-nothing": {**_kernel("moments", "moments"),
                             "kernels/moments/ops.py": "def launch(x):\n"
                                                       "    return x\n"}}[case]
    got = _active(_tree(tmp_path / "bad", bad).parent)
    assert [f.rule for f in got] == ["kernel-trio"], [f.render() for f in got]
    assert _active(_tree(tmp_path / "good",
                         _kernel("moments", "moments")).parent) == []


def _fused(ref_kinds, decode_kinds, pricing_kinds) -> dict:
    def branch(var, kinds):
        return "".join(f"    if {var}.kind == {k!r}:\n        pass\n"
                       for k in kinds)

    return {
        "kernels/fused_plan/ref.py": "def run(st):\n" + branch("st",
                                                                ref_kinds),
        "kernels/fused_plan/ops.py": "def pack(st):\n"
                                     "    if st.kind == 'act':\n"
                                     "        pass\n",
        "kernels/fused_decode/ops.py":
            "def lower(at, n):\n"
            "    if (n, at.kind) != (1, 'attn'):\n        pass\n"
            + branch("at", decode_kinds),
        "core/plan.py": "def other(st):\n    if st.kind == 'ffn':\n"
                        "        pass\n"
                        "def decode_stage_traffic(spec):\n"
                        + branch("st", pricing_kinds),
    }


def _fused_findings(root: Path) -> list[rules.Finding]:
    return [f for f in _active(root) if f.rule != "kernel-trio"]


def test_fused_kind_exhaustiveness(tmp_path):
    """The lowerings' kinds are fused_decode/ops.py's and fused_plan/
    ops.py's together ('attn' from a tuple comparison, 'act' from the
    second file); a kind the pricing drops is flagged there."""
    kinds = ("dense", "act", "norm", "attn", "ffn")
    good = _fused(kinds, ("dense", "norm", "ffn"), kinds)
    assert _fused_findings(_tree(tmp_path / "good", good).parent) == []
    bad = _fused(kinds, ("dense", "norm", "ffn"),
                 ("dense", "act", "norm", "attn"))
    got = _fused_findings(_tree(tmp_path / "bad", bad).parent)
    assert [(f.rule, Path(f.path).name) for f in got] == \
        [("fused-kind-exhaustiveness", "plan.py")]
    assert "'ffn'" in got[0].message


def test_suppressions_and_stale_ones(tmp_path):
    root = _tree(tmp_path, {
        "core/a.py": "def f(x):\n"
                     "    assert x  # repro: ignore[bare-assert] — a test\n"
                     "    return x  # repro: ignore[bare-assert]\n"}).parent
    found = checker.analyze(root)
    assert sorted((f.rule, f.line, f.suppressed) for f in found) == [
        ("bare-assert", 2, True), ("stale-suppression", 3, False)]
    assert cli.main([str(root)]) == 1


def test_cli_json_and_rule_catalog(tmp_path, capsys):
    root = _tree(tmp_path, {"core/a.py": "import jax\n"}).parent
    assert cli.main([str(root), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["active"] == 1 and report["suppressed"] == 0
    assert report["findings"][0]["rule"] == "no-jax"
    assert cli.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(r.id in listed for r in rules.RULES)
    assert len(rules.RULE_IDS) == 9


def test_the_port_passes_its_own_gate():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.cli",
         str(SRC / "repro_torch")], capture_output=True, text=True,
        env={"PYTHONPATH": str(SRC), "PATH": ""}, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stderr
