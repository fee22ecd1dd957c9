"""Cross-file checks: what no single module shows (a kernel package's
shape, the fused step kinds' agreement)."""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.checker import (PACKAGE, build_import_map,
                                          display_path, resolve_dotted)
from repro_torch.analysis.rules import Finding

__all__ = ["KERNEL_PAIR", "check_project", "kind_literals"]

#: Beside its CUDA source under ``kernels/csrc/``, every kernel package
#: ships its plain version and its wrapper.
KERNEL_PAIR = ("ref.py", "ops.py")

_BIND = f"{PACKAGE}.kernels._build.bind"


def check_project(pkg_root: Path) -> list[Finding]:
    return _check_kernel_trio(pkg_root) + _check_fused_kinds(pkg_root)


def _parse(path: Path) -> ast.AST | None:
    try:
        return ast.parse(path.read_text(encoding="utf-8"))
    except SyntaxError:
        return None          # a parse-error finding covers the file


# ---------------------------------------------------------------------------
# kernel-trio
# ---------------------------------------------------------------------------

def _bound_sources(tree: ast.AST, package: str) -> list[tuple[int, str]]:
    """(line, stem) of every ``_build.bind("<stem>", ...)`` in ``tree``."""
    imports = build_import_map(tree, package)
    return [(node.lineno, node.args[0].value) for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and resolve_dotted(node.func, imports) == _BIND and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)]


def _check_kernel_trio(pkg_root: Path) -> list[Finding]:
    kernels = pkg_root / "kernels"
    if not kernels.is_dir():
        return []
    csrc = kernels / "csrc"
    out: list[Finding] = []
    for sub in sorted(p for p in kernels.iterdir() if p.is_dir()):
        init = sub / "__init__.py"
        if not init.exists():
            continue             # not a kernel package (csrc, caches)
        for name in KERNEL_PAIR:
            if not (sub / name).exists():
                out.append(Finding(
                    "kernel-trio", display_path(init), 1, 1,
                    f"kernel package `kernels/{sub.name}` has no `{name}` "
                    f"— every kernel ships its plain version (ref.py) and "
                    f"its wrapper (ops.py) beside its csrc/*.cu"))
        ops = sub / "ops.py"
        tree = _parse(ops) if ops.exists() else None
        if tree is None:
            continue
        bound = _bound_sources(tree, f"{PACKAGE}.kernels.{sub.name}")
        if not bound:
            out.append(Finding(
                "kernel-trio", display_path(ops), 1, 1,
                f"`kernels/{sub.name}/ops.py` binds no kernel "
                f"(`_build.bind(\"<name>\", ...)`): a wrapper launches a "
                f"csrc/<name>.cu"))
        for line, stem in bound:
            if not (csrc / f"{stem}.cu").exists():
                out.append(Finding(
                    "kernel-trio", display_path(ops), line, 1,
                    f"`kernels/{sub.name}/ops.py` binds `{stem}`, but "
                    f"kernels/csrc/{stem}.cu does not exist"))
    return out


# ---------------------------------------------------------------------------
# fused-kind-exhaustiveness
# ---------------------------------------------------------------------------

def _is_kind(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "kind"


def _strings(node: ast.AST) -> set[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return {e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return set()


def kind_literals(scope: ast.AST) -> set[str]:
    """The string literals compared with a ``.kind`` attribute anywhere in
    ``scope``: ``st.kind == "attn"``, ``s.kind not in ("dense", "act")``,
    and element by element in tuple comparisons (``(a.kind, b) ==
    ("attn", c)``)."""
    out: set[str] = set()
    for node in ast.walk(scope):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        if any(_is_kind(s) for s in sides):
            for side in sides:
                out |= _strings(side)
        for a, b in zip(sides, sides[1:]):
            if isinstance(a, ast.Tuple) and isinstance(b, ast.Tuple) and \
                    len(a.elts) == len(b.elts):
                for x, y in zip(a.elts, b.elts):
                    if _is_kind(x):
                        out |= _strings(y)
                    elif _is_kind(y):
                        out |= _strings(x)
    return out


def _function(tree: ast.AST, name: str) -> ast.AST | None:
    return next((n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                 and n.name == name), None)


def _check_fused_kinds(pkg_root: Path) -> list[Finding]:
    ref = pkg_root / "kernels" / "fused_plan" / "ref.py"
    lowerings = (pkg_root / "kernels" / "fused_decode" / "ops.py",
                 pkg_root / "kernels" / "fused_plan" / "ops.py")
    plan = pkg_root / "core" / "plan.py"
    trees = {p: _parse(p) for p in (ref, *lowerings, plan) if p.exists()}
    if len(trees) < 4 or None in trees.values():
        return []     # a missing piece is kernel-trio's or parse-error's
    pricing = _function(trees[plan], "decode_stage_traffic")
    if pricing is None:
        return [Finding(
            "fused-kind-exhaustiveness", display_path(plan), 1, 1,
            "core/plan.py has no `decode_stage_traffic`: the per-kind "
            "pricing of the fused decode step is gone")]
    handled = {
        ref: ("kernels/fused_plan/ref.py", 1, kind_literals(trees[ref])),
        lowerings[0]: ("the kernels' lowerings (kernels/fused_decode/ops.py"
                       " with kernels/fused_plan/ops.py)", 1,
                       kind_literals(trees[lowerings[0]])
                       | kind_literals(trees[lowerings[1]])),
        plan: ("core/plan.decode_stage_traffic", pricing.lineno,
               kind_literals(pricing)),
    }
    vocabulary = set().union(*(kinds for _, _, kinds in handled.values()))
    out: list[Finding] = []
    for path, (where, line, kinds) in handled.items():
        for missing in sorted(vocabulary - kinds):
            out.append(Finding(
                "fused-kind-exhaustiveness", display_path(path), line, 1,
                f"FusedStep kind '{missing}' is handled elsewhere but not "
                f"by {where} — the plain version, the kernels and the "
                f"pricing must agree on the kinds"))
    return out
