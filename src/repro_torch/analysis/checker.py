"""The per-file rules and the :func:`analyze` entry point.

Names resolve through an import map: every ``import`` / ``from`` binding
of a module maps a local name to its dotted origin, and attribute chains
resolve through it before they are matched, so aliases do not hide a
spelling::

    from time import monotonic          # -> time.monotonic
    import time as t; t.perf_counter()  # -> time.perf_counter
    from ..kernels import _build as b; b.load("moments")
"""

from __future__ import annotations

import ast
import dataclasses
import os
from pathlib import Path

from repro_torch.analysis import rules
from repro_torch.analysis.rules import Finding

__all__ = ["PACKAGE", "FORBIDDEN_TOP", "SERVING_CLOCKS", "BUILD_CALLS",
           "build_import_map", "resolve_dotted", "check_source", "analyze",
           "locate_package_root", "display_path"]

#: The package the rules are written for.
PACKAGE = "repro_torch"

#: Top-level modules the port never imports.
FORBIDDEN_TOP = frozenset({"jax", "jaxlib", "repro"})

#: The serving path's one wall clock is ``repro_torch.obs.trace
#: .default_clock`` (injectable); these bypass it.
SERVING_CLOCKS = frozenset({"time.time", "time.monotonic",
                            "time.perf_counter"})

#: Calls that build or load a kernel library.
BUILD_CALLS = frozenset({
    f"{PACKAGE}.kernels._build.build", f"{PACKAGE}.kernels._build.load",
    f"{PACKAGE}.kernels._build.bind", "ctypes.CDLL",
    "ctypes.cdll.LoadLibrary", "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline",
})

_CACHE_DECORATORS = frozenset({"functools.lru_cache", "functools.cache"})

#: Parameter names and annotation words of a hazardous cache key: a model,
#: its parameters or a tensor, pinned for the life of the process.
_HAZARD_PARAM_NAMES = frozenset({
    "model", "models", "params", "weights", "state", "batch", "caches",
    "cache", "array", "arrays", "tensor", "tensors",
})
_HAZARD_ANNOTATION = ("Tensor", "Model", "Params", "ndarray", "Module",
                      "IvimNet")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_TOP


def _hazardous_annotation(ann: str) -> bool:
    """A whole-word match: ``ModelConfig`` does not trip on ``Model``."""
    for word in _HAZARD_ANNOTATION:
        i = ann.find(word)
        while i != -1:
            before = ann[i - 1] if i else ""
            after = ann[i + len(word):i + len(word) + 1]
            if not (before.isalnum() or before == "_") and \
                    not (after.isalnum() or after == "_"):
                return True
            i = ann.find(word, i + 1)
    return False


# ---------------------------------------------------------------------------
# import-map name resolution
# ---------------------------------------------------------------------------

def _absolute(node: ast.ImportFrom, package: str) -> str:
    """The dotted module of a ``from`` import, relative ones resolved
    against ``package`` (the module's own package)."""
    module = node.module or ""
    if not node.level:
        return module
    parts = package.split(".") if package else []
    keep = parts[:len(parts) - (node.level - 1)]
    return ".".join(keep + ([module] if module else []))


def build_import_map(tree: ast.AST, package: str) -> dict[str, str]:
    """Local name -> dotted origin, from every import in ``tree``
    (function-local ones included: the map is flat)."""
    imports: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    imports[alias.asname] = alias.name
                else:
                    top = alias.name.split(".")[0]
                    imports[top] = top
        elif isinstance(node, ast.ImportFrom):
            module = _absolute(node, package)
            for alias in node.names:
                if alias.name != "*":
                    imports[alias.asname or alias.name] = \
                        f"{module}.{alias.name}" if module else alias.name
    return imports


def resolve_dotted(node: ast.AST, imports: dict[str, str]) -> str | None:
    """A Name/Attribute chain's dotted origin, or None if it bottoms out
    in anything else (a call, a subscript, a name never imported)."""
    attrs: list[str] = []
    while isinstance(node, ast.Attribute):
        attrs.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = imports.get(node.id)
    if base is None:
        return None
    return ".".join([base, *reversed(attrs)]) if attrs else base


# ---------------------------------------------------------------------------
# the per-file visitor
# ---------------------------------------------------------------------------

class FileVisitor(ast.NodeVisitor):
    """no-jax, import-time-build, serving-clock, bare-assert and
    cache-key-hazard over one module."""

    def __init__(self, display: str, rel: str, package: str,
                 imports: dict[str, str]):
        self.display, self.package, self.imports = display, package, imports
        self.findings: list[Finding] = []
        self._depth = 0          # function-body nesting: 0 runs at import
        self._in_serving = rel.startswith("serving/")

    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule, self.display, getattr(node, "lineno", 1),
            getattr(node, "col_offset", 0) + 1, message))

    def _resolve(self, node: ast.AST) -> str | None:
        return resolve_dotted(node, self.imports)

    def _no_jax(self, node: ast.AST, module: str) -> None:
        if _forbidden(module):
            self._add("no-jax", node,
                      f"import of `{module}` in the port — it imports "
                      f"torch and numpy, never JAX or the reference "
                      f"package; keep a copy of what it needs")

    def _triton(self, node: ast.AST, module: str) -> None:
        if self._depth == 0 and module.split(".")[0] == "triton":
            self._add("import-time-build", node,
                      f"`{module}` imported at module top level — import "
                      f"triton inside the function that launches")

    def _clock(self, node: ast.AST, dotted: str) -> None:
        if self._in_serving and dotted in SERVING_CLOCKS:
            self._add("serving-clock", node,
                      f"`{dotted}` on the serving path — take time from "
                      f"the injectable repro_torch.obs.trace.default_clock")

    # -- imports ----------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._no_jax(node, alias.name)
            self._triton(node, alias.name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        module = _absolute(node, self.package)
        self._no_jax(node, module)
        self._triton(node, module)
        for alias in node.names:
            self._clock(node, f"{module}.{alias.name}")

    # -- usages -----------------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        dotted = self._resolve(node)
        if dotted is not None:
            self._clock(node, dotted)
            return       # a pure chain: nothing below resolves otherwise
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        dotted = self.imports.get(node.id)
        if dotted is not None:
            self._clock(node, dotted)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._add("bare-assert", node,
                  "assert statement in library code (stripped under "
                  "`python -O`) — raise an error with the diagnostic "
                  "instead")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self._resolve(node.func)
        if dotted == "importlib.import_module" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            self._no_jax(node, node.args[0].value)
            self._triton(node, node.args[0].value)
        if self._depth == 0:
            self._import_time_call(node, dotted)
        self.generic_visit(node)

    def _import_time_call(self, node: ast.Call, dotted: str | None) -> None:
        why = None
        if dotted in BUILD_CALLS:
            why = "builds or loads a kernel library"
        elif (dotted or "").startswith("torch.cuda."):
            why = "touches the card"
        else:
            for kw in node.keywords:
                if kw.arg == "device" and isinstance(kw.value, ast.Constant) \
                        and str(kw.value.value).startswith("cuda"):
                    why = "allocates on the card"
        if why:
            self._add("import-time-build", node,
                      f"`{dotted or ast.unparse(node.func)}(...)` at module "
                      f"top level {why} — do it at first use, never at "
                      f"import")

    # -- function scopes --------------------------------------------------

    def _visit_function(self, node) -> None:
        for dec in node.decorator_list:
            self.visit(dec)
        self._check_cache_hazard(node)
        # defaults and annotations evaluate at def time: the current depth
        self.visit(node.args)
        if node.returns is not None:
            self.visit(node.returns)
        self._depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self._depth -= 1

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.visit(node.args)
        self._depth += 1
        self.visit(node.body)
        self._depth -= 1

    def _check_cache_hazard(self, node) -> None:
        cache_dec = next((d for d in node.decorator_list if self._resolve(
            d.func if isinstance(d, ast.Call) else d) in _CACHE_DECORATORS),
            None)
        if cache_dec is None:
            return
        args = node.args
        for arg in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            ann = ast.unparse(arg.annotation) if arg.annotation else ""
            if arg.arg.lower() in _HAZARD_PARAM_NAMES or \
                    _hazardous_annotation(ann):
                why = f"parameter `{arg.arg}`" + \
                    (f" (annotated `{ann}`)" if ann else "")
                self._add("cache-key-hazard", cache_dec,
                          f"functools cache on `{node.name}` keyed by {why} "
                          f"— a process-lifetime cache pins its keys; key "
                          f"on configs, specs and devices")
                return


# ---------------------------------------------------------------------------
# files and trees
# ---------------------------------------------------------------------------

def _package_of(rel: str) -> str:
    """The dotted package holding the module at package-relative ``rel``
    (a package's ``__init__.py`` is its own package)."""
    return ".".join([PACKAGE, *rel.split("/")[:-1]])


def check_source(source: str, rel: str, display: str) -> list[Finding]:
    """Every per-file finding of one module (suppressions not applied).
    ``rel`` is its posix path under the package root: it scopes the rules
    (``serving/``) and resolves relative imports."""
    try:
        tree = ast.parse(source, filename=display)
    except SyntaxError as exc:
        return [Finding("parse-error", display, exc.lineno or 1,
                        exc.offset or 1, f"file does not parse: {exc.msg}")]
    package = _package_of(rel)
    visitor = FileVisitor(display, rel, package,
                          build_import_map(tree, package))
    visitor.visit(tree)
    seen: set[tuple] = set()
    out = []
    for f in visitor.findings:
        key = (f.rule, f.line, f.col)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def locate_package_root(root: Path) -> Path:
    """A CLI argument as the package directory: the package itself, a
    directory holding it, or a repository root holding ``src/``."""
    for cand in (root, root / PACKAGE, root / "src" / PACKAGE):
        if cand.is_dir() and cand.name == PACKAGE:
            return cand
    raise FileNotFoundError(
        f"no `{PACKAGE}` package under {root}: pass the package directory, "
        f"a directory holding it, or a repository root holding src/")


def display_path(path: Path) -> str:
    """A path as findings print it: relative to the working directory
    where it can be."""
    try:
        return os.path.relpath(path)
    except ValueError:
        return str(path)


def analyze(root: Path) -> list[Finding]:
    """Every rule over the package at ``root``, suppressions applied.
    Returns all findings, suppressed ones marked: a gate counts
    ``[f for f in findings if not f.suppressed]``."""
    from repro_torch.analysis import project    # late: project imports us

    pkg_root = locate_package_root(Path(root))
    findings: list[Finding] = []
    sources: dict[str, str] = {}
    for path in sorted(pkg_root.rglob("*.py")):
        rel = path.relative_to(pkg_root).as_posix()
        display = display_path(path)
        sources[display] = path.read_text(encoding="utf-8")
        findings.extend(check_source(sources[display], rel, display))
    findings.extend(project.check_project(pkg_root))
    return _apply_suppressions(findings, sources)


def _apply_suppressions(findings: list[Finding],
                        sources: dict[str, str]) -> list[Finding]:
    supp = {display: rules.parse_suppressions(src)
            for display, src in sources.items()}
    used: set[tuple] = set()
    out: list[Finding] = []
    for f in findings:
        if f.rule in supp.get(f.path, {}).get(f.line, set()):
            out.append(dataclasses.replace(f, suppressed=True))
            used.add((f.path, f.line, f.rule))
        else:
            out.append(f)
    for display, per_line in supp.items():
        for line in sorted(per_line):
            for rule_id in sorted(per_line[line]):
                if (display, line, rule_id) in used:
                    continue
                reason = ("unknown rule id" if rule_id not in rules.RULE_IDS
                          else f"no {rule_id} finding on this line")
                out.append(Finding(
                    "stale-suppression", display, line, 1,
                    f"stale suppression of `{rule_id}`: {reason} — remove "
                    f"it"))
    return out
