"""The rule catalog, :class:`Finding`, and suppressions.

A finding on a line carrying ``# repro: ignore[rule-id]`` is *suppressed*:
still reported (``--json`` shows ``"suppressed": true``) but not counted
toward the exit code. A suppression that matches no finding on its line
is itself a finding (``stale-suppression``), so an ignore cannot outlive
the violation it excused.
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize

__all__ = ["Rule", "RULES", "RULE_IDS", "Finding", "parse_suppressions"]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One entry of the catalog: id, what it flags, what it protects."""

    id: str
    summary: str
    protects: str


#: The catalog; the CLI prints it with ``--list-rules``.
RULES: tuple[Rule, ...] = (
    Rule("no-jax",
         "an import of jax, jaxlib or the reference package repro (aliased, "
         "from-imports and importlib included)",
         "the port stands alone: it runs where JAX is not installed, and "
         "keeps its own copy of what it needs"),
    Rule("import-time-build",
         "a kernel build or library load (_build.build / load / bind, "
         "ctypes, cpp_extension), a torch.cuda call, a CUDA device, or a "
         "triton import, at module top level (function bodies are fine)",
         "importing the port builds nothing and touches no card: the CPU "
         "tests import every module on machines without a toolkit"),
    Rule("kernel-trio",
         "a kernels/<pkg> package without ref.py and ops.py, or whose "
         "ops.py binds no csrc/<name>.cu that exists",
         "every kernel has its plain version beside it and a wrapper "
         "that launches a hand-written source"),
    Rule("serving-clock",
         "time.time / time.monotonic / time.perf_counter reachable from "
         "repro_torch/serving, aliasing included",
         "injectable-clock serving: virtual-time replay and the fault "
         "harness break if wall time leaks in"),
    Rule("bare-assert",
         "an assert statement in library code",
         "loud failures: asserts vanish under `python -O`; raise an "
         "error with the diagnostic instead"),
    Rule("cache-key-hazard",
         "functools.lru_cache / cache on a function whose parameters are "
         "named or annotated as models, params or tensors",
         "process-lifetime caches keyed on hashable configs, specs and "
         "devices: a cached model or tensor pins its memory for good"),
    Rule("fused-kind-exhaustiveness",
         "a FusedStep.kind handled by one of kernels/fused_plan/ref.py, "
         "the kernels' lowerings (kernels/fused_decode/ops.py with "
         "kernels/fused_plan/ops.py) or core/plan.decode_stage_traffic "
         "but not the others",
         "plain version, kernel and pricing agree on the step kinds"),
    Rule("stale-suppression",
         "a suppression comment matching no finding on its line",
         "suppressions stay honest: each points at a current finding"),
    Rule("parse-error",
         "a file that does not parse as Python",
         "the other rules: an unparseable file is an unchecked file"),
)

RULE_IDS: frozenset[str] = frozenset(r.id for r in RULES)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: rule id, location (1-indexed line/col), message."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "suppressed": self.suppressed}


#: The marker inside a comment: ``ignore[...]`` after the ``repro:`` tag,
#: one rule id or a comma list. (Spelled obliquely here so this comment is
#: not itself a suppression.)
_SUPPRESS_RE = re.compile(r"repro:\s*ignore\[([A-Za-z0-9_\-, ]+)\]")


def parse_suppressions(source: str) -> dict[int, set[str]]:
    """Line number -> the rule ids suppressed on it. Reads COMMENT tokens
    only, so a string that mentions the syntax suppresses nothing. Unknown
    ids are kept: they match no finding and surface as stale."""
    out: dict[int, set[str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
                out.setdefault(tok.start[0], set()).update(ids)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return {}       # a parse-error finding covers the file
    return out
