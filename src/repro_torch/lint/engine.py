"""The lint engine of the port: file walking, suppression pragmas, rule
dispatch.

Pure stdlib (``ast``): ``python -m repro_torch.lint`` runs where torch is
not installed, so nothing in the engine or the rules imports torch (the
runtime sanitizers live in ``repro_torch.lint.runtime`` and import it
lazily).

The pragma syntax is the JAX package's, so one pragma means the same thing
to both linters. Line-scoped::

    self.cap = count_floor(x)  # jaxlint: disable=JXL003 -- sanctioned helper

    # jaxlint: disable=JXL004 -- wall clock feeds a results row, not a seed
    t0 = time.perf_counter()

A pragma suppresses the named rules on its own line and on the line
directly below it (the own-line-comment form). A pragma without a
``-- reason`` trailer is itself a violation (JXL000): suppressions are
justifications, not mutes, and JXL000 cannot be suppressed. A file that
does not parse is JXL999.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*jaxlint:\s*disable=([A-Z0-9,\s]+?)\s*(?:--\s*(\S.*))?$")

BAD_SUPPRESS = "JXL000"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule hit: ``path:line:col: RULE message``."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _suppressions(source: str) -> Tuple[Dict[int, Set[str]], List[Violation]]:
    """Map line number -> rule codes suppressed there, plus JXL000 hits for
    reason-less pragmas. A pragma covers its own line and the next line."""
    by_line: Dict[int, Set[str]] = {}
    bad: List[Violation] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        if not m.group(2):
            bad.append(Violation(
                BAD_SUPPRESS, "", lineno, m.start(),
                "suppression pragma without a '-- <reason>' trailer; "
                "justify the disable or remove it"))
            continue
        for covered in (lineno, lineno + 1):
            by_line.setdefault(covered, set()).update(codes)
    return by_line, bad


def lint_source(source: str, path: str = "<string>",
                select: Optional[Iterable[str]] = None) -> List[Violation]:
    """Lint one source string; ``path`` scopes the path-sensitive rules
    (JXL004's wall-clock check fires only in the deterministic layers)."""
    from repro_torch.lint.rules import RULES

    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Violation("JXL999", path, e.lineno or 1, e.offset or 0,
                          f"file does not parse: {e.msg}")]
    suppressed, bad_pragmas = _suppressions(source)
    wanted = set(select) if select is not None else None
    out: List[Violation] = [
        dataclasses.replace(v, path=path) for v in bad_pragmas
        if wanted is None or BAD_SUPPRESS in wanted]
    for code, rule in sorted(RULES.items()):
        if wanted is not None and code not in wanted:
            continue
        for node, message in rule.check(tree, path):
            line = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
            if code in suppressed.get(line, ()):
                continue
            out.append(Violation(code, path, line, col, message))
    out.sort(key=lambda v: (v.line, v.col, v.rule))
    return out


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    """Yield .py files under each path (a file or a directory), skipping
    bytecode caches and hidden directories."""
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs if d != "__pycache__" and not d.startswith("."))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_paths(paths: Sequence[str],
               select: Optional[Iterable[str]] = None) -> List[Violation]:
    out: List[Violation] = []
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            out.append(Violation("JXL999", path, 1, 0, f"unreadable: {e}"))
            continue
        out.extend(lint_source(source, path=path, select=select))
    return out
