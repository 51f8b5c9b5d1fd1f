"""Reprolint core — a tiny AST lint framework for determinism and
invariant hazards (DESIGN.md §14).

The repo's verification story (chaos-pack CRC determinism, ranking
invariants, bit-identical parity oracles) rests on properties nothing
used to check mechanically: guards that survive ``python -O``, no
wall-clock reads inside simulation logic, seeded RNG everywhere, no
hash-order iteration feeding event ordering, no Python leaking into
traced JAX code, and no jit dispatch that bypasses the bucketed
compile cache. Each of those is a bug class this repo has fixed by
hand at least once; reprolint codifies them as rules
R001–R006 (see `repro_torch.analysis.rules`) so CI catches the next
regression at lint time.

Framework contract:

* A rule is a `Rule` subclass with a unique ``id`` ("R001"), a
  one-line ``title``, and a ``check(ctx)`` generator yielding
  `Finding`s. `FileContext` hands it the parsed AST, the source lines
  and the repo-relative posix path (rules scope themselves by path —
  e.g. R002 only fires under ``metro/`` and ``core/``).
* Suppression is per-line and per-rule: ``# reprolint: disable=R002``
  on the finding's line (or the line directly above, for lines with no
  room) suppresses that rule there; ``# reprolint: disable`` with no
  ids suppresses every rule on that line. There is no file-level or
  block-level suppression — a hazard is either fixed, or visibly
  waived exactly where it lives.
* `lint_paths` walks ``*.py`` files, runs every rule, filters
  suppressed findings and returns the survivors sorted by location.
  Files that fail to parse yield an ``E000`` finding (a syntax error
  is never silently skipped).

The module is stdlib-only (ast + pathlib) so the CI lint step needs no
jax/numpy install.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*disable(?:=(?P<ids>[A-Z0-9, ]+))?")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    path: str            # repo-relative posix path
    line: int            # 1-indexed
    col: int             # 0-indexed (ast convention)
    message: str

    def human(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


@dataclass
class FileContext:
    """Everything a rule may look at for one file."""
    path: str                    # repo-relative posix path
    source: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message)

    def in_dir(self, *parts: str) -> bool:
        """True when the file lives under any of the given package
        directories (matched as path segments, e.g. "metro")."""
        segs = self.path.split("/")
        return any(p in segs for p in parts)


class Rule:
    """Base rule. Subclasses set `id`/`title` and implement check()."""
    id = "R000"
    title = ""

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        raise NotImplementedError


def _suppressions(lines: Sequence[str]) -> Dict[int, Optional[Set[str]]]:
    """Map 1-indexed line number -> suppressed rule ids (None = all).
    A directive covers its own line and the line directly below it
    (for findings whose statement had no room for a trailing comment)."""
    out: Dict[int, Optional[Set[str]]] = {}

    def add(n: int, ids: Optional[Set[str]]) -> None:
        if ids is None or out.get(n, set()) is None:
            out[n] = None
        else:
            out.setdefault(n, set()).update(ids)

    for n, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        raw = m.group("ids")
        ids = None if raw is None else {
            s.strip() for s in raw.split(",") if s.strip()}
        covers = (n, n + 1) if text.lstrip().startswith("#") else (n,)
        for c in covers:
            add(c, ids)
    return out


def _suppressed(f: Finding,
                supp: Dict[int, Optional[Set[str]]]) -> bool:
    ids = supp.get(f.line, set())
    return ids is None or f.rule in ids


def lint_file(path: Path, rules: Sequence[Rule],
              rel: str) -> List[Finding]:
    source = path.read_text(encoding="utf-8")
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding(rule="E000", path=rel, line=e.lineno or 1,
                        col=e.offset or 0,
                        message=f"syntax error: {e.msg}")]
    ctx = FileContext(path=rel, source=source, tree=tree, lines=lines)
    supp = _suppressions(lines)
    found: List[Finding] = []
    for rule in rules:
        for f in rule.check(ctx):
            if not _suppressed(f, supp):
                found.append(f)
    return found


def iter_python_files(paths: Sequence[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            yield from sorted(p.rglob("*.py"))


def lint_paths(paths: Sequence[Path], rules: Sequence[Rule],
               root: Optional[Path] = None) -> List[Finding]:
    """Lint every ``*.py`` under `paths`; paths in findings are
    relative to `root` (default: the current working directory when
    possible, else absolute)."""
    root = root or Path.cwd()
    findings: List[Finding] = []
    for f in iter_python_files([Path(p) for p in paths]):
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        findings.extend(lint_file(f, rules, rel))
    findings.sort(key=lambda x: (x.path, x.line, x.col, x.rule))
    return findings


# ---------------------------------------------------------- AST helpers

def dotted_name(node: ast.AST) -> Optional[str]:
    """"a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Map local alias -> imported dotted module/name.

    ``import numpy as np``          -> {"np": "numpy"}
    ``import numpy.random as npr``  -> {"npr": "numpy.random"}
    ``from numpy import random``    -> {"random": "numpy.random"}
    ``from random import choice``   -> {"choice": "random.choice"}
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def resolve(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted name with the leading alias expanded through the file's
    imports: with ``import numpy as np``, `np.random.rand` resolves to
    "numpy.random.rand"."""
    name = dotted_name(node)
    if name is None:
        return None
    head, _, tail = name.partition(".")
    base = aliases.get(head)
    if base is None:
        return name
    return f"{base}.{tail}" if tail else base
