"""The port's copy of reprolint (`repro_torch.analysis`) against the
reference's (`repro.analysis`): identical findings (rule, path, line,
column, message) on every snippet tests/test_analysis.py lints and, rule
by rule before suppression, on every file of src/; the same CLI report;
and `python -m repro_torch.analysis src/repro_torch` exits 0 in a process
that never loads `repro` or `jax`."""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro import analysis as ref
from repro_torch import analysis as port

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"


def _snippets():
    """(code, file name) of every `lint_snippet(tmp_path, code[, name])`
    call in tests/test_analysis.py (code a literal, or a local name bound
    to one in the calling test), and the number of such calls."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    out, calls = [], 0
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name == "lint_snippet":
            continue
        local = {t.id: n.value.value for n in ast.walk(fn)
                 if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Constant)
                 for t in n.targets if isinstance(t, ast.Name)}
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "lint_snippet"):
                continue
            calls += 1
            code = node.args[1]
            code = code.value if isinstance(code, ast.Constant) \
                else local.get(getattr(code, "id", None))
            names = [k.value.value for k in node.keywords if k.arg == "name"]
            if code is not None:
                out.append((code, names[0] if names else "mod.py"))
    return sorted(set(out), key=lambda s: (s[1], s[0])), calls


SNIPPETS, CALLS = _snippets()


def _dicts(findings):
    return [f.as_dict() for f in findings]


def test_every_snippet_found():
    assert CALLS == 21 and len(SNIPPETS) == CALLS


@pytest.mark.parametrize("code,name", SNIPPETS,
                         ids=[f"{n}:{i}" for i, (_, n) in enumerate(SNIPPETS)])
def test_snippet_findings_match_reference(tmp_path, code, name):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(code))
    got = port.lint_paths([f], port.ALL_RULES, root=tmp_path)
    want = ref.lint_paths([f], ref.ALL_RULES, root=tmp_path)
    assert _dicts(got) == _dicts(want)


def test_rules_match_reference():
    assert [(r.id, r.title) for r in port.ALL_RULES] == \
        [(r.id, r.title) for r in ref.ALL_RULES]


def test_src_tree_findings_match_reference():
    """Every rule on every file of src/ before suppression (the waived
    hazards included), and after it (none), in both packages."""
    from repro.analysis import linter as ref_linter
    from repro_torch.analysis import linter as port_linter
    raw = {}
    for name, pkg, linter in (("port", port, port_linter),
                              ("ref", ref, ref_linter)):
        found = []
        for f in linter.iter_python_files([SRC]):
            source = f.read_text(encoding="utf-8")
            ctx = linter.FileContext(
                path=f.relative_to(REPO).as_posix(), source=source,
                tree=ast.parse(source), lines=source.splitlines())
            for rule in pkg.ALL_RULES:
                found += _dicts(rule.check(ctx))
        raw[name] = found
    assert raw["port"] == raw["ref"]
    assert len(raw["port"]) > 0          # the waived hazards
    assert port.lint_paths([SRC], port.ALL_RULES, root=REPO) == []


def _cli(module, *argv):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)


def test_cli_report_matches_reference(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\ndef f(x):\n    assert x\n"
                   "    return time.time()\n")
    outs = [_cli(m, str(bad), "--format", "json")
            for m in ("repro_torch.analysis", "repro.analysis")]
    assert [o.returncode for o in outs] == [1, 1]
    assert json.loads(outs[0].stdout) == json.loads(outs[1].stdout)
    lists = [_cli(m, "--list-rules") for m in ("repro_torch.analysis",
                                               "repro.analysis")]
    assert lists[0].stdout == lists[1].stdout


def test_port_lints_clean_without_repro_or_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch.analysis', 'src/repro_torch']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print('rc', rc, 'loaded', ','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.splitlines()[-1] == "rc 0 loaded ", out.stdout
    assert "0 finding(s)" in out.stdout
