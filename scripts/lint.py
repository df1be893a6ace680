"""Minimal AST lint for the Python bulk of the quality gate.

The reference runs clang-tidy over its whole C++ codebase
(``run_clang_tidy.sh:2-4``); this is the Python analog for
``scripts/check.sh``. No third-party linter ships in the build image
(ruff/pyflakes/flake8 all absent, and installs are off-limits), so this
implements the highest-signal checks directly on ``ast``:

- **unused-import** (the ruff/pyflakes F401 role): an imported binding
  never referenced by name anywhere else in the module and not exported
  via ``__all__``. ``__init__.py`` files are exempt (their imports ARE
  the package's re-export surface). Suppress a deliberate side-effect
  import with ``# lint: keep`` on the import line.
- **empty-fstring** (F541-ish): an f-string with no placeholders.
- **bare-except** (E722): ``except:`` catching everything incl.
  KeyboardInterrupt/SystemExit.

Exit 1 with findings, 0 clean. Usage: ``python scripts/lint.py [paths]``
(defaults to the package, scripts/, tests/, bench.py, __graft_entry__.py).
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEFAULT_PATHS = [
    REPO / "spec_viterbi",
    REPO / "scripts",
    REPO / "tests",
    REPO / "bench.py",
    REPO / "__graft_entry__.py",
]


def _imported_bindings(tree: ast.AST):
    """Yield (lineno, bound_name, is_star) for every import binding."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                yield node.lineno, name, False
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue  # compiler directives, not bindings to "use"
            for alias in node.names:
                if alias.name == "*":
                    yield node.lineno, "*", True
                else:
                    yield node.lineno, alias.asname or alias.name, False


def _used_names(tree: ast.AST, import_lines: set[int]) -> set[str]:
    """Every identifier referenced outside the import statements."""
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.lineno not in import_lines:
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # foo.bar counts as a use of foo (handled via the Name child)
            continue
    return used


def _exported(tree: ast.AST) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        for elt in node.value.elts:
                            if isinstance(elt, ast.Constant) and isinstance(
                                elt.value, str
                            ):
                                out.add(elt.value)
    return out


def lint_file(path: Path) -> list[str]:
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as exc:  # compileall also catches this; be loud
        return [f"{path}:{exc.lineno}: syntax error: {exc.msg}"]
    lines = src.splitlines()
    findings: list[str] = []

    # ---- unused imports -------------------------------------------------
    if path.name != "__init__.py":
        bindings = list(_imported_bindings(tree))
        import_lines = {ln for ln, _, _ in bindings}
        used = _used_names(tree, import_lines)
        exported = _exported(tree)
        for ln, name, is_star in bindings:
            line_text = lines[ln - 1] if ln - 1 < len(lines) else ""
            if "lint: keep" in line_text:
                continue
            if is_star:
                findings.append(f"{path}:{ln}: star import obscures usage")
                continue
            if name not in used and name not in exported:
                findings.append(f"{path}:{ln}: unused import '{name}'")

    # ---- empty f-strings + bare excepts ---------------------------------
    # format specs (f"{x:.4f}") parse as NESTED JoinedStr nodes that hold
    # only a Constant — skip them, they are not user-written f-strings
    spec_ids = {
        id(n.format_spec)
        for n in ast.walk(tree)
        if isinstance(n, ast.FormattedValue) and n.format_spec is not None
    }
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.JoinedStr)
            and id(node) not in spec_ids
            and not any(isinstance(v, ast.FormattedValue) for v in node.values)
        ):
            findings.append(
                f"{path}:{node.lineno}: f-string without placeholders"
            )
        elif isinstance(node, ast.ExceptHandler) and node.type is None:
            findings.append(f"{path}:{node.lineno}: bare 'except:'")
    return findings


def main(argv: list[str]) -> int:
    paths = [Path(p) for p in argv] if argv else DEFAULT_PATHS
    files: list[Path] = []
    for p in paths:
        files += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    findings: list[str] = []
    for f in files:
        findings += lint_file(f)
    for line in findings:
        print(line)
    print(f"lint: {len(files)} files, {len(findings)} findings")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
