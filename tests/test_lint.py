"""The Python lint gate (run_clang_tidy.sh analog)."""

import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint():
    spec = importlib.util.spec_from_file_location(
        "svt_lint", os.path.join(REPO, "scripts", "lint.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lint_flags_unused_import(tmp_path):
    """The gate's 'Done' criterion: an unused import must fail the check."""
    lint = _lint()
    f = tmp_path / "mod.py"
    f.write_text("import os\nimport sys\nprint(sys.argv)\n")
    findings = lint.lint_file(f)
    assert any("unused import 'os'" in x for x in findings), findings
    assert not any("'sys'" in x for x in findings), findings


def test_lint_suppressions_and_specials(tmp_path):
    lint = _lint()
    f = tmp_path / "mod.py"
    f.write_text(
        "from __future__ import annotations\n"
        "import sideeffect  # lint: keep\n"
        "__all__ = ['api']\n"
        "import api\n"
        "x = f'{1:.4f}'\n"  # format spec is not an empty f-string
    )
    assert lint.lint_file(f) == []
    f.write_text("x = f'static'\ntry:\n    pass\nexcept:\n    pass\n")
    got = lint.lint_file(f)
    assert any("f-string without placeholders" in x for x in got)
    assert any("bare 'except:'" in x for x in got)


def test_repo_is_lint_clean():
    lint = _lint()
    assert lint.main([]) == 0
