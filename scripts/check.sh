#!/usr/bin/env bash
# Quality gate: native build with warnings, bytecode check, full test suite.
# (run_tests.sh / run_clang_tidy.sh analog, SURVEY.md §2.8.)
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== native build (warnings are errors) =="
make -C spec_viterbi/native/src clean
CXXFLAGS="-O3 -std=c++20 -Wall -Wextra -Wpedantic -Werror -fPIC -shared" \
    make -C spec_viterbi/native/src

echo "== native sanitizer checks (ASan/UBSan) =="
echo "2000000000 0 20" > /tmp/svt_hostile.chmm
python -m spec_viterbi.cli gen-corpus corpus --lengths 2405
make -C spec_viterbi/native/src asan CORPUS="$PWD/corpus"

echo "== python bytecode check =="
python -m compileall -q spec_viterbi tests scripts bench.py __graft_entry__.py

echo "== python lint (unused imports etc.; run_clang_tidy.sh analog) =="
python scripts/lint.py

echo "== tests =="
python -m pytest tests/ -q "$@"
