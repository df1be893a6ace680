"""Benchmark harness: timing helpers, .dat format, dataset drivers (on the
tiny fixtures, times=1, CPU)."""

import os

import numpy as np
import pytest

from conftest import TEST_CHMMS, TEST_SEQS

from spec_viterbi.bench import harness
from spec_viterbi.bench.bench_viterbi import (
    benchmark_viterbi_impls_to_dat_file,
    benchmark_viterbi_spec_impls_to_dat_file,
)


def test_median_odd_even():
    assert harness.get_median([1.0, 2.0, 9.0]) == 2.0
    assert harness.get_median([1.0, 2.0, 3.0, 9.0]) == 2.5
    with pytest.raises(ValueError):
        harness.get_median([])


def test_dat_writer_and_sum(tmp_path):
    out = tmp_path / "x.dat"
    harness.print_benchmarks_to_file_as_dat(
        str(out), ["States", "a", "b"], {200: [2.0, 3.0], 100: [1.0, 5.0]}
    )
    lines = out.read_text().splitlines()
    assert lines[0] == "States\ta\tb"
    # rows ascending by state count
    assert lines[1].split("\t")[0] == "100"
    assert lines[2].split("\t")[0] == "200"
    sums = harness.sum_dat_columns(str(out))
    assert sums["States"] == 300
    assert sums["a"] == 3.0
    assert sums["b"] == 8.0


def test_sum_dat_skips_nan_cells(tmp_path):
    """Over-budget spec cells are NaN; sum-dat must skip them, not poison
    the column. An all-NaN column stays NaN."""
    out = tmp_path / "spec.dat"
    harness.print_benchmarks_to_file_as_dat(
        str(out),
        ["States", "ok", "partial", "dead"],
        {100: [1.0, float("nan"), float("nan")], 200: [2.0, 5.0, float("nan")]},
    )
    sums = harness.sum_dat_columns(str(out))
    assert sums["ok"] == 3.0
    assert sums["partial"] == 5.0
    assert np.isnan(sums["dead"])


def test_nonspec_bench_driver(tmp_path):
    out = tmp_path / "bench.dat"
    # 2_test_seq's symbols (max 2) fit fixtures 0/2/3; fixture 1 (2-symbol
    # alphabet) must be skipped by the driver's alphabet guard
    bench = benchmark_viterbi_impls_to_dat_file(
        TEST_CHMMS,
        os.path.join(TEST_SEQS, "2_test_seq.ess"),
        str(out),
        modes=("dense",),
        times_to_run=1,
        verbose=False,
    )
    assert len(bench) >= 2  # fixtures with distinct state counts
    header = out.read_text().splitlines()[0]
    assert header == "States\tdense"


def test_spec_bench_driver_with_memory_policy(tmp_path):
    out = tmp_path / "spec.dat"
    bench = benchmark_viterbi_spec_impls_to_dat_file(
        TEST_CHMMS,
        os.path.join(TEST_SEQS, "0_test_seq.ess"),
        str(out),
        levels=(1, 2),
        struct_levels=(1, 2, 3),
        times_to_run=1,
        max_spec_bytes=0,  # force the over-budget path at every level
        verbose=False,
    )
    header = out.read_text().splitlines()[0].split("\t")
    assert header == [
        "States",
        "spec_1_prep", "spec_1", "spec_2_prep", "spec_2",
        "spec_struct_1_prep", "spec_struct_1", "spec_struct_2_prep", "spec_struct_2",
        "spec_struct_3_prep", "spec_struct_3",
    ]
    for row in bench.values():
        assert all(np.isnan(v) for v in row)  # memory policy engaged


def test_spec_bench_struct_level3_cell_runs(tmp_path):
    """The spec_struct_3 cell must produce a REAL measurement within
    budget (prep composes the L3 stack, decode runs the bucketed batched
    path), not ride the NaN policy."""
    out = tmp_path / "spec3.dat"
    bench = benchmark_viterbi_spec_impls_to_dat_file(
        TEST_CHMMS,
        os.path.join(TEST_SEQS, "1_test_seq.ess"),
        str(out),
        levels=(1,),
        struct_levels=(3,),
        times_to_run=1,
        verbose=False,
    )
    assert bench
    for row in bench.values():
        prep3, dec3 = row[-2], row[-1]
        assert np.isfinite(prep3) and prep3 >= 0
        assert np.isfinite(dec3) and dec3 >= 0


def _run_bench_py(env_extra: dict) -> tuple[int, str, str]:
    import subprocess
    import sys

    env = dict(os.environ, **env_extra)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py")],
        capture_output=True,
        text=True,
        env=env,
        timeout=120,
    )
    return proc.returncode, proc.stdout, proc.stderr


def test_bench_py_survives_hung_mode():
    """A forced stall of one mode must still yield a parsed JSON line
    within budget. The structured child hangs (simulating a native call
    SIGALRM cannot preempt); the parent must SIGKILL its process group at
    the wall-clock budget and publish the dense result alone."""
    import json
    import time

    t0 = time.time()
    rc, out, err = _run_bench_py(
        {
            "SVT_BENCH_FAULT": "hang=structured;stub=dense",
            "SVT_BENCH_TIMEOUT_STRUCTURED": "2",
            "SVT_BENCH_TIMEOUT_RETRY": "1",
            "SVT_BENCH_TIMEOUT_DENSE": "30",
        }
    )
    assert err.count("structured mode killed") == 2  # timeout IS retried
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "decoded_obs_symbols_per_s_per_device_2407"
    assert line["value"] == 152000.0  # dense stub salvaged the number
    assert line["vs_baseline"] == 1.0
    assert time.time() - t0 < 60  # budgets held (2+1 hang + fast dense)


def test_bench_py_all_modes_dead_is_the_only_failure():
    import json

    rc, out, _ = _run_bench_py(
        {
            "SVT_BENCH_FAULT": "hang=structured,dense",
            "SVT_BENCH_TIMEOUT_STRUCTURED": "1",
            "SVT_BENCH_TIMEOUT_RETRY": "1",
            "SVT_BENCH_TIMEOUT_DENSE": "1",
        }
    )
    assert rc != 0

    rc, out, _ = _run_bench_py({"SVT_BENCH_FAULT": "stub=structured,dense"})
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["value"] == 46.5e6
    assert line["vs_baseline"] == 46.5e6 / 152e3
    assert line["us_per_step"] == 11.0


def test_cli_info_and_sum_dat(tmp_path, capsys):
    from spec_viterbi.cli import main

    rc = main(["info", os.path.join(TEST_CHMMS, "0_test_chmm.chmm")])
    assert rc == 0
    assert "structured decomposition" in capsys.readouterr().out

    out = tmp_path / "x.dat"
    harness.print_benchmarks_to_file_as_dat(str(out), ["States", "a"], {10: [1.5]})
    rc = main(["sum-dat", str(out)])
    assert rc == 0
    assert "a\t1.5" in capsys.readouterr().out


def test_cli_generators_roundtrip(tmp_path, capsys):
    from spec_viterbi.cli import main
    from spec_viterbi.io import read_emit_seq, read_hmm

    chmm = tmp_path / "g.chmm"
    ess = tmp_path / "g.ess"
    assert main(["gen-chmm", str(chmm), "--states", "16", "--emit-range", "5"]) == 0
    assert main(["gen-ess", str(ess), "--count", "3", "--length", "7", "--emit-range", "5"]) == 0
    capsys.readouterr()
    hmm = read_hmm(str(chmm))
    seqs = read_emit_seq(str(ess))
    assert hmm.states_num == 16 and len(seqs) == 3 and len(seqs[0]) == 7


def test_cli_decode_spec_level(capsys):
    from spec_viterbi.cli import main

    rc = main(
        [
            "decode",
            os.path.join(TEST_CHMMS, "1_test_chmm.chmm"),
            os.path.join(TEST_SEQS, "1_test_seq.ess"),
            "--spec-level", "2",
        ]
    )
    assert rc == 0
    assert "min=" in capsys.readouterr().out


def test_cli_decode(capsys):
    from spec_viterbi.cli import main

    rc = main(
        [
            "decode",
            os.path.join(TEST_CHMMS, "1_test_chmm.chmm"),
            os.path.join(TEST_SEQS, "1_test_seq.ess"),
            "--path",
        ]
    )
    assert rc == 0
    assert "path=" in capsys.readouterr().out


def test_bench_py_no_retry_on_deterministic_failure():
    """A nonzero child exit is deterministic: the parent must NOT burn the
    retry budget re-running it (only timeouts retry)."""
    import json

    rc, out, err = _run_bench_py(
        {
            "SVT_BENCH_FAULT": "fail=structured;stub=dense",
            "SVT_BENCH_TIMEOUT_STRUCTURED": "30",
            "SVT_BENCH_TIMEOUT_RETRY": "30",
            "SVT_BENCH_TIMEOUT_DENSE": "30",
        }
    )
    assert rc == 0
    assert err.count("structured mode exited rc=3") == 1  # exactly one attempt
    line = json.loads(out.strip().splitlines()[-1])
    assert line["value"] == 152000.0
