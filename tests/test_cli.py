"""End-to-end CLI coverage (the reference's `main.cpp` analog).

Every subcommand runs in-process via ``cli.main(argv)`` on CPU: decode
(plain, --path, --spec-level), info, sum-dat (NaN-aware), the data
tooling (gen-chmm/gen-ess/fasta-to-ess), and a miniature bench run that
writes both `.dat` artifacts.
"""

import os
import re

import numpy as np

from conftest import CHMM_DIR, TEST_CHMMS, TEST_SEQS

from spec_viterbi import cli
from spec_viterbi.io import read_emit_seq, read_hmm
from spec_viterbi.models.oracle import (
    viterbi_path_oracle,
    viterbi_scores_oracle,
)

CHMM0 = os.path.join(TEST_CHMMS, "0_test_chmm.chmm")
ESS0 = os.path.join(TEST_SEQS, "0_test_seq.ess")


def _mins(out: str) -> list[float]:
    return [float(m) for m in re.findall(r"min=([0-9.]+)", out)]


def test_cli_decode_scores(capsys):
    assert cli.main(["decode", CHMM0, ESS0]) == 0
    out = capsys.readouterr().out
    hmm = read_hmm(CHMM0)
    seqs = read_emit_seq(ESS0)
    mins = _mins(out)
    assert len(mins) == len(seqs)
    for m, s in zip(mins, seqs):
        assert abs(m - float(np.min(viterbi_scores_oracle(hmm, s)))) <= 1.0


def test_cli_decode_path(capsys):
    assert cli.main(["decode", CHMM0, ESS0, "--path"]) == 0
    out = capsys.readouterr().out
    hmm = read_hmm(CHMM0)
    seqs = read_emit_seq(ESS0)
    paths = [eval(m) for m in re.findall(r"path=(\[[0-9, ]*\])", out)]
    assert len(paths) == len(seqs)
    for p, s in zip(paths, seqs):
        _, op = viterbi_path_oracle(hmm, s)
        assert p == op.tolist()


def test_cli_decode_stream_chunk(capsys):
    """--stream-chunk decode (scores + exact paths) matches the oracle."""
    assert cli.main(["decode", CHMM0, ESS0, "--stream-chunk", "3"]) == 0
    out = capsys.readouterr().out
    hmm = read_hmm(CHMM0)
    seqs = read_emit_seq(ESS0)
    for m, s in zip(_mins(out), seqs):
        assert abs(m - float(np.min(viterbi_scores_oracle(hmm, s)))) <= 1.0

    assert cli.main(["decode", CHMM0, ESS0, "--stream-chunk", "3", "--path"]) == 0
    out = capsys.readouterr().out
    paths = [eval(m) for m in re.findall(r"path=(\[[0-9, ]*\])", out)]
    assert len(paths) == len(seqs)
    for p, s in zip(paths, seqs):
        _, op = viterbi_path_oracle(hmm, s)
        assert p == op.tolist()


def test_cli_decode_stream_chunk_validation(capsys):
    """Bad --stream-chunk values error out instead of decoding garbage."""
    assert cli.main(["decode", CHMM0, ESS0, "--stream-chunk", "-5"]) == 2
    assert "must be >= 1" in capsys.readouterr().err
    assert (
        cli.main(["decode", CHMM0, ESS0, "--stream-chunk", "3", "--mode", "dense"])
        == 2
    )
    assert "incompatible" in capsys.readouterr().err


def test_cli_decode_spec_level(capsys):
    assert cli.main(["decode", CHMM0, ESS0, "--spec-level", "2"]) == 0
    out = capsys.readouterr().out
    hmm = read_hmm(CHMM0)
    seqs = read_emit_seq(ESS0)
    for m, s in zip(_mins(out), seqs):
        assert abs(m - float(np.min(viterbi_scores_oracle(hmm, s)))) <= 1.0


def test_cli_info(capsys):
    chmm = os.path.join(CHMM_DIR, "100.chmm")
    assert cli.main(["info", chmm]) == 0
    out = capsys.readouterr().out
    hmm = read_hmm(chmm)
    assert f"states:        {hmm.states_num}" in out
    assert f"transitions:   {hmm.trans_num}" in out
    assert "structured decomposition:" in out


def test_cli_sum_dat_nan_aware(tmp_path, capsys):
    dat = tmp_path / "t.dat"
    dat.write_text(
        "States\ta\tb\n100\t1.5\tnan\n200\t2.5\t3.0\n"
    )
    assert cli.main(["sum-dat", str(dat)]) == 0
    out = capsys.readouterr().out
    cols = dict(
        line.split("\t") for line in out.strip().splitlines()
    )
    assert float(cols["a"]) == 4.0
    # NaN cells must not poison the aggregate
    assert float(cols["b"]) == 3.0


def test_cli_data_tooling_roundtrip(tmp_path, capsys):
    chmm = str(tmp_path / "g.chmm")
    ess = str(tmp_path / "g.ess")
    assert cli.main(
        ["gen-chmm", chmm, "--states", "12", "--emit-range", "5", "--seed", "3"]
    ) == 0
    assert cli.main(
        ["gen-ess", ess, "--count", "2", "--length", "9", "--emit-range", "5", "--seed", "4"]
    ) == 0
    capsys.readouterr()
    # generated pair decodes end-to-end and matches the oracle
    assert cli.main(["decode", chmm, ess]) == 0
    out = capsys.readouterr().out
    hmm = read_hmm(chmm)
    for m, s in zip(_mins(out), read_emit_seq(ess)):
        assert abs(m - float(np.min(viterbi_scores_oracle(hmm, s)))) <= 1.0


def test_cli_fasta_to_ess(tmp_path, capsys):
    fasta = tmp_path / "x.fasta"
    fasta.write_text(">seq1\nACDX\n>seq2\nYV\n")
    ess = str(tmp_path / "x.ess")
    assert cli.main(["fasta-to-ess", str(fasta), ess]) == 0
    seqs = read_emit_seq(ess)
    # A..Y -> 0..19, X -> 0 (fasta_to_ess.py:3-8)
    assert seqs[0].tolist() == [0, 1, 2, 0]
    assert len(seqs) == 2


def test_bench_ragged_interpret(tmp_path):
    from spec_viterbi.bench.bench_ragged import (
        HEADERS,
        benchmark_ragged,
    )
    from spec_viterbi.io import write_ess

    from spec_viterbi.utils.batching import bucket_plan

    rng = np.random.default_rng(2)
    ess = str(tmp_path / "rag.ess")
    lens = [4] * 10 + [150] * 2
    write_ess(
        [rng.integers(0, 4, size=t).astype(np.int32) for t in lens],
        ess,
    )
    # 300 lanes, 50 of them 150-symbol: quantizes into a 192-step bucket
    # plus a 64-step bucket — the multi-bucket branch really runs (a
    # workload whose lengths all quantize to the 64-grid minimum would
    # silently fall back to the whole-batch path)
    plan = bucket_plan(lens * 25)
    assert plan is not None and len(plan) == 2
    states, row = benchmark_ragged(
        os.path.join(TEST_CHMMS, "3_test_chmm.chmm"),
        ess,
        copies=25,
        times_to_run=1,
        interpret=True,
    )
    assert states == read_hmm(os.path.join(TEST_CHMMS, "3_test_chmm.chmm")).states_num
    assert len(row) == len(HEADERS) - 1
    assert all(t > 0 for t in row)


def test_cli_bench_writes_dat(tmp_path, capsys):
    ess = str(tmp_path / "mini.ess")
    assert cli.main(
        ["gen-ess", ess, "--count", "2", "--length", "40", "--seed", "1"]
    ) == 0
    assert cli.main(
        [
            "bench",
            "--datasets", ess,
            "--chmm-dir", CHMM_DIR,
            "--out-dir", str(tmp_path),
            "--times", "1",
            "--max-states", "110",
            "--levels", "1",
            "--modes", "structured",
        ]
    ) == 0
    nonspec = tmp_path / "Viterbi_bench_mini.dat"
    spec = tmp_path / "Viterbi_spec_bench_mini.dat"
    assert nonspec.exists() and spec.exists()
    lines = nonspec.read_text().strip().splitlines()
    assert lines[0].startswith("States")
    assert len(lines) >= 2  # at least the 102-state model row
