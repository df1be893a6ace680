"""Test config: a virtual 8-device CPU mesh and the seeded corpus.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); multi-device sharding
logic is validated on ``xla_force_host_platform_device_count=8`` virtual
devices (SURVEY.md §4's multi-host testing note). Tests that need the GPU
carry the ``gpu`` marker and skip elsewhere (the ``on_gpu`` fixture
decides, at run time).

The data files the tests read — profile models, sequence sets, the tiny
golden fixtures, a covid-length FASTA — are written once per session from
fixed seeds by :func:`spec_viterbi.io.corpus.write_corpus` into
``<repo>/.test_data`` (git-ignored). Each xdist worker that finds the tree
missing builds it in a private directory and renames it into place, so
concurrent workers never see a half-written tree.
"""

import os
import shutil
import sys
import uuid

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# bump when the generated content changes, so stale trees are not reused
CORPUS_VERSION = "v1"
REFERENCE_ROOT = os.path.join(REPO, ".test_data", f"corpus-{CORPUS_VERSION}")
TEST_CHMMS = os.path.join(REFERENCE_ROOT, "chmm_files", "test_chmms")
TEST_SEQS = os.path.join(REFERENCE_ROOT, "ess_files", "test_sequences")
CHMM_DIR = os.path.join(REFERENCE_ROOT, "chmm_files")
ESS_DIR = os.path.join(REFERENCE_ROOT, "ess_files")


def _ensure_corpus() -> None:
    if os.path.isdir(REFERENCE_ROOT):
        return
    from spec_viterbi.io.corpus import write_corpus

    parent = os.path.dirname(REFERENCE_ROOT)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{os.getpid()}-{uuid.uuid4().hex}")
    write_corpus(tmp)
    try:
        os.rename(tmp, REFERENCE_ROOT)
    except OSError:  # another worker published first; same content
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="session", autouse=True)
def seeded_corpus():
    _ensure_corpus()
    return REFERENCE_ROOT


@pytest.fixture(scope="session")
def fixture_paths(seeded_corpus):
    return [
        (
            os.path.join(TEST_CHMMS, f"{i}_test_chmm.chmm"),
            os.path.join(TEST_SEQS, f"{i}_test_seq.ess"),
        )
        for i in range(4)
    ]


@pytest.fixture
def on_gpu():
    """Skip unless JAX runs on a GPU (for ``@pytest.mark.gpu`` tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the kernel is compiled only for the card")


def banded_hmm(n=256, offsets=(1,), emit=4, seed=0):
    """Random banded HMM: transitions only along the given diagonals."""
    from spec_viterbi.hmm import HMM, to_modified_prob_np

    rng = np.random.default_rng(seed)
    rows, cols, probs = [], [], []
    for d in offsets:
        src = np.arange(max(0, -d), n - max(0, d))
        rows.append(src)
        cols.append(src + d)
        probs.append(rng.uniform(0.05, 1.0, size=src.shape[0]))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    probs = np.concatenate(probs)
    return HMM(
        states_num=n,
        emit_num=emit,
        trans_rows=rows.astype(np.int64),
        trans_cols=cols.astype(np.int64),
        trans_probs=to_modified_prob_np(probs),
        emissions=to_modified_prob_np(rng.uniform(0.05, 1.0, size=(emit, n))),
        start_probabilities_cols=np.arange(8, dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.full(8, 1 / 8)),
    )
