"""Persistent specialization-operator cache.

The reference rebuilds all specialized operators on every ``spec_with`` call
and keeps them only in RAM/VRAM (``GraphBLAS_spec_impl.cpp:45-48``;
SURVEY.md §5 "Checkpoint / resume: none"). This cache is the extension:
precomputed operator stacks are persisted and loaded straight to device
memory on the next specialization — prep cost is paid once per model per
machine.

Format (v2): one directory per ``(hmm fingerprint, level, padded size)``
holding one ``.npy`` per array. Loads are **memory-mapped**, so a warm
``spec_with`` costs milliseconds regardless of operator size — pages fault
in lazily on first use, and execution paths that never touch the big
level-L stacks (the fused factored kernel) never pay for them at all.
Stores are atomic: arrays are written into a temp directory that is
renamed into place (a concurrent writer losing the race just discards its
copy).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

# v3: `kind` joined the directory name (dense/struct schema namespacing).
# Older-version entries are unreachable under the new naming, so init
# sweeps them — otherwise every pre-existing ~GB level-3 stack would leak
# on disk forever while the model silently re-specialized cold.
_FORMAT_VERSION = 3


class OperatorCache:
    """File-backed cache of specialized operator stacks."""

    def __init__(self, cache_dir: str | None = None):
        self.cache_dir = cache_dir or os.path.join(
            os.path.expanduser("~"), ".cache", "spec_viterbi"
        )
        self._swept = False

    def _sweep_stale_tmp(self, max_age_s: float = 3600.0) -> None:
        """Remove orphaned ``*.tmp`` staging directories left by a process
        that died mid-``store`` (the async level-3 publish writes ~1.3 GB;
        an abort would otherwise accumulate on disk forever) and
        old-format entries unreachable under the current naming.

        Runs lazily on the first ``store`` — a writer in this directory —
        never on construction, so read-only consumers (and older library
        versions sharing the default cache dir mid-upgrade) are not raced
        out of their entries by a mere ``OperatorCache()``.
        Old-layout reclamation matches the FULL historical entry pattern
        (``ops_v<older>_…_L<level>_N<padded>``), not a bare prefix, so a
        non-dedicated directory's unrelated names are never touched.
        Only ``*.tmp`` dirs older than ``max_age_s`` are swept so a live
        concurrent writer is never disturbed."""
        import re
        import time

        try:
            entries = os.listdir(self.cache_dir)
        except OSError:
            return
        now = time.time()
        old_versions = "|".join(str(v) for v in range(1, _FORMAT_VERSION))
        old_entry = re.compile(rf"^ops_v(?:{old_versions})_.+_L\d+_N\d+$")
        for name in entries:
            stale_tmp = name.endswith(".tmp")
            old_layout = bool(old_entry.match(name))
            if not (stale_tmp or old_layout):
                continue
            p = os.path.join(self.cache_dir, name)
            try:
                if old_layout or now - os.path.getmtime(p) > max_age_s:
                    shutil.rmtree(p, ignore_errors=True)
            except OSError:
                pass

    def _path(self, fingerprint: str, level: int, padded: int, kind: str) -> str:
        # `kind` namespaces incompatible operator schemas (the dense
        # specializer stores start_ops/ops_id; the structured one stores
        # l1_offsets/dv/uu/ww) so the two can never collide on one entry.
        return os.path.join(
            self.cache_dir,
            f"ops_v{_FORMAT_VERSION}_{kind}_{fingerprint}_L{level}_N{padded}",
        )

    def load(self, fingerprint: str, level: int, padded: int, kind: str = "dense"):
        """Returns dict of (memory-mapped) arrays or None on miss/corruption."""
        path = self._path(fingerprint, level, padded, kind)
        if not os.path.isdir(path):
            return None
        try:
            out = {}
            for f in sorted(os.listdir(path)):
                if f.endswith(".npy"):
                    out[f[:-4]] = np.load(os.path.join(path, f), mmap_mode="r")
            return out or None
        except Exception:
            # corrupt cache entry: drop it, rebuild
            shutil.rmtree(path, ignore_errors=True)
            return None

    def store_async(
        self, fingerprint: str, level: int, padded: int, arrays: dict,
        kind: str = "dense",
    ) -> "threading.Thread":
        """Publish in a background thread (the level-3 Pfam stack is
        ~1.3 GB — a synchronous write would double ``spec_with`` cold
        time). The atomic rename-publish means a process exiting mid-write
        leaves only a discarded temp directory, never a corrupt entry.
        Arrays are only read, so the caller may keep using them."""
        import threading

        t = threading.Thread(
            target=self.store,
            args=(fingerprint, level, padded, arrays, kind),
            daemon=True,
        )
        t.start()
        return t

    def store(
        self, fingerprint: str, level: int, padded: int, arrays: dict,
        kind: str = "dense",
    ) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        if not self._swept:  # first write proves we own this directory
            self._swept = True
            self._sweep_stale_tmp()
        path = self._path(fingerprint, level, padded, kind)
        tmp = tempfile.mkdtemp(dir=self.cache_dir, suffix=".tmp")
        try:
            for k, a in arrays.items():
                np.save(os.path.join(tmp, f"{k}.npy"), np.asarray(a))
            try:
                os.rename(tmp, path)  # atomic publish
            except OSError:
                # another process published first — keep theirs
                shutil.rmtree(tmp, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
