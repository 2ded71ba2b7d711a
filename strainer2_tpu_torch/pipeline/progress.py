"""Checkpoint/resume for panel counting and detection.

A pinned copy of ``strainer2_tpu.pipeline.progress`` (numpy only; the port
imports nothing of the JAX package), so a checkpoint directory written by
either package resumes in the other (tests/test_torch_resume.py).

The reference's -p progress file only records which panel files were
started (reference src/kmer_scrub_count.c:78-85), so a crash loses all
counts, and ``strain_detect`` has no resume at all.

- :class:`ScrubCheckpoint`: each completed panel file persists the merged
  slot-indexed count buffer plus a manifest, so a restarted scrub-count
  run skips finished files and continues from the exact counts.  Counts
  are integers, so resume is bit-identical to an uninterrupted run.
- :class:`DetectCheckpoint`: each completed batch-list sample persists
  its full output payload (hit rows + the 4 per-file summary lines,
  reference src/strain_detect.c:633-636), zlib-compressed.  A resumed run
  replays stored payloads in batch order into a fresh gzip stream and
  scores only the remaining samples, so the output file is byte-identical
  to an uninterrupted run.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib

import numpy as np

__all__ = ["ScrubCheckpoint", "DetectCheckpoint"]


class ScrubCheckpoint:
    """Directory-backed checkpoint: counts_<col>.npy + manifest.json.

    ``key`` (optional) is an identity string for the COUNTED INDEX (e.g. a
    content hash of the union k-mer set): a manifest recorded under a
    different key is stale — its slot-indexed counts belong to a different
    table geometry — so it is ignored and counting restarts fresh rather
    than silently mixing counts across indexes (the stale files are
    overwritten by the first record())."""

    def __init__(self, directory: str, key: str | None = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "manifest.json")
        self._manifest = {"done": {}}
        if key is not None:
            self._manifest["key"] = key
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                loaded = json.load(f)
            if key is None or loaded.get("key") == key:
                self._manifest = loaded
            else:
                import sys

                print(
                    f"checkpoint {directory} belongs to a different "
                    "strain set; starting fresh",
                    file=sys.stderr,
                )

    def done_files(self, column: int) -> list[str]:
        return list(self._manifest["done"].get(str(column), []))

    def counts(self, column: int) -> np.ndarray | None:
        path = os.path.join(self.dir, f"counts_{column}.npy")
        if os.path.exists(path) and self.done_files(column):
            return np.load(path)
        return None

    def record(self, column: int, path: str, counts: np.ndarray) -> None:
        """Persist counts after completing one panel file (atomic)."""
        tmp_fd, tmp_path = tempfile.mkstemp(dir=self.dir, suffix=".npy")
        os.close(tmp_fd)
        np.save(tmp_path, counts, allow_pickle=False)
        os.replace(tmp_path, os.path.join(self.dir, f"counts_{column}.npy"))
        self._manifest["done"].setdefault(str(column), []).append(path)
        tmp_fd, tmp_manifest = tempfile.mkstemp(dir=self.dir, suffix=".json.tmp")
        with os.fdopen(tmp_fd, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp_manifest, self._manifest_path)


class DetectCheckpoint:
    """Directory-backed per-sample detection checkpoint.

    One payload file per completed batch-list sample (``sample_<i>.z``,
    zlib of the concatenated per-sink texts) plus a manifest recording
    each sample's identity key and per-sink byte lengths.  The identity
    key (target paths + type) guards against a changed batch list: a
    mismatched entry is ignored and the sample rescored.  Multi-strain
    detection stores one payload per strain per sample (the lengths list
    splits the blob).
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "detect_manifest.json")
        self._manifest = {"samples": {}}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self._manifest = json.load(f)

    @staticmethod
    def sample_key(f1: str, f2: str | None, ftype: int) -> str:
        return f"{f1}\t{f2 or ''}\t{ftype}"

    def _payload_path(self, ordinal: int) -> str:
        return os.path.join(self.dir, f"sample_{ordinal}.z")

    def get(self, ordinal: int, key: str) -> list[str] | None:
        """Stored payloads for a completed sample, or None."""
        meta = self._manifest["samples"].get(str(ordinal))
        if meta is None or meta["key"] != key:
            return None
        try:
            with open(self._payload_path(ordinal), "rb") as f:
                blob = zlib.decompress(f.read()).decode("utf-8")
        except (OSError, zlib.error):
            return None
        lengths = meta["lengths"]
        if sum(lengths) != len(blob.encode("utf-8")):
            return None
        out, off = [], 0
        raw = blob.encode("utf-8")
        for n in lengths:
            out.append(raw[off : off + n].decode("utf-8"))
            off += n
        return out

    def record(self, ordinal: int, key: str, payloads: list[str]) -> None:
        """Persist one completed sample's payloads (atomic)."""
        raws = [p.encode("utf-8") for p in payloads]
        tmp_fd, tmp_path = tempfile.mkstemp(dir=self.dir, suffix=".z.tmp")
        with os.fdopen(tmp_fd, "wb") as f:
            f.write(zlib.compress(b"".join(raws), 1))
        os.replace(tmp_path, self._payload_path(ordinal))
        self._manifest["samples"][str(ordinal)] = {
            "key": key,
            "lengths": [len(r) for r in raws],
        }
        tmp_fd, tmp_manifest = tempfile.mkstemp(dir=self.dir, suffix=".json.tmp")
        with os.fdopen(tmp_fd, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp_manifest, self._manifest_path)
