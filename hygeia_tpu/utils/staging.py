"""Object-store work-dir staging for the pipeline orchestrator.

The reference stages all Nextflow work directories on S3
(`/root/reference/run.sh:6` `-bucket-dir s3://hygeia-test-1/nextflow_workdir`,
`/root/reference/aws.config:1-12`) so that `-resume` caching works across
machines/fleets. The orchestrator's analog: `hygeia run --run_bucket_dir
URL` mirrors the output tree (stage outputs + `.done` markers) to any
fsspec-addressable store after every completed stage, and restores it before
a `--resume` run — a fresh machine resumes exactly where the fleet left off.

The mirror is incremental by (size, mtime) signature so per-stage syncs cost
one tree walk plus only the new/changed files. `file://` (or a bare path)
works out of the box and is what the tests exercise; `s3://`, `gs://` etc.
work wherever the corresponding fsspec backend is installed.
"""

from __future__ import annotations

import os
import posixpath
from pathlib import Path


class WorkdirMirror:
    """Incremental two-way mirror between a local results tree and a URL."""

    def __init__(self, url: str):
        import fsspec

        self.fs, base = fsspec.core.url_to_fs(str(url))
        self.base = str(base).rstrip("/")
        # (size, mtime) of files known synced, keyed by tree-relative path.
        self._seen: dict[str, tuple[int, float]] = {}

    def _rpath(self, rel: str) -> str:
        return posixpath.join(self.base, rel) if rel else self.base

    def restore(self, root: Path) -> int:
        """Download the mirrored tree into `root`. Returns the number of
        files fetched.

        A local file is skipped only when its size matches the bucket copy
        AND its stage directory carries a local `.done` marker — a stale or
        partially-written local file of coincidentally equal size in an
        unfinished stage must not survive a bucket-restore resume (size
        alone can't detect it; bucket mtimes aren't comparable to local
        ones across backends, so the completion marker is the trust signal).
        Markers are snapshotted before any fetch, and files outside marked
        stage dirs are conservatively always re-fetched.
        """
        root = Path(root)
        if not self.fs.exists(self.base):
            return 0

        # Snapshot the locally-completed stages BEFORE fetching anything:
        # the bucket also mirrors `.done` markers, and restoring one ahead of
        # its stage's files would re-establish trust mid-restore. `.done*`
        # covers per-chromosome markers too (the BED stage writes
        # `.done_{chrom}`, orchestrator run_single_group).
        done_dirs = (
            {p.parent for p in root.rglob(".done*")} if root.is_dir() else set()
        )

        def _stage_done_locally(dst: Path) -> bool:
            d = dst.parent
            while True:
                if d in done_dirs:
                    return True
                if d == root or d.parent == d:
                    return False
                d = d.parent

        fetched = 0
        for rpath in self.fs.find(self.base):
            rel = rpath[len(self.base) :].lstrip("/")
            if not rel:
                continue
            dst = root / rel
            size = self.fs.info(rpath).get("size")
            if (
                dst.is_file()
                and dst.stat().st_size == size
                and _stage_done_locally(dst)
            ):
                st = dst.stat()
                self._seen[rel] = (st.st_size, st.st_mtime)
                continue
            dst.parent.mkdir(parents=True, exist_ok=True)
            self.fs.get_file(rpath, str(dst))
            st = dst.stat()
            self._seen[rel] = (st.st_size, st.st_mtime)
            fetched += 1
        return fetched

    def sync_up(self, root: Path) -> int:
        """Upload files under `root` that are new or changed since the last
        sync (or restore). Returns the number of files uploaded."""
        root = Path(root)
        uploaded = 0
        made_dirs: set[str] = set()
        for p in sorted(root.rglob("*")):
            if not p.is_file():
                continue
            rel = p.relative_to(root).as_posix()
            st = p.stat()
            sig = (st.st_size, st.st_mtime)
            if self._seen.get(rel) == sig:
                continue
            parent = posixpath.dirname(self._rpath(rel))
            if parent and parent not in made_dirs:
                self.fs.makedirs(parent, exist_ok=True)
                made_dirs.add(parent)
            self.fs.put_file(str(p), self._rpath(rel))
            self._seen[rel] = sig
            uploaded += 1
        return uploaded
