"""Data versioning: a copy of ``rtts/data/versioning.py``.

Content-addressed artifact tracking: ``snapshot(paths, lock_file)`` hashes
files into a lock file (path -> sha256, size); ``status(lock_file)``
reports missing, changed and clean artifacts; ``push``/``pull`` copy blobs
to or from a remote keyed ``objects/<sha256>``.  Remotes resolve by URL
scheme (``register_transport``): local directories and ``file://`` by
default, ``gs://`` through google-cloud-storage, imported when such a
remote is used (an actionable error where it or its credentials are
missing).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
from typing import Callable, Dict, Iterable, List, Protocol, Tuple


def _sha256(path: pathlib.Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def snapshot(paths: Iterable[str], lock_file: str) -> Dict[str, dict]:
    """Hash every file (recursing into directories) into the lock file."""
    entries: Dict[str, dict] = {}
    for p in paths:
        root = pathlib.Path(p)
        files = [root] if root.is_file() else sorted(
            q for q in root.rglob("*") if q.is_file())
        for f in files:
            st = f.stat()
            entries[str(f)] = {
                "sha256": _sha256(f),
                "size": st.st_size,
            }
    lock = pathlib.Path(lock_file)
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as fh:
        json.dump({"version": 1, "artifacts": entries}, fh, indent=1,
                  sort_keys=True)
    return entries


def _load_lock(lock_file: str) -> Dict[str, dict]:
    with open(lock_file) as f:
        return json.load(f)["artifacts"]


def status(lock_file: str) -> Dict[str, List[str]]:
    """-> {"missing": [...], "changed": [...], "clean": [...]}"""
    entries = _load_lock(lock_file)
    out: Dict[str, List[str]] = {"missing": [], "changed": [], "clean": []}
    for path, meta in entries.items():
        p = pathlib.Path(path)
        if not p.exists():
            out["missing"].append(path)
        elif p.stat().st_size != meta["size"] or _sha256(p) != meta["sha256"]:
            out["changed"].append(path)
        else:
            out["clean"].append(path)
    return out


class Transport(Protocol):
    """Blob store for one remote; keys are ``objects/<sha256>`` strings."""

    def exists(self, key: str) -> bool: ...

    def upload(self, local: str, key: str) -> None: ...

    def download(self, key: str, local: str) -> bool:
        """Fetch ``key`` into ``local``; False when the blob is absent."""
        ...


class FilesystemTransport:
    """Default transport: a local (or mounted) directory remote."""

    def __init__(self, remote: str):
        self.root = pathlib.Path(remote.removeprefix("file://"))
        (self.root / "objects").mkdir(parents=True, exist_ok=True)

    def exists(self, key: str) -> bool:
        return (self.root / key).exists()

    def upload(self, local: str, key: str) -> None:
        dst = self.root / key
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(local, dst)

    def download(self, key: str, local: str) -> bool:
        src = self.root / key
        if not src.exists():
            return False
        shutil.copyfile(src, local)
        return True


class GCSTransport:
    """``gs://bucket/prefix`` remote via google-cloud-storage.

    Without the client library, credentials or network access,
    construction raises an actionable error.
    """

    def __init__(self, remote: str):
        try:
            from google.cloud import storage  # type: ignore

            client = storage.Client()
        except Exception as e:  # ImportError / DefaultCredentialsError / net
            raise RuntimeError(
                f"remote {remote!r} needs the google-cloud-storage client, "
                "credentials and network access, unavailable here — use a "
                "local/file:// remote directory, or "
                "register a custom transport via "
                f"register_transport('gs', ...) ({type(e).__name__}: {e})"
            ) from e
        bucket, _, prefix = remote.removeprefix("gs://").partition("/")
        self._bucket = client.bucket(bucket)
        self._prefix = prefix.rstrip("/")

    def _blob(self, key: str):
        name = f"{self._prefix}/{key}" if self._prefix else key
        return self._bucket.blob(name)

    def exists(self, key: str) -> bool:
        return self._blob(key).exists()

    def upload(self, local: str, key: str) -> None:
        self._blob(key).upload_from_filename(local)

    def download(self, key: str, local: str) -> bool:
        blob = self._blob(key)
        if not blob.exists():
            return False
        blob.download_to_filename(local)
        return True


_TRANSPORTS: Dict[str, Callable[[str], Transport]] = {
    "file": FilesystemTransport,
    "gs": GCSTransport,
}


def register_transport(scheme: str,
                       factory: Callable[[str], Transport]) -> None:
    """Plug a transport for ``<scheme>://`` remotes (tests use a fake)."""
    _TRANSPORTS[scheme] = factory


def resolve_transport(remote: str) -> Transport:
    """Scheme-dispatch a remote URL; bare paths are filesystem remotes."""
    scheme, sep, _ = remote.partition("://")
    if not sep:
        return FilesystemTransport(remote)
    try:
        factory = _TRANSPORTS[scheme]
    except KeyError:
        raise RuntimeError(
            f"no transport registered for {scheme!r} remotes "
            f"(have: {sorted(_TRANSPORTS)}); use register_transport") \
            from None
    return factory(remote)


def _key(meta: dict) -> str:
    return f"objects/{meta['sha256']}"


def push(lock_file: str, remote: str) -> int:
    """Upload all lock-file artifacts into the remote blob store."""
    tr = resolve_transport(remote)
    n = 0
    for path, meta in _load_lock(lock_file).items():
        key = _key(meta)
        if not tr.exists(key):
            tr.upload(path, key)
            n += 1
    return n


def pull(lock_file: str, remote: str) -> Tuple[int, List[str]]:
    """Restore missing/changed artifacts from the remote store.
    Returns (restored_count, unavailable_paths)."""
    tr = resolve_transport(remote)
    restored, missing = 0, []
    st = status(lock_file)
    entries = _load_lock(lock_file)
    for path in st["missing"] + st["changed"]:
        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        if tr.download(_key(entries[path]), path):
            restored += 1
        else:
            missing.append(path)
    return restored, missing
