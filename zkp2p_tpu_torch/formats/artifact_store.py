"""Chunked artifact distribution of a proving key (a copy of the
reference's ``formats/artifact_store.py``).

The key ships as gzip chunks ``<name>b.gz`` .. ``<name>k.gz`` beside a
manifest ``<name>.manifest.json`` (chunk names, the SHA-256 and the size
of the whole), in a store behind ``Backend`` (``DirBackend``: a local
directory; an object-store client fits the same three methods).  A
download reassembles the chunks, keeps each compressed chunk in a local
cache directory so that a second fetch reads none from the store, and
checks the hash and the size.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Protocol

CHUNK_SUFFIXES = "bcdefghijk"  # 10 chunks, zkp.ts:13


class Backend(Protocol):
    def put(self, name: str, data: bytes) -> None: ...
    def get(self, name: str) -> bytes: ...
    def exists(self, name: str) -> bool: ...


class DirBackend:
    """Local directory backend (S3 stand-in; msw-mock analog in tests)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def put(self, name: str, data: bytes) -> None:
        with open(os.path.join(self.root, name), "wb") as f:
            f.write(data)

    def get(self, name: str) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, name))


@dataclass
class Manifest:
    name: str
    chunks: List[str]
    sha256: str
    raw_size: int


def upload_chunked(backend: Backend, name: str, blob: bytes, n_chunks: int = len(CHUNK_SUFFIXES)) -> Manifest:
    """Split + gzip + upload (upload_chunked_keys_to_s3.sh semantics:
    ~45% size cut from gzip, 10-way parallel download)."""
    n_chunks = min(n_chunks, max(1, len(blob)))
    size = (len(blob) + n_chunks - 1) // n_chunks
    chunk_names = []
    for i in range(n_chunks):
        part = blob[i * size : (i + 1) * size]
        cname = f"{name}{CHUNK_SUFFIXES[i] if i < len(CHUNK_SUFFIXES) else i}.gz"
        backend.put(cname, gzip.compress(part))
        chunk_names.append(cname)
    manifest = Manifest(
        name=name,
        chunks=chunk_names,
        sha256=hashlib.sha256(blob).hexdigest(),
        raw_size=len(blob),
    )
    backend.put(f"{name}.manifest.json", json.dumps(manifest.__dict__).encode())
    return manifest


def download_chunked(backend: Backend, name: str, cache_dir: Optional[str] = None, progress=None) -> bytes:
    """Fetch + uncompress + reassemble, with a local chunk cache so
    re-fetches are free (the IndexedDB localforage cache, zkp.ts:51-68)."""
    manifest = Manifest(**json.loads(backend.get(f"{name}.manifest.json")))
    parts: List[bytes] = []
    for i, cname in enumerate(manifest.chunks):
        cached = os.path.join(cache_dir, cname) if cache_dir else None
        if cached and os.path.exists(cached):
            with open(cached, "rb") as f:
                comp = f.read()
        else:
            comp = backend.get(cname)
            if cached:
                os.makedirs(cache_dir, exist_ok=True)
                with open(cached, "wb") as f:
                    f.write(comp)
        parts.append(gzip.decompress(comp))
        if progress:
            progress(i + 1, len(manifest.chunks))
    blob = b"".join(parts)
    if hashlib.sha256(blob).hexdigest() != manifest.sha256:
        raise IOError(f"chunk integrity failure for {name}")
    if len(blob) != manifest.raw_size:
        raise IOError(f"size mismatch for {name}")
    return blob
