"""The port's artifact store (zkp2p_tpu_torch.formats.artifact_store), on
the CPU: the three cases of tests/test_artifact_store.py, a store written
by either package read by the other; and through the port's command line,
`setup --chunks 3 --publish` then `prove --zkey-store`: the pulled key
writes back the published file, its chunks the reference's split_zkey of the same
file, and a second pull reads no chunk from the store."""

import gzip
import json
import os

import pytest
import torch

from zkp2p_tpu.formats import artifact_store as ref_store
from zkp2p_tpu.formats.zkey import split_zkey as ref_split_zkey

from zkp2p_tpu_torch.curve.host import G1_GENERATOR, G2_GENERATOR
from zkp2p_tpu_torch.formats.artifact_store import DirBackend, download_chunked, upload_chunked
from zkp2p_tpu_torch.formats.zkey import CHUNK_SUFFIXES, write_zkey_data
from zkp2p_tpu_torch.pipeline import cli
from zkp2p_tpu_torch.snark.groth16 import Proof

torch.set_num_threads(1)


def test_roundtrip_and_progress(tmp_path):
    backend = DirBackend(str(tmp_path / "bucket"))
    blob = bytes(range(256)) * 409 + b"tail"  # not chunk-aligned
    manifest = upload_chunked(backend, "circuit.zkey", blob)
    assert len(manifest.chunks) == 10
    assert manifest.chunks[0] == "circuit.zkeyb.gz"  # the b..k suffixes
    calls = []
    out = download_chunked(backend, "circuit.zkey", progress=lambda i, n: calls.append((i, n)))
    assert out == blob
    assert calls == [(i, 10) for i in range(1, 11)]


def test_cache_skips_backend(tmp_path):
    backend = DirBackend(str(tmp_path / "bucket"))
    cache = str(tmp_path / "cache")
    blob = os.urandom(10_000)
    upload_chunked(backend, "k", blob)
    assert download_chunked(backend, "k", cache_dir=cache) == blob
    for f in os.listdir(tmp_path / "bucket"):  # the store's chunks gone: the cache serves
        if f.endswith(".gz"):
            os.remove(tmp_path / "bucket" / f)
    assert download_chunked(backend, "k", cache_dir=cache) == blob


def test_integrity_failure(tmp_path):
    backend = DirBackend(str(tmp_path / "bucket"))
    upload_chunked(backend, "k", b"hello world" * 100)
    backend.put("kb.gz", gzip.compress(b"evil"))
    with pytest.raises(IOError):
        download_chunked(backend, "k")


def test_stores_cross_read(tmp_path):
    blob = os.urandom(5_000) + b"x" * 3_000
    man = upload_chunked(DirBackend(str(tmp_path / "port")), "k", blob, n_chunks=4)
    assert man.chunks == ["kb.gz", "kc.gz", "kd.gz", "ke.gz"]
    assert ref_store.download_chunked(ref_store.DirBackend(str(tmp_path / "port")), "k") == blob
    ref_store.upload_chunked(ref_store.DirBackend(str(tmp_path / "ref")), "k", blob, n_chunks=4)
    assert download_chunked(DirBackend(str(tmp_path / "ref")), "k") == blob


def test_setup_publish_then_prove_from_the_store(tmp_path, monkeypatch):
    build, store = tmp_path / "build", tmp_path / "store"
    cli.main(["--build-dir", str(build), "--circuit", "toy", "setup", "--device", "cpu", "--chunks", "3",
              "--publish", str(store)])
    whole = str(build / "circuit_final.zkey")
    data = open(whole, "rb").read()
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref_whole = str(ref_dir / "circuit_final.zkey")
    open(ref_whole, "wb").write(data)
    for mine, theirs in zip([whole + s for s in CHUNK_SUFFIXES[:3]], ref_split_zkey(ref_whole, 3)):
        assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert not os.path.exists(whole + CHUNK_SUFFIXES[3])
    man = json.loads((store / "circuit.zkey.manifest.json").read_text())
    assert len(man["chunks"]) == 10 and man["raw_size"] == len(data)

    # prove --zkey-store: the key the prover imports is the one read
    # directly (the proof itself stubbed: proofs are held elsewhere)
    seen = []

    def fake_prove(dpk, w, device=None):
        seen.append(dpk)
        return Proof(a=G1_GENERATOR, b=G2_GENERATOR, c=G1_GENERATOR)

    monkeypatch.setattr(cli, "prove_gpu", fake_prove)
    loaded = []
    real_key = cli._key
    monkeypatch.setattr(cli, "_key", lambda args, zk, dev: loaded.append(zk) or real_key(args, zk, dev))
    argv = ["--build-dir", str(build), "--circuit", "toy", "prove", "--device", "cpu", "--message", "57",
            "--zkey-store", str(store), "--proof", str(tmp_path / "p.json"), "--public", str(tmp_path / "pub.json")]
    cli.main(argv)
    write_zkey_data(str(tmp_path / "pulled.zkey"), loaded[0])  # the pulled key, written back
    assert (tmp_path / "pulled.zkey").read_bytes() == data
    assert len(seen) == 1 and (tmp_path / "p.json").exists()
    cached = sorted(os.listdir(build / "zkey_cache"))
    assert cached == sorted(man["chunks"])
    for f in os.listdir(store):  # a second pull reads the cache, not the store's chunks
        if f.endswith(".gz"):
            os.remove(store / f)
    cli.main(argv)
    assert len(seen) == 2
