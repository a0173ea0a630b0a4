"""The port's tests' hold on the reference's native library
(zkp2p_tpu/native/lib.py), which some of them take as their oracle (the
native fixed-base batches, the reference's setup_device).

get_lib() runs `make -C csrc` at its first call in a process and keeps a
failure for the life of the process.  Under the test runner's six
workers, each worker's first call comes at collection, all at once on a
fresh checkout: every worker's make compiles the library, and the linker
writes csrc/libzkp2p_native.so in place.  A worker whose make starts
while another's link is writing the file finds it newer than its source,
loads the partial file ("file too short") and keeps None.

`native_lib()` is the guard: under a lock shared by the workers it
forgets this process's failed load and loads again, waiting for a
concurrent build to end; a partial file left by a build that was cut
short is built anew once.  Where the library truly cannot be had, the
test fails with make's stderr and the load's error."""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import time
import warnings

import pytest

from zkp2p_tpu.native import lib


def _lock_path() -> str:
    return os.path.join(tempfile.gettempdir(),
                        "zkp2p_native_" + hashlib.sha256(lib._CSRC.encode()).hexdigest()[:12] + ".lock")


def native_lib(wait_s: float = 120.0):
    """The reference's native library, loaded in this process: returns it,
    or fails the calling test with make's stderr and the load's error."""
    if lib._lib is not None:
        return lib._lib
    failed_before = lib._tried
    t0 = time.time()
    with open(_lock_path(), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        rebuilt = False
        while True:
            lib._tried = False  # forget this process's failed load
            got = lib.get_lib()
            if got is not None:
                if failed_before:
                    warnings.warn(f"the reference's native library: the first load in this process failed; "
                                  f"loaded {time.time() - t0:.1f} s later" + (" after a rebuild" if rebuilt else ""))
                return got
            if time.time() - t0 < wait_s:
                time.sleep(2.0)  # a concurrent build may still be writing the file
            elif not rebuilt:
                # a build cut short leaves a partial file newer than its
                # source, which make then keeps
                subprocess.run(["make", "-B", "-C", lib._CSRC], capture_output=True)
                rebuilt = True
            else:
                break
    make = subprocess.run(["make", "-C", lib._CSRC], capture_output=True, text=True)
    try:
        ctypes.CDLL(lib._SO)
        load = "it loads, but get_lib() refused it (its self-check)"
    except OSError as e:
        load = str(e)
    pytest.fail(f"the reference's native library is unavailable: make -C {lib._CSRC} exit {make.returncode}\n"
                f"{make.stdout[-2000:]}{make.stderr[-3000:]}\nload: {load}", pytrace=False)


@pytest.fixture(scope="module")
def native():
    """The reference's native library, for tests that take it as an
    oracle."""
    return native_lib()


def test_guard_loads_again_after_a_failed_first_load(monkeypatch, native):
    """A process whose first get_lib() failed (None kept): the guard loads
    the library and its fixed-base batch gives the host curve's point."""
    from zkp2p_tpu.curve.host import G1_GEN, g1_mul

    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(lib, "_tried", True)
    assert lib.get_lib() is None
    with pytest.warns(UserWarning, match="the first load in this process failed"):
        got = native_lib()
    assert got is not None and lib.get_lib() is got
    assert lib.g1_fixed_base_batch(G1_GEN, [12345]) == [g1_mul(G1_GEN, 12345)]


def test_guard_fails_with_make_and_load_errors(monkeypatch, tmp_path):
    """No library to be had: the test fails with make's stderr and the
    load's error, after one rebuild."""
    (tmp_path / "Makefile").write_text("all:\n\t@echo cannot build here >&2; exit 3\n")
    monkeypatch.setattr(lib, "_CSRC", str(tmp_path))
    monkeypatch.setattr(lib, "_SO", str(tmp_path / "libzkp2p_native.so"))
    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(lib, "_tried", True)
    with pytest.raises(pytest.fail.Exception) as failed:
        native_lib(wait_s=0.0)
    msg = str(failed.value)
    assert "exit 2" in msg and "cannot build here" in msg and "load: " in msg and "libzkp2p_native.so" in msg
