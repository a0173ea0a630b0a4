"""The proving key cache: a ``DeviceProvingKey`` and its
``VerifyingKey`` as one numpy ``.npz`` of integer arrays, never a pickle
(port of the reference's ``prover/keycache.py``).

The layout is the reference's, so a file written by either package loads
in the other and gives the same key and VK: every array field of the key
(limbs as uint32, ids as int32; a point field as "<name>.0" (x) and
"<name>.1" (y)), "meta" = (n_public, n_wires, log_m), "schema_version",
the blinding points and the VK's "vk_gamma_2" and "vk_ic" as standard-form
little-endian bytes, and "circuit_digest" when one is given.

``save_dpk`` writes with ``np.savez``, not ``savez_compressed``: random
field elements do not compress, and ``np.load`` reads both.  As in the
reference, the cache does not store ``inferred_narrow_wires``: a key
imported from a zkey with inferred widths loses its width guard in a
round trip through the cache.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from ..curve.host import G1Point, G2Point
from ..field.tower import Fq2
from ..snark.groth16 import VerifyingKey
from ..utils.device import resolve_device
from .groth16_gpu import (_BASE_FIELDS, _LIMB_FIELDS, DPK_ARRAY_FIELDS, NARROW_PLANES, NARROW_WIDTH,
                          DeviceProvingKey)

# the reference's schema: v3 added the width-classed position arrays
SCHEMA_VERSION = 3


class KeyCacheSchemaError(RuntimeError):
    """The cache file does not match the current key schema or circuit."""


def circuit_digest(cs) -> str:
    """A sampled digest of a constraint system (the reference's): the
    wire, public and constraint counts, about 1k evenly spaced
    constraint rows, the narrow-class rule and the wire widths.
    Duck-typed: reads constraints (a/b/c dicts), num_wires, num_public
    and wire_width."""
    n = len(cs.constraints)
    h = hashlib.sha256(f"{cs.num_wires}|{cs.num_public}|{n}".encode())
    step = max(1, n // 997)
    for i in range(0, n, step):
        c = cs.constraints[i]
        h.update(repr((i, sorted(c.a.items()), sorted(c.b.items()), sorted(c.c.items()))).encode())
    h.update(f"|nw{NARROW_WIDTH}|np{NARROW_PLANES}|".encode())
    widths = getattr(cs, "wire_width", {})
    h.update(hashlib.sha256(repr(sorted(widths.items())).encode()).digest())
    return h.hexdigest()[:16]


def _g1_arr(pt: G1Point) -> np.ndarray:
    if pt is None:
        return np.zeros((2, 32), dtype=np.uint8)
    return np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8) for v in pt])


def _g1_from(arr: np.ndarray) -> G1Point:
    x, y = (int.from_bytes(arr[i].tobytes(), "little") for i in (0, 1))
    return None if x == 0 and y == 0 else (x, y)


def _g2_arr(pt: G2Point) -> np.ndarray:
    if pt is None:
        return np.zeros((4, 32), dtype=np.uint8)
    x, y = pt
    return np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8) for v in (x.c0, x.c1, y.c0, y.c1)])


def _g2_from(arr: np.ndarray) -> G2Point:
    v = [int.from_bytes(arr[i].tobytes(), "little") for i in range(4)]
    return None if not any(v) else (Fq2(v[0], v[1]), Fq2(v[2], v[3]))


def _host(t: torch.Tensor, limbs: bool) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32 if limbs else np.int32)


def save_dpk(path: str, dpk: DeviceProvingKey, vk: VerifyingKey, digest: str = "") -> None:
    """Write the key and VK to `path` (numpy appends ".npz" when it is
    missing).  `digest`, when given (``circuit_digest(cs)``), pins the
    file to its circuit: ``load_dpk`` with another digest raises."""
    data = {}
    if digest:
        data["circuit_digest"] = np.frombuffer(digest.encode(), dtype=np.uint8)
    for f in DPK_ARRAY_FIELDS:
        v = getattr(dpk, f)
        if f in _BASE_FIELDS:
            for i, c in enumerate(v):
                data[f"{f}.{i}"] = _host(c, True)
        else:
            data[f] = _host(v, f in _LIMB_FIELDS)
    data["meta"] = np.array([dpk.n_public, dpk.n_wires, dpk.log_m], dtype=np.int64)
    data["schema_version"] = np.array([SCHEMA_VERSION], dtype=np.int64)
    for name in ("alpha_1", "beta_1", "delta_1"):
        data[name] = _g1_arr(getattr(dpk, name))
    for name in ("beta_2", "delta_2"):
        data[name] = _g2_arr(getattr(dpk, name))
    data["vk_gamma_2"] = _g2_arr(vk.gamma_2)
    data["vk_ic"] = np.stack([_g1_arr(p) for p in vk.ic])
    np.savez(path, **data)


def load_dpk(path: str, digest: str = "", device=None) -> Tuple[DeviceProvingKey, VerifyingKey]:
    """Read a key cache onto `device` (CUDA unless "cpu"; raises without
    CUDA).  Raises KeyCacheSchemaError for another schema version, a
    missing field, or (when `digest` is given) another circuit digest."""
    dev = resolve_device(device)
    with np.load(path) as z:
        found = int(z["schema_version"][0]) if "schema_version" in z else 0
        if found != SCHEMA_VERSION:
            raise KeyCacheSchemaError(f"{path}: key cache schema {found} != current {SCHEMA_VERSION}; re-run setup")
        if digest:
            had = bytes(z["circuit_digest"]).decode() if "circuit_digest" in z else "<none>"
            if had != digest:
                raise KeyCacheSchemaError(f"{path}: circuit digest {had} != rebuilt circuit {digest} "
                                          f"(wire/constraint order changed); re-run setup")

        def tensor(name, limbs):
            if name not in z:
                raise KeyCacheSchemaError(f"{path}: missing field {name!r}; re-run setup")
            a = z[name]
            return torch.from_numpy(a.astype(np.int32 if limbs else np.int64)).to(dev)

        arrays = {}
        for f in DPK_ARRAY_FIELDS:
            if f in _BASE_FIELDS:
                arrays[f] = (tensor(f + ".0", True), tensor(f + ".1", True))
            else:
                arrays[f] = tensor(f, f in _LIMB_FIELDS)
        n_public, n_wires, log_m = (int(v) for v in z["meta"])
        dpk = DeviceProvingKey(
            n_public=n_public, n_wires=n_wires, log_m=log_m,
            alpha_1=_g1_from(z["alpha_1"]), beta_1=_g1_from(z["beta_1"]), beta_2=_g2_from(z["beta_2"]),
            delta_1=_g1_from(z["delta_1"]), delta_2=_g2_from(z["delta_2"]), **arrays,
        )
        vk = VerifyingKey(n_public=n_public, alpha_1=dpk.alpha_1, beta_2=dpk.beta_2,
                          gamma_2=_g2_from(z["vk_gamma_2"]), delta_2=dpk.delta_2,
                          ic=[_g1_from(p) for p in z["vk_ic"]])
    return dpk, vk
