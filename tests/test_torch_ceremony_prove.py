"""The point of phase 2, through the port on the CPU: the key the
reference's test world ends its ceremony with (built as in
test_torch_ceremony.py) still proves under the port's prove_gpu; the
proof verifies against the final key's verification key and is rejected
by the initial one's (each read by read_zkey_vk, the same as read_zkey's)."""

import torch

from test_torch_ceremony import build_world
from zkp2p_tpu_torch.formats.zkey import read_zkey, read_zkey_vk
from zkp2p_tpu_torch.prover.groth16_gpu import device_pk_from_zkey, prove_gpu
from zkp2p_tpu_torch.snark.groth16 import verify

torch.set_num_threads(1)


def test_final_key_still_proves(tmp_path):
    (cs, x, y), z0, _, _, zf = build_world(tmp_path)
    zd = read_zkey(zf)
    key = device_pk_from_zkey(zd, device="cpu")
    w = cs.witness([1849], {x: 43, y: 1})
    proof = prove_gpu(key, w, device="cpu")
    vk = read_zkey_vk(zf)  # the header and IC alone
    assert vk == zd.to_verifying_key()
    assert verify(vk, proof, [1849])
    assert not verify(read_zkey_vk(z0), proof, [1849])
