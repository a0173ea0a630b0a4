"""Groth16 Solidity verifier export (`snarkjs zkey export solidityverifier`).

Emits the same shape as `contracts/Verifier.sol` (Pairing lib over
precompiles 6/7/8, hardcoded vkey, `verifyProof(a, b, c, uint[N] input)`
`Verifier.sol:360-380`) with pragma ^0.8.12 already applied — the job of
`scripts/bump-solidity.js:1-7` folded in.  `Ramp is Verifier` inherits
this contract unchanged, so swapping the proving backend to TPU leaves
the chain side untouched (the whole point of wire compatibility).
"""

from __future__ import annotations

from ..snark.groth16 import VerifyingKey

_TEMPLATE = """// SPDX-License-Identifier: GPL-3.0
/*
    Groth16 verifier generated by zkp2p_tpu.formats.solidity
    (snarkjs solidityverifier-compatible; vkey baked below).
*/
pragma solidity ^0.8.12;

library Pairing {{
    struct G1Point {{ uint X; uint Y; }}
    struct G2Point {{ uint[2] X; uint[2] Y; }}

    function P1() internal pure returns (G1Point memory) {{ return G1Point(1, 2); }}

    function negate(G1Point memory p) internal pure returns (G1Point memory r) {{
        uint q = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
        if (p.X == 0 && p.Y == 0) return G1Point(0, 0);
        return G1Point(p.X, q - (p.Y % q));
    }}

    function addition(G1Point memory p1, G1Point memory p2) internal view returns (G1Point memory r) {{
        uint[4] memory input;
        input[0] = p1.X; input[1] = p1.Y; input[2] = p2.X; input[3] = p2.Y;
        bool success;
        assembly {{ success := staticcall(sub(gas(), 2000), 6, input, 0xc0, r, 0x60) }}
        require(success, "pairing-add-failed");
    }}

    function scalar_mul(G1Point memory p, uint s) internal view returns (G1Point memory r) {{
        uint[3] memory input;
        input[0] = p.X; input[1] = p.Y; input[2] = s;
        bool success;
        assembly {{ success := staticcall(sub(gas(), 2000), 7, input, 0x80, r, 0x60) }}
        require(success, "pairing-mul-failed");
    }}

    function pairing(G1Point[] memory p1, G2Point[] memory p2) internal view returns (bool) {{
        require(p1.length == p2.length, "pairing-lengths-failed");
        uint elements = p1.length;
        uint inputSize = elements * 6;
        uint[] memory input = new uint[](inputSize);
        for (uint i = 0; i < elements; i++) {{
            input[i * 6 + 0] = p1[i].X;
            input[i * 6 + 1] = p1[i].Y;
            input[i * 6 + 2] = p2[i].X[0];
            input[i * 6 + 3] = p2[i].X[1];
            input[i * 6 + 4] = p2[i].Y[0];
            input[i * 6 + 5] = p2[i].Y[1];
        }}
        uint[1] memory out;
        bool success;
        assembly {{ success := staticcall(sub(gas(), 2000), 8, add(input, 0x20), mul(inputSize, 0x20), out, 0x20) }}
        require(success, "pairing-opcode-failed");
        return out[0] != 0;
    }}

    function pairingProd4(
        G1Point memory a1, G2Point memory a2,
        G1Point memory b1, G2Point memory b2,
        G1Point memory c1, G2Point memory c2,
        G1Point memory d1, G2Point memory d2
    ) internal view returns (bool) {{
        G1Point[] memory p1 = new G1Point[](4);
        G2Point[] memory p2 = new G2Point[](4);
        p1[0] = a1; p1[1] = b1; p1[2] = c1; p1[3] = d1;
        p2[0] = a2; p2[1] = b2; p2[2] = c2; p2[3] = d2;
        return pairing(p1, p2);
    }}
}}

contract Verifier {{
    using Pairing for *;
    struct VerifyingKey {{
        Pairing.G1Point alfa1;
        Pairing.G2Point beta2;
        Pairing.G2Point gamma2;
        Pairing.G2Point delta2;
        Pairing.G1Point[] IC;
    }}
    struct Proof {{
        Pairing.G1Point A;
        Pairing.G2Point B;
        Pairing.G1Point C;
    }}

    function verifyingKey() internal pure returns (VerifyingKey memory vk) {{
        vk.alfa1 = Pairing.G1Point({alpha_x}, {alpha_y});
        vk.beta2 = Pairing.G2Point([{beta_x1}, {beta_x0}], [{beta_y1}, {beta_y0}]);
        vk.gamma2 = Pairing.G2Point([{gamma_x1}, {gamma_x0}], [{gamma_y1}, {gamma_y0}]);
        vk.delta2 = Pairing.G2Point([{delta_x1}, {delta_x0}], [{delta_y1}, {delta_y0}]);
        vk.IC = new Pairing.G1Point[]({n_ic});
{ic_lines}
    }}

    function verify(uint[] memory input, Proof memory proof) internal view returns (uint) {{
        uint snark_scalar_field = 21888242871839275222246405745257275088548364400416034343698204186575808495617;
        VerifyingKey memory vk = verifyingKey();
        require(input.length + 1 == vk.IC.length, "verifier-bad-input");
        Pairing.G1Point memory vk_x = Pairing.G1Point(0, 0);
        for (uint i = 0; i < input.length; i++) {{
            require(input[i] < snark_scalar_field, "verifier-gte-snark-scalar-field");
            vk_x = Pairing.addition(vk_x, Pairing.scalar_mul(vk.IC[i + 1], input[i]));
        }}
        vk_x = Pairing.addition(vk_x, vk.IC[0]);
        if (!Pairing.pairingProd4(
            Pairing.negate(proof.A), proof.B,
            vk.alfa1, vk.beta2,
            vk_x, vk.gamma2,
            proof.C, vk.delta2
        )) return 1;
        return 0;
    }}

    /// @return r  bool true if proof is valid
    function verifyProof(
        uint[2] memory a,
        uint[2][2] memory b,
        uint[2] memory c,
        uint[{n_pub}] memory input
    ) public view returns (bool r) {{
        Proof memory proof;
        proof.A = Pairing.G1Point(a[0], a[1]);
        proof.B = Pairing.G2Point([b[0][0], b[0][1]], [b[1][0], b[1][1]]);
        proof.C = Pairing.G1Point(c[0], c[1]);
        uint[] memory inputValues = new uint[](input.length);
        for (uint i = 0; i < input.length; i++) {{
            inputValues[i] = input[i];
        }}
        if (verify(inputValues, proof) == 0) {{
            return true;
        }} else {{
            return false;
        }}
    }}
}}
"""


def export_verifier(vk: VerifyingKey) -> str:
    ic_lines = "\n".join(
        f"        vk.IC[{i}] = Pairing.G1Point({pt[0]}, {pt[1]});" for i, pt in enumerate(vk.ic)
    )
    bx, by = vk.beta_2
    gx, gy = vk.gamma_2
    dx, dy = vk.delta_2
    return _TEMPLATE.format(
        alpha_x=vk.alpha_1[0], alpha_y=vk.alpha_1[1],
        beta_x0=bx.c0, beta_x1=bx.c1, beta_y0=by.c0, beta_y1=by.c1,
        gamma_x0=gx.c0, gamma_x1=gx.c1, gamma_y0=gy.c0, gamma_y1=gy.c1,
        delta_x0=dx.c0, delta_x1=dx.c1, delta_y0=dy.c0, delta_y1=dy.c1,
        n_ic=len(vk.ic),
        ic_lines=ic_lines,
        n_pub=vk.n_public,
    )
