"""BN254 curve and field constants.

Numeric facts mirror the reference's type aliases (reference:
rln/src/circuit/mod.rs:88-124 — ark-bn254 Fr/Fq/G1/G2) but everything here is
derived from the published BN254 parameters, expressed as plain Python ints.

Fr = scalar field (circuit field), Fq = base field of the curve.
"""

# BN254 (alt_bn128) parameter x
BN_X = 4965661367192848881

# Base field modulus q = 36x^4 + 36x^3 + 24x^2 + 6x + 1
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Scalar field modulus r = 36x^4 + 36x^3 + 18x^2 + 6x + 1
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Montgomery radix used by the limb kernels and by arkworks (4x64-bit limbs)
MONT_BITS = 256
MONT_R = 1 << MONT_BITS

# Montgomery constants for Fr
FR_R_MOD = MONT_R % R
FR_R2_MOD = (MONT_R * MONT_R) % R
FR_NINV = (-pow(R, -1, MONT_R)) % MONT_R  # -r^{-1} mod 2^256

# Montgomery constants for Fq
FQ_R_MOD = MONT_R % Q
FQ_R2_MOD = (MONT_R * MONT_R) % Q
FQ_NINV = (-pow(Q, -1, MONT_R)) % MONT_R

# Two-adicity of Fr: r - 1 = 2^28 * t
FR_TWO_ADICITY = 28
FR_TWO_ADIC_T = (R - 1) >> FR_TWO_ADICITY
# Smallest generator of the multiplicative group of Fr (matches ark-bn254: 5)
FR_GENERATOR = 5
# 2^28-th primitive root of unity in Fr (ark-bn254 TWO_ADIC_ROOT_OF_UNITY)
FR_TWO_ADIC_ROOT = pow(FR_GENERATOR, FR_TWO_ADIC_T, R)

# G1 generator (x, y) = (1, 2)
G1_GEN = (1, 2)

# G2 generator over Fq2 = Fq[u]/(u^2 + 1); coordinates (c0, c1)
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# Curve equations: G1: y^2 = x^3 + 3; G2: y^2 = x^3 + 3/(u+9)
B_G1 = 3
# b2 = 3 / (9 + u) in Fq2
_B2_DEN_INV_C0 = pow(9 * 9 + 1, -1, Q)
B_G2 = (
    3 * 9 * _B2_DEN_INV_C0 % Q,
    (-3 * _B2_DEN_INV_C0) % Q,
)

# Serialization sizes (reference: rln/src/protocol/serialize.rs:37-50)
FR_BYTE_SIZE = 32
FR_LIMB_BYTE_SIZE = 8
VEC_LEN_BYTE_SIZE = 8
VERSION_BYTE_SIZE = 1
COMPRESS_PROOF_SIZE = 128  # reference: rln/src/circuit/mod.rs:82

# Protocol defaults (reference: rln/src/circuit/mod.rs:80-81)
DEFAULT_TREE_DEPTH = 20
DEFAULT_MAX_OUT = 4

# Limb layout for device kernels: 16 limbs x 16 bits, little-endian limb order
NUM_LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
