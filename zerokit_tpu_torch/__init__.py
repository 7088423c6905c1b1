"""zerokit_tpu_torch: the PyTorch + CUDA port of zerokit_tpu's proving path.

Batched RLN Groth16 proving over BN254 on an NVIDIA H100: host witness
interpreter, the QAP witness map, from_mont and the five fixed-base MSMs on
the card, then the native blinding assembly. Every kernel of that path is a
hand-written CUDA kernel under csrc/ (built with nvcc at first use); each
has a plain PyTorch version that CPU tensors take.

Field elements keep zerokit_tpu's layout at every public function: (16, ...)
limbs of 16 bits, Montgomery radix 2^256, stored as int32 tensors holding
values in [0, 2^16).

Importing this package imports no JAX and nothing from zerokit_tpu.
"""
