"""Published peaks of one NVIDIA H100 SXM5 (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit). A card set below 700 W
runs slower under load: the result line carries the card's ``power.limit``
beside every share of a peak."""

BF16_FLOPS = 989e12  # dense bf16 / fp16 tensor-core FLOP/s
HBM_BYTES = 3.35e12  # HBM3 bytes/s
F32_FLOPS = 67e12  # f32 outside the tensor cores
