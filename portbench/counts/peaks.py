"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A run reports the
card's power limit beside the shares taken against them."""

BF16_FLOPS = 989e12          # tensor cores, bf16 / fp16
F32_FLOPS = 67e12            # float32 outside the tensor cores
HBM_BYTES = 3.35e12          # HBM3, bytes a second
