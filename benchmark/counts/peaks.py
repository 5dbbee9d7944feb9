"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full 700 W power limit). A share of a peak is stated with the
card's power limit beside it."""

# float32 operands on the tensor cores (TF32): the highest published rate at
# which the card takes fp32 operands. A path that runs fp32 products on the
# tensor cores in 3xTF32 can pass the 67 TFLOP/s CUDA-core rate, never this.
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12  # bf16 and fp16 operands on the tensor cores
FP32_FLOPS = 67e12  # float32 outside the tensor cores (CUDA cores)
BYTES_PER_S = 3.35e12  # HBM3
MEMORY_BYTES = 80e9

# the configuration's precision -> the tensor-core rate its products are held to
TENSOR_FLOPS = {"float32": TF32_FLOPS, "bfloat16": BF16_FLOPS}
