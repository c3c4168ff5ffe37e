// Flash-attention forward, dq and dk/dv kernels at head_dim 256 (bf16 and
// fp32; the Gemma family), in a library of their own so that nvcc builds
// them beside flash_attention.cu; the kernels are in flash_attention.cuh.
#define FLASH_HEAD_DIMS 256
#include "flash_attention.cuh"
