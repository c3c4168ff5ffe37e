// Flash-attention forward, dq and dk/dv kernels at head_dim 64 and 128
// (bf16 and fp32); the kernels are in flash_attention.cuh.
#define FLASH_HEAD_DIMS 64, 128
#include "flash_attention.cuh"
