// The wide attention kernels at dh 32 (attention_wide.cuh has the kernels,
// what they replace, their bound and their design): the forward, the row
// pass and the key pass, each plain, [dropout], [qknorm] and both.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a).

#include "attention_wide.cuh"

VIT_ATTN_WIDE_DEFINE(32)
