// The paged-attention library of the decode and window kernels at
// split_keys kSplitWide (paged_attention.cuh).
#define PAGED_ATTENTION_BUILDS 1
#include "paged_attention.cuh"
