// The paged-attention library of the tile kernel at every (split_keys,
// chunk_keys) pair but the default (paged_attention.cuh).
#define PAGED_ATTENTION_BUILDS 2
#include "paged_attention.cuh"
