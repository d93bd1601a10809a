// The paged-attention library of the default builds: the decode and window
// kernels at split_keys kSplit and the tile kernel at (kSplit, kTileKeys).
// The kernels and the C interface are paged_attention.cuh's; the other
// builds are paged_attention_wide.cu's and paged_attention_tiles.cu's,
// libraries of their own that nvcc builds beside this one.
#define PAGED_ATTENTION_BUILDS 0
#include "paged_attention.cuh"
