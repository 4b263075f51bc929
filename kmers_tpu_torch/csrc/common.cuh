// Shared definitions of the port's kernels (register convention of
// kmers_tpu_torch/convert.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// register of an invalid window: INT64_MAX sorts after every real register
#define KMERS_SENTINEL 0x7FFFFFFFFFFFFFFFLL
