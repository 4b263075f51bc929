// Error text for the codes the kernels' C entry points return.
#include "common.cuh"

extern "C" const char* kmers_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
