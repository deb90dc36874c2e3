// Shared helpers of the port's CUDA kernels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
// (kernels/build.py).  Every C entry point takes device pointers and the
// CUDA stream as void*, launches on that stream without synchronising, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  -fmad=false keeps every a*b+c as two IEEE-rounded operations, as
// PyTorch's eager elementwise ops compute them: the kernels then gate radii
// and pick SHOT bins on the same float values as their plain twins.
#pragma once

#include <cuda_runtime.h>

#define PCD_EXPORT extern "C" __attribute__((visibility("default")))

static inline int pcd_last_error() { return (int)cudaGetLastError(); }
