// The fp32 (3xTF32) builds of kernel #16, kernel #1's tensor-core kernel in
// POOL mode (kpconv_mma.cuh), at every padded width pair: a source of their
// own, so that nvcc compiles them in a process beside the bf16 builds
// (residual_fused.cu).

#include "kpconv_mma.cuh"

int cofii2p::residual_launch_f32(const FusedArgs& a) { return launch_mma_widths<true, true>(a); }
