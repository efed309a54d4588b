// The fp32 (3xTF32) builds of kernel #1 (kpconv_mma.cuh) at every padded
// width pair: a source of their own, so that nvcc compiles them in a
// process beside the bf16 builds (kpconv_fused.cu).

#include "kpconv_mma.cuh"

int cofii2p::fused_launch_f32(const FusedArgs& a) { return launch_mma_widths<false, true>(a); }
