// The fp32 (3xTF32) builds of the tensor-core tau KPConv (kpconv_tau_mma.cuh),
// kernels #7 and #6 at every padded width: a source of their own, so that
// nvcc compiles them in a process beside the bf16 builds (kpconv_tau.cu).

#include "kpconv_tau_mma.cuh"

int cofii2p::tau_launch_f32(const TauArgs& a) { return launch_tau_widths<true>(a); }
