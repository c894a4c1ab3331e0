// The megastep instances of few variables and the pose family
// (position/orientation/pose goals; bench.py's path and the regularized
// one): the lane's linearization in registers.  The step, the kernels and
// the C API are csrc/megastep.cuh; csrc/megastep_wide.cu holds the wide
// instances.  Replaces the TPU kernels bio_ik_tpu/kernels/bio2_megastep.py::
// make_megastep_kernel and bio2_fullstep.py::make_fullstep_kernel at these
// shapes.

// (V, K, T) instances, each for every group size G
#define SHAPES(X) X(7, 1, 1) X(6, 1, 1)
#define GROUPS(X, v, k, t) X(v, k, t, 1) X(v, k, t, 2) X(v, k, t, 4) X(v, k, t, 8)
#define MEGASTEP_WIDE 0

#include "megastep.cuh"

// One Philox4x32-10 call per thread, and the same kernel without it: the
// difference of their SASS is one call's instructions (chip_smoke.py's
// integer bound).  Never launched.
__global__ void philox_probe_kernel(const uint32_t* in, uint32_t* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const U4 w = philox4x32(in[4 * t], in[4 * t + 1], in[4 * t + 2], in[4 * t + 3], in[0], 0u);
  out[4 * t] = w.x; out[4 * t + 1] = w.y; out[4 * t + 2] = w.z; out[4 * t + 3] = w.w;
}

__global__ void philox_probe_base_kernel(const uint32_t* in, uint32_t* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  out[4 * t] = in[4 * t] ^ in[0]; out[4 * t + 1] = in[4 * t + 1];
  out[4 * t + 2] = in[4 * t + 2]; out[4 * t + 3] = in[4 * t + 3];
}

