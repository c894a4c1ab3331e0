// FP32 peak calibration for Hopper (sm_90a): eight independent chains of
// the chaotic logistic map x <- 3.9·x·(1−x) per element, T iterations.
//
// Replaces the TPU kernel tools/bench_mfu.py::vpu_peak_flops (its
// pl.pallas_call); the plain torch version it is held to, bitwise, is
// bio_ik_tpu_torch/kernels/peak.py::peak_chains_plain.
//
// The input is (R, WG) floats, one thread per element.  Chain k starts at
// x·(1 − 0.01·k); after T iterations the eight chains are summed in chain
// order.  The output is (R, W): the TPU kernel's grid of WG/W column blocks
// all wrote the same (R, W) tile, so it holds the last block's sums — here
// the threads of the last W columns store theirs (other threads store only
// a NaN sum, which a chain in [0, 1] never makes: the test keeps the
// compiler from dropping their work).
//
// What bounds it: operations.  Each iteration is a multiply, a subtract and
// a multiply — 3 FLOPs in 3 instructions, not fused (__fmul_rn/__fsub_rn):
// the map is chaotic, so a contraction into FMA would change the last bit
// and the chains would part from the plain version within ~100
// iterations.  Unfused, one FP32 instruction per FLOP reaches at most half
// the FMA-counted 67 TFLOP/s of the H100 SXM data sheet.  Eight
// independent chains per thread hide the FP32 pipeline latency.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define PEAK_BLOCK 256
#define CHAINS 8

__global__ void __launch_bounds__(PEAK_BLOCK)
peak_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int WG,
            int W, int T) {
  const long long i = (long long)blockIdx.x * PEAK_BLOCK + threadIdx.x;
  if (i >= (long long)R * WG) return;
  const float x0 = x[i];
  float xs[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) xs[k] = __fmul_rn(x0, (float)(1.0 - 0.01 * k));
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      xs[k] = __fmul_rn(__fmul_rn(3.9f, xs[k]), __fsub_rn(1.0f, xs[k]));
  }
  float acc = xs[0];
#pragma unroll
  for (int k = 1; k < CHAINS; ++k) acc = __fadd_rn(acc, xs[k]);
  const int r = (int)(i / WG), c = (int)(i % WG);
  if (c >= WG - W || acc != acc) out[(size_t)r * W + (c % W)] = acc;
}

extern "C" int peak_launch(const float* x, float* out, int R, int WG, int W,
                           int T, void* stream) {
  if (R <= 0 || W <= 0 || WG < W || WG % W || T < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * WG;
  dim3 grid((unsigned)((n + PEAK_BLOCK - 1) / PEAK_BLOCK)), block(PEAK_BLOCK);
  peak_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, R, WG, W, T);
  return (int)cudaGetLastError();
}
