// Joint-space secondary fitness and its gradient over the packed `sec`
// rows, shared by csrc/megastep.cu and csrc/species.cu.
//
// The port of bio_ik_tpu/kernels/bio2_step.py::make_sec_eval; the plain
// torch version is bio_ik_tpu_torch/kernels/bio2_step.py::make_sec_eval, and
// these functions repeat its operations in its order, each rounded on its
// own (__fmul_rn/__fadd_rn/__fsub_rn: no contraction into FMA, whatever the
// build flags), so a kernel built with -fmad=true (megastep.cu) gets the
// same secondary fitness as the plain version, bit for bit, from the same
// inputs: the pre-selection ranks children by these sums, and a last-bit
// difference would flip near-ties.
//
// `sec` is the (8·V, N) per-lane const of engine._secondary_rows, row
// r·V + v for row name r in SEC_ROWS order (alpha, beta, gamma, delta, tbar,
// mid, hspan, seed):
//   sec(x) = Σ_v α(x−mid)² + β(x−seed)² + δ(x−tbar)² + γ·relu(2|x−mid|−hspan)²
// `mask` holds bit i for the i-th of alpha, beta, gamma, delta
// (bio2_step.sec_term_mask).  `S(r, v)` reads row r·V + v of the lane:
// SecRows from global memory where it is used (one coalesced load each,
// lanes contiguous; csrc/species.cu), or a copy in shared memory
// (csrc/megastep.cu).

#pragma once

enum { SEC_ALPHA = 0, SEC_BETA = 1, SEC_GAMMA = 2, SEC_DELTA = 3, SEC_TBAR = 4,
       SEC_MID = 5, SEC_HSPAN = 6, SEC_SEED = 7 };
enum { SECM_ALPHA = 1, SECM_BETA = 2, SECM_GAMMA = 4, SECM_DELTA = 8 };

struct SecRows {
  const float* p;   // the lane's element of row 0
  size_t N;
  int V;
  __device__ __forceinline__ float operator()(int r, int v) const {
    return p[(size_t)(r * V + v) * N];   // a lane-uniform offset
  }
};

// Σ_v of the terms in `mask`: per variable alpha, beta, delta, then gamma.
template <int V, typename Rows>
__device__ __forceinline__ float sec_of(const Rows& S, unsigned mask,
                                        const float (&x)[V]) {
  float acc = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float xm = __fsub_rn(x[v], S(SEC_MID, v));
    if (mask & SECM_ALPHA) acc = __fadd_rn(acc, __fmul_rn(S(SEC_ALPHA, v), __fmul_rn(xm, xm)));
    if (mask & SECM_BETA) {
      const float e = __fsub_rn(x[v], S(SEC_SEED, v));
      acc = __fadd_rn(acc, __fmul_rn(S(SEC_BETA, v), __fmul_rn(e, e)));
    }
    if (mask & SECM_DELTA) {
      const float e = __fsub_rn(x[v], S(SEC_TBAR, v));
      acc = __fadd_rn(acc, __fmul_rn(S(SEC_DELTA, v), __fmul_rn(e, e)));
    }
    if (mask & SECM_GAMMA) {
      const float r = fmaxf(__fsub_rn(__fmul_rn(2.0f, fabsf(xm)), S(SEC_HSPAN, v)), 0.0f);
      acc = __fadd_rn(acc, __fmul_rn(S(SEC_GAMMA, v), __fmul_rn(r, r)));
    }
  }
  return acc;
}

// ∂sec/∂x_v.
template <int V, typename Rows>
__device__ __forceinline__ float sec_grad(const Rows& S, unsigned mask,
                                          const float (&x)[V], int v) {
  const float xm = __fsub_rn(x[v], S(SEC_MID, v));
  float g = 0.0f;
  if (mask & SECM_ALPHA) g = __fadd_rn(g, __fmul_rn(__fmul_rn(2.0f, S(SEC_ALPHA, v)), xm));
  if (mask & SECM_BETA)
    g = __fadd_rn(g, __fmul_rn(__fmul_rn(2.0f, S(SEC_BETA, v)),
                               __fsub_rn(x[v], S(SEC_SEED, v))));
  if (mask & SECM_DELTA)
    g = __fadd_rn(g, __fmul_rn(__fmul_rn(2.0f, S(SEC_DELTA, v)),
                               __fsub_rn(x[v], S(SEC_TBAR, v))));
  if (mask & SECM_GAMMA) {
    const float r = fmaxf(__fsub_rn(__fmul_rn(2.0f, fabsf(xm)), S(SEC_HSPAN, v)), 0.0f);
    const float sgn = (xm >= 0.0f) ? 1.0f : -1.0f;
    g = __fadd_rn(g, __fmul_rn(__fmul_rn(__fmul_rn(4.0f, S(SEC_GAMMA, v)), r), sgn));
  }
  return g;
}

// Children kept by the pre-selection of one generation (reference
// ik_evolution_2.cpp:366-378): child c's rank is the number of children
// j with s_j < s_c, or s_j == s_c and j < c; the best int(keep·(C−1)) + 1
// survive.  `ss(j)` is child j's secondary fitness.
template <typename SS>
__device__ __forceinline__ bool sec_keep(const SS& ss, int C, int c, int kcount) {
  const float sc = ss(c);
  int rank = 0;
  for (int j = 0; j < C; ++j) {
    const float sj = ss(j);
    rank += (sj < sc) || (sj == sc && j < c);
  }
  return rank < kcount;
}

__device__ __forceinline__ int sec_kcount(float keep_u, int C) {
  return (int)(keep_u * (float)(C - 1)) + 1;
}
