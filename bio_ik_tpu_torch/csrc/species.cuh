// bio2 species step for Hopper (sm_90a): on a linearization given by the
// caller, `gens` generations of mutate -> quaternion renormalization ->
// linearized fitness -> select-2, then `mem_iters` memetic line-search
// iterations on parent 0, one thread per lane.
//
// Replaces the TPU kernel bio_ik_tpu/kernels/bio2_step.py::
// make_species_kernel (its pl.pallas_call), the engine's species tier for
// chains with floating or planar joints.  The plain torch version it is
// held to is bio_ik_tpu_torch/kernels/bio2_step.py::make_species_inner.
//
// Two randomness modes, as in csrc/megastep.cu (rng_mode):
//   * noise tensors — noise (gens, V, C, N), rates (gens, C, N) and, with
//     secondary goals, keeps (gens, 1, N) from the caller: the TPU kernel's
//     interface, in which the kernel is held to the JAX package's;
//   * in-kernel Philox (csrc/philox.cuh), the mode of the solve: key
//     (seed, 0), counter (lane, step, generation g, draw), the lane's salt
//     XORed into every word — the megastep's stream and mapping word for
//     word (bio2_megastep.philox_draw): child c's CLT4 Gaussians from calls
//     c·NC .. c·NC + NC − 1 (NC = ceil(3V/4), packed 24-bit fields summed
//     in integers), Box–Muller Gaussian (v, c) from call v·C + c, the C
//     rates from the 4-bit fields of call V·C and the pre-selection keep
//     from that call's last word.
//
// What bounds it on the card: issued instructions.  For the floating-base
// arm (V=10, K=1, C=16, gens=8, mem_iters=8) a lane does ~30k FLOPs (176
// linearized fitness evaluations of 14·K·V + 30·K FLOPs, one instruction
// each: see -fmad=false below) and, in Philox mode, 8 × (16·8 + 1) = 1 032
// Philox4x32-10 calls (~36 SASS instructions each once the calls' shared
// first rounds are hoisted) on 788 bytes of lane state; in noise-tensor
// mode it reads 5 632 bytes of noise and rates more.  The design:
//   * one thread per lane, lanes contiguous in every (rows, N) array, so
//     each row read is one coalesced load; parent 0, both parents' momentum
//     and the goal rows stay in registers for the whole launch;
//   * a thread's shared memory is its own column, read and written with
//     16-byte accesses (Rows: the delta rows of each (v, k) as two float4,
//     each variable's bounds and parent 1's gene as one, the generation's
//     momentum terms and best children): no bank conflicts, no block
//     synchronisation;
//   * one instance per (V, K, quaternion mask) and randomness mode, so the
//     quaternion renormalization and the draws are compiled for exactly
//     what the launch needs (a runtime mask had all 7 possible blocks
//     computed for every child);
//   * children are built, renormalized and evaluated two at a time (one
//     delta read serves both), then offered in order to a running best two
//     (strict '<' in pool order p0, p1, child 0..C-1 reproduces the
//     first-min pick of the plain version); of a child only its genes
//     before the renormalization are kept while it is among the best two,
//     and the winners' renormalized genes and momentum are recomputed from
//     them (the same operations, so the same bits);
//   * with secondary goals (SEC) each child is built once: its secondary and
//     primary fitness go to shared memory, the C secondary values are
//     ranked, the kept children offered in order, and the two winners drawn
//     again from their counters (or noise rows), together;
//   * the memetic search carries the accepted candidate's evaluation into
//     the next iteration and stops at its first non-improvement (the plain
//     version's later iterations change nothing);
//   * it is built with -fmad=false: plain IEEE multiplies and adds make the
//     kernel round as the plain version does (the plain version has no
//     transcendental function outside Box–Muller's logf/cosf), which keeps
//     the memetic line search — a quotient of differences of nearly equal
//     fitness values — on the plain version's trajectory: in noise-tensor
//     mode and under CLT4 the kernel is bitwise equal to its plain version.
// The ragged last block is masked: threads past N return at once (the
// kernel has no warp- or block-level exchange).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC -fmad=false (kernels/build.py).
//
// The step, its kernels and their C API, over the (V, K, quaternion mask)
// instances of the including source: csrc/species.cu (the floating-base
// free_arm and the planar_arm), or a source that kernels/bio2_step.py
// generates for another shape on its first use.  Each defines SHAPES(X)
// before including this header.

#pragma once

#ifndef SHAPES
#error "define SHAPES(X) before including species.cuh"
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "sec_eval.cuh"

#define BLOCK 128
#define MAX_C 16   // children per generation (4-bit rate fields of one call)
// Resident blocks per SM the register budget is held to: 2 (255
// registers); at 3 (168) the V = 10 instance spills and runs slower.
constexpr int MIN_BLOCKS = 2;

enum { RNG_TENSORS = 0, RNG_CLT4 = 1, RNG_BOX_MULLER = 2 };
enum { H_P0 = -2, H_P1 = -1 };   // handles of the two parents in the selection

struct SParams {
  int N, gens, C, mem_iters, memetic, rng_mode, step;
  float h;
  uint32_t sec_mask, seed;
  const int* salt;
  const float *genes, *grads, *tips0, *deltas, *gpos, *gquat, *wpos, *wrot;
  const float *span, *cmin, *cmax, *noise, *rates, *keeps, *sec;
  float *genes_o, *grads_o;
};

template <int K>
struct Goals {
  float base[K][7];   // tip components of each goal instance at x0
  float gpos[K][3], gquat[K][4], wpos[K], wrot[K];
};

// This thread's column of the block's shared memory.  Vector rows (float4,
// read with one 16-byte load, row i at q[i·BLOCK]): the delta rows of each
// (v, k) as two float4 (tip components 0-3, 4-6 and a pad), the bounds of
// each variable (span, cmin, cmax and parent 1's gene), the generation's
// momentum term of each child class and, without SEC, two slots for the
// genes of the generation's best children.  Scalar rows (row r at
// s[r·BLOCK]): with SEC, the children's secondary and primary fitness.
// The classes are the reference child index cg mod 6 (parity and cg mod 3:
// the shift times cg mod 3 is stored) or, with SEC, whose shared memory
// holds the children's fitness instead, the parity alone (the shift,
// multiplied by cg mod 3 at each child; the same operations either way).
template <int V, int K, bool SEC>
struct Rows {
  static constexpr int NV4 = (V + 3) / 4;              // float4 per gene vector
  static constexpr int NCLS = SEC ? 2 : 6;             // momentum classes
  static constexpr int QD = 0, QB = QD + 2 * V * K, QP = QB + V, QL = QP + NCLS * NV4;
  static constexpr int Q = QL + (SEC ? 0 : 2 * NV4);    // vector rows in all
  float4* q;
  float* s;
  __device__ __forceinline__ float4 delta(int v, int k, int h) const {
    return q[(QD + (v * K + k) * 2 + h) * BLOCK];
  }
  __device__ __forceinline__ float4& bounds(int v) const { return q[(QB + v) * BLOCK]; }
  __device__ __forceinline__ float4* momentum(int cls) const {
    return q + (QP + cls * NV4) * BLOCK;
  }
  __device__ __forceinline__ float4* lb(int slot) const { return q + (QL + slot * NV4) * BLOCK; }
  __device__ __forceinline__ float& kid(int r) const { return s[r * BLOCK]; }
};

// A gene vector to and from NV4 vector rows starting at p (stride BLOCK).
template <int V>
__device__ __forceinline__ void store_vec(float4* p, const float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < (V + 3) / 4; ++j) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = 4 * j + i < V ? x[4 * j + i] : 0.0f;
    p[j * BLOCK] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const float4* p, float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < (V + 3) / 4; ++j) {
    const float4 u = p[j * BLOCK];
    const float e[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * j + i < V) x[4 * j + i] = e[i];
  }
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Pose-family fitness of linearized tip components ph (bio2_step.
// make_species_inner: fitness_rows; the same operation order).
template <int K>
__device__ __forceinline__ float fitness_ph(const float (&ph)[K][7], const Goals<K>& G) {
  float fit = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float perr = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float e = ph[k][c] - G.gpos[k][c];
      perr = perr + e * e;
    }
    float dm = 0.0f, dp = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float q = ph[k][3 + c], g = G.gquat[k][c];
      dm = dm + (q - g) * (q - g);
      dp = dp + (q + g) * (q + g);
    }
    const float term = G.wpos[k] * perr + G.wrot[k] * fminf(dm, dp);
    fit = (k == 0) ? term : fit + term;
  }
  return fit;
}

// Linearized phenotypes ph[m] = tips0 + Σ_v deltas_v·(x[m]_v − x0_v) of M
// gene vectors (each component summed in v order, bio2_step.
// make_species_inner: phen) and their fitness.  The M vectors share each
// delta read from shared memory, the kernel's main shared-memory traffic.
template <int V, int K, int M, typename RowsT>
__device__ __forceinline__ void eval_lin(const RowsT& R, const Goals<K>& G,
                                         const float (*x)[V], const float (&x0)[V],
                                         float* fit, float (&ph)[M][K][7]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < 7; ++c) ph[m][k][c] = G.base[k][c];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float dq[M];
#pragma unroll
    for (int m = 0; m < M; ++m) dq[m] = x[m][v] - x0[v];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 a = R.delta(v, k, 0), b = R.delta(v, k, 1);
      const float d[7] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
#pragma unroll
      for (int c = 0; c < 7; ++c)
#pragma unroll
        for (int m = 0; m < M; ++m) ph[m][k][c] = ph[m][k][c] + d[c] * dq[m];
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) fit[m] = fitness_ph<K>(ph[m], G);
}

// The fitness of M gene vectors, phenotypes discarded.
template <int V, int K, int M, typename RowsT>
__device__ __forceinline__ void eval_fit(const RowsT& R, const Goals<K>& G,
                                         const float (*x)[V], const float (&x0)[V],
                                         float* fit) {
  float ph[M][K][7];
  eval_lin<V, K, M>(R, G, x, x0, fit, ph);
}

// Genes of children cs[0 .. M−1] of generation g before the quaternion
// renormalization: their noise drawn (clt4: Philox counters (lane, step, g,
// c·NC + k), the salt applied to the 24-bit fields as it would be to the
// words, `srot`; Box–Muller: (lane, step, g, v·C + c)) or read, mutated at
// rate[m], shifted by the momentum term of their class (the generation's
// `pgf` rows) and clipped (reference :263-299); a variable's bounds are read
// once for the M children.
template <int V, int K, int RNG, int M, typename RowsT>
__device__ __forceinline__ void children_raw(const SParams& P, const RowsT& R, int n,
                                             uint32_t salt, const uint32_t (&srot)[4], int g,
                                             const int (&cs)[M], const float (&rate)[M],
                                             const float (&p0g)[V], float (*raw)[V]) {
  const size_t N = P.N;
  const int C = P.C;
  constexpr int NC = clt4_calls<V>();
  float pgf[M][V];
  uint32_t w[M][4 * NC];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int cg = cs[m] + 2;      // the reference's child index
    load_vec<V>(R.momentum(cg % RowsT::NCLS), pgf[m]);
    if constexpr (RowsT::NCLS == 2) {
#pragma unroll
      for (int v = 0; v < V; ++v) pgf[m][v] = pgf[m][v] * (float)(cg % 3);
    }
    if constexpr (RNG == RNG_CLT4) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const U4 u = philox4x32(n, P.step, g, cs[m] * NC + k, P.seed, 0u);
        w[m][4 * k] = u.x; w[m][4 * k + 1] = u.y; w[m][4 * k + 2] = u.z; w[m][4 * k + 3] = u.w;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4 bd = R.bounds(v);   // span, cmin, cmax
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = cs[m];
      float nz;
      if constexpr (RNG == RNG_TENSORS) {
        nz = P.noise[(((size_t)g * V + v) * C + c) * N + n];
      } else if constexpr (RNG == RNG_CLT4) {
        // clt4 with the power-of-two scale moved past the subtraction:
        // (fl(S)·2^-24 − 2)·√3 and (fl(S) − 2^25)·(√3·2^-24) round alike
        const uint32_t sum = field24_salted(w[m], 4 * v, srot)
                           + field24_salted(w[m], 4 * v + 1, srot)
                           + field24_salted(w[m], 4 * v + 2, srot)
                           + field24_salted(w[m], 4 * v + 3, srot);
        nz = ((float)sum - 33554432.0f) * (1.7320508f / 16777216.0f);
      } else {
        const U4 u = salted(philox4x32(n, P.step, g, v * C + c, P.seed, 0u), salt);
        const float a = u01(u.x, 2.98023224e-08f);
        const float b = u01(u.y, 0.0f);
        nz = sqrtf(-2.0f * logf(a)) * cosf(6.28318548f * b);
      }
      const float gv = p0g[v] + nz * (rate[m] * bd.x) + pgf[m][v];
      raw[m][v] = clampf(gv, bd.y, bd.z);
    }
  }
}

// One Newton step of each quaternion block toward unit norm (reference
// :320-324, normalizeFast, frame.h:231-238), on a copy; bit s of QMASK: a
// block starts at gene s.
template <int V, uint32_t QMASK>
__device__ __forceinline__ void renorm(const float (&raw)[V], float (&x)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = raw[v];
#pragma unroll
  for (int s = 0; s + 4 <= V; ++s) {
    if ((QMASK >> s) & 1u) {
      const float n2 = raw[s] * raw[s] + raw[s + 1] * raw[s + 1]
                     + raw[s + 2] * raw[s + 2] + raw[s + 3] * raw[s + 3];
      const float fn = (3.0f - n2) * 0.5f;
#pragma unroll
      for (int d = 0; d < 4; ++d) x[s + d] = raw[s + d] * fn;
    }
  }
}

// The momentum shift p0r·(1 − fmix) + p1r·fmix of a child of reference
// index cg (fmix 0.2 for even cg, else 0).
__device__ __forceinline__ float momentum_shift(int cg, float p0r, float p1r) {
  const float fmix = (cg % 2 == 0) ? 0.2f : 0.0f;
  return p0r * (1.0f - fmix) + p1r * fmix;
}

// Running best two on strict '<', offered in pool order; ties keep the
// earlier one.
__device__ __forceinline__ void offer(float f, int c, float& f1, int& h1, float& f2, int& h2) {
  if (f < f1) { f2 = f1; h2 = h1; f1 = f; h1 = c; }
  else if (f < f2) { f2 = f; h2 = c; }
}

template <int V, int K, uint32_t QMASK, bool SEC, int RNG>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
species_kernel(const SParams P) {
  extern __shared__ float4 smem[];
  using RowsT = Rows<V, K, SEC>;
  const int t = threadIdx.x;
  const int n = blockIdx.x * BLOCK + t;
  if (n >= P.N) return;
  const size_t N = P.N;
  const RowsT R{smem + t, reinterpret_cast<float*>(smem + RowsT::Q * BLOCK) + t};

#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* d = P.deltas + ((size_t)(v * K + k) * 7) * N + n;
      R.q[(RowsT::QD + (v * K + k) * 2) * BLOCK] = make_float4(d[0], d[N], d[2 * N], d[3 * N]);
      R.q[(RowsT::QD + (v * K + k) * 2 + 1) * BLOCK] =
          make_float4(d[4 * N], d[5 * N], d[6 * N], 0.0f);
    }
  Goals<K> G;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 7; ++c) G.base[k][c] = P.tips0[(k * 7 + c) * N + n];
#pragma unroll
    for (int c = 0; c < 3; ++c) G.gpos[k][c] = P.gpos[(k * 3 + c) * N + n];
#pragma unroll
    for (int c = 0; c < 4; ++c) G.gquat[k][c] = P.gquat[(k * 4 + c) * N + n];
    G.wpos[k] = P.wpos[k * N + n];
    G.wrot[k] = P.wrot[k * N + n];
  }
  float p0g[V], p0r[V], p1r[V], x0[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p0g[v] = P.genes[v * N + n];
    p0r[v] = P.grads[v * N + n];
    p1r[v] = P.grads[(V + v) * N + n];
    x0[v] = p0g[v];   // the linearization point: parent 0 at entry
    R.bounds(v) = make_float4(P.span[v * N + n], P.cmin[v * N + n], P.cmax[v * N + n],
                              P.genes[(V + v) * N + n]);
  }
  const int C = P.C;
  constexpr bool tensors = RNG == RNG_TENSORS;
  const uint32_t salt = tensors ? 0u : (uint32_t)P.salt[n];
  // the salt as each 24-bit field offset sees it (field24_salted)
  uint32_t srot[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) srot[i] = __funnelshift_r(salt, salt, 8 * i) & 0xFFFFFFu;
  const SecRows S{P.sec + n, N, V};

  // ---- generations (reference ik_evolution_2.cpp:349-431) ----
  float f_p[2];   // the parents' fitness
  {
    float par[2][V];
#pragma unroll
    for (int v = 0; v < V; ++v) { par[0][v] = p0g[v]; par[1][v] = R.bounds(v).w; }
    eval_fit<V, K, 2>(R, G, par, x0, f_p);
  }
  for (int g = 0; g < P.gens; ++g) {
    U4 rw = {0u, 0u, 0u, 0u};   // the generation's rate call
    if constexpr (!tensors) rw = salted(philox4x32(n, P.step, g, V * C, P.seed, 0u), salt);
    auto rate = [&](int c) {
      return tensors ? P.rates[((size_t)g * C + c) * N + n] : rate_of_field(rw, c);
    };
    // the momentum term of each child class (Rows): the shift of each
    // parity, then for cg mod 6 that times cg mod 3
#pragma unroll
    for (int parity = 0; parity < 2; ++parity) {
      float pg[V], pgf[V];
#pragma unroll
      for (int v = 0; v < V; ++v) pg[v] = momentum_shift(parity, p0r[v], p1r[v]);
#pragma unroll
      for (int cls = parity; cls < RowsT::NCLS; cls += 2) {
#pragma unroll
        for (int v = 0; v < V; ++v) pgf[v] = RowsT::NCLS == 6 ? pg[v] * (float)(cls % 3) : pg[v];
        store_vec<V>(R.momentum(cls), pgf);
      }
    }
    const bool sw = f_p[1] < f_p[0];
    float f1 = sw ? f_p[1] : f_p[0], f2 = sw ? f_p[0] : f_p[1];
    int h1 = sw ? H_P1 : H_P0, h2 = sw ? H_P0 : H_P1;
    // genes before renormalization of the child winners
    float lb[2][V];
    // children two at a time (the last one alone when C is odd): built,
    // renormalized, evaluated together, offered in order
    if constexpr (!SEC) {
      // the best two children's genes in the shared slots s1, s2: a new
      // best takes the slot of the old second
      int s1 = 0, s2 = 1;
      for (int c = 0; c < C; c += 2) {
        const int c2 = min(c + 1, C - 1);
        const int cs[2] = {c, c2};
        const float rt[2] = {rate(c), rate(c2)};
        float raw[2][V], cgn[2][V], f[2];
        children_raw<V, K, RNG, 2>(P, R, n, salt, srot, g, cs, rt, p0g, raw);
        renorm<V, QMASK>(raw[0], cgn[0]);
        renorm<V, QMASK>(raw[1], cgn[1]);
        eval_fit<V, K, 2>(R, G, cgn, x0, f);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m == 1 && c2 == c) break;
          const bool first = f[m] < f1, second = !first && f[m] < f2;   // as offer
          if (first) { const int t = s1; s1 = s2; s2 = t; }
          if (first || second) store_vec<V>(R.lb(first ? s1 : s2), raw[m]);
          offer(f[m], c + m, f1, h1, f2, h2);
        }
      }
      load_vec<V>(R.lb(s1), lb[0]);
      load_vec<V>(R.lb(s2), lb[1]);
    } else {
      // pre-selection (reference :366-378): each child's secondary and
      // primary fitness first
      for (int c = 0; c < C; c += 2) {
        const int c2 = min(c + 1, C - 1);
        const int cs[2] = {c, c2};
        const float rt[2] = {rate(c), rate(c2)};
        float raw[2][V], cgn[2][V], f[2];
        children_raw<V, K, RNG, 2>(P, R, n, salt, srot, g, cs, rt, p0g, raw);
        renorm<V, QMASK>(raw[0], cgn[0]);
        renorm<V, QMASK>(raw[1], cgn[1]);
        eval_fit<V, K, 2>(R, G, cgn, x0, f);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m == 1 && c2 == c) break;
          R.kid(2 * (c + m)) = sec_of<V>(S, P.sec_mask, cgn[m]);
          R.kid(2 * (c + m) + 1) = f[m];
        }
      }
      const float keep_u = tensors ? P.keeps[(size_t)g * N + n] : u01(rw.w, 0.0f);
      const int kcount = sec_kcount(keep_u, C);
      // child c is kept when fewer than kcount children j rank before it:
      // s_j < s_c, or s_j == s_c and j < c (bio2_step.preselect)
      for (int k = 0; k < C; ++k) {
        const float sk = R.kid(2 * k);
        int rank = 0;
        for (int j = 0; j < C; ++j) {
          const float sj = R.kid(2 * j);
          rank += j < k ? sj <= sk : (j > k && sj < sk);
        }
        if (rank < kcount) offer(R.kid(2 * k + 1), k, f1, h1, f2, h2);
      }
      // the two winners drawn again, together (the same counters give the
      // same bits; a parent's slot draws child 0 and is not read)
      const int cs[2] = {max(h1, 0), max(h2, 0)};
      const float rt[2] = {rate(cs[0]), rate(cs[1])};
      children_raw<V, K, RNG, 2>(P, R, n, salt, srot, g, cs, rt, p0g, lb);
    }
    float wg[2][V], ws[2][V];   // the winners' genes, momentum shifts
    renorm<V, QMASK>(lb[0], wg[0]);
    renorm<V, QMASK>(lb[1], wg[1]);
    // the shift of a parity is the row of class 4 (even) or 1 (odd): times
    // cg mod 3 = 1 (with two classes, the row of the parity)
    load_vec<V>(R.momentum(h1 & 1 ? 1 : (RowsT::NCLS == 6 ? 4 : 0)), ws[0]);
    load_vec<V>(R.momentum(h2 & 1 ? 1 : (RowsT::NCLS == 6 ? 4 : 0)), ws[1]);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float4& bd = R.bounds(v);
      const float q1 = bd.w;   // parent 1's gene
      const float g1 = h1 == H_P0 ? p0g[v] : (h1 == H_P1 ? q1 : wg[0][v]);
      const float g2 = h2 == H_P0 ? p0g[v] : (h2 == H_P1 ? q1 : wg[1][v]);
      // a child's momentum from its genes before the renormalization (:299)
      const float r1 = h1 == H_P0 ? p0r[v] : (h1 == H_P1 ? p1r[v]
                     : ws[0][v] * 0.7f + (lb[0][v] - p0g[v]) * 0.3f);
      const float r2 = h2 == H_P0 ? p0r[v] : (h2 == H_P1 ? p1r[v]
                     : ws[1][v] * 0.7f + (lb[1][v] - p0g[v]) * 0.3f);
      p0g[v] = g1; bd.w = g2; p0r[v] = r1; p1r[v] = r2;
    }
    f_p[0] = f1;
    f_p[1] = f2;
  }

  // ---- memetic line search on parent 0 (reference :436-600) ----
  // An iteration's fitness at x is the last accepted candidate's (the same
  // evaluation of the same genes), and the search stops at the first
  // non-improvement (:535-537), after which the plain version's remaining
  // iterations change nothing.
  if (P.memetic) {
    float x[1][V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[0][v] = p0g[v];
    float ph[1][K][7], f2p;
    eval_lin<V, K, 1>(R, G, x, x0, &f2p, ph);
    for (int it = 0; it < P.mem_iters; ++it) {
      // the line search runs on primary + secondary, acceptance on the
      // primary (reference :459-537)
      const float f2 = SEC ? f2p + sec_of<V>(S, P.sec_mask, x[0]) : f2p;
      // analytic gradient of the linearized fitness
      float sgn[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float dm = 0.0f, dp = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float q = ph[0][k][3 + c], gq = G.gquat[k][c];
          dm = dm + (q - gq) * (q - gq);
          dp = dp + (q + gq) * (q + gq);
        }
        sgn[k] = (dm <= dp) ? 1.0f : -1.0f;
      }
      float grad[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float gv = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4 a = R.delta(v, k, 0), b = R.delta(v, k, 1);
          const float d[7] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
          float acc_p = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c) acc_p = acc_p + d[c] * (ph[0][k][c] - G.gpos[k][c]);
          float acc_q = 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc_q = acc_q + d[3 + c] * (ph[0][k][3 + c] - sgn[k] * G.gquat[k][c]);
          gv = gv + 2.0f * (G.wpos[k] * acc_p + G.wrot[k] * acc_q);
        }
        if (SEC) gv = gv + sec_grad<V>(S, P.sec_mask, x[0], v);
        grad[v] = gv;
      }
      float l1 = 0.0f;
#pragma unroll
      for (int v = 0; v < V; ++v) l1 = l1 + fabsf(grad[v]);
      const float scale = P.h / (l1 + 1e-12f);
      float gdir[V], probe[2][V], cand[1][V], fp[2];   // probe: x − gdir, x + gdir
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gdir[v] = grad[v] * scale;
        probe[0][v] = x[0][v] - gdir[v];
        probe[1][v] = x[0][v] + gdir[v];
      }
      eval_fit<V, K, 2>(R, G, probe, x0, fp);
      float f1 = fp[0], f3 = fp[1];
      if (SEC) {
        f1 = f1 + sec_of<V>(S, P.sec_mask, probe[0]);
        f3 = f3 + sec_of<V>(S, P.sec_mask, probe[1]);
      }
      float st;
      if (P.memetic == 1) {   // quadratic fit (reference :498-516)
        const float v1 = f2 - f1, v2 = f3 - f2;
        const float vv = (v1 + v2) * 0.5f;
        const float a = v1 - v2;
        st = vv / a;
      } else {                // linear step (reference :545-556)
        const float cd = (f3 - f1) * 0.5f;
        st = f2 / cd;
      }
      st = isfinite(st) ? st : 0.0f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float4 bd = R.bounds(v);
        const float step = P.memetic == 1 ? x[0][v] + gdir[v] * st : x[0][v] - gdir[v] * st;
        cand[0][v] = clampf(step, bd.y, bd.z);
      }
      float phc[1][K][7], f4;
      eval_lin<V, K, 1>(R, G, cand, x0, &f4, phc);
      if (!(f4 < f2p)) break;   // break on non-improvement (:535-537)
#pragma unroll
      for (int v = 0; v < V; ++v) x[0][v] = cand[0][v];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int c = 0; c < 7; ++c) ph[0][k][c] = phc[0][k][c];
      f2p = f4;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) p0g[v] = x[0][v];
  }

#pragma unroll
  for (int v = 0; v < V; ++v) {
    P.genes_o[v * N + n] = p0g[v];
    P.genes_o[(V + v) * N + n] = R.bounds(v).w;
    P.grads_o[v * N + n] = p0r[v];
    P.grads_o[(V + v) * N + n] = p1r[v];
  }
}

// ------------------------------------------------------------ C API ----
// Over the including source's (V, K, quaternion mask) instances (SHAPES).

// Version of species_launch's argument list, raised whenever it changes:
// a caller that launches another build (tools/megastep_ab.py) checks it
// first.  1 was the list before this symbol: noise tensors only.
extern "C" int species_abi_version() { return 2; }

// Dynamic shared memory of one block, bytes.
extern "C" int species_smem_bytes(int V, int K, int C, unsigned int sec_mask) {
  const int vec = 2 * V * K + V + (sec_mask ? 2 : 8) * ((V + 3) / 4);   // Rows::Q
  return (vec * 4 + (sec_mask ? 2 * C : 0)) * BLOCK * 4;
}

// The dynamic shared memory of a block, and as much of the SM's unified
// L1 as shared memory as the blocks its registers allow need (in percent
// of the most it can be): the rest stays L1 cache, which holds the
// secondary rows the secondary-goal instance reads from global memory.
template <typename KF>
static int prepare(KF kernel, size_t smem) {
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
  if (e) return e;
  static int sm_smem = 0, sm_regs = 0;
  if (!sm_smem) {
    int dev;
    if ((e = (int)cudaGetDevice(&dev)) ||
        (e = (int)cudaDeviceGetAttribute(&sm_regs, cudaDevAttrMaxRegistersPerMultiprocessor,
                                         dev)) ||
        (e = (int)cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                         dev)))
      return e;
  }
  cudaFuncAttributes fa;
  if ((e = (int)cudaFuncGetAttributes(&fa, kernel))) return e;
  const long warp_regs = (long)((fa.numRegs + 7) / 8) * 8 * 32;   // allocated per warp
  const long blocks = sm_regs / (warp_regs * (BLOCK / 32));
  const long need = blocks * ((long)smem + 1024);                  // + each block's reserve
  const long percent = (100 * need + sm_smem - 1) / sm_smem;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)(percent < 100 ? percent : 100));
}

// f applied to the instance of (V, K, QMASK) for the secondary terms and
// randomness mode.
template <int V, int K, uint32_t QMASK, typename F>
static int with_instance(bool sec, int rng_mode, F f) {
#define CASE(r)                                                                    \
  case r: return sec ? f(species_kernel<V, K, QMASK, true, r>)                     \
                     : f(species_kernel<V, K, QMASK, false, r>);
  switch (rng_mode) {
    CASE(RNG_TENSORS)
    CASE(RNG_CLT4)
    CASE(RNG_BOX_MULLER)
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of an instance at `smem` bytes.
extern "C" int species_blocks_per_sm(int V, int K, unsigned int qmask, int sec, int rng_mode,
                                     int smem, int* blocks) {
  *blocks = 0;
  auto occ = [&](auto kernel) {
    int e = prepare(kernel, smem);
    if (e) return e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, BLOCK, smem);
  };
#define OCC(v, k, q) \
  if (V == v && K == k && qmask == q) return with_instance<v, k, q>(sec, rng_mode, occ);
  SHAPES(OCC)
#undef OCC
  return (int)cudaErrorInvalidValue;
}

extern "C" int species_launch(
    int V, int K, int N, int gens, int C, int mem_iters, int memetic, float h,
    unsigned int qmask, unsigned int sec_mask, int rng_mode, unsigned int seed,
    int step, const int* salt, const float* genes, const float* grads,
    const float* tips0, const float* deltas, const float* gpos, const float* gquat,
    const float* wpos, const float* wrot, const float* span, const float* cmin,
    const float* cmax, const float* noise, const float* rates, const float* keeps,
    const float* sec, float* genes_o, float* grads_o, void* stream) {
  if (N <= 0 || C <= 0 || C > MAX_C) return (int)cudaErrorInvalidValue;
  const SParams P{N, gens, C, mem_iters, memetic, rng_mode, step, h, sec_mask, seed, salt,
                  genes, grads, tips0, deltas, gpos, gquat, wpos, wrot, span, cmin, cmax,
                  noise, rates, keeps, sec, genes_o, grads_o};
  const dim3 grid((N + BLOCK - 1) / BLOCK), block(BLOCK);
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)species_smem_bytes(V, K, C, sec_mask);
  auto launch = [&](auto kernel) {
    int e = prepare(kernel, smem);
    if (e) return e;
    void* args[] = {(void*)&P};
    return (int)cudaLaunchKernel(kernel, grid, block, args, smem, s);
  };
#define LAUNCH(v, k, q) \
  if (V == v && K == k && qmask == q) return with_instance<v, k, q>(sec_mask, rng_mode, launch);
  SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
