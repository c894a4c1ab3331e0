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
// What bounds it on the card: bytes.  For the floating-base arm (V=10,
// K=1, C=16, gens=8, mem_iters=8) a lane reads 6 416 bytes per launch —
// almost all of it the (gens, V, C, N) noise tensor — and does ~30k FLOPs
// (176 linearized fitness evaluations of 14·K·V + 30·K FLOPs): about five
// FLOPs per byte, below the H100's FP32 ridge (~20).  The design:
//   * one thread per lane, lanes contiguous in every (rows, N) array, so
//     each row read (the noise tensor's too: noise[((g·V+v)·C+c)·N+n]) is
//     one coalesced load, and parents, bounds and goal rows stay in
//     registers for the whole launch, written back once;
//   * the V·K·7 delta rows of the lane live in shared memory, one column
//     per thread ([row][thread], no bank conflicts, no block
//     synchronisation: a thread reads only its own column), which keeps the
//     registers for the parents and the running best two;
//   * children are streamed: a child's genes and momentum are built, its
//     quaternion blocks renormalized, its linearized fitness evaluated and a
//     running best two kept (strict '<' in pool order p0, p1, child 0..C-1
//     reproduces the first-min pick of the plain version) — no (C+2)-wide
//     pool is ever materialized;
//   * it is built with -fmad=false: the kernel is bound by bytes, so plain
//     IEEE multiplies and adds cost nothing measurable, and they make the
//     kernel round as the plain version does (the plain version has no
//     transcendental functions), which keeps the memetic line search — a
//     quotient of differences of nearly equal fitness values — on the plain
//     version's trajectory.
// The ragged last block is masked: threads past N return at once (the
// kernel has no warp- or block-level exchange).
//
// Joint-space secondary goals run in a second instance of each shape,
// species_kernel<..., SEC = true> (bio2_step.make_species_inner with
// sec_terms): per generation every child is built once to rank it by
// secondary fitness (the C values in shared memory, csrc/sec_eval.cuh),
// then built again — the same operations, so the same bits — and offered
// to the running best two only if the pre-selection keeps it; the memetic
// line search runs on primary + secondary and accepts on the primary.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC -fmad=false (kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sec_eval.cuh"

#define BLOCK 128
#define SEC_MAX_C 16   // children per generation the SEC instance holds

struct SParams {
  int N, gens, C, mem_iters, memetic;
  float h;
  uint32_t qmask;   // bit s: a quaternion gene block starts at slot s
  uint32_t sec_mask;
  const float *genes, *grads, *tips0, *deltas, *gpos, *gquat, *wpos, *wrot;
  const float *span, *cmin, *cmax, *noise, *rates, *keeps, *sec;
  float *genes_o, *grads_o;
};

template <int K>
struct Goals {
  float base[K][7];   // tip components of each goal instance at x0
  float gpos[K][3], gquat[K][4], wpos[K], wrot[K];
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Linearized phenotype of genes x (dq = x - x0) and its pose-family
// fitness (bio2_step.make_species_inner: phen_rows, fitness_rows; the same
// operation order).
template <int V, int K>
__device__ __forceinline__ float eval_lin(const float (*sd)[BLOCK], int t,
                                          const Goals<K>& G, const float (&x)[V],
                                          const float (&x0)[V], float (&ph)[K][7]) {
  float dq[V];
#pragma unroll
  for (int v = 0; v < V; ++v) dq[v] = x[v] - x0[v];
  float fit = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      float acc = G.base[k][c];
#pragma unroll
      for (int v = 0; v < V; ++v) acc = acc + sd[(v * K + k) * 7 + c][t] * dq[v];
      ph[k][c] = acc;
    }
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

// Child c of generation g: genes built, clipped, momentum mixed (before the
// renormalization), then one Newton step of each quaternion block toward
// unit norm (reference :320-324, normalizeFast, frame.h:231-238).
template <int V>
__device__ __forceinline__ void species_child(const SParams& P, int n, int g, int c,
                                              const float (&p0g)[V], const float (&p0r)[V],
                                              const float (&p1r)[V], const float (&span)[V],
                                              const float (&cmin)[V], const float (&cmax)[V],
                                              float (&cgn)[V], float (&crn)[V]) {
  const size_t N = P.N;
  const int C = P.C;
  const int cg = c + 2;            // the reference's child index
  const float fmix = (cg % 2 == 0) ? 0.2f : 0.0f;
  const float gfac = (float)(cg % 3);
  const float rate = P.rates[((size_t)g * C + c) * N + n];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float nz = P.noise[(((size_t)g * V + v) * C + c) * N + n];
    const float pg = p0r[v] * (1.0f - fmix) + p1r[v] * fmix;
    float gv = p0g[v] + nz * (rate * span[v]) + pg * gfac;
    gv = clampf(gv, cmin[v], cmax[v]);
    cgn[v] = gv;
    crn[v] = pg * 0.7f + (gv - p0g[v]) * 0.3f;   // momentum before renorm
  }
#pragma unroll
  for (int s = 0; s + 4 <= V; ++s) {
    if ((P.qmask >> s) & 1u) {
      const float n2 = cgn[s] * cgn[s] + cgn[s + 1] * cgn[s + 1]
                     + cgn[s + 2] * cgn[s + 2] + cgn[s + 3] * cgn[s + 3];
      const float fn = (3.0f - n2) * 0.5f;
#pragma unroll
      for (int d = 0; d < 4; ++d) cgn[s + d] = cgn[s + d] * fn;
    }
  }
}

template <int V, int K, bool SEC>
__global__ void __launch_bounds__(BLOCK)
species_kernel(const SParams P) {
  __shared__ float sd[V * K * 7][BLOCK];
  __shared__ float ss[SEC ? SEC_MAX_C : 1][BLOCK];   // children's secondary fitness
  const int t = threadIdx.x;
  const int n = blockIdx.x * BLOCK + t;
  if (n >= P.N) return;
  const size_t N = P.N;

#pragma unroll
  for (int r = 0; r < V * K * 7; ++r) sd[r][t] = P.deltas[r * N + n];
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
  float p0g[V], p1g[V], p0r[V], p1r[V], x0[V];
  float span[V], cmin[V], cmax[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p0g[v] = P.genes[v * N + n];
    p1g[v] = P.genes[(V + v) * N + n];
    p0r[v] = P.grads[v * N + n];
    p1r[v] = P.grads[(V + v) * N + n];
    x0[v] = p0g[v];   // the linearization point: parent 0 at entry
    span[v] = P.span[v * N + n];
    cmin[v] = P.cmin[v * N + n];
    cmax[v] = P.cmax[v * N + n];
  }
  const int C = P.C;
  const SecRows S{P.sec, N, V, n};
  float ph[K][7];

  // ---- generations (reference ik_evolution_2.cpp:349-431) ----
  float f_p0 = eval_lin<V, K>(sd, t, G, p0g, x0, ph);
  float f_p1 = eval_lin<V, K>(sd, t, G, p1g, x0, ph);
  for (int g = 0; g < P.gens; ++g) {
    float b1g[V], b1r[V], b2g[V], b2r[V], f1, f2;
    const bool sw = f_p1 < f_p0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      b1g[v] = sw ? p1g[v] : p0g[v]; b1r[v] = sw ? p1r[v] : p0r[v];
      b2g[v] = sw ? p0g[v] : p1g[v]; b2r[v] = sw ? p0r[v] : p1r[v];
    }
    f1 = sw ? f_p1 : f_p0;
    f2 = sw ? f_p0 : f_p1;
    int kcount = C;
    if (SEC) {   // pre-selection (reference :366-378)
      for (int c = 0; c < C; ++c) {
        float cgn[V], crn[V];
        species_child<V>(P, n, g, c, p0g, p0r, p1r, span, cmin, cmax, cgn, crn);
        ss[c][t] = sec_of<V>(S, P.sec_mask, cgn);
      }
      kcount = sec_kcount(P.keeps[(size_t)g * N + n], C);
    }
    for (int c = 0; c < C; ++c) {
      if (SEC && !sec_keep([&](int j) { return ss[j][t]; }, C, c, kcount)) continue;
      float cgn[V], crn[V];
      species_child<V>(P, n, g, c, p0g, p0r, p1r, span, cmin, cmax, cgn, crn);
      const float f = eval_lin<V, K>(sd, t, G, cgn, x0, ph);
      if (f < f1) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          b2g[v] = b1g[v]; b2r[v] = b1r[v]; b1g[v] = cgn[v]; b1r[v] = crn[v];
        }
        f2 = f1; f1 = f;
      } else if (f < f2) {
#pragma unroll
        for (int v = 0; v < V; ++v) { b2g[v] = cgn[v]; b2r[v] = crn[v]; }
        f2 = f;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p0g[v] = b1g[v]; p0r[v] = b1r[v]; p1g[v] = b2g[v]; p1r[v] = b2r[v];
    }
    f_p0 = f1;
    f_p1 = f2;
  }

  // ---- memetic line search on parent 0 (reference :436-600) ----
  if (P.memetic) {
    float x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = p0g[v];
    bool done = false;
    for (int it = 0; it < P.mem_iters; ++it) {
      const float f2p = eval_lin<V, K>(sd, t, G, x, x0, ph);
      // the line search runs on primary + secondary, acceptance on the
      // primary (reference :459-537)
      const float f2 = SEC ? f2p + sec_of<V>(S, P.sec_mask, x) : f2p;
      // analytic gradient of the linearized fitness
      float sgn[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float dm = 0.0f, dp = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float q = ph[k][3 + c], gq = G.gquat[k][c];
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
          float acc_p = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            acc_p = acc_p + sd[(v * K + k) * 7 + c][t] * (ph[k][c] - G.gpos[k][c]);
          float acc_q = 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc_q = acc_q + sd[(v * K + k) * 7 + 3 + c][t]
                                * (ph[k][3 + c] - sgn[k] * G.gquat[k][c]);
          gv = gv + 2.0f * (G.wpos[k] * acc_p + G.wrot[k] * acc_q);
        }
        if (SEC) gv = gv + sec_grad<V>(S, P.sec_mask, x, v);
        grad[v] = gv;
      }
      float l1 = 0.0f;
#pragma unroll
      for (int v = 0; v < V; ++v) l1 = l1 + fabsf(grad[v]);
      const float scale = P.h / (l1 + 1e-12f);
      float gdir[V], xm[V], xp[V], cand[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gdir[v] = grad[v] * scale;
        xm[v] = x[v] - gdir[v];
        xp[v] = x[v] + gdir[v];
      }
      float f1 = eval_lin<V, K>(sd, t, G, xm, x0, ph);
      float f3 = eval_lin<V, K>(sd, t, G, xp, x0, ph);
      if (SEC) {
        f1 = f1 + sec_of<V>(S, P.sec_mask, xm);
        f3 = f3 + sec_of<V>(S, P.sec_mask, xp);
      }
      if (P.memetic == 1) {   // quadratic fit (reference :498-516)
        const float v1 = f2 - f1, v2 = f3 - f2;
        const float vv = (v1 + v2) * 0.5f;
        const float a = v1 - v2;
        float st = vv / a;
        st = isfinite(st) ? st : 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) cand[v] = clampf(x[v] + gdir[v] * st, cmin[v], cmax[v]);
      } else {                // linear step (reference :545-556)
        const float cd = (f3 - f1) * 0.5f;
        float st = f2 / cd;
        st = isfinite(st) ? st : 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) cand[v] = clampf(x[v] - gdir[v] * st, cmin[v], cmax[v]);
      }
      const float f4 = eval_lin<V, K>(sd, t, G, cand, x0, ph);
      const bool accept = (f4 < f2p) && !done;
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = accept ? cand[v] : x[v];
      done = done || !accept;   // break on non-improvement (:535-537)
    }
#pragma unroll
    for (int v = 0; v < V; ++v) p0g[v] = x[v];
  }

#pragma unroll
  for (int v = 0; v < V; ++v) {
    P.genes_o[v * N + n] = p0g[v];
    P.genes_o[(V + v) * N + n] = p1g[v];
    P.grads_o[v * N + n] = p0r[v];
    P.grads_o[(V + v) * N + n] = p1r[v];
  }
}

// ------------------------------------------------------------ C API ----
// (V, K) instances; kernels/bio2_step.py::SPECIES_SHAPES lists the same.
#define SHAPES(X) X(10, 1) X(5, 1)

extern "C" int species_has_shape(int V, int K) {
#define HAS(v, k) if (V == v && K == k) return 1;
  SHAPES(HAS)
#undef HAS
  return 0;
}

extern "C" int species_launch(
    int V, int K, int N, int gens, int C, int mem_iters, int memetic, float h,
    unsigned int qmask, unsigned int sec_mask, const float* genes,
    const float* grads, const float* tips0, const float* deltas,
    const float* gpos, const float* gquat, const float* wpos, const float* wrot,
    const float* span, const float* cmin, const float* cmax,
    const float* noise, const float* rates, const float* keeps,
    const float* sec, float* genes_o, float* grads_o, void* stream) {
  if (N <= 0 || C <= 0 || (sec_mask && C > SEC_MAX_C)) return (int)cudaErrorInvalidValue;
  SParams P{N, gens, C, mem_iters, memetic, h, qmask, sec_mask, genes, grads,
            tips0, deltas, gpos, gquat, wpos, wrot, span, cmin, cmax, noise,
            rates, keeps, sec, genes_o, grads_o};
  dim3 grid((N + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(v, k)                                                         \
  if (V == v && K == k) {                                                    \
    if (sec_mask) species_kernel<v, k, true><<<grid, block, 0, s>>>(P);      \
    else species_kernel<v, k, false><<<grid, block, 0, s>>>(P);              \
    return (int)cudaGetLastError();                                          \
  }
  SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
