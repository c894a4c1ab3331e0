// Fused bio2 megastep for Hopper (sm_90a): n_steps whole bio2 solver steps
// per lane in one launch, with the species sort, wipeout and per-lane
// incumbent bookkeeping between steps.
//
// Replaces the TPU kernel bio_ik_tpu/kernels/bio2_megastep.py::
// make_megastep_kernel (its pl.pallas_call), which inlines
// bio2_fullstep.py::make_fullstep_inner, fk_rows.py::FkRows and the
// in-kernel RNG (make_rng_helpers, gauss_from_u01, make_rate_draw).  The
// plain torch version it is held to is
// bio_ik_tpu_torch/kernels/bio2_megastep.py::make_megastep_body.
//
// What bounds it on the card: FP32 arithmetic.  For PR2 (V=7, K=1) a lane
// moves 536 bytes per launch (state read and written once, constants and
// salt read once) but does ~23.4k FLOPs per solver step (gens·(C+2) +
// 4·mem_iters linearized fitness evaluations of 14·K·V + 30·K FLOPs each,
// plus ~900 for the two exact FK passes), 24-64 steps per launch: about
// a thousand FLOPs per byte, far above the H100's FP32 ridge (~20).  The design therefore keeps every intermediate in
// registers and never touches device memory inside the step loop:
//   * one thread per lane, lanes contiguous in every (rows, N) array, so
//     each state/const row read is one coalesced load and the whole
//     n_steps loop runs on registers, writing back once;
//   * children are streamed: a child's noise is drawn, its genes and
//     momentum built, its linearized fitness evaluated and a running
//     best-two kept (strict '<' in pool order p0, p1, child 0..C-1
//     reproduces the reference's first-min pick) — no (V, C) noise tile
//     and no (C+2)-wide pool is ever materialized;
//   * randomness is counter-based Philox4x32-10 computed in registers
//     (key (seed, 0), counter (lane, step, generation, draw)), the salt of
//     the lane's scenario XORed into every word, as the TPU kernel did
//     with its hardware PRNG — the generator costs integer operations the
//     FLOP count above leaves out;
//   * the two species of an island are adjacent lanes, so the species
//     compare-swap is __shfl_xor_sync(…, 1) (the TPU kernel's
//     pltpu.roll(±1)); padding threads past N take part in every shuffle
//     and only skip the final store.
// The chain (FIXED/REVOLUTE/PRISMATIC joints, mimic, fixed rows) arrives as
// a compact per-link description in device memory (FkRows.chain_arrays);
// its uniform loads are broadcast within a warp.  The kernel is templated
// on V (active variables), K (goal instances) and T (tips) so that genes,
// delta frames and goal rows stay in registers; link frames live in a
// small per-thread array indexed by schedule slot.
//
// Joint-space secondary goals (the reference's regularizers) run in a
// second kernel of each shape, megastep_sec_kernel: the per-generation
// pre-selection keeps the C children of a generation in dynamic shared
// memory (one column per thread), and the packed `sec` rows are read from
// global memory where used (csrc/sec_eval.cuh).  It and a second entry
// point, fullstep_launch (one step without the bookkeeping: the port of the
// TPU kernel bio2_fullstep.py::make_fullstep_kernel), call the step device
// function bio2_step; the pose-only megastep_kernel keeps its own inline
// copy of the step (see there).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: sincosf/logf/cosf and division are
// the IEEE-accurate versions).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sec_eval.cuh"

#define MAX_LINKS 40   // must equal fk_rows.MAX_LINKS
#define LINK_I 6       // ints per link   (fk_rows.FkRows.chain_arrays)
#define LINK_F 19      // floats per link
#define BLOCK 128

enum { SRC_NONE = 0, SRC_ACTIVE = 1, SRC_FIXED = 2, SRC_CONST = 3 };
enum { J_FIXED = 0, J_REVOLUTE = 1, J_PRISMATIC = 2 };
enum { RNG_TENSORS = 0, RNG_CLT4 = 1, RNG_BOX_MULLER = 2 };

struct Params {
  int N, nlinks, n_steps, gens, C, mem_iters, memetic, rng_mode;
  float h;
  uint32_t seed, sec_mask;
  const int* salt;
  const float *genes, *grads, *sfit, *sol, *sol_fit, *sol_tips;
  // megastep: the state out; fullstep: genes_o, grads_o, tips_o, fit_o
  float *genes_o, *grads_o, *sfit_o, *sol_o, *sol_fit_o, *sol_tips_o;
  float *tips_o, *fit_o;
  const float *qfix, *gpos, *gquat, *wpos, *wrot;
  const float *span, *cmin, *cmax, *amin, *amax, *sec;
  const float *noise, *rates, *wipe_u, *wipe_g, *keep;
  const int* chain_i;
  const float* chain_f;
  const int* tip_slot;
  const int* inst_tip;
};

// ---------------------------------------------------------------- RNG --
struct U4 { uint32_t x, y, z, w; };

__device__ __forceinline__ U4 philox4x32(uint32_t c0, uint32_t c1,
                                         uint32_t c2, uint32_t c3,
                                         uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
  }
  return U4{c0, c1, c2, c3};
}

__device__ __forceinline__ float u01(uint32_t bits, float lo) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f) + lo;
}

// ----------------------------------------------------- quaternion ops --
// Same expression order as fk_rows._qmul/_qrot.
__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  float x = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  float y = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  float z = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  float w = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
  o[0] = x; o[1] = y; o[2] = z; o[3] = w;
}

__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  float tx = 2.0f * (q[1] * v[2] - q[2] * v[1]);
  float ty = 2.0f * (q[2] * v[0] - q[0] * v[2]);
  float tz = 2.0f * (q[0] * v[1] - q[1] * v[0]);
  float x = v[0] + q[3] * tx + (q[1] * tz - q[2] * ty);
  float y = v[1] + q[3] * ty + (q[2] * tx - q[0] * tz);
  float z = v[2] + q[3] * tz + (q[0] * ty - q[1] * tx);
  o[0] = x; o[1] = y; o[2] = z;
}

template <int V>
__device__ __forceinline__ float pick_var(const float (&x)[V], int idx) {
  float r = x[0];
#pragma unroll
  for (int v = 1; v < V; ++v) r = (idx == v) ? x[v] : r;
  return r;
}

// Exact FK over the link schedule: frames of every schedule slot into
// lp/lq (fk_rows.FkRows.frames).
template <int V>
__device__ __forceinline__ void fk_frames(const Params& P, int n, const float (&x)[V],
                          float (*lp)[3], float (*lq)[4]) {
  for (int s = 0; s < P.nlinks; ++s) {
    const int* I = P.chain_i + s * LINK_I;
    const float* F = P.chain_f + s * LINK_F;
    const int kind = I[2];
    if (kind == SRC_CONST) {
      lp[s][0] = F[12]; lp[s][1] = F[13]; lp[s][2] = F[14];
      lq[s][0] = F[15]; lq[s][1] = F[16]; lq[s][2] = F[17]; lq[s][3] = F[18];
      continue;
    }
    float pp[3], pq[4];
    if (I[5]) {
      pp[0] = F[12]; pp[1] = F[13]; pp[2] = F[14];
      pq[0] = F[15]; pq[1] = F[16]; pq[2] = F[17]; pq[3] = F[18];
    } else {
      const int par = I[0];
      float r[3];
      qrot(lq[par], F + 0, r);
      pp[0] = lp[par][0] + r[0];
      pp[1] = lp[par][1] + r[1];
      pp[2] = lp[par][2] + r[2];
      qmul(lq[par], F + 3, pq);
    }
    const int jt = I[1];
    if (jt == J_FIXED || kind == SRC_NONE) {
      lp[s][0] = pp[0]; lp[s][1] = pp[1]; lp[s][2] = pp[2];
      lq[s][0] = pq[0]; lq[s][1] = pq[1]; lq[s][2] = pq[2]; lq[s][3] = pq[3];
      continue;
    }
    float q = (kind == SRC_ACTIVE) ? pick_var<V>(x, I[3])
                                   : P.qfix[(size_t)I[3] * P.N + n];
    const float f = F[10], off = F[11];
    if (f != 1.0f || off != 0.0f) q = q * f + off;
    if (jt == J_REVOLUTE) {
      float sn, cs;
      sincosf(0.5f * q, &sn, &cs);
      float jq[4] = {F[7] * sn, F[8] * sn, F[9] * sn, cs};
      lp[s][0] = pp[0]; lp[s][1] = pp[1]; lp[s][2] = pp[2];
      qmul(pq, jq, lq[s]);
    } else {  // prismatic
      float d[3] = {F[7] * q, F[8] * q, F[9] * q}, r[3];
      qrot(pq, d, r);
      lp[s][0] = pp[0] + r[0]; lp[s][1] = pp[1] + r[1]; lp[s][2] = pp[2] + r[2];
      lq[s][0] = pq[0]; lq[s][1] = pq[1]; lq[s][2] = pq[2]; lq[s][3] = pq[3];
    }
  }
}

// Per-lane goal constants and the linearization at parent 0.
template <int V, int K>
struct Lin {
  float base[K][7];     // exact tip components of each goal instance at x0
  float d[V][K][7];     // ∂tip_kd/∂x_v (zero where no dependency)
};

template <int V, int K>
struct Goals {
  float gpos[K][3], gquat[K][4], wpos[K], wrot[K];
};

// Linearized pose-family fitness of genes x (dq = x − x0); with grad,
// also ∂fit/∂x (bio2_fullstep.eval_goals + the memetic chain rule).
template <int V, int K, bool GRAD>
__device__ __forceinline__ float eval_lin(const Lin<V, K>& L, const Goals<V, K>& G,
                                          const float (&x)[V], const float (&x0)[V],
                                          float (&grad)[V]) {
  float dq[V];
#pragma unroll
  for (int v = 0; v < V; ++v) dq[v] = x[v] - x0[v];
  float fit = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) grad[v] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float ph[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      float acc = L.base[k][c];
#pragma unroll
      for (int v = 0; v < V; ++v) acc = acc + L.d[v][k][c] * dq[v];
      ph[c] = acc;
    }
    float perr = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float e = ph[c] - G.gpos[k][c];
      perr = perr + e * e;
    }
    float dm = 0.0f, dp = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float q = ph[3 + c], g = G.gquat[k][c];
      dm = dm + (q - g) * (q - g);
      dp = dp + (q + g) * (q + g);
    }
    float term = G.wpos[k] * perr + G.wrot[k] * fminf(dm, dp);
    fit = (k == 0) ? term : fit + term;
    if (GRAD) {
      float sgn = (dm <= dp) ? 1.0f : -1.0f;
      float gv[7];
#pragma unroll
      for (int c = 0; c < 3; ++c) gv[c] = 2.0f * G.wpos[k] * (ph[c] - G.gpos[k][c]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        gv[3 + c] = 2.0f * G.wrot[k] * (ph[3 + c] - sgn * G.gquat[k][c]);
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int c = 0; c < 7; ++c) grad[v] = grad[v] + L.d[v][k][c] * gv[c];
    }
  }
  return fit;
}

// Exact fitness of the tip components (no linearization).
template <int V, int K>
__device__ __forceinline__ float eval_exact(const float (&ph)[K][7], const Goals<V, K>& G) {
  float fit = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float perr = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float e = ph[k][c] - G.gpos[k][c];
      perr = perr + e * e;
    }
    float dm = 0.0f, dp = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float q = ph[k][3 + c], g = G.gquat[k][c];
      dm = dm + (q - g) * (q - g);
      dp = dp + (q + g) * (q + g);
    }
    float term = G.wpos[k] * perr + G.wrot[k] * fminf(dm, dp);
    fit = (k == 0) ? term : fit + term;
  }
  return fit;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}


// One child of generation g (reference :263-299): its rate and noise drawn
// (Philox counter (lane, step, g, draw) or the noise tensors), genes built
// and clipped, momentum mixed.
template <int V>
__device__ __forceinline__ void make_child(const Params& P, int n, int nn,
                                           uint32_t salt, int step, int g, int c,
                                           const float (&p0g)[V], const float (&p0r)[V],
                                           const float (&p1r)[V], const float (&span)[V],
                                           const float (&cmin)[V], const float (&cmax)[V],
                                           float (&cgn)[V], float (&crn)[V]) {
  const size_t N = P.N;
  const int C = P.C;
  const int gi = step * P.gens + g;
  const int cg = c + 2;
  const float fmix = (cg % 2 == 0) ? 0.2f : 0.0f;
  const float gfac = (float)(cg % 3);
  float rate;
  if (P.rng_mode == RNG_TENSORS) {
    rate = P.rates[((size_t)gi * C + c) * N + nn];
  } else {
    uint32_t b = philox4x32(n, step, g, V * C + c, P.seed, 0u).x ^ salt;
    rate = __int_as_float((int)(((b & 15u) + 104u) << 23));
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float nz;
    if (P.rng_mode == RNG_TENSORS) {
      nz = P.noise[(((size_t)gi * V + v) * C + c) * N + nn];
    } else {
      U4 w = philox4x32(n, step, g, v * C + c, P.seed, 0u);
      if (P.rng_mode == RNG_CLT4) {
        float s = u01(w.x ^ salt, 0.0f) + u01(w.y ^ salt, 0.0f);
        s = s + u01(w.z ^ salt, 0.0f);
        s = s + u01(w.w ^ salt, 0.0f);
        nz = (s - 2.0f) * 1.7320508f;
      } else {
        float a = u01(w.x ^ salt, 2.98023224e-08f);
        float b = u01(w.y ^ salt, 0.0f);
        nz = sqrtf(-2.0f * logf(a)) * cosf(6.28318548f * b);
      }
    }
    float pg = p0r[v] * (1.0f - fmix) + p1r[v] * fmix;
    float gv = p0g[v] + nz * (rate * span[v]) + pg * gfac;
    gv = clampf(gv, cmin[v], cmax[v]);
    cgn[v] = gv;
    crn[v] = pg * 0.7f + (gv - p0g[v]) * 0.3f;
  }
}

// One whole bio2 step of the lane (bio2_fullstep.make_fullstep_inner):
// exact FK and linearization at parent 0, `gens` generations, the memetic
// line search, exact FK of the new parent 0.  Updates the parents in place,
// writes the exact tip frames to `tips` and returns the exact fitness.
// megastep_kernel repeats this step inline for SEC = false: a fix to one
// copy goes into the other (ROADMAP.md: merge the two into one body).
//
// With SEC (joint-space secondary goals, P.sec / P.sec_mask) each
// generation first builds all C children into shared memory (`smem`,
// (C·V + C) rows of BLOCK floats, one column per thread) with their
// secondary fitness, then offers only the children the pre-selection keeps
// to the running best two; the keep uniform is Philox draw V·C + C of the
// generation (or P.keep[(step·gens + g)·N + lane]).  The memetic line
// search then runs on primary + secondary and accepts on the primary.
template <int V, int K, int T, bool SEC>
__device__ __forceinline__ float bio2_step(
    const Params& P, int n, int nn, uint32_t salt, int step,
    float (&p0g)[V], float (&p1g)[V], float (&p0r)[V], float (&p1r)[V],
    const float (&span)[V], const float (&cmin)[V], const float (&cmax)[V],
    const Goals<V, K>& G, const int (&inst_tip)[K], float (*frames_p)[3],
    float (*frames_q)[4], float* smem, float (&tips)[T][7]) {
  const size_t N = P.N;
  const int C = P.C;
  const SecRows S{P.sec, N, V, nn};

  // ---- exact FK + linearization at parent 0 (reference :341-346) ----
  float x0[V];
#pragma unroll
  for (int v = 0; v < V; ++v) x0[v] = p0g[v];
  fk_frames<V>(P, nn, x0, frames_p, frames_q);
  float tips0[T][7];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int s = P.tip_slot[t];
#pragma unroll
    for (int c = 0; c < 3; ++c) tips0[t][c] = frames_p[s][c];
#pragma unroll
    for (int c = 0; c < 4; ++c) tips0[t][3 + c] = frames_q[s][c];
  }
  float dts[V][T][7];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int c = 0; c < 7; ++c) dts[v][t][c] = 0.0f;
  for (int s = 0; s < P.nlinks; ++s) {
    const int* I = P.chain_i + s * LINK_I;
    const int mask = I[4];
    if (!mask) continue;
    const float* F = P.chain_f + s * LINK_F;
    const int slot = I[3];
    const float factor = F[10];
    float om[3];
    qrot(frames_q[s], F + 7, om);
    const bool rev = I[1] == J_REVOLUTE;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (!((mask >> t) & 1)) continue;
      float dd[7];
      if (rev) {
        float arm[3] = {tips0[t][0] - frames_p[s][0], tips0[t][1] - frames_p[s][1],
                        tips0[t][2] - frames_p[s][2]};
        dd[0] = om[1] * arm[2] - om[2] * arm[1];
        dd[1] = om[2] * arm[0] - om[0] * arm[2];
        dd[2] = om[0] * arm[1] - om[1] * arm[0];
        float w4[4] = {om[0], om[1], om[2], 0.0f}, dq4[4];
        qmul(w4, &tips0[t][3], dq4);
#pragma unroll
        for (int c = 0; c < 4; ++c) dd[3 + c] = 0.5f * dq4[c];
      } else {
        dd[0] = om[0]; dd[1] = om[1]; dd[2] = om[2];
        dd[3] = dd[4] = dd[5] = dd[6] = 0.0f;
      }
      if (factor != 1.0f) {
#pragma unroll
        for (int c = 0; c < 7; ++c) dd[c] = factor * dd[c];
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (slot == v) {
#pragma unroll
          for (int c = 0; c < 7; ++c) dts[v][t][c] = dts[v][t][c] + dd[c];
        }
    }
  }
  Lin<V, K> L;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (inst_tip[k] == t) {
#pragma unroll
        for (int c = 0; c < 7; ++c) {
          L.base[k][c] = tips0[t][c];
#pragma unroll
          for (int v = 0; v < V; ++v) L.d[v][k][c] = dts[v][t][c];
        }
      }

  // ---- generations (reference :349-431) ----
  float gtmp[V];
  float f_p0 = eval_lin<V, K, false>(L, G, p0g, x0, gtmp);
  float f_p1 = eval_lin<V, K, false>(L, G, p1g, x0, gtmp);
  for (int g = 0; g < P.gens; ++g) {
    // running best-two over the pool in order p0, p1, child 0..C-1 with
    // strict '<' = the first-min pick of the reference
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
    if (SEC) {
      // pre-selection (reference :366-378): every child and its secondary
      // fitness first
      const int tid = threadIdx.x;
      for (int c = 0; c < C; ++c) {
        float cgn[V], crn[V];
        make_child<V>(P, n, nn, salt, step, g, c, p0g, p0r, p1r, span, cmin,
                      cmax, cgn, crn);
#pragma unroll
        for (int v = 0; v < V; ++v) smem[(c * V + v) * BLOCK + tid] = cgn[v];
        smem[(C * V + c) * BLOCK + tid] = sec_of<V>(S, P.sec_mask, cgn);
      }
      float keep_u;
      if (P.rng_mode == RNG_TENSORS)
        keep_u = P.keep[(size_t)(step * P.gens + g) * N + nn];
      else
        keep_u = u01(philox4x32(n, step, g, V * C + C, P.seed, 0u).x ^ salt, 0.0f);
      kcount = sec_kcount(keep_u, C);
    }
    for (int c = 0; c < C; ++c) {
      float cgn[V], crn[V];
      if (SEC) {
        const int tid = threadIdx.x;
        const float* ss = smem + (size_t)C * V * BLOCK + tid;
        if (!sec_keep([&](int j) { return ss[j * BLOCK]; }, C, c, kcount)) continue;
        const int cg = c + 2;
        const float fmix = (cg % 2 == 0) ? 0.2f : 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float gv = smem[(c * V + v) * BLOCK + tid];
          const float pg = p0r[v] * (1.0f - fmix) + p1r[v] * fmix;
          cgn[v] = gv;
          crn[v] = pg * 0.7f + (gv - p0g[v]) * 0.3f;
        }
      } else {
        make_child<V>(P, n, nn, salt, step, g, c, p0g, p0r, p1r, span, cmin,
                      cmax, cgn, crn);
      }
      float f = eval_lin<V, K, false>(L, G, cgn, x0, gtmp);
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

  // ---- memetic on parent 0 (reference :436-600) ----
  if (P.memetic) {
    float x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = p0g[v];
    bool done = false;
    for (int it = 0; it < P.mem_iters; ++it) {
      float grad[V];
      const float f2p = eval_lin<V, K, true>(L, G, x, x0, grad);
      float f2 = f2p;
      if (SEC) {   // combined fitness for the search, primary for acceptance
        f2 = __fadd_rn(f2p, sec_of<V>(S, P.sec_mask, x));
#pragma unroll
        for (int v = 0; v < V; ++v) grad[v] = __fadd_rn(grad[v], sec_grad<V>(S, P.sec_mask, x, v));
      }
      float l1 = 0.0f;
#pragma unroll
      for (int v = 0; v < V; ++v) l1 = l1 + fabsf(grad[v]);
      const float scale = P.h / (l1 + 1e-12f);
      float gdir[V], xm[V], xp[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gdir[v] = grad[v] * scale;
        xm[v] = x[v] - gdir[v];
        xp[v] = x[v] + gdir[v];
      }
      float f1 = eval_lin<V, K, false>(L, G, xm, x0, gtmp);
      float f3 = eval_lin<V, K, false>(L, G, xp, x0, gtmp);
      if (SEC) {
        f1 = __fadd_rn(f1, sec_of<V>(S, P.sec_mask, xm));
        f3 = __fadd_rn(f3, sec_of<V>(S, P.sec_mask, xp));
      }
      float cand[V];
      if (P.memetic == 1) {  // quadratic line search
        const float v1 = f2 - f1, v2 = f3 - f2;
        const float vv = (v1 + v2) * 0.5f;
        const float a = v1 - v2;
        float st = vv / a;
        st = isfinite(st) ? st : 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) cand[v] = clampf(x[v] + gdir[v] * st, cmin[v], cmax[v]);
      } else {               // linear
        const float cd = (f3 - f1) * 0.5f;
        float st = f2 / cd;
        st = isfinite(st) ? st : 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) cand[v] = clampf(x[v] - gdir[v] * st, cmin[v], cmax[v]);
      }
      const float f4 = eval_lin<V, K, false>(L, G, cand, x0, gtmp);
      const bool accept = (f4 < f2p) && !done;
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = accept ? cand[v] : x[v];
      done = done || !accept;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) p0g[v] = x[v];
  }

  // ---- exact FK + species fitness at the new parent 0 ----
  fk_frames<V>(P, nn, p0g, frames_p, frames_q);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int s = P.tip_slot[t];
#pragma unroll
    for (int c = 0; c < 3; ++c) tips[t][c] = frames_p[s][c];
#pragma unroll
    for (int c = 0; c < 4; ++c) tips[t][3 + c] = frames_q[s][c];
  }
  float ph[K][7];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (inst_tip[k] == t) {
#pragma unroll
        for (int c = 0; c < 7; ++c) ph[k][c] = tips[t][c];
      }
  return eval_exact<V, K>(ph, G);
}

// State and constants of lane nn into registers.
template <int V, int K>
__device__ __forceinline__ void load_lane(const Params& P, int nn,
                                          float (&p0g)[V], float (&p1g)[V],
                                          float (&p0r)[V], float (&p1r)[V],
                                          float (&span)[V], float (&cmin)[V],
                                          float (&cmax)[V], Goals<V, K>& G,
                                          int (&inst_tip)[K]) {
  const size_t N = P.N;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p0g[v] = P.genes[v * N + nn];
    p1g[v] = P.genes[(V + v) * N + nn];
    p0r[v] = P.grads[v * N + nn];
    p1r[v] = P.grads[(V + v) * N + nn];
    span[v] = P.span[v * N + nn];
    cmin[v] = P.cmin[v * N + nn];
    cmax[v] = P.cmax[v * N + nn];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) G.gpos[k][c] = P.gpos[(k * 3 + c) * N + nn];
#pragma unroll
    for (int c = 0; c < 4; ++c) G.gquat[k][c] = P.gquat[(k * 4 + c) * N + nn];
    G.wpos[k] = P.wpos[k * N + nn];
    G.wrot[k] = P.wrot[k * N + nn];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) inst_tip[k] = P.inst_tip[k];
}

// The pose-only megastep (no secondary goals: bench.py's path).  It keeps
// the step inline instead of calling bio2_step: through the shared device
// function this kernel ran 5-7 % slower on an H100 SXM (700 W), while the
// secondary-goal kernel below spills when its step is inline (PERF.md §6).
// The two bodies do the same step; kernels/bio2_megastep.py's plain
// version is the reference for both, and a fix to one copy goes into
// the other, bio2_step above.
template <int V, int K, int T>
__global__ void __launch_bounds__(BLOCK)
megastep_kernel(const Params P) {
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = n < P.N;
  const int nn = live ? n : P.N - 1;   // padding threads read a real lane
  const size_t N = P.N;
  const bool even = (n & 1) == 0;
  const uint32_t salt = (uint32_t)P.salt[nn];

  float frames_p[MAX_LINKS][3], frames_q[MAX_LINKS][4];

  // ---- state and constants into registers ----
  float p0g[V], p1g[V], p0r[V], p1r[V];
  float span[V], cmin[V], cmax[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p0g[v] = P.genes[v * N + nn];
    p1g[v] = P.genes[(V + v) * N + nn];
    p0r[v] = P.grads[v * N + nn];
    p1r[v] = P.grads[(V + v) * N + nn];
    span[v] = P.span[v * N + nn];
    cmin[v] = P.cmin[v * N + nn];
    cmax[v] = P.cmax[v * N + nn];
  }
  Goals<V, K> G;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) G.gpos[k][c] = P.gpos[(k * 3 + c) * N + nn];
#pragma unroll
    for (int c = 0; c < 4; ++c) G.gquat[k][c] = P.gquat[(k * 4 + c) * N + nn];
    G.wpos[k] = P.wpos[k * N + nn];
    G.wrot[k] = P.wrot[k * N + nn];
  }
  float sfit = P.sfit[nn];
  float sol_fit = P.sol_fit[nn];
  // the incumbent genes/tips live in the output buffers
  if (live) {
#pragma unroll
    for (int v = 0; v < V; ++v) P.sol_o[v * N + n] = P.sol[v * N + n];
#pragma unroll
    for (int r = 0; r < 7 * T; ++r) P.sol_tips_o[r * N + n] = P.sol_tips[r * N + n];
  }
  int inst_tip[K];
#pragma unroll
  for (int k = 0; k < K; ++k) inst_tip[k] = P.inst_tip[k];
  const int C = P.C;

  for (int step = 0; step < P.n_steps; ++step) {
    // ---- exact FK + linearization at parent 0 (reference :341-346) ----
    float x0[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x0[v] = p0g[v];
    fk_frames<V>(P, nn, x0, frames_p, frames_q);
    float tips0[T][7];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int s = P.tip_slot[t];
#pragma unroll
      for (int c = 0; c < 3; ++c) tips0[t][c] = frames_p[s][c];
#pragma unroll
      for (int c = 0; c < 4; ++c) tips0[t][3 + c] = frames_q[s][c];
    }
    float dts[V][T][7];
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int c = 0; c < 7; ++c) dts[v][t][c] = 0.0f;
    for (int s = 0; s < P.nlinks; ++s) {
      const int* I = P.chain_i + s * LINK_I;
      const int mask = I[4];
      if (!mask) continue;
      const float* F = P.chain_f + s * LINK_F;
      const int slot = I[3];
      const float factor = F[10];
      float om[3];
      qrot(frames_q[s], F + 7, om);
      const bool rev = I[1] == J_REVOLUTE;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (!((mask >> t) & 1)) continue;
        float dd[7];
        if (rev) {
          float arm[3] = {tips0[t][0] - frames_p[s][0], tips0[t][1] - frames_p[s][1],
                          tips0[t][2] - frames_p[s][2]};
          dd[0] = om[1] * arm[2] - om[2] * arm[1];
          dd[1] = om[2] * arm[0] - om[0] * arm[2];
          dd[2] = om[0] * arm[1] - om[1] * arm[0];
          float w4[4] = {om[0], om[1], om[2], 0.0f}, dq4[4];
          qmul(w4, &tips0[t][3], dq4);
#pragma unroll
          for (int c = 0; c < 4; ++c) dd[3 + c] = 0.5f * dq4[c];
        } else {
          dd[0] = om[0]; dd[1] = om[1]; dd[2] = om[2];
          dd[3] = dd[4] = dd[5] = dd[6] = 0.0f;
        }
        if (factor != 1.0f) {
#pragma unroll
          for (int c = 0; c < 7; ++c) dd[c] = factor * dd[c];
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (slot == v) {
#pragma unroll
            for (int c = 0; c < 7; ++c) dts[v][t][c] = dts[v][t][c] + dd[c];
          }
      }
    }
    Lin<V, K> L;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (inst_tip[k] == t) {
#pragma unroll
          for (int c = 0; c < 7; ++c) {
            L.base[k][c] = tips0[t][c];
#pragma unroll
            for (int v = 0; v < V; ++v) L.d[v][k][c] = dts[v][t][c];
          }
        }

    // ---- generations (reference :349-431) ----
    float gtmp[V];
    float f_p0 = eval_lin<V, K, false>(L, G, p0g, x0, gtmp);
    float f_p1 = eval_lin<V, K, false>(L, G, p1g, x0, gtmp);
    for (int g = 0; g < P.gens; ++g) {
      // running best-two over the pool in order p0, p1, child 0..C-1 with
      // strict '<' = the first-min pick of the reference
      float b1g[V], b1r[V], b2g[V], b2r[V], f1, f2;
      const bool sw = f_p1 < f_p0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        b1g[v] = sw ? p1g[v] : p0g[v]; b1r[v] = sw ? p1r[v] : p0r[v];
        b2g[v] = sw ? p0g[v] : p1g[v]; b2r[v] = sw ? p0r[v] : p1r[v];
      }
      f1 = sw ? f_p1 : f_p0;
      f2 = sw ? f_p0 : f_p1;
      const int gi = step * P.gens + g;
      for (int c = 0; c < C; ++c) {
        const int cg = c + 2;
        const float fmix = (cg % 2 == 0) ? 0.2f : 0.0f;
        const float gfac = (float)(cg % 3);
        float rate;
        if (P.rng_mode == RNG_TENSORS) {
          rate = P.rates[((size_t)gi * C + c) * N + nn];
        } else {
          uint32_t b = philox4x32(n, step, g, V * C + c, P.seed, 0u).x ^ salt;
          rate = __int_as_float((int)(((b & 15u) + 104u) << 23));
        }
        float cgn[V], crn[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float nz;
          if (P.rng_mode == RNG_TENSORS) {
            nz = P.noise[(((size_t)gi * V + v) * C + c) * N + nn];
          } else {
            U4 w = philox4x32(n, step, g, v * C + c, P.seed, 0u);
            if (P.rng_mode == RNG_CLT4) {
              float s = u01(w.x ^ salt, 0.0f) + u01(w.y ^ salt, 0.0f);
              s = s + u01(w.z ^ salt, 0.0f);
              s = s + u01(w.w ^ salt, 0.0f);
              nz = (s - 2.0f) * 1.7320508f;
            } else {
              float a = u01(w.x ^ salt, 2.98023224e-08f);
              float b = u01(w.y ^ salt, 0.0f);
              nz = sqrtf(-2.0f * logf(a)) * cosf(6.28318548f * b);
            }
          }
          float pg = p0r[v] * (1.0f - fmix) + p1r[v] * fmix;
          float gv = p0g[v] + nz * (rate * span[v]) + pg * gfac;
          gv = clampf(gv, cmin[v], cmax[v]);
          cgn[v] = gv;
          crn[v] = pg * 0.7f + (gv - p0g[v]) * 0.3f;
        }
        float f = eval_lin<V, K, false>(L, G, cgn, x0, gtmp);
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

    // ---- memetic on parent 0 (reference :436-600) ----
    if (P.memetic) {
      float x[V];
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = p0g[v];
      bool done = false;
      for (int it = 0; it < P.mem_iters; ++it) {
        float grad[V];
        const float f2p = eval_lin<V, K, true>(L, G, x, x0, grad);
        const float f2 = f2p;
        float l1 = 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) l1 = l1 + fabsf(grad[v]);
        const float scale = P.h / (l1 + 1e-12f);
        float gdir[V], xm[V], xp[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          gdir[v] = grad[v] * scale;
          xm[v] = x[v] - gdir[v];
          xp[v] = x[v] + gdir[v];
        }
        const float f1 = eval_lin<V, K, false>(L, G, xm, x0, gtmp);
        const float f3 = eval_lin<V, K, false>(L, G, xp, x0, gtmp);
        float cand[V];
        if (P.memetic == 1) {  // quadratic line search
          const float v1 = f2 - f1, v2 = f3 - f2;
          const float vv = (v1 + v2) * 0.5f;
          const float a = v1 - v2;
          float st = vv / a;
          st = isfinite(st) ? st : 0.0f;
#pragma unroll
          for (int v = 0; v < V; ++v) cand[v] = clampf(x[v] + gdir[v] * st, cmin[v], cmax[v]);
        } else {               // linear
          const float cd = (f3 - f1) * 0.5f;
          float st = f2 / cd;
          st = isfinite(st) ? st : 0.0f;
#pragma unroll
          for (int v = 0; v < V; ++v) cand[v] = clampf(x[v] - gdir[v] * st, cmin[v], cmax[v]);
        }
        const float f4 = eval_lin<V, K, false>(L, G, cand, x0, gtmp);
        const bool accept = (f4 < f2p) && !done;
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] = accept ? cand[v] : x[v];
        done = done || !accept;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) p0g[v] = x[v];
    }

    // ---- exact FK + species fitness at the new parent 0 ----
    fk_frames<V>(P, nn, p0g, frames_p, frames_q);
    float tips[T][7];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int s = P.tip_slot[t];
#pragma unroll
      for (int c = 0; c < 3; ++c) tips[t][c] = frames_p[s][c];
#pragma unroll
      for (int c = 0; c < 4; ++c) tips[t][3 + c] = frames_q[s][c];
    }
    float ph[K][7];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (inst_tip[k] == t) {
#pragma unroll
          for (int c = 0; c < 7; ++c) ph[k][c] = tips[t][c];
        }
    float fit = eval_exact<V, K>(ph, G);

    // ---- megastep bookkeeping (bio2_megastep.py:120-156) ----
    // 1. per-lane incumbent on strict '<'
    if (fit < sol_fit) {
      sol_fit = fit;
      if (live) {
#pragma unroll
        for (int v = 0; v < V; ++v) P.sol_o[v * N + n] = p0g[v];
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int c = 0; c < 7; ++c) P.sol_tips_o[(t * 7 + c) * N + n] = tips[t][c];
      }
    }
    // 2. improvement, taken before the swap
    bool improved = fit != sfit;
    // 3. species compare-swap with the adjacent lane
    const float fp = __shfl_xor_sync(0xffffffffu, fit, 1);
    const bool swap = even ? (fp < fit) : (fit < fp);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float a = __shfl_xor_sync(0xffffffffu, p0g[v], 1);
      float b = __shfl_xor_sync(0xffffffffu, p1g[v], 1);
      float c = __shfl_xor_sync(0xffffffffu, p0r[v], 1);
      float d = __shfl_xor_sync(0xffffffffu, p1r[v], 1);
      if (swap) { p0g[v] = a; p1g[v] = b; p0r[v] = c; p1r[v] = d; }
    }
    const bool pimp = __shfl_xor_sync(0xffffffffu, (int)improved, 1) != 0;
    if (swap) { improved = pimp; fit = fp; }
    // 4. wipeout of the odd lane: both parents to the same random genes
    float wu, wg[V];
    if (P.rng_mode == RNG_TENSORS) {
      wu = P.wipe_u[(size_t)step * N + nn];
#pragma unroll
      for (int v = 0; v < V; ++v) wg[v] = P.wipe_g[((size_t)step * V + v) * N + nn];
    } else {
      wu = u01(philox4x32(n, step, 0xFFFFFFFFu, 0u, P.seed, 0u).x ^ salt, 0.0f);
#pragma unroll
      for (int v = 0; v < V; ++v)
        wg[v] = u01(philox4x32(n, step, 0xFFFFFFFFu, 1u + v, P.seed, 0u).x ^ salt, 0.0f);
    }
    const bool wipe = !even && (wu < 0.1f || !improved);
    if (wipe) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float lo = P.amin[v * N + nn], hi = P.amax[v * N + nn];
        const float r = lo + wg[v] * (hi - lo);
        p0g[v] = r; p1g[v] = r; p0r[v] = 0.0f; p1r[v] = 0.0f;
      }
    }
    sfit = fit;
  }

  if (live) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      P.genes_o[v * N + n] = p0g[v];
      P.genes_o[(V + v) * N + n] = p1g[v];
      P.grads_o[v * N + n] = p0r[v];
      P.grads_o[(V + v) * N + n] = p1r[v];
    }
    P.sfit_o[n] = sfit;
    P.sol_fit_o[n] = sol_fit;
  }
}

// The megastep with joint-space secondary goals: the same bookkeeping
// around bio2_step<..., SEC = true>; the children of a generation in
// dynamic shared memory.
template <int V, int K, int T>
__global__ void __launch_bounds__(BLOCK)
megastep_sec_kernel(const Params P) {
  extern __shared__ float smem[];   // the generation's children
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = n < P.N;
  const int nn = live ? n : P.N - 1;   // padding threads read a real lane
  const size_t N = P.N;
  const bool even = (n & 1) == 0;
  const uint32_t salt = (uint32_t)P.salt[nn];

  float frames_p[MAX_LINKS][3], frames_q[MAX_LINKS][4];
  float p0g[V], p1g[V], p0r[V], p1r[V];
  float span[V], cmin[V], cmax[V];
  Goals<V, K> G;
  int inst_tip[K];
  load_lane<V, K>(P, nn, p0g, p1g, p0r, p1r, span, cmin, cmax, G, inst_tip);
  float sfit = P.sfit[nn];
  float sol_fit = P.sol_fit[nn];
  // the incumbent genes/tips live in the output buffers
  if (live) {
#pragma unroll
    for (int v = 0; v < V; ++v) P.sol_o[v * N + n] = P.sol[v * N + n];
#pragma unroll
    for (int r = 0; r < 7 * T; ++r) P.sol_tips_o[r * N + n] = P.sol_tips[r * N + n];
  }

  for (int step = 0; step < P.n_steps; ++step) {
    float tips[T][7];
    float fit = bio2_step<V, K, T, true>(P, n, nn, salt, step, p0g, p1g, p0r, p1r,
                                         span, cmin, cmax, G, inst_tip, frames_p,
                                        frames_q, smem, tips);

    // ---- megastep bookkeeping (bio2_megastep.py:120-156) ----
    // 1. per-lane incumbent on strict '<'
    if (fit < sol_fit) {
      sol_fit = fit;
      if (live) {
#pragma unroll
        for (int v = 0; v < V; ++v) P.sol_o[v * N + n] = p0g[v];
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int c = 0; c < 7; ++c) P.sol_tips_o[(t * 7 + c) * N + n] = tips[t][c];
      }
    }
    // 2. improvement, taken before the swap
    bool improved = fit != sfit;
    // 3. species compare-swap with the adjacent lane
    const float fp = __shfl_xor_sync(0xffffffffu, fit, 1);
    const bool swap = even ? (fp < fit) : (fit < fp);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float a = __shfl_xor_sync(0xffffffffu, p0g[v], 1);
      float b = __shfl_xor_sync(0xffffffffu, p1g[v], 1);
      float c = __shfl_xor_sync(0xffffffffu, p0r[v], 1);
      float d = __shfl_xor_sync(0xffffffffu, p1r[v], 1);
      if (swap) { p0g[v] = a; p1g[v] = b; p0r[v] = c; p1r[v] = d; }
    }
    const bool pimp = __shfl_xor_sync(0xffffffffu, (int)improved, 1) != 0;
    if (swap) { improved = pimp; fit = fp; }
    // 4. wipeout of the odd lane: both parents to the same random genes
    float wu, wg[V];
    if (P.rng_mode == RNG_TENSORS) {
      wu = P.wipe_u[(size_t)step * N + nn];
#pragma unroll
      for (int v = 0; v < V; ++v) wg[v] = P.wipe_g[((size_t)step * V + v) * N + nn];
    } else {
      wu = u01(philox4x32(n, step, 0xFFFFFFFFu, 0u, P.seed, 0u).x ^ salt, 0.0f);
#pragma unroll
      for (int v = 0; v < V; ++v)
        wg[v] = u01(philox4x32(n, step, 0xFFFFFFFFu, 1u + v, P.seed, 0u).x ^ salt, 0.0f);
    }
    const bool wipe = !even && (wu < 0.1f || !improved);
    if (wipe) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float lo = P.amin[v * N + nn], hi = P.amax[v * N + nn];
        const float r = lo + wg[v] * (hi - lo);
        p0g[v] = r; p1g[v] = r; p0r[v] = 0.0f; p1r[v] = 0.0f;
      }
    }
    sfit = fit;
  }

  if (live) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      P.genes_o[v * N + n] = p0g[v];
      P.genes_o[(V + v) * N + n] = p1g[v];
      P.grads_o[v * N + n] = p0r[v];
      P.grads_o[(V + v) * N + n] = p1r[v];
    }
    P.sfit_o[n] = sfit;
    P.sol_fit_o[n] = sol_fit;
  }
}

// The fullstep kernel (TPU make_fullstep_kernel): one bio2 step per lane,
// no species bookkeeping, pose family without secondary goals as there;
// Philox step word 0.
template <int V, int K, int T>
__global__ void __launch_bounds__(BLOCK)
fullstep_kernel(const Params P) {
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= P.N) return;   // no exchange between lanes
  const size_t N = P.N;
  const uint32_t salt = (uint32_t)P.salt[n];
  float frames_p[MAX_LINKS][3], frames_q[MAX_LINKS][4];
  float p0g[V], p1g[V], p0r[V], p1r[V];
  float span[V], cmin[V], cmax[V];
  Goals<V, K> G;
  int inst_tip[K];
  load_lane<V, K>(P, n, p0g, p1g, p0r, p1r, span, cmin, cmax, G, inst_tip);
  float tips[T][7];
  const float fit = bio2_step<V, K, T, false>(P, n, n, salt, 0, p0g, p1g, p0r, p1r,
                                              span, cmin, cmax, G, inst_tip,
                                              frames_p, frames_q, nullptr, tips);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    P.genes_o[v * N + n] = p0g[v];
    P.genes_o[(V + v) * N + n] = p1g[v];
    P.grads_o[v * N + n] = p0r[v];
    P.grads_o[(V + v) * N + n] = p1r[v];
  }
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int c = 0; c < 7; ++c) P.tips_o[(t * 7 + c) * N + n] = tips[t][c];
  P.fit_o[n] = fit;
}

// ------------------------------------------------------------ C API ----
// (V, K, T) instances; kernels/bio2_megastep.py::MEGASTEP_SHAPES lists the
// same.  Each has a pose-only and a secondary-goal (SEC) megastep.
#define SHAPES(X) X(7, 1, 1) X(6, 1, 1)

extern "C" int megastep_has_shape(int V, int K, int T) {
#define HAS(v, k, t) if (V == v && K == k && T == t) return 1;
  SHAPES(HAS)
#undef HAS
  return 0;
}

extern "C" int megastep_launch(
    int V, int K, int T, int N, int nlinks, int n_steps, int gens, int C,
    int mem_iters, int memetic, float h, int rng_mode, unsigned int seed,
    unsigned int sec_mask, const int* salt,
    const float* genes, const float* grads, const float* sfit,
    const float* sol, const float* sol_fit, const float* sol_tips,
    float* genes_o, float* grads_o, float* sfit_o, float* sol_o,
    float* sol_fit_o, float* sol_tips_o,
    const float* qfix, const float* gpos, const float* gquat,
    const float* wpos, const float* wrot, const float* span,
    const float* cmin, const float* cmax, const float* amin,
    const float* amax, const float* sec, const float* noise, const float* rates,
    const float* wipe_u, const float* wipe_g, const float* keep,
    const int* chain_i, const float* chain_f, const int* tip_slot,
    const int* inst_tip, void* stream) {
  if (N <= 0 || (N & 1) || nlinks > MAX_LINKS || C <= 0) return (int)cudaErrorInvalidValue;
  Params P{N, nlinks, n_steps, gens, C, mem_iters, memetic, rng_mode, h, seed,
           sec_mask, salt, genes, grads, sfit, sol, sol_fit, sol_tips,
           genes_o, grads_o, sfit_o, sol_o, sol_fit_o, sol_tips_o, nullptr, nullptr,
           qfix, gpos, gquat, wpos, wrot, span, cmin, cmax, amin, amax, sec,
           noise, rates, wipe_u, wipe_g, keep, chain_i, chain_f, tip_slot, inst_tip};
  dim3 grid((N + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sec_mask ? (size_t)C * (V + 1) * BLOCK * sizeof(float) : 0;
#define LAUNCH(v, k, t)                                                              \
  if (V == v && K == k && T == t) {                                                  \
    if (!sec_mask) {                                                                 \
      megastep_kernel<v, k, t><<<grid, block, 0, s>>>(P);                            \
    } else {                                                                         \
      cudaError_t e = cudaFuncSetAttribute(megastep_sec_kernel<v, k, t>,             \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);                   \
      if (e != cudaSuccess) return (int)e;                                           \
      megastep_sec_kernel<v, k, t><<<grid, block, smem, s>>>(P);                     \
    }                                                                                \
    return (int)cudaGetLastError();                                                  \
  }
  SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int fullstep_launch(
    int V, int K, int T, int N, int nlinks, int gens, int C, int mem_iters,
    int memetic, float h, int rng_mode, unsigned int seed, const int* salt,
    const float* genes, const float* grads, const float* qfix,
    const float* gpos, const float* gquat, const float* wpos, const float* wrot,
    const float* span, const float* cmin, const float* cmax,
    const float* noise, const float* rates, float* genes_o, float* grads_o,
    float* tips_o, float* fit_o, const int* chain_i, const float* chain_f,
    const int* tip_slot, const int* inst_tip, void* stream) {
  if (N <= 0 || nlinks > MAX_LINKS || C <= 0) return (int)cudaErrorInvalidValue;
  Params P{N, nlinks, 1, gens, C, mem_iters, memetic, rng_mode, h, seed, 0u,
           salt, genes, grads, nullptr, nullptr, nullptr, nullptr,
           genes_o, grads_o, nullptr, nullptr, nullptr, nullptr, tips_o, fit_o,
           qfix, gpos, gquat, wpos, wrot, span, cmin, cmax, nullptr, nullptr, nullptr,
           noise, rates, nullptr, nullptr, nullptr, chain_i, chain_f, tip_slot, inst_tip};
  dim3 grid((N + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(v, k, t) \
  if (V == v && K == k && T == t) { fullstep_kernel<v, k, t><<<grid, block, 0, s>>>(P); return (int)cudaGetLastError(); }
  SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
