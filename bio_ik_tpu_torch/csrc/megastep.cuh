// Fused bio2 megastep for Hopper (sm_90a): n_steps whole bio2 solver steps
// per lane in one launch, with the species sort, wipeout and per-lane
// incumbent bookkeeping between steps.
//
// What both layouts share (Params, the quaternion ops, the selection) and
// the narrow layout's step, kernels and C API: csrc/megastep.cu
// (MEGASTEP_WIDE 0: the pose family on few variables, one thread a lane,
// the lane's linearization in registers).  With MEGASTEP_WIDE 1 the step,
// kernels and C API are those of csrc/megastep_wide.cuh (many variables and
// tips, every goal kind of the step, a lane over a group of W threads):
// csrc/megastep_wide.cu (the PR2 dual arm), csrc/megastep_high.cu
// (snake-32 and the 30-DOF humanoid) and the source that
// kernels/bio2_megastep.py::megastep_instance generates for any other shape
// on its first use.  Each source defines SHAPES(X) and GROUPS(X, v, k, t)
// before including this header.
//
// Replaces the TPU kernel bio_ik_tpu/kernels/bio2_megastep.py::
// make_megastep_kernel (its pl.pallas_call), which inlines
// bio2_fullstep.py::make_fullstep_inner, fk_rows.py::FkRows and the
// in-kernel RNG (make_rng_helpers, gauss_from_u01, make_rate_draw).  The
// plain torch version it is held to is
// bio_ik_tpu_torch/kernels/bio2_megastep.py::make_megastep_body.  A second
// entry point, fullstep_launch, runs one step without the bookkeeping: the
// port of the TPU kernel bio2_fullstep.py::make_fullstep_kernel.
//
// What bounds the narrow layout on the card: issued instructions, most of them the
// generator's integer work, and their latency.  For PR2 (V=7, K=1, C=16,
// gens=8, mem_iters=8) a lane-step does ~23.4k FLOPs (gens·(C+2) +
// 4·mem_iters linearized fitness evaluations, three exact FK passes) on
// 536 bytes of state per launch — far above the FP32 ridge — and makes 778
// Philox4x32-10 calls (48 SASS instructions each, 20 of them 32×32→64
// multiplies on the IMAD pipe).  Tensor cores do not apply: the per-lane
// products are 7×V by V×1 matrices in float32, and TF32 would lose the
// 1e-7 m precision the main path holds.  The design:
//   * one step body, bio2_step<V, K, T, SEC, G>, for all three kernels
//     (megastep_kernel, megastep_sec_kernel, fullstep_kernel);
//   * a lane's C children can be split over a group of G adjacent threads
//     (G ∈ {1, 2, 4, 8}; the wrapper picks G per launch from the lane count
//     and the occupancy, bio2_megastep.choose_group: G > 1 only where a
//     launch leaves the card part empty, since every thread of a group
//     repeats the exact FK, the linearization, the memetic line search and
//     the bookkeeping — about a quarter of a lane-step, and the memetic
//     search is sequential).  Thread j makes and evaluates children
//     c ≡ j (mod G) with the Philox counters of G = 1 and keeps its own best
//     two; the generation's best two come from a shuffle merge over the
//     group that reproduces the sequential strict-'<' scan over p0, p1,
//     child 0..C-1 (ties to the earlier, NaN and +inf children never taken,
//     a NaN p0 or p1 sticky — see select_two).  Results do not depend on G;
//   * lean draws with the distributions unchanged: a child's V CLT4
//     Gaussians take 4V 24-bit fields packed four to three words
//     (ceil(3V/4) calls instead of V), each the integer sum of its four
//     fields (exact, < 2^26) converted once; the C rates of a generation
//     are the 4-bit fields of one call (the secondary pre-selection's keep
//     uniform is that call's spare word); the wipe coin and restart genes
//     come from ceil((V+1)/4) calls;
//   * registers (168 or 255, see MIN_BLOCKS): the link table and the
//     lane's clamp rows (span, cmin, cmax; with SEC the secondary rows) live
//     in shared memory, one column per lane; the FK keeps only the running
//     frame in registers (the linearization re-runs the FK once the tip is
//     known) and stores in shared memory only the frames of links that a
//     later, non-adjacent link hangs from — no frame array in local memory;
//   * with secondary goals (SEC) a thread keeps only its children's
//     secondary and primary fitness (shared memory), ranks the C secondary
//     values (across the group by shuffles) and draws the two winners again
//     from their counters instead of keeping every child's genes;
//   * the two species of an island are adjacent lanes, so the species
//     compare-swap is __shfl_xor_sync(…, G) (the TPU kernel's
//     pltpu.roll(±1)); padding threads past N·G read lane N−1, take part in
//     every shuffle and skip the stores.
// Randomness is counter-based Philox4x32-10 in registers (key (seed, 0),
// counter (lane, step, generation, draw)), the salt of the lane's scenario
// XORed into every word, as the TPU kernel did with its hardware PRNG; the
// generator and its word-to-draw maps are csrc/philox.cuh, shared with the
// species kernel.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: sincosf/logf/cosf and division are
// the IEEE-accurate versions; FMA contraction on, as before).  rsqrtf in
// the goal kinds is the approximate instruction, as torch.rsqrt on the card.

#pragma once

#ifndef MEGASTEP_WIDE
#error "define MEGASTEP_WIDE (0 or 1), SHAPES and GROUPS before including megastep.cuh"
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "sec_eval.cuh"

#define MAX_LINKS 40   // must equal fk_rows.MAX_LINKS
#define LINK_I 7       // ints per link: fk_rows.FkRows.chain_arrays + branch slot
#define LINK_F 19      // floats per link
#define BLOCK 128
#define MAX_C 16       // children per generation (the rates use 4-bit fields of one call)
#define FULL 0xffffffffu
#define NO_CHILD 0x7fffffff

enum { SRC_NONE = 0, SRC_ACTIVE = 1, SRC_FIXED = 2, SRC_CONST = 3 };
enum { J_FIXED = 0, J_REVOLUTE = 1, J_PRISMATIC = 2 };
enum { RNG_TENSORS = 0, RNG_CLT4 = 1, RNG_BOX_MULLER = 2 };
enum { H_P0 = -2, H_P1 = -1 };   // handles of the two parents in select_two
// goal kinds (kernels/bio2_megastep.KIND_CODE): the pose family, then
// bio2_fullstep.LINK_KINDS in order
enum { GK_POSE = 0, GK_LOOKAT = 1, GK_LINE = 2, GK_PLANE = 3, GK_MAXD = 4, GK_MIND = 5,
       GK_CONE = 6, GK_DIRECTION = 7, GK_SIDE = 8 };

struct Params {
  int N, nlinks, nbranch, n_steps, gens, C, mem_iters, memetic, rng_mode;
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
  // the wide layout: the gaux rows, each instance's kind, the columns of
  // the linearization (cols: V·T by (v, t), then K·V by (k, v); −1 none)
  const float* gaux;
  const int *inst_kind, *cols;
  int ncol;
};

// The `sec` rows (sec_eval.cuh order) the terms of `mask` read.
__host__ __device__ inline unsigned sec_rows_needed(unsigned mask) {
  unsigned r = 0;
  if (mask & SECM_ALPHA) r |= (1u << SEC_ALPHA) | (1u << SEC_MID);
  if (mask & SECM_BETA) r |= (1u << SEC_BETA) | (1u << SEC_SEED);
  if (mask & SECM_GAMMA) r |= (1u << SEC_GAMMA) | (1u << SEC_MID) | (1u << SEC_HSPAN);
  if (mask & SECM_DELTA) r |= (1u << SEC_DELTA) | (1u << SEC_TBAR);
  return r;
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

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float child_momentum(int c, float p0g, float p0r, float p1r,
                                                float gv) {
  const float fmix = ((c + 2) % 2 == 0) ? 0.2f : 0.0f;
  const float pg = p0r * (1.0f - fmix) + p1r * fmix;
  return pg * 0.7f + (gv - p0g) * 0.3f;
}

// Running best two on strict '<' — offered in increasing index, ties keep
// the earlier one; from (+inf, NO_CHILD), NaN and +inf are never taken.
__device__ __forceinline__ void offer(float f, int c, float& f1, int& i1, float& f2, int& i2) {
  if (f < f1) { f2 = f1; i2 = i1; f1 = f; i1 = c; }
  else if (f < f2) { f2 = f; i2 = c; }
}

__device__ __forceinline__ bool lex_less(float fa, int ia, float fb, int ib) {
  return fa < fb || (fa == fb && ia < ib);
}

// The group's best two children under (f, index) from each thread's own
// best two: a butterfly of shuffles over the G threads of the lane.  The
// merge is commutative and associative (distinct indices; empty slots are
// (+inf, NO_CHILD)), so every thread of the group ends with the same pair.
template <int G>
__device__ __forceinline__ void group_best_two(float& f1, int& i1, float& f2, int& i2) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float g1 = __shfl_xor_sync(FULL, f1, off), g2 = __shfl_xor_sync(FULL, f2, off);
    const int j1 = __shfl_xor_sync(FULL, i1, off), j2 = __shfl_xor_sync(FULL, i2, off);
    if (lex_less(g1, j1, f1, i1)) {
      if (lex_less(f1, i1, g2, j2)) { f2 = f1; i2 = i1; } else { f2 = g2; i2 = j2; }
      f1 = g1; i1 = j1;
    } else if (lex_less(g1, j1, f2, i2)) {
      f2 = g1; i2 = j1;
    }
  }
}

// The sequential scan of the reference's first-min pick over the pool p0,
// p1, child 0..C−1 with strict '<' (bio2_fullstep: select 2 of C+2), given
// the children's best two (c1 before c2 under (f, index)): p0 first, p1
// second (swapped when f_p1 < f_p0), then c1, c2 offered in turn.  Offering
// only the children's best two gives the scan's result: a child outside
// them is beaten by both in the scan's order, and NaN or +inf children are
// never taken by the scan either; a NaN p0 (or p1 that stays second) is
// never displaced, as in the scan.  Returns handles: H_P0, H_P1 or a child.
__device__ __forceinline__ void select_two(float f_p0, float f_p1, float c1f, int c1,
                                           float c2f, int c2, float& f1, int& h1,
                                           float& f2, int& h2) {
  const bool sw = f_p1 < f_p0;
  f1 = sw ? f_p1 : f_p0; h1 = sw ? H_P1 : H_P0;
  f2 = sw ? f_p0 : f_p1; h2 = sw ? H_P0 : H_P1;
  offer(c1f, c1, f1, h1, f2, h2);
  offer(c2f, c2, f1, h1, f2, h2);
}


template <typename KF>
static int prepare(KF kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

#if MEGASTEP_WIDE

#include "megastep_wide.cuh"

#else   // the narrow layout

// Resident blocks per SM the register budget is held to: 3 (168
// registers) for the pose-only kernel at G = 1 and the fullstep kernel, 2
// (255) for the pose-only kernel at G > 1 and the secondary-goal kernel:
// each the faster on an H100 (PERF.md §6).
constexpr int MIN_BLOCKS = 3;
constexpr int GROUP_MIN_BLOCKS = 2;

// Dynamic shared memory of a block, in 4-byte words: the link table, the
// branch frames (per thread), the lane rows (per lane: span, cmin, cmax
// and, with SEC, the 8·V secondary rows, of which those in use are
// loaded), with SEC each thread's children's secondary and primary
// fitness.
struct Layout {
  int link_i, link_f, branch, lane, kids, words;
};

__host__ __device__ inline Layout layout(int V, int nlinks, int nbranch, int C, int G,
                                         unsigned sec_mask) {
  Layout L;
  int o = 0;
  L.link_i = o; o += nlinks * LINK_I;
  L.link_f = o; o += nlinks * LINK_F;
  L.branch = o; o += nbranch * 7 * BLOCK;
  L.lane = o;   o += (sec_mask ? 3 + 8 : 3) * V * (BLOCK / G);
  L.kids = o;   o += sec_mask ? (C / G) * 2 * BLOCK : 0;
  L.words = o;
  return L;
}

template <int V>
__device__ __forceinline__ float pick_var(const float (&x)[V], int idx) {
  float r = x[0];
#pragma unroll
  for (int v = 1; v < V; ++v) r = (idx == v) ? x[v] : r;
  return r;
}

// ------------------------------------------------------------ the lane --
// Where a thread finds its lane: Philox lane n (padding threads past N
// keep their own n), data lane nn, rank j in the lane's group, the chain
// and the lane's rows in shared memory.
template <int V, int T, int G>
struct Lane {
  static constexpr int ld = BLOCK / G;   // lanes per block: the lane rows' stride
  int n, nn, j;
  uint32_t salt;
  const int* li;     // link table, LINK_I ints per link
  const float* lf;   // link table, LINK_F floats per link
  float* br;         // this thread's branch frames (stride BLOCK)
  const float* rows; // this lane's column of the lane rows (stride ld)
  float* kids;       // SEC: this thread's children (stride BLOCK)
  int tip_slot[T];
  __device__ float span(int v) const { return rows[v * ld]; }
  __device__ float cmin(int v) const { return rows[(V + v) * ld]; }
  __device__ float cmax(int v) const { return rows[(2 * V + v) * ld]; }
};

// The secondary rows of the lane in shared memory (sec_eval.cuh order).
template <int V, int LD>
struct SmemSecRows {
  const float* p;
  __device__ __forceinline__ float operator()(int r, int v) const {
    return p[(r * V + v) * LD];
  }
};

// Block prologue: the link table and the lane rows into shared memory.
// Every thread of the block reaches the barrier (padding threads too).
template <int V, int K, int T, int G>
__device__ __forceinline__ Lane<V, T, G> enter(const Params& P, float* smem) {
  const Layout Lo = layout(V, P.nlinks, P.nbranch, P.C, G, P.sec_mask);
  const int tid = threadIdx.x;
  const int LPB = BLOCK / G;
  const int lane0 = blockIdx.x * LPB;
  int* li = reinterpret_cast<int*>(smem) + Lo.link_i;
  float* lf = smem + Lo.link_f;
  for (int i = tid; i < P.nlinks * LINK_I; i += BLOCK) li[i] = P.chain_i[i];
  for (int i = tid; i < P.nlinks * LINK_F; i += BLOCK) lf[i] = P.chain_f[i];
  const unsigned need = sec_rows_needed(P.sec_mask);
  const int nrows = (P.sec_mask ? 3 + 8 : 3) * V;
  float* rows = smem + Lo.lane;
  const size_t N = P.N;
  for (int i = tid; i < nrows * LPB; i += BLOCK) {
    const int r = i / LPB, l = i - r * LPB;
    const int lane = min(lane0 + l, P.N - 1);
    const float* src;
    if (r < V) src = P.span + r * N;
    else if (r < 2 * V) src = P.cmin + (r - V) * N;
    else if (r < 3 * V) src = P.cmax + (r - 2 * V) * N;
    else if ((need >> ((r - 3 * V) / V)) & 1u) src = P.sec + (r - 3 * V) * N;
    else continue;   // a secondary row no term reads
    rows[i] = src[lane];
  }
  __syncthreads();

  Lane<V, T, G> X;
  const int t = blockIdx.x * BLOCK + tid;
  X.n = t / G;
  X.j = t & (G - 1);
  X.nn = min(X.n, P.N - 1);
  X.salt = (uint32_t)P.salt[X.nn];
  X.li = li;
  X.lf = lf;
  X.br = smem + Lo.branch + tid;
  X.rows = rows + tid / G;
  X.kids = smem + Lo.kids + tid;
#pragma unroll
  for (int t2 = 0; t2 < T; ++t2) X.tip_slot[t2] = P.tip_slot[t2];
  return X;
}

// ----------------------------------------------------------------- FK --
// Exact FK over the link schedule (fk_rows.FkRows.frames) with the running
// frame in registers.  Without LIN: the tip frames into `tips`.  With LIN
// (a second pass, the tips known): the delta rows ∂tip/∂x_v of every moving
// link into `dts` (fk_rows.FkRows.deltas), from the same frames.
template <int V, int T, int G, bool LIN>
__device__ __forceinline__ void fk_pass(const Params& P, const Lane<V, T, G>& X,
                                        const float (&x)[V], float (&tips)[T][7],
                                        float (&dts)[V][T][7]) {
  float cp[3] = {0.0f, 0.0f, 0.0f}, cq[4] = {0.0f, 0.0f, 0.0f, 1.0f};
  for (int s = 0; s < P.nlinks; ++s) {
    const int* I = X.li + s * LINK_I;
    const float* F = X.lf + s * LINK_F;
    const int kind = I[2];
    float np[3], nq[4];
    if (kind == SRC_CONST) {
      np[0] = F[12]; np[1] = F[13]; np[2] = F[14];
      nq[0] = F[15]; nq[1] = F[16]; nq[2] = F[17]; nq[3] = F[18];
    } else {
      float pp[3], pq[4];
      if (I[5]) {
        pp[0] = F[12]; pp[1] = F[13]; pp[2] = F[14];
        pq[0] = F[15]; pq[1] = F[16]; pq[2] = F[17]; pq[3] = F[18];
      } else {
        const int par = I[0];
        float ap[3], aq[4];
        if (par == s - 1) {
          ap[0] = cp[0]; ap[1] = cp[1]; ap[2] = cp[2];
          aq[0] = cq[0]; aq[1] = cq[1]; aq[2] = cq[2]; aq[3] = cq[3];
        } else {   // a branch link: its frame was kept in shared memory
          const float* b = X.br + X.li[par * LINK_I + 6] * 7 * BLOCK;
          ap[0] = b[0]; ap[1] = b[BLOCK]; ap[2] = b[2 * BLOCK];
          aq[0] = b[3 * BLOCK]; aq[1] = b[4 * BLOCK]; aq[2] = b[5 * BLOCK];
          aq[3] = b[6 * BLOCK];
        }
        float r[3];
        qrot(aq, F + 0, r);
        pp[0] = ap[0] + r[0];
        pp[1] = ap[1] + r[1];
        pp[2] = ap[2] + r[2];
        qmul(aq, F + 3, pq);
      }
      const int jt = I[1];
      if (jt == J_FIXED || kind == SRC_NONE) {
        np[0] = pp[0]; np[1] = pp[1]; np[2] = pp[2];
        nq[0] = pq[0]; nq[1] = pq[1]; nq[2] = pq[2]; nq[3] = pq[3];
      } else {
        float q = (kind == SRC_ACTIVE) ? pick_var<V>(x, I[3])
                                       : P.qfix[(size_t)I[3] * P.N + X.nn];
        const float f = F[10], off = F[11];
        if (f != 1.0f || off != 0.0f) q = q * f + off;
        if (jt == J_REVOLUTE) {
          float sn, cs;
          sincosf(0.5f * q, &sn, &cs);
          float jq[4] = {F[7] * sn, F[8] * sn, F[9] * sn, cs};
          np[0] = pp[0]; np[1] = pp[1]; np[2] = pp[2];
          qmul(pq, jq, nq);
        } else {  // prismatic
          float d[3] = {F[7] * q, F[8] * q, F[9] * q}, r[3];
          qrot(pq, d, r);
          np[0] = pp[0] + r[0]; np[1] = pp[1] + r[1]; np[2] = pp[2] + r[2];
          nq[0] = pq[0]; nq[1] = pq[1]; nq[2] = pq[2]; nq[3] = pq[3];
        }
      }
    }
    cp[0] = np[0]; cp[1] = np[1]; cp[2] = np[2];
    cq[0] = nq[0]; cq[1] = nq[1]; cq[2] = nq[2]; cq[3] = nq[3];
    if (I[6] >= 0) {
      float* b = X.br + I[6] * 7 * BLOCK;
      b[0] = cp[0]; b[BLOCK] = cp[1]; b[2 * BLOCK] = cp[2];
      b[3 * BLOCK] = cq[0]; b[4 * BLOCK] = cq[1]; b[5 * BLOCK] = cq[2];
      b[6 * BLOCK] = cq[3];
    }
    if (!LIN) {
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (s == X.tip_slot[t]) {
#pragma unroll
          for (int c = 0; c < 3; ++c) tips[t][c] = cp[c];
#pragma unroll
          for (int c = 0; c < 4; ++c) tips[t][3 + c] = cq[c];
        }
      continue;
    }
    const int mask = I[4];
    if (!mask) continue;
    const int slot = I[3];
    const float factor = F[10];
    float om[3];
    qrot(cq, F + 7, om);
    const bool rev = I[1] == J_REVOLUTE;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (!((mask >> t) & 1)) continue;
      float dd[7];
      if (rev) {
        float arm[3] = {tips[t][0] - cp[0], tips[t][1] - cp[1], tips[t][2] - cp[2]};
        dd[0] = om[1] * arm[2] - om[2] * arm[1];
        dd[1] = om[2] * arm[0] - om[0] * arm[2];
        dd[2] = om[0] * arm[1] - om[1] * arm[0];
        float w4[4] = {om[0], om[1], om[2], 0.0f}, dq4[4];
        qmul(w4, &tips[t][3], dq4);
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

// The step's linearized fitness: the Lin rows in registers.
template <int V, int K, int T, int G, bool GRAD>
__device__ __forceinline__ float lin_fit(const Lane<V, T, G>& X, const Lin<V, K>& L,
                                         const Goals<V, K>& GL, const float (&x)[V],
                                         const float (&x0)[V], float (&grad)[V]) {
  return eval_lin<V, K, GRAD>(L, GL, x, x0, grad);
}

// ---------------------------------------------------------- children --
// Genes of child c of generation g (reference :263-299): its noise drawn
// (clt4: Philox counters (lane, step, g, c·clt4_calls + k); Box–Muller:
// (lane, step, g, v·C + c); or the noise tensor), mutated at `rate`,
// momentum-shifted and clipped.  The child's momentum is child_momentum,
// computed only for the children selected.
template <int V, int T, int G>
__device__ __forceinline__ void child_genes(const Params& P, const Lane<V, T, G>& X, int step,
                                            int g, int c, float rate,
                                            const float (&p0g)[V], const float (&p0r)[V],
                                            const float (&p1r)[V], float (&cgn)[V]) {
  const size_t N = P.N;
  const int C = P.C;
  const int gi = step * P.gens + g;
  const int cg = c + 2;
  const float fmix = (cg % 2 == 0) ? 0.2f : 0.0f;
  const float gfac = (float)(cg % 3);
  constexpr int NC = clt4_calls<V>();
  uint32_t w[4 * NC];
  if (P.rng_mode == RNG_CLT4) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const U4 u = salted(philox4x32(X.n, step, g, c * NC + k, P.seed, 0u), X.salt);
      w[4 * k] = u.x; w[4 * k + 1] = u.y; w[4 * k + 2] = u.z; w[4 * k + 3] = u.w;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float nz;
    if (P.rng_mode == RNG_TENSORS) {
      nz = P.noise[(((size_t)gi * V + v) * C + c) * N + X.nn];
    } else if (P.rng_mode == RNG_CLT4) {
      nz = clt4(field24(w, 4 * v), field24(w, 4 * v + 1), field24(w, 4 * v + 2),
                field24(w, 4 * v + 3));
    } else {
      const U4 u = salted(philox4x32(X.n, step, g, v * C + c, P.seed, 0u), X.salt);
      float a = u01(u.x, 2.98023224e-08f);
      float b = u01(u.y, 0.0f);
      nz = sqrtf(-2.0f * logf(a)) * cosf(6.28318548f * b);
    }
    float pg = p0r[v] * (1.0f - fmix) + p1r[v] * fmix;
    float gv = p0g[v] + nz * (rate * X.span(v)) + pg * gfac;
    cgn[v] = clampf(gv, X.cmin(v), X.cmax(v));
  }
}

// ------------------------------------------------------------- the step --
// One whole bio2 step of the lane (bio2_fullstep.make_fullstep_inner):
// exact FK and linearization at parent 0, `gens` generations, the memetic
// line search, exact FK of the new parent 0.  Updates the parents in place,
// writes the exact tip frames to `tips` and returns the exact fitness.
//
// With SEC (joint-space secondary goals, P.sec / P.sec_mask) a generation
// first builds the thread's children with their secondary and primary
// fitness into shared memory, ranks the C secondary values across the group
// (bio2_step.preselect: ties to the lower index) and offers only the
// children the pre-selection keeps; the keep uniform is the spare word of
// the generation's rate call (or P.keep[(step·gens + g)·N + lane]).  The
// memetic line search then runs on primary + secondary and accepts on the
// primary.
template <int V, int K, int T, bool SEC, int G>
__device__ __forceinline__ float bio2_step(const Params& P, const Lane<V, T, G>& X, int step,
                                           float (&p0g)[V], float (&p1g)[V],
                                           float (&p0r)[V], float (&p1r)[V],
                                           const Goals<V, K>& GL, const int (&inst_tip)[K],
                                           float (&tips)[T][7]) {
  constexpr int MAXM = MAX_C / G;   // children per thread at most
  const size_t N = P.N;
  const int C = P.C;
  const int m = C / G;
  const SmemSecRows<V, BLOCK / G> S{X.rows + 3 * V * X.ld};
  const unsigned smask = P.sec_mask;

  // ---- exact FK + linearization at parent 0 (reference :341-346) ----
  float x0[V];
#pragma unroll
  for (int v = 0; v < V; ++v) x0[v] = p0g[v];
  float tips0[T][7];
  float dts[V][T][7];   // the linearization in registers
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int c = 0; c < 7; ++c) dts[v][t][c] = 0.0f;
  fk_pass<V, T, G, false>(P, X, x0, tips0, dts);
  fk_pass<V, T, G, true>(P, X, x0, tips0, dts);
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
  float f_p0 = lin_fit<V, K, T, G, false>(X, L, GL, p0g, x0, gtmp);
  float f_p1 = lin_fit<V, K, T, G, false>(X, L, GL, p1g, x0, gtmp);
  for (int g = 0; g < P.gens; ++g) {
    const int gi = step * P.gens + g;
    U4 rw = {0u, 0u, 0u, 0u};   // the generation's rate call
    if (P.rng_mode != RNG_TENSORS)
      rw = salted(philox4x32(X.n, step, g, V * C, P.seed, 0u), X.salt);
    auto rate = [&](int c) {
      return P.rng_mode == RNG_TENSORS ? P.rates[((size_t)gi * C + c) * N + X.nn]
                                       : rate_of_field(rw, c);
    };
    // this thread's best two children, c ≡ j (mod G)
    float lf1 = __int_as_float(0x7f800000), lf2 = lf1;
    int li1 = NO_CHILD, li2 = NO_CHILD;
    float lb1[V], lb2[V];   // their genes (pose-only)
#pragma unroll
    for (int v = 0; v < V; ++v) lb1[v] = lb2[v] = 0.0f;
    if constexpr (!SEC) {
      for (int c = X.j; c < C; c += G) {
        float cgn[V];
        child_genes<V, T, G>(P, X, step, g, c, rate(c), p0g, p0r, p1r, cgn);
        const float f = lin_fit<V, K, T, G, false>(X, L, GL, cgn, x0, gtmp);
        if (f < lf1) {
          lf2 = lf1; li2 = li1; lf1 = f; li1 = c;
#pragma unroll
          for (int v = 0; v < V; ++v) { lb2[v] = lb1[v]; lb1[v] = cgn[v]; }
        } else if (f < lf2) {
          lf2 = f; li2 = c;
#pragma unroll
          for (int v = 0; v < V; ++v) lb2[v] = cgn[v];
        }
      }
    } else {
      // pre-selection (reference :366-378): the secondary and primary
      // fitness of the thread's children first (their genes are not kept:
      // the two winners are drawn again below)
      for (int k = 0; k < m; ++k) {
        const int c = k * G + X.j;
        float cgn[V];
        child_genes<V, T, G>(P, X, step, g, c, rate(c), p0g, p0r, p1r, cgn);
        X.kids[2 * k * BLOCK] = sec_of<V>(S, smask, cgn);
        X.kids[(2 * k + 1) * BLOCK] = lin_fit<V, K, T, G, false>(X, L, GL, cgn, x0, gtmp);
      }
      const float keep_u = P.rng_mode == RNG_TENSORS ? P.keep[(size_t)gi * N + X.nn]
                                                     : u01(rw.w, 0.0f);
      const int kcount = sec_kcount(keep_u, C);
      // child c is kept when fewer than kcount children j rank before it:
      // s_j < s_c, or s_j == s_c and j < c (bio2_step.preselect)
      float sc[MAXM];
#pragma unroll
      for (int k = 0; k < MAXM; ++k) sc[k] = k < m ? X.kids[2 * k * BLOCK] : 0.0f;
      if constexpr (G == 1) {   // all C values in this thread
#pragma unroll
        for (int k = 0; k < MAXM; ++k) {
          if (k >= m) break;
          int rank = 0;
#pragma unroll
          for (int jj = 0; jj < MAXM; ++jj)
            if (jj != k && jj < m) rank += jj < k ? sc[jj] <= sc[k] : sc[jj] < sc[k];
          if (rank < kcount) offer(X.kids[(2 * k + 1) * BLOCK], k, lf1, li1, lf2, li2);
        }
      } else {                  // the others' values by shuffles
        int rank[MAXM];
#pragma unroll
        for (int k = 0; k < MAXM; ++k) rank[k] = 0;
#pragma unroll
        for (int kk = 0; kk < MAXM; ++kk) {
          if (kk >= m) break;
#pragma unroll
          for (int src = 0; src < G; ++src) {
            const float sv = __shfl_sync(FULL, sc[kk], src, G);
            const int cj = kk * G + src;
#pragma unroll
            for (int k = 0; k < MAXM; ++k) {
              const int c = k * G + X.j;
              rank[k] += (sv < sc[k]) || (sv == sc[k] && cj < c);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < MAXM; ++k)
          if (k < m && rank[k] < kcount)
            offer(X.kids[(2 * k + 1) * BLOCK], k * G + X.j, lf1, li1, lf2, li2);
      }
    }
    float c1f = lf1, c2f = lf2;
    int c1 = li1, c2 = li2;
    group_best_two<G>(c1f, c1, c2f, c2);
    float f1, f2;
    int h1, h2;
    select_two(f_p0, f_p1, c1f, c1, c2f, c2, f1, h1, f2, h2);
    // the winners' genes: pose-only, from the thread that made the child;
    // with SEC and in wide instances, drawn again (the same counters give
    // the same bits); the momentum recomputed from the parents
    float wg[2][V];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int h = w ? h2 : h1;
      const int hc = h < 0 ? 0 : h;
      if constexpr (SEC) {
        child_genes<V, T, G>(P, X, step, g, hc, rate(hc), p0g, p0r, p1r, wg[w]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float mine = (li1 == hc) ? lb1[v] : lb2[v];
          wg[w][v] = G == 1 ? mine : __shfl_sync(FULL, mine, hc & (G - 1), G);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float ng[2], nr[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int h = w ? h2 : h1;
        ng[w] = h == H_P0 ? p0g[v] : (h == H_P1 ? p1g[v] : wg[w][v]);
        nr[w] = h == H_P0 ? p0r[v]
              : (h == H_P1 ? p1r[v] : child_momentum(h, p0g[v], p0r[v], p1r[v], wg[w][v]));
      }
      p0g[v] = ng[0]; p0r[v] = nr[0]; p1g[v] = ng[1]; p1r[v] = nr[1];
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
      const float f2p = lin_fit<V, K, T, G, true>(X, L, GL, x, x0, grad);
      float f2 = f2p;
      if constexpr (SEC) {   // combined fitness for the search, primary for acceptance
        f2 = __fadd_rn(f2p, sec_of<V>(S, smask, x));
#pragma unroll
        for (int v = 0; v < V; ++v) grad[v] = __fadd_rn(grad[v], sec_grad<V>(S, smask, x, v));
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
      float f1 = lin_fit<V, K, T, G, false>(X, L, GL, xm, x0, gtmp);
      float f3 = lin_fit<V, K, T, G, false>(X, L, GL, xp, x0, gtmp);
      if constexpr (SEC) {
        f1 = __fadd_rn(f1, sec_of<V>(S, smask, xm));
        f3 = __fadd_rn(f3, sec_of<V>(S, smask, xp));
      }
      float cand[V];
      if (P.memetic == 1) {  // quadratic line search
        const float v1 = f2 - f1, v2 = f3 - f2;
        const float vv = (v1 + v2) * 0.5f;
        const float a = v1 - v2;
        float st = vv / a;
        st = isfinite(st) ? st : 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) cand[v] = clampf(x[v] + gdir[v] * st, X.cmin(v), X.cmax(v));
      } else {               // linear
        const float cd = (f3 - f1) * 0.5f;
        float st = f2 / cd;
        st = isfinite(st) ? st : 0.0f;
#pragma unroll
        for (int v = 0; v < V; ++v) cand[v] = clampf(x[v] - gdir[v] * st, X.cmin(v), X.cmax(v));
      }
      const float f4 = lin_fit<V, K, T, G, false>(X, L, GL, cand, x0, gtmp);
      const bool accept = (f4 < f2p) && !done;
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = accept ? cand[v] : x[v];
      done = done || !accept;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) p0g[v] = x[v];
  }

  // ---- exact FK + species fitness at the new parent 0 ----
  fk_pass<V, T, G, false>(P, X, p0g, tips, dts);
  float ph[K][7];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (inst_tip[k] == t) {
#pragma unroll
        for (int c = 0; c < 7; ++c) ph[k][c] = tips[t][c];
      }
  return eval_exact<V, K>(ph, GL);
}

// Parents and goal rows of lane nn into registers.
template <int V, int K>
__device__ __forceinline__ void load_lane(const Params& P, int nn,
                                          float (&p0g)[V], float (&p1g)[V],
                                          float (&p0r)[V], float (&p1r)[V],
                                          Goals<V, K>& G, int (&inst_tip)[K]) {
  const size_t N = P.N;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p0g[v] = P.genes[v * N + nn];
    p1g[v] = P.genes[(V + v) * N + nn];
    p0r[v] = P.grads[v * N + nn];
    p1r[v] = P.grads[(V + v) * N + nn];
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

// n_steps steps of bio2_step with the megastep bookkeeping between them
// (bio2_megastep.py:120-156).
template <int V, int K, int T, bool SEC, int G>
__device__ __forceinline__ void megastep_body(const Params& P) {
  extern __shared__ float smem[];
  const Lane<V, T, G> X = enter<V, K, T, G>(P, smem);
  const bool live = X.n < P.N;
  const bool writer = live && X.j == 0;
  const int n = X.n, nn = X.nn;
  const size_t N = P.N;
  const bool even = (n & 1) == 0;

  float p0g[V], p1g[V], p0r[V], p1r[V];
  Goals<V, K> GL;
  int inst_tip[K];
  load_lane<V, K>(P, nn, p0g, p1g, p0r, p1r, GL, inst_tip);
  float sfit = P.sfit[nn];
  float sol_fit = P.sol_fit[nn];
  // the incumbent genes/tips live in the output buffers
  if (writer) {
#pragma unroll
    for (int v = 0; v < V; ++v) P.sol_o[v * N + n] = P.sol[v * N + n];
#pragma unroll
    for (int r = 0; r < 7 * T; ++r) P.sol_tips_o[r * N + n] = P.sol_tips[r * N + n];
  }

  for (int step = 0; step < P.n_steps; ++step) {
    float tips[T][7];
    float fit = bio2_step<V, K, T, SEC, G>(P, X, step, p0g, p1g, p0r, p1r, GL, inst_tip,
                                           tips);
    // 1. per-lane incumbent on strict '<'
    if (fit < sol_fit) {
      sol_fit = fit;
      if (writer) {
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
    // 3. species compare-swap with the adjacent lane (its thread j: xor G)
    const float fp = __shfl_xor_sync(FULL, fit, G);
    const bool swap = even ? (fp < fit) : (fit < fp);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float a = __shfl_xor_sync(FULL, p0g[v], G);
      float b = __shfl_xor_sync(FULL, p1g[v], G);
      float c = __shfl_xor_sync(FULL, p0r[v], G);
      float d = __shfl_xor_sync(FULL, p1r[v], G);
      if (swap) { p0g[v] = a; p1g[v] = b; p0r[v] = c; p1r[v] = d; }
    }
    const bool pimp = __shfl_xor_sync(FULL, (int)improved, G) != 0;
    if (swap) { improved = pimp; fit = fp; }
    // 4. wipeout of the odd lane: both parents to the same random genes;
    //    coin and genes are words 0 and 1 + v of calls 0, 1, … of
    //    generation word 0xFFFFFFFF
    float wu, wg[V];
    if (P.rng_mode == RNG_TENSORS) {
      wu = P.wipe_u[(size_t)step * N + nn];
#pragma unroll
      for (int v = 0; v < V; ++v) wg[v] = P.wipe_g[((size_t)step * V + v) * N + nn];
    } else {
      constexpr int NW = (V + 4) / 4;
      uint32_t ww[4 * NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const U4 w = salted(philox4x32(n, step, 0xFFFFFFFFu, k, P.seed, 0u), X.salt);
        ww[4 * k] = w.x; ww[4 * k + 1] = w.y; ww[4 * k + 2] = w.z; ww[4 * k + 3] = w.w;
      }
      wu = u01(ww[0], 0.0f);
#pragma unroll
      for (int v = 0; v < V; ++v) wg[v] = u01(ww[1 + v], 0.0f);
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

  if (writer) {
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

// The pose-only megastep (bench.py's path).
template <int V, int K, int T, int G>
__global__ void __launch_bounds__(BLOCK, G == 1 ? MIN_BLOCKS : GROUP_MIN_BLOCKS)
megastep_kernel(const Params P) {
  megastep_body<V, K, T, false, G>(P);
}

// The megastep with joint-space secondary goals.
template <int V, int K, int T, int G>
__global__ void __launch_bounds__(BLOCK, GROUP_MIN_BLOCKS)
megastep_sec_kernel(const Params P) {
  megastep_body<V, K, T, true, G>(P);
}

// The fullstep kernel (TPU make_fullstep_kernel): one bio2 step per lane,
// no species bookkeeping, pose family without secondary goals as there;
// Philox step word 0; one thread per lane.
template <int V, int K, int T>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
fullstep_kernel(const Params P) {
  extern __shared__ float smem[];
  const Lane<V, T, 1> X = enter<V, K, T, 1>(P, smem);
  if (X.n >= P.N) return;   // no exchange between lanes
  const int n = X.n;
  const size_t N = P.N;
  float p0g[V], p1g[V], p0r[V], p1r[V];
  Goals<V, K> GL;
  int inst_tip[K];
  load_lane<V, K>(P, n, p0g, p1g, p0r, p1r, GL, inst_tip);
  float tips[T][7];
  const float fit = bio2_step<V, K, T, false, 1>(P, X, 0, p0g, p1g, p0r, p1r, GL,
                                                 inst_tip, tips);
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
// Over the including source's (V, K, T) instances (SHAPES; kernels/
// bio2_megastep.py::MEGASTEP_SOURCES lists the prebuilt ones): pose-only and
// secondary-goal (SEC) megasteps for every group size G of GROUPS and a
// fullstep kernel each.

// Version of megastep_launch's argument list, raised whenever it changes:
// a caller that launches another build (tools/megastep_ab.py) checks it
// first.  1 was the list before this symbol: no G, no nbranch, 6-int link
// rows; 2 had no gaux, inst_kind, cols, ncol.
extern "C" int megastep_abi_version() { return 3; }

// Dynamic shared memory of one block, bytes (ncol, K, T: the wide layout's
// arguments, not read here).
extern "C" int megastep_smem_bytes(int V, int nlinks, int nbranch, int C, int G,
                                   unsigned int sec_mask, int ncol, int K, int T) {
  (void)ncol; (void)K; (void)T;
  return layout(V, nlinks, nbranch, C, G, sec_mask).words * 4;
}

// Resident blocks per SM of a megastep instance at `smem` bytes: 0 blocks
// (and success) where a block does not fit, its shared memory over the
// card's opt-in limit; an error when the instance does not exist.
extern "C" int megastep_blocks_per_sm(int V, int K, int T, int sec, int G, int smem,
                                      int* blocks) {
  *blocks = 0;
  int dev = 0, optin = 0;
  cudaError_t q = cudaGetDevice(&dev);
  if (q == cudaSuccess)
    q = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (q != cudaSuccess) return (int)q;
  const bool fits = smem <= optin;
#define OCC(v, k, t, g)                                                            \
  if (V == v && K == k && T == t && G == g) {                                      \
    cudaError_t e;                                                                 \
    if (!fits) {                                                                   \
      e = cudaSuccess;                                                             \
    } else if (sec) {                                                              \
      e = (cudaError_t)prepare(megastep_sec_kernel<v, k, t, g>, smem);            \
      if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(     \
          blocks, megastep_sec_kernel<v, k, t, g>, BLOCK, smem);                   \
    } else {                                                                       \
      e = (cudaError_t)prepare(megastep_kernel<v, k, t, g>, smem);                \
      if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(     \
          blocks, megastep_kernel<v, k, t, g>, BLOCK, smem);                       \
    }                                                                              \
    return (int)e;                                                                 \
  }
#define OCC_G(v, k, t) GROUPS(OCC, v, k, t)
  SHAPES(OCC_G)
#undef OCC_G
#undef OCC
  return (int)cudaErrorInvalidValue;
}

extern "C" int megastep_launch(
    int V, int K, int T, int G, int N, int nlinks, int nbranch, int n_steps, int gens,
    int C, int mem_iters, int memetic, float h, int rng_mode, unsigned int seed,
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
    const int* inst_tip, const float* gaux, const int* inst_kind, const int* cols,
    int ncol, void* stream) {
  if (N <= 0 || (N & 1) || nlinks > MAX_LINKS || C <= 0 || C > MAX_C || C % G)
    return (int)cudaErrorInvalidValue;
  ncol = 0;
  Params P{N, nlinks, nbranch, n_steps, gens, C, mem_iters, memetic, rng_mode, h, seed,
           sec_mask, salt, genes, grads, sfit, sol, sol_fit, sol_tips,
           genes_o, grads_o, sfit_o, sol_o, sol_fit_o, sol_tips_o, nullptr, nullptr,
           qfix, gpos, gquat, wpos, wrot, span, cmin, cmax, amin, amax, sec,
           noise, rates, wipe_u, wipe_g, keep, chain_i, chain_f, tip_slot, inst_tip,
           gaux, inst_kind, cols, ncol};
  const size_t threads = (size_t)N * G;
  dim3 grid((unsigned)((threads + BLOCK - 1) / BLOCK)), block(BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)megastep_smem_bytes(V, nlinks, nbranch, C, G, sec_mask, ncol,
                                                  K, T);
#define LAUNCH(v, k, t, g)                                                         \
  if (V == v && K == k && T == t && G == g) {                                      \
    int e;                                                                         \
    if (!sec_mask) {                                                               \
      if ((e = prepare(megastep_kernel<v, k, t, g>, smem))) return e;              \
      megastep_kernel<v, k, t, g><<<grid, block, smem, s>>>(P);                    \
    } else {                                                                       \
      if ((e = prepare(megastep_sec_kernel<v, k, t, g>, smem))) return e;          \
      megastep_sec_kernel<v, k, t, g><<<grid, block, smem, s>>>(P);                \
    }                                                                              \
    return (int)cudaGetLastError();                                                \
  }
#define LAUNCH_G(v, k, t) GROUPS(LAUNCH, v, k, t)
  SHAPES(LAUNCH_G)
#undef LAUNCH_G
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int fullstep_launch(
    int V, int K, int T, int N, int nlinks, int nbranch, int gens, int C, int mem_iters,
    int memetic, float h, int rng_mode, unsigned int seed, const int* salt,
    const float* genes, const float* grads, const float* qfix,
    const float* gpos, const float* gquat, const float* wpos, const float* wrot,
    const float* span, const float* cmin, const float* cmax,
    const float* noise, const float* rates, float* genes_o, float* grads_o,
    float* tips_o, float* fit_o, const int* chain_i, const float* chain_f,
    const int* tip_slot, const int* inst_tip, const float* gaux, const int* inst_kind,
    const int* cols, int ncol, void* stream) {
  if (N <= 0 || nlinks > MAX_LINKS || C <= 0 || C > MAX_C)
    return (int)cudaErrorInvalidValue;
  ncol = 0;
  Params P{N, nlinks, nbranch, 1, gens, C, mem_iters, memetic, rng_mode, h, seed, 0u,
           salt, genes, grads, nullptr, nullptr, nullptr, nullptr,
           genes_o, grads_o, nullptr, nullptr, nullptr, nullptr, tips_o, fit_o,
           qfix, gpos, gquat, wpos, wrot, span, cmin, cmax, nullptr, nullptr, nullptr,
           noise, rates, nullptr, nullptr, nullptr, chain_i, chain_f, tip_slot, inst_tip,
           gaux, inst_kind, cols, ncol};
  dim3 grid((N + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)megastep_smem_bytes(V, nlinks, nbranch, C, 1, 0u, 0, K, T);
#define LAUNCH(v, k, t)                                                            \
  if (V == v && K == k && T == t) {                                                \
    int e;                                                                         \
    if ((e = prepare(fullstep_kernel<v, k, t>, smem))) return e;                   \
    fullstep_kernel<v, k, t><<<grid, block, smem, s>>>(P);                         \
    return (int)cudaGetLastError();                                                \
  }
  SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

#endif   // MEGASTEP_WIDE
