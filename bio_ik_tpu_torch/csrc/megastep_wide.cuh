// The wide megastep layout for Hopper (sm_90a): many variables and tips,
// every goal kind of the step, a lane spread over a group of W threads.
//
// Included by csrc/megastep.cuh when MEGASTEP_WIDE is 1 (csrc/megastep_wide.cu,
// the PR2 dual arm (17, 2, 2); csrc/megastep_high.cu, snake-32 (32, 1, 1)
// and the 30-DOF humanoid (30, 3, 3); and every source that
// kernels/bio2_megastep.py::megastep_instance generates), after the
// definitions the two layouts share (Params, the quaternion ops, the
// selection).  GROUPS(X, v, k, t) lists the group widths W of each shape.
//
// Replaces the TPU kernel bio_ik_tpu/kernels/bio2_megastep.py::
// make_megastep_kernel (its pl.pallas_call at :321), which inlines
// bio2_fullstep.py::make_fullstep_inner (the TPU kernel
// make_fullstep_kernel, bio2_fullstep.py:591, is fullstep_launch here), at
// these shapes.  The plain torch version it is held to is
// bio_ik_tpu_torch/kernels/bio2_megastep.py::make_megastep_body.
//
// What bounds it on the card: the generator's integer work (ceil(3V/4)
// Philox4x32-10 calls a child, 48 SASS instructions each, 20 on the IMAD
// pipe) and the latency of the lane's dependent chains.  The layout before
// this one kept a lane's state in one thread: arrays of length V (parents,
// momenta, children, the memetic search's vectors) in registers, 0.4–2.6 KB
// of spill at V = 17–32, and the lane's linearization and branch frames in
// shared memory for 128 lanes a block, so one or two blocks (8 warps) an
// SM.  The design here:
//   * a lane per group of W adjacent threads (W ∈ {4, 8, 16}, a
//     template parameter; the wrapper picks it per launch from the lane
//     count and the occupancy, bio2_megastep.choose_width), all of one warp,
//     synchronized with __syncwarp; no thread holds an array of length V:
//     the lane's vectors live in shared memory, one region a lane (wide_layout);
//   * the children's genes are made by (child, quad) items over the group:
//     the four Gaussians of variables 4q … 4q+3 are words 12q … 12q+11 of
//     the child's Philox stream, calls 3q … 3q+2, so each call is made once
//     a lane, by one thread, and its words never leave it (the bits of
//     bio2_fullstep.packed_fields, unchanged);
//   * child c is evaluated by thread c mod W, its linearized fitness summed
//     in the plain version's order (each tip component over increasing v,
//     the absent columns left out by a per-instance list); the best two
//     come from the group's shuffle merge and the strict-'<' scan
//     (group_best_two, select_two) as in the narrow layout; the winners'
//     genes are read back from shared memory;
//   * the memetic line search and the parents' evaluation spread the 7·K
//     tip components of one or two vectors over the group (each summed by
//     one thread over increasing v), then the goal terms, then each
//     variable's gradient and step (by its owner, v ≡ j mod W, over (k, c)
//     in order); the secondary fitness as per-variable addends over the
//     group, summed in order by one thread; the L1 norm and the step length
//     in order in every thread (one thread a whole vector lengthened the
//     serial chain, and ran slower at W ≥ 8 on an H100);
//   * the exact FK: each link's joint rotation (its sincosf) in parallel
//     over the group, the chain of frames by the group's first thread, every
//     link's frame kept, the linearization's columns in parallel over the
//     moving links (links that share a variable summed in link order);
//   * the species compare-swap exchanges the two lanes' regions under a
//     block barrier (the lanes of an island are adjacent regions of a
//     block); padding threads past N take part in every barrier and skip
//     the stores;
//   * three expressions whose multiply-adds nvcc contracted otherwise in
//     this layout than in the one before it — a joint's rotation onto its
//     link's frame, a child's momentum and the memetic search's candidate —
//     are written with explicit __fmaf_rn/__fmul_rn in that layout's order
//     (qmul_joint, wide_child_momentum, the candidate's step), so that a
//     lane rounds as it did there.
// Loads and stores of the state go through shared memory, coalesced over
// the block's lanes.

#pragma once

// Resident blocks per SM the register budget is held to (128 registers).
constexpr int WIDE_MIN_BLOCKS = 4;
// The end of phase i of a lane-step (i < 0: the start of the steps): no
// code, unless a build defines it (tools/megastep_phases.py's clock64()
// probe; 0 the exact FK and linearization, 1 the children's genes, 2 their
// evaluation and selection, 3 the new parents, 4 the memetic search, 5 the
// final FK and fitness, 6 the species bookkeeping).
#ifndef WIDE_PHASE
#define WIDE_PHASE(i)
#endif
// The group width of fullstep_launch (its C API has no group argument).
constexpr int FULLSTEP_W = 16;

// Dynamic shared memory of a block, in 4-byte words.  Block tables: the
// link table, per link the head flag and the next link of its variable
// (for the linearization's columns), the column table (V·(T + K) ints),
// per goal instance the count and list of its present columns (K + K·V
// ints: v | column << 16 by increasing v), the goal instances' kinds and
// tips and the tips' link slots.  Then one region of `lane` words per lane
// (BLOCK / W lanes), odd so that the lanes of a warp fall on different
// banks; within it: 8 rows of V (the parents' genes and momenta, x0, span,
// cmin, cmax), with SEC the secondary rows its terms read (sec_rows_needed,
// in sec_eval.cuh order), the incumbent (V genes,
// 7·T tip rows), the children's block — max(C, 13) rows of VP = V | 1
// (the children's genes; the memetic search's gradient, direction, three
// probes and two vectors' secondary addends), which every link's frame
// (nlinks·7) shares, the frames being dead while the children live —, the
// linearization (ncol·7), the exact tips (7·T), the goal rows (12·K), the
// tip components of two vectors (14·K), the goal gradient (7·K), two
// vectors' goal terms (2·K), with SEC the children's secondary fitness
// (C), and eight words of scalars (two vectors' secondary fitness; the
// swap's and the wipeout's).
struct WideLayout {
  int link_i, link_f, chain, cols, kcl, tabs, lanes, lane;
  int vec, sec, sol, kids, lin, tips, goal, ph, gv, term, ksec, misc;
  int words;
};

__host__ __device__ inline WideLayout wide_layout(int V, int K, int T, int nlinks, int C,
                                                  int W, unsigned sec_mask, int ncol) {
  WideLayout L;
  int o = 0;
  L.link_i = o; o += nlinks * LINK_I;
  L.link_f = o; o += nlinks * LINK_F;
  L.chain = o;  o += 2 * nlinks;
  L.cols = o;   o += V * (T + K);
  L.kcl = o;    o += K + K * V;
  L.tabs = o;   o += 2 * K + T;
  L.lanes = o;
  int l = 0;
  L.vec = l;  l += 8 * V;
  int nsec = 0;
  for (unsigned r = sec_rows_needed(sec_mask); r; r &= r - 1) ++nsec;
  L.sec = l;  l += nsec * V;
  L.sol = l;  l += V + 7 * T;
  const int kids = (C > 13 ? C : 13) * (V | 1);
  L.kids = l; l += kids > 7 * nlinks ? kids : 7 * nlinks;
  L.lin = l;  l += ncol * 7;
  L.tips = l; l += 7 * T;
  L.goal = l; l += 12 * K;
  L.ph = l;   l += 14 * K;
  L.gv = l;   l += 7 * K;
  L.term = l; l += 2 * K;
  L.ksec = l; l += sec_mask ? C : 0;
  L.misc = l; l += 8;
  L.lane = l | 1;
  L.words = o + L.lane * (BLOCK / W);
  return L;
}

// rows of the lane's vector block (WideLayout::vec), of V each
enum { R_P0G = 0, R_P1G = 1, R_P0R = 2, R_P1R = 3, R_X0 = 4, R_SPAN = 5, R_CMIN = 6,
       R_CMAX = 7 };
// rows of the children's block (WideLayout::kids) the memetic search uses:
// the gradient, the direction, the three probes, then two vectors'
// secondary addends (4·V each)
enum { M_GRAD = 0, M_GDIR = 1, M_XM = 2, M_XP = 3, M_CAND = 4, M_SADD = 5 };
// a goal instance's row (WideLayout::goal): position, quaternion, aux,
// the two weights
enum { GL_POS = 0, GL_QUAT = 3, GL_AUX = 7, GL_WPOS = 10, GL_WROT = 11, GL_STRIDE = 12 };
// the lane's scalars (WideLayout::misc): two vectors' secondary fitness
// (lin_fit_group), the swap's fitness and improvement, the wipeout coin
enum { S_SEC = 0, S_PAIR_FIT = 2, S_PAIR_IMP = 3, S_WIPE = 4 };

// A vector of the lane in shared memory as the array sec_eval.cuh takes.
template <int V>
__device__ __forceinline__ const float (&as_vec(const float* p))[V] {
  return *reinterpret_cast<const float(*)[V]>(p);
}

// The lane's secondary rows in shared memory: those the terms read, in
// sec_eval.cuh order (row r at the count of needed rows before it).
template <int V>
struct LaneSecRows {
  const float* p;
  unsigned need;   // sec_rows_needed of the mask
  __device__ __forceinline__ float operator()(int r, int v) const {
    return p[__popc(need & ((1u << r) - 1u)) * V + v];
  }
};

// Where a thread finds its lane: Philox lane n (padding threads past N
// keep their own n), data lane nn, rank j in the lane's group, the block
// tables and the lane's region in shared memory.
template <int V, int K, int T, int W>
struct WLane {
  static constexpr int VP = V | 1;   // stride of the children's rows
  int n, nn, j;
  uint32_t salt;
  const int* li;     // link table, LINK_I ints per link
  const float* lf;   // link table, LINK_F floats per link
  const int* head;   // per link: 1 where it is the first moving link of its variable
  const int* nxt;    // per link: the next moving link of its variable, or −1
  const int* tcol;   // (v, t) → column, −1 none
  const int* kcol;   // (k, v) → column, −1 none
  const int* kcl;    // per goal instance: count, then its present columns
  const int* kind;   // per goal instance: GK_*
  const int* itip;   // per goal instance: its tip
  const int* tslot;  // per tip: its link slot
  float* L;          // the lane's region
  WideLayout Lo;
  __device__ float* row(int r) const { return L + Lo.vec + r * V; }
  __device__ float* kid(int c) const { return L + Lo.kids + c * VP; }
  __device__ float* lin() const { return L + Lo.lin; }
  __device__ float* fr() const { return L + Lo.kids; }   // shares the children's block
  __device__ float* tips() const { return L + Lo.tips; }
  __device__ float* goal(int k) const { return L + Lo.goal + k * GL_STRIDE; }
  __device__ float* ph() const { return L + Lo.ph; }
  __device__ float* gv() const { return L + Lo.gv; }
  __device__ float* term() const { return L + Lo.term; }
  __device__ float* sol() const { return L + Lo.sol; }
  __device__ float* misc() const { return L + Lo.misc; }
  unsigned sec_need;
  __device__ LaneSecRows<V> sec() const { return LaneSecRows<V>{L + Lo.sec, sec_need}; }
};

// The group's barrier: the W threads of a lane lie in one warp, and every
// lane of a warp reaches the same barriers.
__device__ __forceinline__ void group_sync() { __syncwarp(); }

// Rows of the block's lanes between global memory (row r of lane n at
// src[r·N + n]) and the lanes' regions (word r of the region at `dst`),
// coalesced over the lanes: `read` true loads, false stores (lanes < N).
__device__ __forceinline__ void lane_rows(float* smem_lanes, const WideLayout& Lo, int lpb,
                                          int lane0, int N, int nrows, int dst, float* g,
                                          const float* cg, bool read) {
  for (int i = threadIdx.x; i < nrows * lpb; i += BLOCK) {
    const int r = i / lpb, l = i - r * lpb;
    const int lane = lane0 + l;
    float* s = smem_lanes + l * Lo.lane + dst + r;
    if (read) *s = cg[(size_t)r * N + min(lane, N - 1)];
    else if (lane < N) g[(size_t)r * N + lane] = *s;
  }
}

// Block prologue: the block tables and the lanes' rows into shared memory.
// Every thread of the block reaches the barrier (padding threads too).
template <int V, int K, int T, int W, bool SEC>
__device__ __forceinline__ WLane<V, K, T, W> wide_enter(const Params& P, float* smem,
                                                        bool with_sol) {
  const WideLayout Lo = wide_layout(V, K, T, P.nlinks, P.C, W, SEC ? P.sec_mask : 0u, P.ncol);
  constexpr int LPB = BLOCK / W;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * LPB;
  int* ism = reinterpret_cast<int*>(smem);
  int* li = ism + Lo.link_i;
  float* lf = smem + Lo.link_f;
  for (int i = tid; i < P.nlinks * LINK_I; i += BLOCK) li[i] = P.chain_i[i];
  for (int i = tid; i < P.nlinks * LINK_F; i += BLOCK) lf[i] = P.chain_f[i];
  for (int s = tid; s < P.nlinks; s += BLOCK) {   // the columns' link chains
    const int* I = P.chain_i + s * LINK_I;
    int head = I[4] != 0, nxt = -1;
    for (int s2 = 0; s2 < P.nlinks && I[4]; ++s2) {
      const int* I2 = P.chain_i + s2 * LINK_I;
      if (!I2[4] || I2[3] != I[3]) continue;
      if (s2 < s) head = 0;
      if (s2 > s && nxt < 0) nxt = s2;
    }
    ism[Lo.chain + s] = head;
    ism[Lo.chain + P.nlinks + s] = nxt;
  }
  for (int i = tid; i < V * (T + K); i += BLOCK) ism[Lo.cols + i] = P.cols[i];
  for (int k = tid; k < K; k += BLOCK) {   // goal instance k's present columns
    int n = 0;
    for (int v = 0; v < V; ++v) {
      const int col = P.cols[V * T + k * V + v];
      if (col >= 0) ism[Lo.kcl + K + k * V + n++] = v | (col << 16);
    }
    ism[Lo.kcl + k] = n;
  }
  for (int i = tid; i < K; i += BLOCK) {
    ism[Lo.tabs + i] = P.inst_kind[i];
    ism[Lo.tabs + K + i] = P.inst_tip[i];
  }
  for (int i = tid; i < T; i += BLOCK) ism[Lo.tabs + 2 * K + i] = P.tip_slot[i];
  float* lanes = smem + Lo.lanes;
  const int N = P.N;
  lane_rows(lanes, Lo, LPB, lane0, N, 2 * V, Lo.vec + R_P0G * V, nullptr, P.genes, true);
  lane_rows(lanes, Lo, LPB, lane0, N, 2 * V, Lo.vec + R_P0R * V, nullptr, P.grads, true);
  lane_rows(lanes, Lo, LPB, lane0, N, V, Lo.vec + R_SPAN * V, nullptr, P.span, true);
  lane_rows(lanes, Lo, LPB, lane0, N, V, Lo.vec + R_CMIN * V, nullptr, P.cmin, true);
  lane_rows(lanes, Lo, LPB, lane0, N, V, Lo.vec + R_CMAX * V, nullptr, P.cmax, true);
  if constexpr (SEC) {
    const unsigned need = sec_rows_needed(P.sec_mask);
    for (int r = 0, slot = 0; r < 8; ++r)
      if ((need >> r) & 1u)
        lane_rows(lanes, Lo, LPB, lane0, N, V, Lo.sec + slot++ * V, nullptr,
                  P.sec + (size_t)r * V * N, true);
  }
  if (with_sol) {
    lane_rows(lanes, Lo, LPB, lane0, N, V, Lo.sol, nullptr, P.sol, true);
    lane_rows(lanes, Lo, LPB, lane0, N, 7 * T, Lo.sol + V, nullptr, P.sol_tips, true);
  }
  for (int k = 0; k < K; ++k) {
    const int g = Lo.goal + k * GL_STRIDE;
    lane_rows(lanes, Lo, LPB, lane0, N, 3, g + GL_POS, nullptr, P.gpos + (size_t)3 * k * N,
              true);
    lane_rows(lanes, Lo, LPB, lane0, N, 4, g + GL_QUAT, nullptr, P.gquat + (size_t)4 * k * N,
              true);
    lane_rows(lanes, Lo, LPB, lane0, N, 3, g + GL_AUX, nullptr, P.gaux + (size_t)3 * k * N,
              true);
    lane_rows(lanes, Lo, LPB, lane0, N, 1, g + GL_WPOS, nullptr, P.wpos + (size_t)k * N, true);
    lane_rows(lanes, Lo, LPB, lane0, N, 1, g + GL_WROT, nullptr, P.wrot + (size_t)k * N, true);
  }
  __syncthreads();

  WLane<V, K, T, W> X;
  const int t = blockIdx.x * BLOCK + tid;
  X.n = t / W;
  X.j = t & (W - 1);
  X.nn = min(X.n, P.N - 1);
  X.salt = (uint32_t)P.salt[X.nn];
  X.li = li;
  X.lf = lf;
  X.head = ism + Lo.chain;
  X.nxt = ism + Lo.chain + P.nlinks;
  X.tcol = ism + Lo.cols;
  X.kcol = ism + Lo.cols + V * T;
  X.kcl = ism + Lo.kcl;
  X.kind = ism + Lo.tabs;
  X.itip = ism + Lo.tabs + K;
  X.tslot = ism + Lo.tabs + 2 * K;
  X.L = lanes + (tid / W) * Lo.lane;
  X.Lo = Lo;
  X.sec_need = SEC ? sec_rows_needed(P.sec_mask) : 0u;
  return X;
}

// ------------------------------------------------------- goal kinds --
// atan2 for y ≥ 0 by the JAX body's Hastings polynomial
// (bio2_fullstep._atan2_nonneg), in its operation order.
__device__ __forceinline__ float atan2_nonneg(float y, float x) {
  const float ax = fabsf(x);
  const float mn = fminf(y, ax), mx = fmaxf(y, ax);
  const float t = mn / (mx + 1e-30f);
  const float t2 = t * t;
  const float p = t * (0.9998660f + t2 * (-0.3302995f + t2 * (0.1801410f + t2 * (
      -0.0851330f + t2 * 0.0208351f))));
  const float r = (y > ax) ? 1.57079637f - p : p;
  return (x < 0.0f) ? 3.14159274f - r : r;
}

// The error of a goal instance of kind `kind` (its row `gk`) from its tip
// components ph and, with GRAD, d(error)/d(ph) into gv (zero where the kind
// has no such column: the rotation columns of every kind but the pose
// family) — the plain version's eval_goals / link_goal, kind by kind in its
// operation order.
template <bool GRAD>
__device__ __forceinline__ float goal_term(const float* gk, int kind, const float (&ph)[7],
                                           float (&gv)[7]) {
  const float w = gk[GL_WPOS], wrot = gk[GL_WROT];
  const float* gp = gk + GL_POS;
  const float* gq = gk + GL_QUAT;
  const float* aux = gk + GL_AUX;
  if (GRAD) {
#pragma unroll
    for (int c = 0; c < 7; ++c) gv[c] = 0.0f;
  }
  switch (kind) {
    case GK_LOOKAT: {   // ‖normalize(target − p) − normalize(R·axis)‖²
      float u[3];
      qrot(ph + 3, aux, u);
      const float uinv = rsqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + 1e-12f);
      const float dx[3] = {gp[0] - ph[0], gp[1] - ph[1], gp[2] - ph[2]};
      const float dinv = rsqrtf(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2] + 1e-12f);
      float n[3], e[3], err = 0.0f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        n[d] = dx[d] * dinv;
        e[d] = n[d] - u[d] * uinv;
        err = err + e[d] * e[d];
      }
      if (GRAD) {
        float sd = 0.0f;
#pragma unroll
        for (int d = 0; d < 3; ++d) sd = sd + n[d] * e[d];
#pragma unroll
        for (int d = 0; d < 3; ++d) gv[d] = w * (-2.0f * dinv) * (e[d] - n[d] * sd);
      }
      return w * err;
    }
    case GK_LINE: {     // ‖(p − o) − d·((p − o)·d)‖²
      const float dx[3] = {ph[0] - gp[0], ph[1] - gp[1], ph[2] - gp[2]};
      const float along = dx[0] * aux[0] + dx[1] * aux[1] + dx[2] * aux[2];
      const float pp[3] = {dx[0] - aux[0] * along, dx[1] - aux[1] * along,
                           dx[2] - aux[2] * along};
      if (GRAD) {
#pragma unroll
        for (int d = 0; d < 3; ++d) gv[d] = 2.0f * w * pp[d];
      }
      return w * (pp[0] * pp[0] + pp[1] * pp[1] + pp[2] * pp[2]);
    }
    case GK_PLANE: {    // ((p − o)·n)²
      float sd = 0.0f;
#pragma unroll
      for (int d = 0; d < 3; ++d) sd = sd + (ph[d] - gp[d]) * aux[d];
      if (GRAD) {
#pragma unroll
        for (int d = 0; d < 3; ++d) gv[d] = 2.0f * w * sd * aux[d];
      }
      return w * (sd * sd);
    }
    case GK_MAXD:
    case GK_MIND: {     // relu(±(|p − t| − dist))², dist in the wrot row
      const float dx[3] = {ph[0] - gp[0], ph[1] - gp[1], ph[2] - gp[2]};
      const float nrm2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
      const float rinv = rsqrtf(nrm2 + 1e-12f);
      const float sgn = kind == GK_MAXD ? 1.0f : -1.0f;
      const float dd = fmaxf(sgn * (nrm2 * rinv - wrot), 0.0f);
      if (GRAD) {
        const float c = 2.0f * sgn * w * dd * rinv;
#pragma unroll
        for (int d = 0; d < 3; ++d) gv[d] = c * dx[d];
      }
      return w * (dd * dd);
    }
    case GK_CONE: {     // max(0, ∠(R·axis, dir) − angle)² + pw·‖apex − p‖²
      float v[3];
      qrot(ph + 3, aux, v);
      const float* dr = gq;   // [dir, angle]
      const float cx = v[1] * dr[2] - v[2] * dr[1];
      const float cy = v[2] * dr[0] - v[0] * dr[2];
      const float cz = v[0] * dr[1] - v[1] * dr[0];
      const float cn = sqrtf(cx * cx + cy * cy + cz * cz + 1e-18f);
      const float dot = v[0] * dr[0] + v[1] * dr[1] + v[2] * dr[2];
      const float dd = fmaxf(atan2_nonneg(cn, dot) - dr[3], 0.0f);
      float pe = 0.0f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float e = gp[d] - ph[d];
        pe = pe + e * e;
      }
      if (GRAD) {
        const float c = 2.0f * w * wrot;
#pragma unroll
        for (int d = 0; d < 3; ++d) gv[d] = c * (ph[d] - gp[d]);
      }
      return w * (dd * dd + wrot * pe);
    }
    case GK_DIRECTION:
    case GK_SIDE: {     // ‖R·axis − dir‖², relu(R·axis · dir)²; no gradient
      float v[3];
      qrot(ph + 3, aux, v);
      float err = 0.0f;
      if (kind == GK_DIRECTION) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float e = v[d] - gp[d];
          err = err + e * e;
        }
      } else {
        float f = 0.0f;
#pragma unroll
        for (int d = 0; d < 3; ++d) f = f + v[d] * gp[d];
        f = fmaxf(f, 0.0f);
        err = f * f;
      }
      return w * err;
    }
    default: {          // the pose family
      float perr = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float e = ph[c] - gp[c];
        perr = perr + e * e;
      }
      float dm = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float q = ph[3 + c], g = gq[c];
        dm = dm + (q - g) * (q - g);
        dp = dp + (q + g) * (q + g);
      }
      if (GRAD) {
        float sgn = (dm <= dp) ? 1.0f : -1.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) gv[c] = 2.0f * w * (ph[c] - gp[c]);
#pragma unroll
        for (int c = 0; c < 4; ++c) gv[3 + c] = 2.0f * wrot * (ph[3 + c] - sgn * gq[c]);
      }
      return w * perr + wrot * fminf(dm, dp);
    }
  }
}

// ---------------------------------------------------------------- FK --
// A link's frame times its joint's rotation (qmul's expressions), with the
// contraction pinned to the one nvcc gave the previous wide layout (one
// thread a lane): x fuses a0·b3 onto the rounded a3·b0, y, z and w their
// first product onto the rounded second, and each later product onto the
// running sum.  Left to nvcc, this layout fused x the other way, and every
// joint about the x axis then rounded otherwise (PERF.md §6).
__device__ __forceinline__ void qmul_joint(const float* a, const float* b, float* o) {
  o[0] = __fmaf_rn(-a[2], b[1],
                   __fmaf_rn(a[1], b[2], __fmaf_rn(a[0], b[3], __fmul_rn(a[3], b[0]))));
  o[1] = __fmaf_rn(a[2], b[0],
                   __fmaf_rn(a[1], b[3], __fmaf_rn(a[3], b[1], -__fmul_rn(a[0], b[2]))));
  o[2] = __fmaf_rn(a[2], b[3],
                   __fmaf_rn(-a[1], b[0], __fmaf_rn(a[3], b[2], __fmul_rn(a[0], b[1]))));
  o[3] = __fmaf_rn(-a[2], b[2],
                   __fmaf_rn(-a[1], b[1], __fmaf_rn(a[3], b[3], -__fmul_rn(a[0], b[0]))));
}

// Exact FK of the lane at genes x (a row of its region): every link's frame
// into fr (7 words a link), the tips into tips; with LIN, the
// linearization's columns ∂tip_t/∂x_v (fk_rows.FkRows.deltas) from those
// frames.  Called by every thread of the group; ends synchronized.
template <int V, int K, int T, int W, bool LIN>
__device__ __forceinline__ void wide_fk(const Params& P, const WLane<V, K, T, W>& X,
                                        const float* x) {
  float* fr = X.fr();
  // each moving joint's rotation (or displacement) in parallel
  for (int s = X.j; s < P.nlinks; s += W) {
    const int* I = X.li + s * LINK_I;
    const float* F = X.lf + s * LINK_F;
    const int kind = I[2], jt = I[1];
    if (kind == SRC_CONST || jt == J_FIXED || kind == SRC_NONE) continue;
    float q = (kind == SRC_ACTIVE) ? x[I[3]] : P.qfix[(size_t)I[3] * P.N + X.nn];
    const float f = F[10], off = F[11];
    if (f != 1.0f || off != 0.0f) q = q * f + off;
    float* J = fr + s * 7;
    if (jt == J_REVOLUTE) {
      float sn, cs;
      sincosf(0.5f * q, &sn, &cs);
      J[0] = F[7] * sn; J[1] = F[8] * sn; J[2] = F[9] * sn; J[3] = cs;
    } else {
      J[0] = q;
    }
  }
  group_sync();
  // the chain, by the group's first thread: a link's joint words are read
  // before its frame takes their place
  if (X.j == 0) {
    float cp[3] = {0.0f, 0.0f, 0.0f}, cq[4] = {0.0f, 0.0f, 0.0f, 1.0f};
    for (int s = 0; s < P.nlinks; ++s) {
      const int* I = X.li + s * LINK_I;
      const float* F = X.lf + s * LINK_F;
      const int kind = I[2];
      float* out = fr + s * 7;
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
          } else {   // a branch link: its parent's frame, kept
            const float* b = fr + par * 7;
            ap[0] = b[0]; ap[1] = b[1]; ap[2] = b[2];
            aq[0] = b[3]; aq[1] = b[4]; aq[2] = b[5]; aq[3] = b[6];
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
        } else if (jt == J_REVOLUTE) {
          const float jq[4] = {out[0], out[1], out[2], out[3]};
          np[0] = pp[0]; np[1] = pp[1]; np[2] = pp[2];
          qmul_joint(pq, jq, nq);
        } else {  // prismatic
          const float q = out[0];
          float d[3] = {F[7] * q, F[8] * q, F[9] * q}, r[3];
          qrot(pq, d, r);
          np[0] = pp[0] + r[0]; np[1] = pp[1] + r[1]; np[2] = pp[2] + r[2];
          nq[0] = pq[0]; nq[1] = pq[1]; nq[2] = pq[2]; nq[3] = pq[3];
        }
      }
      cp[0] = np[0]; cp[1] = np[1]; cp[2] = np[2];
      cq[0] = nq[0]; cq[1] = nq[1]; cq[2] = nq[2]; cq[3] = nq[3];
      out[0] = cp[0]; out[1] = cp[1]; out[2] = cp[2];
      out[3] = cq[0]; out[4] = cq[1]; out[5] = cq[2]; out[6] = cq[3];
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (s == X.tslot[t]) {
          float* tp = X.tips() + t * 7;
#pragma unroll
          for (int c = 0; c < 7; ++c) tp[c] = out[c];
        }
    }
  }
  group_sync();
  if (!LIN) return;
  // the columns: each variable's moving links, in link order, from its
  // first one (X.head), summed from zero as the plain version does
  const float* tips = X.tips();
  for (int s0 = X.j; s0 < P.nlinks; s0 += W) {
    if (!X.head[s0]) continue;
    const int slot = X.li[s0 * LINK_I + 3];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int col = X.tcol[slot * T + t];
      if (col < 0) continue;
      float acc[7];
#pragma unroll
      for (int c = 0; c < 7; ++c) acc[c] = 0.0f;
      for (int s = s0; s >= 0; s = X.nxt[s]) {
        const int* I = X.li + s * LINK_I;
        if (!((I[4] >> t) & 1)) continue;
        const float* F = X.lf + s * LINK_F;
        const float* f = fr + s * 7;
        const float factor = F[10];
        float om[3];
        qrot(f + 3, F + 7, om);
        float dd[7];
        if (I[1] == J_REVOLUTE) {
          const float* tp = tips + t * 7;
          float arm[3] = {tp[0] - f[0], tp[1] - f[1], tp[2] - f[2]};
          dd[0] = om[1] * arm[2] - om[2] * arm[1];
          dd[1] = om[2] * arm[0] - om[0] * arm[2];
          dd[2] = om[0] * arm[1] - om[1] * arm[0];
          float w4[4] = {om[0], om[1], om[2], 0.0f}, dq4[4];
          qmul(w4, tp + 3, dq4);
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
        for (int c = 0; c < 7; ++c) acc[c] += dd[c];
      }
      float* d = X.lin() + col * 7;
#pragma unroll
      for (int c = 0; c < 7; ++c) d[c] = acc[c];
    }
  }
  group_sync();
}

// ------------------------------------------------------- evaluations --
// Linearized fitness of genes x (a row of the lane) by one thread
// (bio2_fullstep.eval_goals on x − x0): each goal instance's 7 tip
// components summed over its present columns by increasing v (the absent
// ones skipped, as the plain version skips them at trace time), then its
// term; the terms summed in order.  With GRAD the goal gradient goes to
// the lane's gv rows.  The loop over the columns unrolls by 4 (fully
// unrolled at V = 30–32 it doubled the kernels' nvcc time and ran no
// faster, PERF.md §6).
template <int V, int K, int T, int W, bool GRAD = false>
__device__ __forceinline__ float lin_fit(const WLane<V, K, T, W>& X, const float* x) {
  const float* x0 = X.row(R_X0);
  const float* lin = X.lin();
  float fit = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* base = X.tips() + X.itip[k] * 7;
    float ph[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) ph[c] = base[c];
    const int* e = X.kcl + K + k * V;
    const int n = X.kcl[k];
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int v = e[i] & 0xFFFF;
      const float dq = x[v] - x0[v];
      const float* d = lin + (e[i] >> 16) * 7;
#pragma unroll
      for (int c = 0; c < 7; ++c) ph[c] = ph[c] + d[c] * dq;
    }
    float gv[7];
    const float term = goal_term<GRAD>(X.goal(k), X.kind[k], ph, gv);
    if (GRAD) {
#pragma unroll
      for (int c = 0; c < 7; ++c) X.gv()[k * 7 + c] = gv[c];
    }
    fit = (k == 0) ? term : fit + term;
  }
  return fit;
}

// Linearized fitness of nv (1 or 2) rows xa, xb of the lane over the
// group, in the order of lin_fit: one thread a tip component (k, c) of a
// row, summed over the instance's present columns by increasing v; then
// one thread a goal term (with GRAD, nv = 1, the goal gradient to the
// lane's gv rows); the terms summed in order in every thread.  With SEC,
// each row's secondary fitness (sec_eval.cuh sec_of): its addends — per
// variable alpha, beta, delta, gamma, each rounded as there — one thread a
// variable beside the components, then summed in sec_of's order by one
// thread a row beside the goal terms.  Returns the primary fitness in f[i]
// and with SEC the secondary in s[i].  Called by every thread of the
// group; ends synchronized.
template <int V, int K, int T, int W, bool SEC, bool GRAD>
__device__ __forceinline__ void lin_fit_group(const Params& P, const WLane<V, K, T, W>& X,
                                              int nv, const float* xa, const float* xb,
                                              float (&f)[2], float (&s)[2]) {
  constexpr int NCOMP = 7 * K;
  const float* x0 = X.row(R_X0);
  const float* lin = X.lin();
  float* ph = X.ph();
  float* sadd = X.kid(M_SADD);   // the addends of row i, variable v, term t at (i·V + v)·4 + t
  const unsigned smask = P.sec_mask;
  const int items = nv * NCOMP + (SEC ? nv * V : 0);
  for (int it = X.j; it < items; it += W) {
    if (it < nv * NCOMP) {
      const int i = it >= NCOMP, r = it - i * NCOMP, k = r / 7, c = r - k * 7;
      const float* x = i ? xb : xa;
      const int* e = X.kcl + K + k * V;
      const int n = X.kcl[k];
      float acc = X.tips()[X.itip[k] * 7 + c];
#pragma unroll 4
      for (int q = 0; q < n; ++q) {
        const int v = e[q] & 0xFFFF;
        acc = acc + lin[(e[q] >> 16) * 7 + c] * (x[v] - x0[v]);
      }
      ph[it] = acc;
    } else if constexpr (SEC) {
      const int r = it - nv * NCOMP, i = r >= V, v = r - i * V;
      const float xv = (i ? xb : xa)[v];
      const LaneSecRows<V> S = X.sec();
      float* a = sadd + r * 4;
      const float xm = __fsub_rn(xv, S(SEC_MID, v));
      if (smask & SECM_ALPHA) a[0] = __fmul_rn(S(SEC_ALPHA, v), __fmul_rn(xm, xm));
      if (smask & SECM_BETA) {
        const float e = __fsub_rn(xv, S(SEC_SEED, v));
        a[1] = __fmul_rn(S(SEC_BETA, v), __fmul_rn(e, e));
      }
      if (smask & SECM_DELTA) {
        const float e = __fsub_rn(xv, S(SEC_TBAR, v));
        a[2] = __fmul_rn(S(SEC_DELTA, v), __fmul_rn(e, e));
      }
      if (smask & SECM_GAMMA) {
        const float g = fmaxf(__fsub_rn(__fmul_rn(2.0f, fabsf(xm)), S(SEC_HSPAN, v)), 0.0f);
        a[3] = __fmul_rn(S(SEC_GAMMA, v), __fmul_rn(g, g));
      }
    }
  }
  group_sync();
  float* term = X.term();
  float* out = X.misc();
  for (int it = X.j; it < nv * K + (SEC ? nv : 0); it += W) {
    if (it < nv * K) {
      const int i = it >= K, k = it - i * K;
      float q[7], gv[7];
#pragma unroll
      for (int c = 0; c < 7; ++c) q[c] = ph[i * NCOMP + k * 7 + c];
      term[it] = goal_term<GRAD>(X.goal(k), X.kind[k], q, gv);
      if (GRAD) {
#pragma unroll
        for (int c = 0; c < 7; ++c) X.gv()[k * 7 + c] = gv[c];
      }
    } else if constexpr (SEC) {   // sec_of's sum: per variable alpha, beta, delta, gamma
      const int i = it - nv * K;
      const float* a = sadd + i * V * 4;
      float acc = 0.0f;
      for (int v = 0; v < V; ++v) {
        if (smask & SECM_ALPHA) acc = __fadd_rn(acc, a[4 * v]);
        if (smask & SECM_BETA) acc = __fadd_rn(acc, a[4 * v + 1]);
        if (smask & SECM_DELTA) acc = __fadd_rn(acc, a[4 * v + 2]);
        if (smask & SECM_GAMMA) acc = __fadd_rn(acc, a[4 * v + 3]);
      }
      out[S_SEC + i] = acc;
    }
  }
  group_sync();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float fit = 0.0f;
    if (i < nv) {
#pragma unroll
      for (int k = 0; k < K; ++k) fit = (k == 0) ? term[i * K] : fit + term[i * K + k];
    }
    f[i] = fit;
    s[i] = (SEC && i < nv) ? out[S_SEC + i] : 0.0f;
  }
}

// ---------------------------------------------------------- children --
// child_momentum with the contraction pinned to the previous wide layout's:
// p0r·(1 − fmix) and pg·0.7 fused, the other product rounded (nvcc fused
// the other order here, PERF.md §6).
__device__ __forceinline__ float wide_child_momentum(int c, float p0g, float p0r, float p1r,
                                                     float gv) {
  const float fmix = ((c + 2) % 2 == 0) ? 0.2f : 0.0f;
  const float pg = __fmaf_rn(p0r, 1.0f - fmix, __fmul_rn(p1r, fmix));
  return __fmaf_rn(pg, 0.7f, __fmul_rn(gv - p0g, 0.3f));
}

// Genes of variables 4q … 4q+3 of child c of generation g (reference
// :263-299) into the child's row: their noise drawn (clt4: the quad's
// Philox calls 3q … 3q+2 of the child's ceil(3V/4), counters (lane, step,
// g, c·NC + k), words 12q … 12q+11 of its field string; Box–Muller: draw
// (lane, step, g, v·C + c); or the noise tensor), mutated at `rate`,
// momentum-shifted and clipped.
template <int V, int K, int T, int W>
__device__ __forceinline__ void child_quad(const Params& P, const WLane<V, K, T, W>& X,
                                           int step, int g, int c, int q, float rate) {
  const size_t N = P.N;
  const int C = P.C;
  const int gi = step * P.gens + g;
  const int cg = c + 2;
  const float fmix = (cg % 2 == 0) ? 0.2f : 0.0f;
  const float gfac = (float)(cg % 3);
  constexpr int NC = clt4_calls<V>();
  uint32_t w[12];
  if (P.rng_mode == RNG_CLT4) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int call = 3 * q + k;
      U4 u = {0u, 0u, 0u, 0u};
      if (call < NC) u = salted(philox4x32(X.n, step, g, c * NC + call, P.seed, 0u), X.salt);
      w[4 * k] = u.x; w[4 * k + 1] = u.y; w[4 * k + 2] = u.z; w[4 * k + 3] = u.w;
    }
  }
  const float* p0g = X.row(R_P0G);
  const float* p0r = X.row(R_P0R);
  const float* p1r = X.row(R_P1R);
  float* out = X.kid(c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = 4 * q + i;
    if (v >= V) break;
    float nz;
    if (P.rng_mode == RNG_TENSORS) {
      nz = P.noise[(((size_t)gi * V + v) * C + c) * N + X.nn];
    } else if (P.rng_mode == RNG_CLT4) {
      nz = clt4(field24(w, 4 * i), field24(w, 4 * i + 1), field24(w, 4 * i + 2),
                field24(w, 4 * i + 3));
    } else {
      const U4 u = salted(philox4x32(X.n, step, g, v * C + c, P.seed, 0u), X.salt);
      float a = u01(u.x, 2.98023224e-08f);
      float b = u01(u.y, 0.0f);
      nz = sqrtf(-2.0f * logf(a)) * cosf(6.28318548f * b);
    }
    float pg = p0r[v] * (1.0f - fmix) + p1r[v] * fmix;
    float gv = p0g[v] + nz * (rate * X.row(R_SPAN)[v]) + pg * gfac;
    out[v] = clampf(gv, X.row(R_CMIN)[v], X.row(R_CMAX)[v]);
  }
}

// ------------------------------------------------------------- the step --
// One whole bio2 step of the lane (bio2_fullstep.make_fullstep_inner) over
// its group: exact FK and linearization at parent 0, `gens` generations,
// the memetic line search, exact FK of the new parent 0.  Updates the
// parents in the lane's region, leaves the exact tip frames in its tips
// and returns the exact fitness (in every thread of the group).
//
// With SEC (joint-space secondary goals, P.sec / P.sec_mask) a generation
// ranks the children's secondary fitness (bio2_step.preselect: ties to the
// lower index) and offers only those the pre-selection keeps; the keep
// uniform is the spare word of the generation's rate call (or
// P.keep[(step·gens + g)·N + lane]).  The memetic line search then runs on
// primary + secondary and accepts on the primary.
template <int V, int K, int T, bool SEC, int W>
__device__ __forceinline__ float wide_step(const Params& P, const WLane<V, K, T, W>& X,
                                           int step) {
  constexpr int NQ = (V + 3) / 4;
  constexpr int MAXM = (MAX_C + W - 1) / W;   // children per thread at most
  const size_t N = P.N;
  const int C = P.C;
  const unsigned smask = P.sec_mask;
  float* p0g = X.row(R_P0G);
  float* p1g = X.row(R_P1G);
  float* p0r = X.row(R_P0R);
  float* p1r = X.row(R_P1R);
  float* x0 = X.row(R_X0);

  // ---- exact FK + linearization at parent 0 (reference :341-346) ----
  for (int v = X.j; v < V; v += W) x0[v] = p0g[v];
  group_sync();
  wide_fk<V, K, T, W, true>(P, X, x0);
  WIDE_PHASE(0);

  // ---- generations (reference :349-431) ----
  float fp[2], sp[2];
  lin_fit_group<V, K, T, W, false, false>(P, X, 2, p0g, p1g, fp, sp);
  float f_p0 = fp[0], f_p1 = fp[1];
  for (int g = 0; g < P.gens; ++g) {
    const int gi = step * P.gens + g;
    U4 rw = {0u, 0u, 0u, 0u};   // the generation's rate call
    if (P.rng_mode != RNG_TENSORS)
      rw = salted(philox4x32(X.n, step, g, V * C, P.seed, 0u), X.salt);
    auto rate = [&](int c) {
      return P.rng_mode == RNG_TENSORS ? P.rates[((size_t)gi * C + c) * N + X.nn]
                                       : rate_of_field(rw, c);
    };
    for (int it = X.j; it < C * NQ; it += W) {
      const int c = it / NQ, q = it - c * NQ;
      child_quad<V, K, T, W>(P, X, step, g, c, q, rate(c));
    }
    group_sync();
    WIDE_PHASE(1);
    // this thread's best two children, c ≡ j (mod W)
    float lf1 = __int_as_float(0x7f800000), lf2 = lf1;
    int li1 = NO_CHILD, li2 = NO_CHILD;
    if constexpr (!SEC) {
      for (int c = X.j; c < C; c += W)
        offer(lin_fit<V, K, T, W>(X, X.kid(c)), c, lf1, li1, lf2, li2);
    } else {
      // pre-selection (reference :366-378): the children's secondary
      // fitness to the lane, their primary fitness kept
      float* ks = X.L + X.Lo.ksec;
      float fc[MAXM];
#pragma unroll
      for (int k = 0; k < MAXM; ++k) {
        const int c = k * W + X.j;
        fc[k] = 0.0f;
        if (c < C) {
          ks[c] = sec_of<V>(X.sec(), smask, as_vec<V>(X.kid(c)));
          fc[k] = lin_fit<V, K, T, W>(X, X.kid(c));
        }
      }
      group_sync();
      const float keep_u = P.rng_mode == RNG_TENSORS ? P.keep[(size_t)gi * N + X.nn]
                                                     : u01(rw.w, 0.0f);
      const int kcount = sec_kcount(keep_u, C);
      // child c is kept when fewer than kcount children j rank before it:
      // s_j < s_c, or s_j == s_c and j < c (bio2_step.preselect)
#pragma unroll
      for (int k = 0; k < MAXM; ++k) {
        const int c = k * W + X.j;
        if (c >= C) break;
        const float sc = ks[c];
        int rank = 0;
        for (int jj = 0; jj < C; ++jj) {
          const float sj = ks[jj];
          rank += (sj < sc) || (sj == sc && jj < c);
        }
        if (rank < kcount) offer(fc[k], c, lf1, li1, lf2, li2);
      }
    }
    float c1f = lf1, c2f = lf2;
    int c1 = li1, c2 = li2;
    group_best_two<W>(c1f, c1, c2f, c2);
    float f1, f2;
    int h1, h2;
    select_two(f_p0, f_p1, c1f, c1, c2f, c2, f1, h1, f2, h2);
    WIDE_PHASE(2);
    // the new parents, each variable by its owner: a child's genes from its
    // row, its momentum recomputed from the parents
    for (int v = X.j; v < V; v += W) {
      float ng[2], nr[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int h = w ? h2 : h1;
        const float kg = h >= 0 ? X.kid(h)[v] : 0.0f;
        ng[w] = h == H_P0 ? p0g[v] : (h == H_P1 ? p1g[v] : kg);
        nr[w] = h == H_P0 ? p0r[v]
              : (h == H_P1 ? p1r[v] : wide_child_momentum(h, p0g[v], p0r[v], p1r[v], kg));
      }
      p0g[v] = ng[0]; p0r[v] = nr[0]; p1g[v] = ng[1]; p1r[v] = nr[1];
    }
    group_sync();
    WIDE_PHASE(3);
    f_p0 = f1;
    f_p1 = f2;
  }

  // ---- memetic on parent 0 (reference :436-600), x = p0g in place ----
  if (P.memetic) {
    float* grad = X.kid(M_GRAD);
    float* gdir = X.kid(M_GDIR);
    float* xm = X.kid(M_XM);
    float* xp = X.kid(M_XP);
    float* cand = X.kid(M_CAND);
    bool done = false;
    for (int it = 0; it < P.mem_iters; ++it) {
      float f[2], s[2];
      lin_fit_group<V, K, T, W, SEC, true>(P, X, 1, p0g, p0g, f, s);
      const float f2p = f[0];
      const float f2 = SEC ? __fadd_rn(f2p, s[0]) : f2p;
      const float* gvk = X.gv();
      for (int v = X.j; v < V; v += W) {
        float gr = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int col = X.kcol[k * V + v];
          if (col < 0) continue;
          const float* d = X.lin() + col * 7;
#pragma unroll
          for (int c = 0; c < 7; ++c) gr = gr + d[c] * gvk[k * 7 + c];
        }
        if constexpr (SEC) gr = __fadd_rn(gr, sec_grad<V>(X.sec(), smask, as_vec<V>(p0g), v));
        grad[v] = gr;
      }
      group_sync();
      float l1 = 0.0f;
      for (int v = 0; v < V; ++v) l1 = l1 + fabsf(grad[v]);
      const float scale = P.h / (l1 + 1e-12f);
      for (int v = X.j; v < V; v += W) {
        const float gd = grad[v] * scale;
        gdir[v] = gd;
        xm[v] = p0g[v] - gd;
        xp[v] = p0g[v] + gd;
      }
      group_sync();
      lin_fit_group<V, K, T, W, SEC, false>(P, X, 2, xm, xp, f, s);
      float f1 = f[0], f3 = f[1];
      if constexpr (SEC) {
        f1 = __fadd_rn(f1, s[0]);
        f3 = __fadd_rn(f3, s[1]);
      }
      float st;
      if (P.memetic == 1) {  // quadratic line search
        const float v1 = f2 - f1, v2 = f3 - f2;
        const float vv = (v1 + v2) * 0.5f;
        const float a = v1 - v2;
        st = vv / a;
        st = isfinite(st) ? st : 0.0f;
      } else {               // linear
        const float cd = (f3 - f1) * 0.5f;
        st = f2 / cd;
        st = isfinite(st) ? st : 0.0f;
      }
      const float* cmin = X.row(R_CMIN);
      const float* cmax = X.row(R_CMAX);
      // the step fused onto x, as the previous wide layout rounded it
      // (nvcc left the product unfused here, PERF.md §6)
      for (int v = X.j; v < V; v += W)
        cand[v] = clampf(__fmaf_rn(P.memetic == 1 ? gdir[v] : -gdir[v], st, p0g[v]), cmin[v],
                         cmax[v]);
      group_sync();
      lin_fit_group<V, K, T, W, false, false>(P, X, 1, cand, cand, f, s);
      const bool accept = (f[0] < f2p) && !done;
      for (int v = X.j; v < V; v += W) p0g[v] = accept ? cand[v] : p0g[v];
      done = done || !accept;
      group_sync();
    }
  }

  WIDE_PHASE(4);
  // ---- exact FK + species fitness at the new parent 0 ----
  wide_fk<V, K, T, W, false>(P, X, p0g);
  float* term = X.term();
  for (int k = X.j; k < K; k += W) {
    const float* tp = X.tips() + X.itip[k] * 7;
    float q[7], gv[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) q[c] = tp[c];
    term[k] = goal_term<false>(X.goal(k), X.kind[k], q, gv);
  }
  group_sync();
  float fit = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) fit = (k == 0) ? term[0] : fit + term[k];
  WIDE_PHASE(5);
  return fit;
}

// n_steps steps of wide_step with the megastep bookkeeping between them
// (bio2_megastep.py:120-156).
template <int V, int K, int T, bool SEC, int W>
__device__ __forceinline__ void wide_megastep_body(const Params& P) {
  extern __shared__ float smem[];
  const WLane<V, K, T, W> X = wide_enter<V, K, T, W, SEC>(P, smem, true);
  constexpr int LPB = BLOCK / W;
  const bool live = X.n < P.N;
  const int n = X.n, nn = X.nn;
  const size_t N = P.N;
  const bool even = (n & 1) == 0;
  float* p0g = X.row(R_P0G);
  float* p1g = X.row(R_P1G);
  float* p0r = X.row(R_P0R);
  float* p1r = X.row(R_P1R);
  float* sol = X.sol();
  float* misc = X.misc();
  const float* pmisc = misc + (even ? X.Lo.lane : -X.Lo.lane);   // the paired lane's
  float sfit = P.sfit[nn];
  float sol_fit = P.sol_fit[nn];
  WIDE_PHASE(-1);

  for (int step = 0; step < P.n_steps; ++step) {
    float fit = wide_step<V, K, T, SEC, W>(P, X, step);
    // 1. per-lane incumbent on strict '<'
    if (fit < sol_fit) {
      sol_fit = fit;
      for (int v = X.j; v < V; v += W) sol[v] = p0g[v];
      for (int r = X.j; r < 7 * T; r += W) sol[V + r] = X.tips()[r];
    }
    // 2. improvement, taken before the swap
    bool improved = fit != sfit;
    // 3. species compare-swap with the paired lane (the adjacent region):
    //    the even lane's group exchanges both lanes' parents
    if (X.j == 0) {
      misc[S_PAIR_FIT] = fit;
      misc[S_PAIR_IMP] = improved ? 1.0f : 0.0f;
    }
    __syncthreads();
    const float fpair = pmisc[S_PAIR_FIT];
    const bool pimp = pmisc[S_PAIR_IMP] != 0.0f;
    const bool swap = even ? (fpair < fit) : (fit < fpair);
    if (even && swap) {
      float* q = p0g + X.Lo.lane;
      for (int i = X.j; i < 4 * V; i += W) {
        const float a = p0g[i];
        p0g[i] = q[i];
        q[i] = a;
      }
    }
    __syncthreads();
    if (swap) { improved = pimp; fit = fpair; }
    // 4. wipeout of the odd lane: both parents to the same random genes;
    //    coin and genes are words 0 and 1 + v of calls 0, 1, … of
    //    generation word 0xFFFFFFFF, each call by one thread
    float* wg = X.kid(0);
    if (P.rng_mode != RNG_TENSORS) {
      constexpr int NW = (V + 4) / 4;
      for (int k = X.j; k < NW; k += W) {
        const U4 w = salted(philox4x32(n, step, 0xFFFFFFFFu, k, P.seed, 0u), X.salt);
        const uint32_t ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = 4 * k + i;
          if (idx == 0) misc[S_WIPE] = u01(ww[i], 0.0f);
          else if (idx <= V) wg[idx - 1] = u01(ww[i], 0.0f);
        }
      }
      group_sync();
    }
    const float wu = P.rng_mode == RNG_TENSORS ? P.wipe_u[(size_t)step * N + nn]
                                               : misc[S_WIPE];
    const bool wipe = !even && (wu < 0.1f || !improved);
    if (wipe) {
      for (int v = X.j; v < V; v += W) {
        const float u = P.rng_mode == RNG_TENSORS ? P.wipe_g[((size_t)step * V + v) * N + nn]
                                                  : wg[v];
        const float lo = P.amin[v * N + nn], hi = P.amax[v * N + nn];
        const float r = lo + u * (hi - lo);
        p0g[v] = r; p1g[v] = r; p0r[v] = 0.0f; p1r[v] = 0.0f;
      }
    }
    sfit = fit;
    group_sync();
    WIDE_PHASE(6);
  }

  if (live && X.j == 0) {
    P.sfit_o[n] = sfit;
    P.sol_fit_o[n] = sol_fit;
  }
  __syncthreads();
  float* lanes = smem + X.Lo.lanes;
  const int lane0 = blockIdx.x * LPB;
  const WideLayout& Lo = X.Lo;
  lane_rows(lanes, Lo, LPB, lane0, P.N, 2 * V, Lo.vec + R_P0G * V, P.genes_o, nullptr, false);
  lane_rows(lanes, Lo, LPB, lane0, P.N, 2 * V, Lo.vec + R_P0R * V, P.grads_o, nullptr, false);
  lane_rows(lanes, Lo, LPB, lane0, P.N, V, Lo.sol, P.sol_o, nullptr, false);
  lane_rows(lanes, Lo, LPB, lane0, P.N, 7 * T, Lo.sol + V, P.sol_tips_o, nullptr, false);
}

// The pose-only megastep.
template <int V, int K, int T, int W>
__global__ void __launch_bounds__(BLOCK, WIDE_MIN_BLOCKS) megastep_kernel(const Params P) {
  wide_megastep_body<V, K, T, false, W>(P);
}

// The megastep with joint-space secondary goals.
template <int V, int K, int T, int W>
__global__ void __launch_bounds__(BLOCK, WIDE_MIN_BLOCKS) megastep_sec_kernel(const Params P) {
  wide_megastep_body<V, K, T, true, W>(P);
}

// The fullstep kernel (TPU make_fullstep_kernel): one bio2 step per lane,
// no species bookkeeping, every goal kind without secondary goals as
// there; Philox step word 0; a lane per FULLSTEP_W threads.
template <int V, int K, int T>
__global__ void __launch_bounds__(BLOCK, WIDE_MIN_BLOCKS) fullstep_kernel(const Params P) {
  constexpr int W = FULLSTEP_W, LPB = BLOCK / W;
  extern __shared__ float smem[];
  const WLane<V, K, T, W> X = wide_enter<V, K, T, W, false>(P, smem, false);
  const float fit = wide_step<V, K, T, false, W>(P, X, 0);
  if (X.n < P.N && X.j == 0) P.fit_o[X.n] = fit;
  __syncthreads();
  float* lanes = smem + X.Lo.lanes;
  const int lane0 = blockIdx.x * LPB;
  const WideLayout& Lo = X.Lo;
  lane_rows(lanes, Lo, LPB, lane0, P.N, 2 * V, Lo.vec + R_P0G * V, P.genes_o, nullptr, false);
  lane_rows(lanes, Lo, LPB, lane0, P.N, 2 * V, Lo.vec + R_P0R * V, P.grads_o, nullptr, false);
  lane_rows(lanes, Lo, LPB, lane0, P.N, 7 * T, Lo.tips, P.tips_o, nullptr, false);
}

// ------------------------------------------------------------ C API ----
// Over the including source's (V, K, T) instances (SHAPES): pose-only and
// secondary-goal megasteps for every group width W of GROUPS and a
// fullstep kernel each (W = FULLSTEP_W).  The argument lists are those of
// the narrow layout's C API (csrc/megastep.cuh), G being the width W; nbranch
// is not read (every link's frame is kept).

// Version of megastep_launch's argument list (see csrc/megastep.cuh).
extern "C" int megastep_abi_version() { return 3; }

// Dynamic shared memory of one block, bytes, at group width G.
extern "C" int megastep_smem_bytes(int V, int nlinks, int nbranch, int C, int G,
                                   unsigned int sec_mask, int ncol, int K, int T) {
  (void)nbranch;
  return wide_layout(V, K, T, nlinks, C, G, sec_mask, ncol).words * 4;
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
#define OCC(v, k, t, w)                                                            \
  if (V == v && K == k && T == t && G == w) {                                      \
    cudaError_t e;                                                                 \
    if (!fits) {                                                                   \
      e = cudaSuccess;                                                             \
    } else if (sec) {                                                              \
      e = (cudaError_t)prepare(megastep_sec_kernel<v, k, t, w>, smem);            \
      if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(     \
          blocks, megastep_sec_kernel<v, k, t, w>, BLOCK, smem);                   \
    } else {                                                                       \
      e = (cudaError_t)prepare(megastep_kernel<v, k, t, w>, smem);                \
      if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(     \
          blocks, megastep_kernel<v, k, t, w>, BLOCK, smem);                       \
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
  if (N <= 0 || (N & 1) || nlinks > MAX_LINKS || C <= 0 || C > MAX_C || ncol <= 0)
    return (int)cudaErrorInvalidValue;
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
#define LAUNCH(v, k, t, w)                                                         \
  if (V == v && K == k && T == t && G == w) {                                      \
    int e;                                                                         \
    if (!sec_mask) {                                                               \
      if ((e = prepare(megastep_kernel<v, k, t, w>, smem))) return e;              \
      megastep_kernel<v, k, t, w><<<grid, block, smem, s>>>(P);                    \
    } else {                                                                       \
      if ((e = prepare(megastep_sec_kernel<v, k, t, w>, smem))) return e;          \
      megastep_sec_kernel<v, k, t, w><<<grid, block, smem, s>>>(P);                \
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
  if (N <= 0 || nlinks > MAX_LINKS || C <= 0 || C > MAX_C || ncol <= 0)
    return (int)cudaErrorInvalidValue;
  Params P{N, nlinks, nbranch, 1, gens, C, mem_iters, memetic, rng_mode, h, seed, 0u,
           salt, genes, grads, nullptr, nullptr, nullptr, nullptr,
           genes_o, grads_o, nullptr, nullptr, nullptr, nullptr, tips_o, fit_o,
           qfix, gpos, gquat, wpos, wrot, span, cmin, cmax, nullptr, nullptr, nullptr,
           noise, rates, nullptr, nullptr, nullptr, chain_i, chain_f, tip_slot, inst_tip,
           gaux, inst_kind, cols, ncol};
  const size_t threads = (size_t)N * FULLSTEP_W;
  dim3 grid((unsigned)((threads + BLOCK - 1) / BLOCK)), block(BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)megastep_smem_bytes(V, nlinks, nbranch, C, FULLSTEP_W, 0u,
                                                  ncol, K, T);
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
