// The high-DOF megastep instances: snake-32 (V = 32, one tip) and the
// 30-DOF humanoid (V = 30, K = T = 3), the wide layout of
// csrc/megastep_wide.cu (the lane's linearization in shared memory by
// dependency column, every goal kind of the step; csrc/megastep.cuh holds
// the step, the kernels and the C API).  Replaces the TPU kernels
// bio_ik_tpu/kernels/bio2_megastep.py::make_megastep_kernel and
// bio2_fullstep.py::make_fullstep_kernel at these shapes.

// (V, K, T) instances, each at the group size G = 2 alone.  At G = 1 a
// block holds 164 KB (snake) or 128 KB (humanoid) of shared memory, one
// block per SM, and G = 2 runs as many lanes per SM in twice the threads;
// with secondary goals G = 1 does not fit at all (308 KB, 264 KB).  G = 4
// ran slower than G = 2 at every launch shape of the paths, with and
// without secondary goals, on an H100 (PERF.md §6)
#define SHAPES(X) X(32, 1, 1) X(30, 3, 3)
#define GROUPS(X, v, k, t) X(v, k, t, 2)
#define MEGASTEP_WIDE 1

#include "megastep.cuh"
