// The wide megastep instances: many variables and tips (the PR2 dual arm,
// V = 17, K = T = 2), every goal kind of the step, a lane over a group of
// W threads with its vectors, linearization and frames in shared memory
// (csrc/megastep_wide.cuh holds the step, the kernels and the C API).
// Replaces the TPU kernels bio_ik_tpu/kernels/bio2_megastep.py::
// make_megastep_kernel and bio2_fullstep.py::make_fullstep_kernel at these
// shapes.

// (V, K, T) instances, each for every group width W (W = 8 ran fastest at
// both dual ladders' large launches on an H100, W = 4 and 16 where few
// lanes leave the card part empty; kernels/bio2_megastep.choose_width)
#define SHAPES(X) X(17, 2, 2)
#define GROUPS(X, v, k, t) X(v, k, t, 4) X(v, k, t, 8) X(v, k, t, 16)
#define MEGASTEP_WIDE 1

#include "megastep.cuh"
