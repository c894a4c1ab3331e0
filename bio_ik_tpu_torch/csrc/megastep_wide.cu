// The wide megastep instances: many variables and tips (the PR2 dual arm,
// V = 17, K = T = 2), every goal kind of the step.  The lane's
// linearization lives in shared memory by dependency column (see
// csrc/megastep.cuh, which holds the step, the kernels and the C API).
// Replaces the TPU kernels bio_ik_tpu/kernels/bio2_megastep.py::
// make_megastep_kernel and bio2_fullstep.py::make_fullstep_kernel at these
// shapes.

// (V, K, T) instances, each for every group size G (not 8: no launch of the
// wide paths picks it, kernels/bio2_megastep.MEGASTEP_GROUPS)
#define SHAPES(X) X(17, 2, 2)
#define GROUPS(X, v, k, t) X(v, k, t, 1) X(v, k, t, 2) X(v, k, t, 4)
#define MEGASTEP_WIDE 1

#include "megastep.cuh"
