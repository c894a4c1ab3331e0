// The high-DOF megastep instances: snake-32 (V = 32, one tip) and the
// 30-DOF humanoid (V = 30, K = T = 3), every goal kind of the step, a lane
// over a group of W threads with its vectors, linearization and frames in
// shared memory (csrc/megastep_wide.cuh holds the step, the kernels and the
// C API).  Replaces the TPU kernels bio_ik_tpu/kernels/bio2_megastep.py::
// make_megastep_kernel and bio2_fullstep.py::make_fullstep_kernel at these
// shapes.

// (V, K, T) instances, each for the group widths W = 8 and 16 (W = 32 ran
// slower than W = 16 at every first launch of the paths on an H100;
// kernels/bio2_megastep.choose_width picks per launch)
#define SHAPES(X) X(32, 1, 1) X(30, 3, 3)
#define GROUPS(X, v, k, t) X(v, k, t, 8) X(v, k, t, 16)
#define MEGASTEP_WIDE 1

#include "megastep.cuh"
