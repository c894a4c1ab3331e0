// The species kernel's prebuilt instances: the floating-base free_arm (V =
// 10, a quaternion block at gene 3) and the planar_arm (V = 5), one goal
// instance each.  The step, the kernels and the C API are csrc/species.cuh;
// kernels/bio2_step.py::SPECIES_SHAPES lists the same instances, and any
// other shape is generated and built on its first use.  Replaces the TPU
// kernel bio_ik_tpu/kernels/bio2_step.py::make_species_kernel at these
// shapes.

// (V, K, quaternion mask) instances
#define SHAPES(X) X(10, 1, 8) X(5, 1, 0)

#include "species.cuh"
