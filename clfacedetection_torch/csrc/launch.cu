// The host side of launch.cuh.
#include "launch.cuh"

// Setups of the kernels' shared-memory limits so far (ClfdSmem): one per
// kernel and device; a launch on a device that is set up adds none.
extern "C" int clfd_smem_setups() { return clfd_smem_setup_count.load(); }
