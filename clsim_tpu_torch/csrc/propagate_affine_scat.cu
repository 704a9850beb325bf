// The twelve instantiations of the global affine plan (K1·B3) in the
// closed-form ice with a tabulated scattering angle (K1·B5):
// COLL_AFFINE with MED_CLOSED_SCAT, every deposit mode (launch_family in
// propagate.cuh; the entry points are in propagate.cu).

#include "propagate.cuh"

int dispatch_affine_scat(int mode, const LaunchArgs& a) {
  return launch_family<COLL_AFFINE, MED_CLOSED_SCAT>(mode, a);
}
