// The twelve instantiations of the global general plan (K1·B3) in the
// closed-form ice with a tabulated scattering angle (K1·B5):
// COLL_GENERAL with MED_CLOSED_SCAT, every deposit mode (launch_family in
// propagate.cuh; the entry points are in propagate.cu).

#include "propagate.cuh"

int dispatch_general_scat(int mode, const LaunchArgs& a) {
  return launch_family<COLL_GENERAL, MED_CLOSED_SCAT>(mode, a);
}
