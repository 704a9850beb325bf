// The twelve instantiations of the closed-form ice with a tabulated
// scattering angle (K1·B5: e.g. the Antares angle on IceCube ice) with
// SubPlan collision: COLL_SUBPLANS with MED_CLOSED_SCAT, every deposit mode
// (launch_family in propagate.cuh; the entry points are in propagate.cu).

#include "propagate.cuh"

int dispatch_scat(int mode, const LaunchArgs& a) {
  return launch_family<COLL_SUBPLANS, MED_CLOSED_SCAT>(mode, a);
}
