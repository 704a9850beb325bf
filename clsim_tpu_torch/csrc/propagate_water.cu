// The twelve instantiations of sea water (K1·B7) with SubPlan collision:
// COLL_SUBPLANS with MED_WATER, every deposit mode (launch_family in
// propagate.cuh; the entry points are in propagate.cu).

#include "propagate.cuh"

int dispatch_water(int mode, const LaunchArgs& a) {
  return launch_family<COLL_SUBPLANS, MED_WATER>(mode, a);
}
