// The twelve instantiations of the global general plan (K1·B3) in sea water
// (K1·B7): COLL_GENERAL with MED_WATER, every deposit mode (launch_family
// in propagate.cuh; the entry points are in propagate.cu).

#include "propagate.cuh"

int dispatch_general_water(int mode, const LaunchArgs& a) {
  return launch_family<COLL_GENERAL, MED_WATER>(mode, a);
}
