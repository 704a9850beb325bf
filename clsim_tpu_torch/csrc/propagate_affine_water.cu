// The twelve instantiations of the global affine plan (K1·B3) in sea water
// (K1·B7): COLL_AFFINE with MED_WATER, every deposit mode (launch_family
// in propagate.cuh; the entry points are in propagate.cu).

#include "propagate.cuh"

int dispatch_affine_water(int mode, const LaunchArgs& a) {
  return launch_family<COLL_AFFINE, MED_WATER>(mode, a);
}
