// The twelve instantiations of the global general plan (K1·B3) in the
// closed-form medium: COLL_GENERAL with MED_CLOSED, every deposit mode
// (launch_family in propagate.cuh; the entry points are in propagate.cu).

#include "propagate.cuh"

int dispatch_general(int mode, const LaunchArgs& a) {
  return launch_family<COLL_GENERAL, MED_CLOSED>(mode, a);
}
