// Instantiations of the global collision plans (K1 B3) in the closed-form
// medium: COLL_AFFINE and COLL_GENERAL with MED_CLOSED
// (stopping detect, with and without records; the kernel is in
// propagate.cuh, the entry points in propagate.cu).

#include "propagate.cuh"

int dispatch_b3(int mode, const LaunchArgs& a) {
  int rc;
  if ((rc = launch_stop<COLL_AFFINE, MED_CLOSED>(mode, a)) != -1) return rc;
  if ((rc = launch_stop<COLL_GENERAL, MED_CLOSED>(mode, a)) != -1) return rc;
  return -1;
}
