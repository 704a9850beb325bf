// Instantiations of the tabulated media (K1 B7) with SubPlan collision:
// COLL_SUBPLANS with MED_TABLES (photonics-table ice) and MED_WATER
// (stopping detect, with and without records; the kernel is in
// propagate.cuh, the entry points in propagate.cu).

#include "propagate.cuh"

int dispatch_b7(int mode, const LaunchArgs& a) {
  int rc;
  if ((rc = launch_stop<COLL_SUBPLANS, MED_TABLES>(mode, a)) != -1) return rc;
  if ((rc = launch_stop<COLL_SUBPLANS, MED_WATER>(mode, a)) != -1) return rc;
  return -1;
}
