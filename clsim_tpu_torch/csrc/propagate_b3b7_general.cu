// Instantiations of the global general plan (K1 B3) in the tabulated media
// (K1 B7): COLL_GENERAL with MED_TABLES and MED_WATER
// (stopping detect, with and without records; the kernel is in
// propagate.cuh, the entry points in propagate.cu).

#include "propagate.cuh"

int dispatch_b3b7_general(int mode, const LaunchArgs& a) {
  int rc;
  if ((rc = launch_stop<COLL_GENERAL, MED_TABLES>(mode, a)) != -1) return rc;
  if ((rc = launch_stop<COLL_GENERAL, MED_WATER>(mode, a)) != -1) return rc;
  return -1;
}
