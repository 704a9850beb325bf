// Instantiations of the global affine plan (K1 B3) in the tabulated media
// (K1 B7): COLL_AFFINE with MED_TABLES and MED_WATER
// (stopping detect, with and without records; the kernel is in
// propagate.cuh, the entry points in propagate.cu).

#include "propagate.cuh"

int dispatch_b3b7_affine(int mode, const LaunchArgs& a) {
  int rc;
  if ((rc = launch_stop<COLL_AFFINE, MED_TABLES>(mode, a)) != -1) return rc;
  if ((rc = launch_stop<COLL_AFFINE, MED_WATER>(mode, a)) != -1) return rc;
  return -1;
}
