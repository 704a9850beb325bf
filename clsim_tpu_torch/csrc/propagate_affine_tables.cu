// The twelve instantiations of the global affine plan (K1·B3) in the
// photonics-table medium (K1·B7): COLL_AFFINE with MED_TABLES, every
// deposit mode (launch_family in propagate.cuh; the entry points are in
// propagate.cu).

#include "propagate.cuh"

int dispatch_affine_tables(int mode, const LaunchArgs& a) {
  return launch_family<COLL_AFFINE, MED_TABLES>(mode, a);
}
