// The twelve instantiations of the global general plan (K1·B3) in the
// photonics-table medium (K1·B7): COLL_GENERAL with MED_TABLES, every
// deposit mode (launch_family in propagate.cuh; the entry points are in
// propagate.cu).

#include "propagate.cuh"

int dispatch_general_tables(int mode, const LaunchArgs& a) {
  return launch_family<COLL_GENERAL, MED_TABLES>(mode, a);
}
