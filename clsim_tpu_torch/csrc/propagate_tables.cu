// The twelve instantiations of the photonics-table medium (K1·B7) with
// SubPlan collision: COLL_SUBPLANS with MED_TABLES, every deposit mode
// (launch_family in propagate.cuh; the entry points are in propagate.cu).

#include "propagate.cuh"

int dispatch_tables(int mode, const LaunchArgs& a) {
  return launch_family<COLL_SUBPLANS, MED_TABLES>(mode, a);
}
