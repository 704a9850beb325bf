// Photon propagation kernel for NVIDIA Hopper (sm_90a): the C entry points
// and the instantiations of the main path's family (SubPlans, closed-form
// medium: every deposit mode, each with Philox or an external stream and
// with in-kernel threefry, and records with either).  The kernel itself and
// its design notes are in propagate.cuh; propagate_{affine,general,tables,
// water,scat,affine_tables,affine_water,affine_scat,general_tables,
// general_water,general_scat}.cu build the same twelve modes for every
// other (COLL, MED) pair, one translation unit each, so that nvcc compiles
// them in parallel.

#include "propagate.cuh"

int dispatch_main(int mode, const LaunchArgs& a) {
  return launch_family<COLL_SUBPLANS, MED_CLOSED>(mode, a);
}

typedef int (*Dispatch)(int, const LaunchArgs&);
static const Dispatch kDispatch[] = {
    dispatch_main,          dispatch_affine,        dispatch_general,
    dispatch_tables,        dispatch_water,         dispatch_affine_tables,
    dispatch_affine_water,  dispatch_general_tables, dispatch_general_water,
    dispatch_scat,          dispatch_affine_scat,   dispatch_general_scat};

static int dispatch(int mode, const LaunchArgs& a) {
  for (const Dispatch fn : kDispatch) {
    const int rc = fn(mode, a);
    if (rc != -1) return rc;
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Launch on `stream` in `mode` (kernel.py kernel_mode: DEP | MODE_THREEFRY |
// MODE_FIXED | COLL << COLL_SHIFT | MED << MED_SHIFT, without MODE_RECORDS);
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// mode without an instantiation (MODE_FIXED only in detect modes; every
// (COLL, MED) pair has the twelve modes of launch_family, every deposit
// mode with and without threefry).  All buffers are device pointers
// allocated by the caller; `uniforms` may be null when params->use_uniforms
// is 0, `tf_keys` ((2 * params->iters,) uint32) when the mode has no
// threefry, `ang` (params->n_ang floats, the angular polynomial in
// ascending powers) when the mode is not DEP_EXPECTED or n_ang is 0, and
// `rel`, `strings`, `wtab`, `scat` when the mode does not read them.
// `cnt_i` holds 18 int64, zeroed: generated, hits, alive, work; (COLL or
// MED other than 0) strings tested, candidates culled, cull passes, DOM
// rows tested, scatters and Rayleigh scatters (the tabulated angle);
// layer-walk steps, warp-iterations with a live lane, warp-iterations that
// ran the spawn stage, and five cycle accounts.  Mode 0 is the main path's
// instantiation.
int clsim_propagate(int mode, const Params* params, float* state,
                    const float* steps, const float* uniforms,
                    const float* layers, const float* spec_tab,
                    const float* bias_tab, const float* tilt_zc,
                    const float* cells, float* hist, long long* cnt_i,
                    double* cnt_w, const float* rel, const float* strings,
                    const float* wtab, const float* scat, const float* ang,
                    const unsigned int* tf_keys, void* stream) {
  if (mode & MODE_RECORDS) return (int)cudaErrorInvalidValue;
  const LaunchArgs a = {params, state, steps, uniforms, tf_keys, layers,
                        spec_tab, bias_tab, tilt_zc, cells, hist, cnt_i,
                        cnt_w, nullptr, nullptr, nullptr, rel, strings, wtab,
                        scat, ang, stream};
  return dispatch(mode, a);
}

// The record mode (stopping detect; Philox, an external stream or, with
// MODE_THREEFRY, the key table `tf_keys`) of any (COLL, MED) in `mode`
// (MODE_RECORDS set): `state` has NSF + NRSF rows, `doms` is (n_doms, 4)
// [x, y, z, 0], `rec_buf` holds params->rec_cap records of NRC floats and
// `rec_cnt` (one zeroed int64) receives the number of appends tried.
int clsim_propagate_records(int mode, const Params* params, float* state,
                            const float* steps, const float* uniforms,
                            const float* layers, const float* spec_tab,
                            const float* bias_tab, const float* tilt_zc,
                            const float* cells, float* hist, long long* cnt_i,
                            double* cnt_w, const float* rel,
                            const float* strings, const float* wtab,
                            const float* scat, const float* doms,
                            float* rec_buf, long long* rec_cnt,
                            const unsigned int* tf_keys, void* stream) {
  if (!(mode & MODE_RECORDS)) return (int)cudaErrorInvalidValue;
  const LaunchArgs a = {params, state, steps, uniforms, tf_keys, layers,
                        spec_tab, bias_tab, tilt_zc, cells, hist, cnt_i,
                        cnt_w, doms, rec_buf, rec_cnt, rel, strings, wtab,
                        scat, nullptr, stream};
  return dispatch(mode, a);
}

int clsim_record_columns(void) { return NRC; }
int clsim_record_state_rows(void) { return NRSF; }

const char* clsim_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int clsim_params_size(void) { return (int)sizeof(Params); }

// Resident blocks of BLOCK threads per SM of the main path's instantiation
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 on an error.
int clsim_main_occupancy(void) {
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, propagate_kernel<false, DEP_STOP, false, false, COLL_SUBPLANS,
                           MED_CLOSED>,
      BLOCK, 0);
  return rc == cudaSuccess ? n : -1;
}

}  // extern "C"
