// Photon propagation kernel for NVIDIA Hopper (sm_90a): the kernel template
// and its launcher.  The translation units propagate*.cu instantiate it (one
// nvcc each, built in parallel by clsim_tpu_torch/_build.py); propagate.cu
// holds the C entry points.
//
// Replaces the Pallas TPU kernel clsim_tpu/propagate/kernel.py::_make_kernel
// (pl.pallas_call at clsim_tpu/propagate/kernel.py:2427) in these
// configurations: IceCube layered ice with optional tilt and anisotropy,
// with its Liu/HG scattering or a tabulated scattering angle mixed with
// Rayleigh, or a tabulated medium (sea water, photonics-table ice); the
// Cherenkov spectrum and any stacked flasher spectra, with a uniform or
// non-uniform bias grid; per-subdetector SubPlan collision or the global
// cell plan (affine or general); the detect estimator with or without
// stop-on-detection and with a sampled or fixed absorption budget, or the
// expected estimator (survival-weight deposits, soft binning, an angular
// polynomial of any length), with every collision plan and medium; Philox,
// an external stream or in-kernel threefry for the random numbers, in every
// deposit mode and with records.  Its plain PyTorch version is
// clsim_tpu_torch/propagate/kernel.py::run_fused_iterations_plain.
//
// Design.  One thread owns one photon slot and keeps its photon's state in
// registers for the launch.  Each launch runs up to `iters` iterations of
// two stages, the spawn stage for the slots that need a photon (`fresh`)
// and the propagate stage, under one of two loop policies, a constexpr of
// the template arguments (warp_loop), so that each instantiation compiles
// one loop:
//  * block-synchronous, for the detect modes and the record modes (the
//    main path among them), whose slots spawn 52-149 photons a
//    block-iteration: the block of 256 threads iterates in step.  The fresh
//    slots are listed in shared memory (a ballot and popc per warp, a
//    prefix over the block's warps); the block's first n_spawn threads
//    each make the photon of one listed slot (make_photon: the step row,
//    the spectrum's binary search and solve, the medium's factors, the
//    Cherenkov cone and its rotation, the bias) and write it to a shared
//    slab; after a barrier each owner loads its photon.  A drained or
//    stalled thread stays in the loop, inactive, so that every thread
//    reaches the block's barriers; the block leaves when no slot of it is
//    live (__syncthreads_or);
//  * warp-independent, where photons live to a fixed horizon (the expected
//    estimator, and FIXED), whose block-iterations spawn 0.6-12 photons:
//    each warp iterates on its own, a fresh lane makes its own photon, and
//    the warp leaves when no lane of it is live (__ballot_sync).  No
//    barrier is in the loop; the one after the step rows are staged and
//    the one before the counters' reduction stay.
// The step rows are staged in shared memory at launch start.  The random
// numbers of a spawn stay keyed to the slot whose photon is made (rows 0-3
// of the stream at [it, r, slot], Philox counter (it0 + it, slot, 0),
// threefry element r * N + slot), never to the thread that computes it, so
// both policies draw what the slot-per-thread loop drew.  The propagate
// stage, on each owner's registers: the photon walks the layered ice until
// its scattering or absorption budget or the segment cap is used up, the
// segment is tested against the DOMs of the strings its cell may reach, a
// hit is deposited into the (dom, time-bin) histogram with a float
// atomicAdd (and kills the photon when stopping), and a survivor scatters.
// The walk tests its exit by products, (tb - t_done) * rate >= budget (both
// rates are positive), and divides the two distances once, at its last
// step; divisions by per-launch constants are products by reciprocals the
// host computed (Params), and the rotation uses sincosf and rsqrtf.  The
// kernel counts its walk steps (CNT_WALK), its warp-iterations with a live
// lane and those that ran the spawn stage, and each warp's clock cycles
// (lane 0's) in the block's barriers, the propagate stage, the spawn stage
// and, on the global plans, the collision test and its cull (kernel.py
// CNT_*; chip_smoke's k1_stats).
//
// What bounds it on this card: latency, not bandwidth or arithmetic
// (PERF.md section 5 has the measured account; NVIDIA H100 80GB HBM3,
// 700.00 W).  Every thread runs data-dependent loops (layer walk, candidate
// strings, z-window DOMs) with early exits, so warps diverge, and it reads
// the layer and cell tables at random.  The design keeps all photon state
// in registers for the launch (read and written once), keeps the tables
// small and read-only (`const __restrict__`, served from L1/L2), and
// reduces the counters per warp and block so that one atomic per block
// reaches global memory.  Measured on the parent body: the block's
// barriers took 17-25% of each warp's cycles on the SubPlans and the
// affine plan and 39-43% on the general plan and in water; the global
// cull, one L2 read after another for 11-28 candidates a slot-iteration,
// 39-50% on the global plans, and still 23% once its entries were
// consecutive, with over 95% of the candidates rejected; the general
// plan's 57-59 DOM rows a tested string 13-20%.  So: the compacted spawn
// stays where spawns are many and the warp loop takes the fixed-horizon
// modes; the global cull reads a list per fine cell and azimuth sector,
// the strings the segment's strip can reach (0.41-0.47 a slot-iteration
// on the IC86 event streams, where the coarse cells' lists held 14-19,
// and the cull 7-9% of the cycles), its entries consecutive 16-byte loads
// issued four at a time; the general plan tests only the DOM rows of the
// segment's z-window (0.8-1.0 a tested string; general_window in kernel.py
// proves the accept set unchanged); and a third resident block a SM (80
// registers) hides more latency than the registers it spills cost.
//
// Random numbers: Philox4x32-10 keyed by the wrapper's 64-bit seed, counter
// (it0 + iteration, slot, block); or, in parity mode, an external (T, 8, N)
// float32 stream read at [iteration, row, slot]; or, in the THREEFRY
// instantiations (the TPU kernel's `threefry`, kernel.py:341-361, :447-456,
// :758-773; built with every deposit mode and with records, as the TPU
// kernel takes a key with any estimator: the fit's forward, and a detect
// run in the goldens' own stream), threefry2x32 keyed by the host-folded
// key of the iteration (a (2T,) uint32 table), counter (0, row * N + slot),
// the two output words XORed and mapped to [0, 1) as jax.random.uniform
// does: bit-exact to ops/rng.py and to jax.random, so the engine run with
// the same key (the fit's backward) sees the same numbers.  THREEFRY stays
// a template argument: a runtime branch would put the 20 rounds into the
// register allocation of the Philox modes.  Rows 0-3 are drawn only when
// the slot spawns (the values are those of the full (8, N) block: a counter-
// based draw depends on nothing but its counter); ~100 integer operations
// per row.
//
// Deposit modes (the template's DEP; the TPU kernel's `expected`,
// `stopping`, `soft`, `ang_poly`, `fixed_abs`, kernel.py:855-857,
// :1478-1529).  DEP_STOP is the main path: a hit deposits w0 and kills the
// photon.  DEP_PASS (non-stopping detect) deposits w0 and keeps flying.
// DEP_EXPECTED deposits the survival weight w0 exp(-(tau_start + frac *
// tau_seg)) at every DOM entry, times the clipped angular polynomial (its
// n_ang coefficients read from a device table, Horner's rule in the loop:
// any length, as the TPU kernel unrolls any length), into
// one bin or (soft) two neighbouring bins; the photon passes through and
// dies only at the fixed horizon.  FIXED sets the spawn budget to the
// horizon in detect mode.  What bounds these modes beyond the main path:
// coherent workloads (every photon of a beam crossing the same DOM in the
// same iteration) make many threads add to the same bins at once, so the
// atomics serialise there; sums stay exact up to their order.
//
// Photon records (the RECORDS instantiation; the TPU kernel's `records`,
// `rec_all` and `rec_prescale`: REC_STATE_FIELDS, the record position with
// the pancake undone, SAVE_ALL and the record queue in `flush`).  The record
// state (wavelength, emission point and direction, scatter count, absorption
// depth) stays in registers for the launch and rides as extra state rows
// between launches.  A photon that hits (or, with rec_all, is absorbed)
// still deposits into the histogram, then its record of NRC floats is
// appended to a device buffer at a slot taken by an atomicAdd on one
// counter.  The host call loop sets the capacity: a thread whose append
// finds it full keeps the record pending (the photon is dead, so its x/y/z
// and t already hold the record; `pend` keeps the flat index) and sits out
// the rest of the launch; the next launch writes the pending record first.
// No record is lost and the buffer stays bounded (a threefry run has one
// launch, whose key table covers its iterations, so the host gives it room
// for every record).  What bounds the mode beyond the main path:
// one atomic per record on a single counter and 88 scattered bytes per
// record, both small beside the photon's walk.  The main path's
// instantiation (RECORDS = false) compiles none of this.
//
// Collision and media (the template's COLL and MED; the TPU kernel's
// global plan, kernel.py:947-1003, :1270-1456, and media tables, :807-833,
// :1606-1629).  COLL 0 is the SubPlan test above.  COLL 1 and 2 cull from
// the card's own table (kernel.py card_cull_table), not the TPU kernel's
// one list per coarse cell: the photon's fine cell and azimuth sector (its
// quadrant by the signs of dx, dy, then |dy| against fixed multiples of
// |dx|: comparisons only) select an (offset, count) pair, and the list's
// entries (position, cull radius, string index) are every string whose
// cull disc meets what a capped segment from that cell into that sector
// can sweep, in ascending string index as the TPU kernel's lists are.  The
// cull's test is the TPU kernel's, per string, so the strings that pass,
// their ranking (ties keep the lower index) and the hits are those of the
// coarse lists.  Per string the table holds its z extent and DOM ladder,
// and its DOM count, DOM offset, 1 / DOM spacing and the z-window's
// half-width.  The cull ranks by the static segment cap, as the TPU kernel
// does, and the n_rounds closest culled strings stay in sorted registers.
// A geometry whose refined table would not fit its budget gets the coarse
// lists through the same code (one sector, the TPU kernel's cells).
// COLL 1 (affine: every DOM on its string's z0 + m*dz
// ladder) tests the n_dom_cand ladder DOMs of the segment's z-window; COLL 2
// (surveyed positions) tests the DOM rows of the segment's z-window on the
// string's fitted ladder, widened by the string's largest residual in z
// (the string's half-width entry), from an (S, M) float4 residual table beside
// a float4 per string: a row the full test accepts has its entry point on
// the segment inside the DOM's sphere, so it lies in the window (with
// pancake_factor >= 1; otherwise the half-width keeps every row).
// MED 1 and 2 replace the closed-form wavelength factors at spawn by a lerp
// of the (rows, n_wtab) wavelength table (gs, pa, qa, ra, and n, g when
// tabulated); MED 2 (sea water) and MED 3 (the closed-form ice with a
// tabulated scattering angle, e.g. Antares's) replace the Liu/HG scattering
// by the Rayleigh cubic mixed with the tabulated (Petzold) angle, located
// in its CDF by binary search and solved as the wavelength is; the
// Rayleigh fraction rides in liu_frac, as the TPU kernel reads it from
// PF_LIU_FRAC (kernel.py:1606-1629).  The main path is COLL 0, MED 0: none
// of this is compiled there.
//
// Flasher spectra and the bias grid (the TPU kernel's `sample_wavelength`
// row mask and `wavelength_bias`, kernel.py:533-580).  The spectrum table
// holds every stacked spectrum, (n_tables, 3, n_spec); a spawn offsets it
// by the step's source_type and runs the one-table binary search and solve
// there, so one table is the main path's code and a flasher step samples
// its own LED spectrum (the engine's sample_wavelength_dispatch).  The host
// refuses a source_type without a table (check_source_types), so the
// offset never leaves the table.  A non-Cherenkov step keeps its direction.
// The bias is read from a (2, n_bias) table of grid points and values: by
// index on a uniform grid, by binary search over the points otherwise,
// with the wavelength clamped to the grid (the engine's interp).  Both are
// runtime parameters of the spawn, not template arguments, so every
// instantiation serves flasher steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC per translation unit, then one -shared link (no
//        fast-math: parity depends on logf/expf/powf).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define BIG 1e30f
#define EPS 1e-5f
#define C_LIGHT 0.299792458f
#define MAX_PLANS 4
#define MAX_ROUNDS 4
#define MAX_TILT_D 16
// the sector rule's thresholds (kernel.py CULL_MAX_SUB - 1)
#define CULL_TAN 7
#define BLOCK 256

// parameter block, mirrored field for field by the ctypes structures in
// clsim_tpu_torch/propagate/kernel.py (every field is 4 bytes)
struct PlanParams {
  float x0, y0, inv_cell, uz_z0, uz_dz, inv_dz, uz_nd, minz, maxz;
  int nx, ny, k_cand, n_dom_cand, rounds, cell_off;
};

struct Params {
  int n_slots, iters, K, L, n_spec, n_bias, nz_tilt, nd_tilt, aniso, nbins,
      n_plans, use_uniforms, n_tables, bias_uniform;
  unsigned int it0, seed_lo, seed_hi;
  float z_start, layer_h, alpha, kappa, abs_a, abs_b, abs_d, abs_e;
  float an_ca, an_sa, an_k1, an_k2, an_kz, mean_cos, liu_frac, r, r2;
  float inv_pancake, max_seg, hist_t0, hist_dt;
  float tilt_z0, tilt_dz, tilt_ca, tilt_sa, bias_x0, bias_inv_dx;
  float n[5], g[5];
  float tilt_d[MAX_TILT_D];
  PlanParams plans[MAX_PLANS];
  int rec_cap, rec_all;        // record mode: buffer capacity, SAVE_ALL
  float rec_prescale, rec_fpk;  // SAVE_ALL prescale, (pancake - 1) / pancake
  float horizon;               // fixed absorption horizon [abs. lengths]
  int soft, n_ang;             // soft binning; angular coefficients
  float pmt_ax, pmt_ay, pmt_az;  // PMT axis of the angular polynomial
  // the global cell plan (COLL 1, 2): the card's cull table (kernel.py
  // card_cull_table): fine cells of 1 / c_inv_cell from (c_x0, c_y0),
  // c_nx x c_ny of them, c_sectors azimuth sectors a cell (sector q *
  // c_qmul + min(j, c_m - 1), q the quadrant and j the thresholds c_tan
  // that |dy| exceeds times |dx|), and the rows of `cells` where the
  // per-string ladder entries, the lists' (offset, count) pairs and their
  // cull entries start (the per-string z extents at row 0); DOM-window
  // candidates (affine), test rounds, DOM rows per string (general)
  float c_x0, c_y0, c_inv_cell;
  int c_nx, c_ny, c_sectors, c_qmul, c_m, c_lad, c_hdr, c_ent;
  float c_tan[CULL_TAN];
  int n_dom_cand, n_rounds, m_rel;
  // tabulated media (MED 1, 2): the uniform wavelength grid, its points,
  // whether the phase/group index is tabulated, points of the angle CDF
  float wtab_x0, wtab_inv_dx;
  int n_wtab, ref_table, n_scat;
  // per-launch constants the kernel multiplies by instead of dividing:
  // 1 / layer height, 1 / tilt z-spacing; the anisotropy's 1 / k_i^2, their
  // sum (B2) and 1 / k_i; the Liu exponent (1 - g) / (1 + g).  Two
  // divisions stay: the histogram's time bin (a hit's bin must be the one
  // its record's time gives, hits/photons; once a hit, not an iteration)
  // and HG's / (2 g), whose product moved a hit away from the plain
  // version (PERF.md, the kernel's redesign).
  float inv_layer_h, inv_tilt_dz;
  float an_il1, an_il2, an_il3, an_b2, an_ik1, an_ik2, an_ikz;
  float liu_beta;
  // the slots a launch runs, the first n_active (the live prefix the call
  // loop's repack leaves; n_slots for a whole launch); n_slots stays every
  // row's stride and the random numbers' slot index
  int n_active;
};

// collision (template COLL) and medium (template MED) instantiations
enum { COLL_SUBPLANS = 0, COLL_AFFINE = 1, COLL_GENERAL = 2 };
enum { MED_CLOSED = 0, MED_TABLES = 1, MED_WATER = 2, MED_CLOSED_SCAT = 3 };

// the closed-form wavelength factors at spawn (MED 0, 3), and the tabulated
// scattering angle mixed with Rayleigh (MED 2, 3)
template <int MED>
__host__ __device__ constexpr bool closed_form() {
  return MED == MED_CLOSED || MED == MED_CLOSED_SCAT;
}
template <int MED>
__host__ __device__ constexpr bool tabulated_angle() {
  return MED == MED_WATER || MED == MED_CLOSED_SCAT;
}

// deposit modes (template DEP) and the host's mode flags (kernel.py
// kernel_mode: DEP | MODE_THREEFRY | MODE_FIXED)
enum { DEP_STOP = 0, DEP_PASS = 1, DEP_EXPECTED = 2 };
enum { MODE_THREEFRY = 4, MODE_FIXED = 8, MODE_RECORDS = 16 };
enum { COLL_SHIFT = 5, MED_SHIFT = 7 };

// slot-state rows (engine.SlotState field order) and step rows
enum { F_LEFT, F_INF, F_X, F_Y, F_Z, F_T, F_DX, F_DY, F_DZ, F_W0, F_IGV,
       F_ABS, F_GS, F_PA, F_QA, F_RA, NSF };
enum { S_X, S_Y, S_Z, S_T, S_DX, S_DY, S_DZ, S_LEN, S_BETA, S_W, S_SRC,
       S_ID };
// record-mode state rows after the NSF rows (kernel.py REC_STATE_FIELDS)
enum { R_WLEN, R_ABS0, R_NSCAT, R_DABS, R_SX, R_SY, R_SZ, R_ST, R_SDX, R_SDY,
       R_SDZ, R_PEND, NRSF };
// columns of one record (kernel.py REC_COLUMNS)
enum { C_PX, C_PY, C_PZ, C_T, C_DX, C_DY, C_DZ, C_WLEN, C_ID, C_SX, C_SY,
       C_SZ, C_ST, C_SDX, C_SDY, C_SDZ, C_IGV, C_NSCAT, C_DABS, C_IDX, C_W,
       C_SLOT, NRC };

// threefry2x32 (20 rounds) of counter (0, c1) under key (k0, k1), the two
// output words XORed: jax.random's 32 random bits of element c1
// (clsim_tpu/propagate/kernel.py::_threefry_bits)
#define TF_ROUND(r) x0 += x1; x1 = __funnelshift_l(x1, x1, r) ^ x0;
__device__ __forceinline__ unsigned int threefry_bits(unsigned int k0,
                                                      unsigned int k1,
                                                      unsigned int c1) {
  const unsigned int k2 = 0x1BD11BDAu ^ k0 ^ k1;
  unsigned int x0 = k0, x1 = c1 + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}
#undef TF_ROUND

// jax.random.uniform's float of 32 random bits: [1, 2) by the mantissa,
// minus 1
__device__ __forceinline__ float tf_u01(unsigned int bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float u01(unsigned int bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);  // [0, 1)
}

__device__ __forceinline__ float poly4(const float* c, float x) {
  return c[0] + x * (c[1] + x * (c[2] + x * (c[3] + x * c[4])));
}

// ops/rotations.scatter_direction_by_angle, including its vertical branch:
// the azimuth's sine and cosine in one call (of the same rounded angle as
// the plain version's), 1 / sin(theta) and the final normalisation by
// rsqrtf (no IEEE division)
__device__ __forceinline__ void scatter_dir(float cosa, float sina, float dx,
                                            float dy, float dz, float u_az,
                                            float* ox, float* oy, float* oz) {
  float sinb, cosb;
  sincosf(2.0f * 3.14159265358979323846f * u_az, &sinb, &cosb);
  const float q = fmaxf(1.0f - dz * dz, 0.0f);
  float nx, ny, nz;
  if (q > 0.0f) {
    const float r = rsqrtf(q);
    const float f = sina * r;
    nx = dx * cosa - (dy * cosb + dz * dx * sinb) * f;
    ny = dy * cosa + (dx * cosb - dz * dy * sinb) * f;
    nz = dz * cosa + sina * sinb * (q * r);
  } else {
    nx = sina * cosb;
    ny = sina * sinb;
    nz = cosa * (dz > 0.0f ? 1.0f : (dz < 0.0f ? -1.0f : 0.0f));
  }
  const float inv = rsqrtf(nx * nx + ny * ny + nz * nz);
  *ox = nx * inv;
  *oy = ny * inv;
  *oz = nz * inv;
}

// anisotropy frame transform: normalize(T^T diag(d1, d2, d3) T dir)
__device__ __forceinline__ void aniso_transform(const Params& p, float d1,
                                                float d2, float d3, float* x,
                                                float* y, float* z) {
  const float n1 = (p.an_ca * *x + p.an_sa * *y) * d1;
  const float n2 = (-p.an_sa * *x + p.an_ca * *y) * d2;
  const float n3 = *z * d3;
  const float ox = p.an_ca * n1 - p.an_sa * n2;
  const float oy = p.an_sa * n1 + p.an_ca * n2;
  const float inv = rsqrtf(ox * ox + oy * oy + n3 * n3);
  *x = ox * inv;
  *y = oy * inv;
  *z = n3 * inv;
}

// inverse-CDF quadratic solve within a located segment
// (I3CLSimRandomValueInterpolatedDistribution.cxx:84-135)
__device__ __forceinline__ float interp_solve(float u, float x0, float x1,
                                              float b0, float b1, float acu0) {
  const float slope = (b1 - b0) / (x1 - x0);
  const float dy = u - acu0;
  const bool s_zero = fabsf(slope) < 1e-20f;
  const bool b_zero = fabsf(b0) < 1e-20f;
  if (b_zero && s_zero) return x0;
  if (b_zero) return x0 + sqrtf(fmaxf(2.0f * dy / slope, 0.0f));
  if (s_zero) return x0 + dy / b0;
  return x0 + (sqrtf(fmaxf(dy * 2.0f * slope / (b0 * b0) + 1.0f, 0.0f)) -
               1.0f) * b0 / slope;
}

// Rayleigh scattering cosine by the closed cubic (ops/samplers.rayleigh_cos,
// I3CLSimRandomValueRayleighScatteringCosAngle.cxx), b = 0.835
__device__ __forceinline__ float rayleigh_cos(float u) {
  const float p3 = (float)((1.0 / 0.835) * (1.0 / 0.835) * (1.0 / 0.835));
  const float q = 3.835f * (u - 0.5f) / 0.835f;
  const float d = q * q + p3;
  const float u1 = -q + sqrtf(d);
  const float v1 = -q - sqrtf(d);
  const float c = copysignf(powf(fabsf(u1), 1.0f / 3.0f), u1) +
                  copysignf(powf(fabsf(v1), 1.0f / 3.0f), v1);
  return fminf(fmaxf(c, -1.0f), 1.0f);
}

// k = clip(#{acu <= u} - 1, 0, n - 2) of an ascending CDF table
__device__ __forceinline__ int locate_cdf(const float* __restrict__ acu, int n,
                                      float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (acu[mid] <= u) lo = mid + 1; else hi = mid;
  }
  return min(max(lo - 1, 0), n - 2);
}

// medium/tilt.tilt_z_shift
__device__ __forceinline__ float tilt_shift(const Params& p,
                                            const float* __restrict__ zc,
                                            float x, float y, float z) {
  const int nz = p.nz_tilt, nd = p.nd_tilt;
  const float zr = (z - p.tilt_z0) * p.inv_tilt_dz;
  const float kzf = fminf(fmaxf(floorf(zr), 0.0f), (float)(nz - 2));
  const int kz = (int)kzf;
  const float fz_above = zr - kzf;
  const float fz_below = 1.0f - fz_above;
  const float nr = p.tilt_ca * x + p.tilt_sa * y;
  int j = 1;
  for (int jj = 1; jj < nd - 1; ++jj)
    if (nr >= p.tilt_d[jj]) j = jj + 1;
  const float d_lo = p.tilt_d[j - 1], d_hi = p.tilt_d[j];
  const float q_ll = zc[(j - 1) * nz + kz], q_lh = zc[(j - 1) * nz + kz + 1];
  const float q_hl = zc[j * nz + kz], q_hh = zc[j * nz + kz + 1];
  const float frac_lo = (d_hi - nr) / (d_hi - d_lo);
  const float frac_hi = 1.0f - frac_lo;
  const float val_lo = q_lh * fz_above + q_ll * fz_below;
  const float val_hi = q_hh * fz_above + q_hl * fz_below;
  return val_hi * frac_hi + val_lo * frac_lo;
}

// Record state of a slot's photon (kernel.py REC_STATE_FIELDS), kept in
// registers for the launch.
struct RecRegs {
  float wlen, abs0, nscat, dabs, sx, sy, sz, st, sdx, sdy, sdz, pend;
};

// Append the record of a dead photon (its x/y/z hold the record position,
// t the record time) at the next free buffer slot; false when the buffer of
// `cap` records is full (the counter still counts the attempt).
__device__ __forceinline__ bool push_record(
    float* __restrict__ buf, unsigned long long* __restrict__ cnt, int cap,
    const RecRegs& r, float x, float y, float z, float t, float dx, float dy,
    float dz, float ident, float inv_gv, float idx, float w, int slot) {
  const unsigned long long at = atomicAdd(cnt, 1ull);
  if (at >= (unsigned long long)cap) return false;
  const float v[NRC] = {x, y, z, t, dx, dy, dz, r.wlen, ident, r.sx, r.sy,
                        r.sz, r.st, r.sdx, r.sdy, r.sdz, inv_gv, r.nscat,
                        r.dabs, idx, w, (float)slot};
  float* __restrict__ d = buf + at * NRC;
#pragma unroll
  for (int k = 0; k < NRC; ++k) d[k] = v[k];
  return true;
}

// ---------------------------------------------------------------------------
// the spawn stage: the block's threads share one spawn list and one slab
// ---------------------------------------------------------------------------

// rows of the slab through which a spawner hands a new photon to its slot's
// thread (the spawned part of the state, then the wavelength for records)
enum { P_X, P_Y, P_Z, P_T, P_DX, P_DY, P_DZ, P_W0, P_IGV, P_ABS, P_GS, P_PA,
       P_QA, P_RA, P_WL, NPR };
// step rows a spawner reads (S_X .. S_SRC; S_ID stays with the slot)
constexpr int NSTEP = S_SRC + 1;

// Rows 0-3 of the random numbers of slot `s` in iteration `it`, the draws of
// its spawn, whichever thread computes them: the external stream's
// [it, r, s], threefry's element r * N + s under the iteration's key, or
// Philox block 0 of counter (it0 + it, s).
template <bool THREEFRY>
__device__ __forceinline__ void spawn_draws(
    const Params& p, const float* __restrict__ uni,
    const unsigned int* __restrict__ tf_keys, int it, int s, float* u) {
  const int N = p.n_slots;
  if constexpr (THREEFRY) {
    const unsigned int k0 = tf_keys[2 * it], k1 = tf_keys[2 * it + 1];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      u[r] = tf_u01(threefry_bits(
          k0, k1, (unsigned int)r * (unsigned int)N + (unsigned int)s));
  } else if (p.use_uniforms) {
    const float* ui = uni + (size_t)it * 8 * N + s;
#pragma unroll
    for (int r = 0; r < 4; ++r) u[r] = ui[(size_t)r * N];
  } else {
    const uint4 b = philox4x32_10(
        make_uint4(p.it0 + (unsigned int)it, (unsigned int)s, 0u, 0u),
        make_uint2(p.seed_lo, p.seed_hi));
    u[0] = u01(b.x); u[1] = u01(b.y); u[2] = u01(b.z); u[3] = u01(b.w);
  }
}

// A new photon: the spawned part of a slot's state, and its wavelength
// (kept by the record mode).
struct Spawned {
  float x, y, z, t, dx, dy, dz, w0, igv, abs, gs, pa, qa, ra, wl;
};

// The new photon of a step (createPhotonFromTrack, kernel.cl:132-184) from
// the step row `st` and the spawn draws u0-u3: emission point and time, the
// wavelength from the step's own spectrum table (binary search and solve),
// the medium's factors, the Cherenkov cone (a flasher keeps its direction),
// the absorption budget, the group velocity and the bias.
template <int DEP, bool FIXED, int MED>
__device__ __forceinline__ Spawned make_photon(
    const Params& p, const float* st, const float* u,
    const float* __restrict__ spec_tab, const float* __restrict__ bias_tab,
    const float* __restrict__ wtab) {
  Spawned q;
  const float s_dx = st[S_DX], s_dy = st[S_DY], s_dz = st[S_DZ];
  const float s_beta = st[S_BETA];
  const int src = (int)st[S_SRC];
  const float shift = st[S_LEN] * u[0];
  q.x = st[S_X] + s_dx * shift;
  q.y = st[S_Y] + s_dy * shift;
  q.z = st[S_Z] + s_dz * shift;
  q.t = st[S_T] + shift / (C_LIGHT * s_beta);
  // wavelength: k = clip(#{acu <= u} - 1, 0, n-2), then the solve
  const int ns = p.n_spec;
  const float* __restrict__ sp_x = spec_tab + (size_t)src * 3 * ns;
  const float* __restrict__ sp_acu = sp_x + ns;
  const float* __restrict__ sp_beta = sp_x + 2 * ns;
  const int k = locate_cdf(sp_acu, ns, u[1]);
  const float wl = interp_solve(u[1], sp_x[k], sp_x[k + 1], sp_beta[k],
                                sp_beta[k + 1], sp_acu[k]);
  float n_phase, n_group, gs, pa, qa, ra;
  if constexpr (closed_form<MED>()) {
    const float wl_um = wl * 1e-3f;
    n_phase = poly4(p.n, wl_um);
    n_group = n_phase * poly4(p.g, wl_um);
    gs = powf(wl / 400.0f, -p.alpha);
    const float xkap = powf(wl, -p.kappa);
    const float ebx = p.abs_a * expf(-p.abs_b / wl);
    pa = p.abs_d * xkap;
    qa = p.abs_e * xkap + ebx;
    ra = 0.01f * ebx;
  } else {
    // tabulated medium: lerp the rows gs, pa, qa, ra (and n, g) on the
    // uniform grid (MediumProperties._water_table)
    const int nw = p.n_wtab;
    const float wxi = (wl - p.wtab_x0) * p.wtab_inv_dx;
    const float wk = fminf(fmaxf(floorf(wxi), 0.0f), (float)(nw - 2));
    const float wfr = fminf(fmaxf(wxi - wk, 0.0f), 1.0f);
    const float* __restrict__ w = wtab + (int)wk;
    auto lerp = [&](int r) {
      const float a = w[r * nw], b = w[r * nw + 1];
      return a + wfr * (b - a);
    };
    gs = lerp(0);
    pa = lerp(1);
    qa = lerp(2);
    ra = lerp(3);
    if (p.ref_table) {
      n_phase = lerp(4);
      n_group = lerp(5);
    } else {
      const float wl_um = wl * 1e-3f;
      n_phase = poly4(p.n, wl_um);
      n_group = n_phase * poly4(p.g, wl_um);
    }
  }
  float dx = s_dx, dy = s_dy, dz = s_dz;
  if (src == 0) {  // the Cherenkov cone (a flasher keeps its direction)
    const float cos_c = fminf(1.0f, 1.0f / (s_beta * n_phase));
    const float sin_c = sqrtf(fmaxf(1.0f - cos_c * cos_c, 0.0f));
    scatter_dir(cos_c, sin_c, s_dx, s_dy, s_dz, u[2], &dx, &dy, &dz);
  }
  q.dx = dx;
  q.dy = dy;
  q.dz = dz;
  if constexpr (DEP == DEP_EXPECTED || FIXED)
    q.abs = p.horizon;  // fixed absorption horizon
  else
    q.abs = -logf(1.0f - u[3]);
  q.igv = 1.0f / (C_LIGHT / n_group);
  // bias: linear interpolation, clamped at the grid's ends; the (2, n_bias)
  // table holds the grid points, then the values
  const int nb = p.n_bias;
  const float* __restrict__ bias_y = bias_tab + nb;
  int bk;
  float bfrac;
  if (p.bias_uniform) {  // index math on a uniform grid
    const float bxi = (wl - p.bias_x0) * p.bias_inv_dx;
    const float bkf = fminf(fmaxf(floorf(bxi), 0.0f), (float)(nb - 2));
    bk = (int)bkf;
    bfrac = fminf(fmaxf(bxi - bkf, 0.0f), 1.0f);
  } else {  // binary search over the grid points
    const float wlc = fminf(fmaxf(wl, bias_tab[0]), bias_tab[nb - 1]);
    bk = locate_cdf(bias_tab, nb, wlc);
    const float x0 = bias_tab[bk], x1 = bias_tab[bk + 1];
    bfrac = fminf(fmaxf((wlc - x0) / fmaxf(x1 - x0, 1e-30f), 0.0f), 1.0f);
  }
  const float f0 = bias_y[bk], f1 = bias_y[bk + 1];
  q.w0 = st[S_W] / fmaxf(f0 + bfrac * (f1 - f0), 1e-20f);
  q.gs = gs;
  q.pa = pa;
  q.qa = qa;
  q.ra = ra;
  q.wl = wl;
  return q;
}

// The loop policy of an instantiation.  Where photons live to a fixed
// horizon (the expected estimator, which passes through DOMs, and the fixed
// absorption budget of FIXED) a block-iteration spawns 0.6-12 photons, so
// the block-cooperative spawn has little to compact while its barriers take
// 16-43% of each warp's cycles: there each warp iterates on its own, 6-25%
// faster than the block loop on the same body in turns (one tie).  The
// detect modes (DEP_PASS included: 52-59 spawns a block-iteration, a tie in
// turns) and the record modes keep the block's step and its compacted
// spawn (PERF.md, the fixed-horizon redesign).
template <bool RECORDS, int DEP, bool FIXED>
__host__ __device__ constexpr bool warp_loop() {
  return !RECORDS && (DEP == DEP_EXPECTED || FIXED);
}

// Three resident blocks a SM, so at most 80 registers a thread.  Every
// instantiation timed at 3 and at 1 (124 registers, 2 blocks) in turns ran
// faster at 3, the record modes too, which spill 44-120 bytes (PERF.md).
template <bool RECORDS, int DEP, bool THREEFRY, bool FIXED, int COLL, int MED>
__global__ void __launch_bounds__(BLOCK, 3)
propagate_kernel(const Params p, float* __restrict__ state,
                 const float* __restrict__ steps,
                 const float* __restrict__ uni,
                 const unsigned int* __restrict__ tf_keys,
                 const float* __restrict__ layers,
                 const float* __restrict__ spec_tab,
                 const float* __restrict__ bias_tab,
                 const float* __restrict__ tilt_zc,
                 const float4* __restrict__ cells, float* __restrict__ hist,
                 unsigned long long* __restrict__ cnt_i,
                 double* __restrict__ cnt_w,
                 const float4* __restrict__ doms, float* __restrict__ rec_buf,
                 unsigned long long* __restrict__ rec_cnt,
                 const float4* __restrict__ rel,
                 const float4* __restrict__ strings,
                 const float* __restrict__ wtab,
                 const float* __restrict__ scat,
                 const float* __restrict__ ang_tab) {
  __shared__ float s_slab[RECORDS ? NPR : P_WL][BLOCK];
  __shared__ float s_step[NSTEP][BLOCK];
  __shared__ unsigned short s_list[BLOCK];
  __shared__ int s_wcnt[2][BLOCK / 32];

  const int N = p.n_slots;
  const int tid = threadIdx.x;
  const int slot = blockIdx.x * BLOCK + tid;
  const bool valid = slot < p.n_active;
  const int lane = tid & 31, warp = tid >> 5;
  // a thread's counts (32 bits: one launch's fit; the block sums in 64)
  unsigned int n_gen = 0, n_hits = 0, n_work = 0, n_alive = 0;
  // the work the bound counts beyond the main path's (kernel.py CNT_*): the
  // global plans' candidates culled, cull passes, strings given the sphere
  // test and DOM rows tested (COLL 1, 2); the tabulated angle's scatters
  // and those that drew Rayleigh (MED 2, 3); in every instantiation the
  // layer-walk steps, and (lane 0 of each warp) warp-iterations with a live
  // lane and those that ran the spawn stage
  unsigned int n_cand = 0, n_cull = 0, n_tested = 0, n_rows = 0;
  unsigned int n_scat = 0, n_ray = 0;
  unsigned int n_walk = 0, n_warps = 0, n_swarps = 0;
  double w_sum = 0.0;
  // clock cycles of each warp (lane 0's count is reduced) in the block's
  // barriers, in the propagate stage and in the spawn stage: each lap adds
  // the cycles since the last mark to one account (32-bit clock deltas,
  // wrap-safe; a launch's account fits 32 bits)
  unsigned int c_wait = 0, c_prop = 0, c_spawn = 0;
  unsigned int t_mark = 0;
  // of the propagate stage, the global plans' (COLL 1, 2) collision test
  // and its cull (the cell lookup and the candidate loop)
  unsigned int c_coll = 0, c_cull = 0;
  auto lap = [&](unsigned int& acc) {
    const unsigned int now = (unsigned int)clock();
    acc += now - t_mark;
    t_mark = now;
  };

  // the slot's state (benign values past the last slot: such a thread only
  // takes part in the block's barriers)
  float left = 0.0f, inflight = 0.0f, x = 0.0f, y = 0.0f, z = 0.0f;
  float t = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f, w0 = 0.0f;
  float inv_gv = 5.0f, abs_left = 0.0f, gs = 1.0f, pa = 0.0f, qa = 1.0f;
  float ra = 0.0f;
  if (valid) {
    left = state[F_LEFT * N + slot]; inflight = state[F_INF * N + slot];
    x = state[F_X * N + slot]; y = state[F_Y * N + slot];
    z = state[F_Z * N + slot]; t = state[F_T * N + slot];
    dx = state[F_DX * N + slot]; dy = state[F_DY * N + slot];
    dz = state[F_DZ * N + slot]; w0 = state[F_W0 * N + slot];
    inv_gv = state[F_IGV * N + slot];
    abs_left = state[F_ABS * N + slot];
    gs = state[F_GS * N + slot]; pa = state[F_PA * N + slot];
    qa = state[F_QA * N + slot]; ra = state[F_RA * N + slot];
  }
  // the block's step rows, for its spawners
#pragma unroll
  for (int f = 0; f < NSTEP; ++f)
    s_step[f][tid] = valid ? steps[f * N + slot] : 0.0f;

  const int L = p.L;
  const float* __restrict__ lay_b = layers;
  const float* __restrict__ lay_a = layers + L;
  const float* __restrict__ lay_t = layers + 2 * L;

  // record state (RECORDS only; dead code otherwise).  A slot whose record
  // finds the buffer full stalls: it stays in the loop, inactive, and the
  // next launch writes its record first.
  RecRegs rr = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  float* __restrict__ rs = state + (size_t)NSF * N + slot;
  float ident = 0.0f;
  bool stalled = false;
  if constexpr (RECORDS) {
    if (valid) {
      rr = {rs[R_WLEN * N], rs[R_ABS0 * N], rs[R_NSCAT * N], rs[R_DABS * N],
            rs[R_SX * N],   rs[R_SY * N],   rs[R_SZ * N],    rs[R_ST * N],
            rs[R_SDX * N],  rs[R_SDY * N],  rs[R_SDZ * N],   rs[R_PEND * N]};
      ident = steps[S_ID * N + slot];
      if (rr.pend >= 0.0f) {  // the last launch's buffer was full: write first
        if (push_record(rec_buf, rec_cnt, p.rec_cap, rr, x, y, z, t, dx, dy,
                        dz, ident, inv_gv, rr.pend, p.rec_all ? 0.0f : w0,
                        slot))
          rr.pend = -1.0f;
        else
          stalled = true;
      }
    }
  }

  // a spawned photon becomes the slot's
  auto adopt = [&](const Spawned& q) {
    x = q.x; y = q.y; z = q.z; t = q.t;
    dx = q.dx; dy = q.dy; dz = q.dz;
    w0 = q.w0; inv_gv = q.igv; abs_left = q.abs;
    gs = q.gs; pa = q.pa; qa = q.qa; ra = q.ra;
    inflight = 1.0f;
    left -= 1.0f;
    ++n_gen;
    if constexpr (RECORDS) {  // spawn-time record state
      rr.wlen = q.wl; rr.abs0 = abs_left; rr.nscat = 0.0f;
      rr.sx = x; rr.sy = y; rr.sz = z; rr.st = t;
      rr.sdx = dx; rr.sdy = dy; rr.sdz = dz;
    }
  };

  t_mark = (unsigned int)clock();
  for (int it = 0; it < p.iters; ++it) {
    const bool live = valid && !stalled && (inflight > 0.5f || left > 0.5f);
    const bool fresh = live && inflight < 0.5f;
    const unsigned int fb = __ballot_sync(0xffffffffu, fresh);
    const unsigned int lb = __ballot_sync(0xffffffffu, live);
    if constexpr (warp_loop<RECORDS, DEP, FIXED>()) {
      // ---------- the warp's own iteration: no block barrier ----------
      lap(c_prop);  // the last iteration's propagate stage
      if (lb == 0u) break;  // the warp leaves when no lane of it is live
      if (lane == 0) {
        ++n_warps;
        n_swarps += fb != 0u;
      }
      if (fb != 0u) {
        // a fresh lane makes its own photon, from its own step row and its
        // slot's random numbers
        if (fresh) {
          float u[4], st[NSTEP];
          spawn_draws<THREEFRY>(p, uni, tf_keys, it, slot, u);
#pragma unroll
          for (int f = 0; f < NSTEP; ++f) st[f] = s_step[f][tid];
          adopt(make_photon<DEP, FIXED, MED>(p, st, u, spec_tab, bias_tab,
                                             wtab));
        }
        lap(c_spawn);
      }
    } else {
      if (lane == 0) s_wcnt[it & 1][warp] = __popc(fb);
      lap(c_prop);  // the last iteration's propagate stage
      // every thread stays in the loop until no slot of its block is live
      const int any_live = __syncthreads_or(live);
      lap(c_wait);
      if (!any_live) break;

      // ---------- spawn stage: the block's fresh slots, compacted --------
      int base = 0, n_spawn = 0;
#pragma unroll
      for (int w = 0; w < BLOCK / 32; ++w) {
        const int c = s_wcnt[it & 1][w];
        base += w < warp ? c : 0;
        n_spawn += c;
      }
      if (lane == 0) {
        n_warps += lb != 0u;
        n_swarps += warp * 32 < n_spawn;
      }
      if (n_spawn > 0) {
        if (fresh)
          s_list[base + __popc(fb & ((1u << lane) - 1u))] =
              (unsigned short)tid;
        lap(c_spawn);
        __syncthreads();
        lap(c_wait);
        // the first n_spawn threads of the block each make the photon of
        // one listed slot, with that slot's random numbers and step row
        if (tid < n_spawn) {
          const int j = s_list[tid];
          const int s = blockIdx.x * BLOCK + j;
          float u[4], st[NSTEP];
          spawn_draws<THREEFRY>(p, uni, tf_keys, it, s, u);
#pragma unroll
          for (int f = 0; f < NSTEP; ++f) st[f] = s_step[f][j];
          const Spawned q = make_photon<DEP, FIXED, MED>(
              p, st, u, spec_tab, bias_tab, wtab);
          const float v[NPR] = {q.x,  q.y,  q.z,   q.t,   q.dx,
                                q.dy, q.dz, q.w0,  q.igv, q.abs,
                                q.gs, q.pa, q.qa,  q.ra,  q.wl};
#pragma unroll
          for (int f = 0; f < (RECORDS ? NPR : P_WL); ++f)
            s_slab[f][j] = v[f];
        }
        lap(c_spawn);
        __syncthreads();
        lap(c_wait);
        if (fresh) {
          Spawned q;
          q.x = s_slab[P_X][tid]; q.y = s_slab[P_Y][tid];
          q.z = s_slab[P_Z][tid]; q.t = s_slab[P_T][tid];
          q.dx = s_slab[P_DX][tid]; q.dy = s_slab[P_DY][tid];
          q.dz = s_slab[P_DZ][tid]; q.w0 = s_slab[P_W0][tid];
          q.igv = s_slab[P_IGV][tid]; q.abs = s_slab[P_ABS][tid];
          q.gs = s_slab[P_GS][tid]; q.pa = s_slab[P_PA][tid];
          q.qa = s_slab[P_QA][tid]; q.ra = s_slab[P_RA][tid];
          if constexpr (RECORDS)
            q.wl = s_slab[P_WL][tid];
          else
            q.wl = 0.0f;
          adopt(q);
        }
        lap(c_spawn);
      }
    }
    if (!live) continue;

    // ---------- propagate stage: the slot's own photon ----------
    float u[8];  // rows 4-7: the segment's draws
    if constexpr (THREEFRY) {
      const unsigned int k0 = tf_keys[2 * it], k1 = tf_keys[2 * it + 1];
#pragma unroll
      for (int r = 4; r < 8; ++r)
        u[r] = tf_u01(threefry_bits(
            k0, k1, (unsigned int)r * (unsigned int)N + (unsigned int)slot));
    } else if (p.use_uniforms) {
      const float* ui = uni + (size_t)it * 8 * N + slot;
#pragma unroll
      for (int r = 4; r < 8; ++r) u[r] = ui[(size_t)r * N];
    } else {
      const uint4 b1 = philox4x32_10(
          make_uint4(p.it0 + (unsigned int)it, (unsigned int)slot, 1u, 0u),
          make_uint2(p.seed_lo, p.seed_hi));
      u[4] = u01(b1.x); u[5] = u01(b1.y); u[6] = u01(b1.z); u[7] = u01(b1.w);
    }
    ++n_work;

    // ---------- budgets + anisotropy (kernel.cl:615-694) ----------
    float abs_corr = 1.0f;
    if (p.aniso) {
      const float l1 = p.an_k1 * p.an_k1, l2 = p.an_k2 * p.an_k2;
      const float l3 = p.an_kz * p.an_kz;
      const float n1 = p.an_ca * dx + p.an_sa * dy;
      const float n2 = -p.an_sa * dx + p.an_ca * dy;
      const float s1 = n1 * n1, s2 = n2 * n2, s3 = dz * dz;
      const float nB = s1 * p.an_il1 + s2 * p.an_il2 + s3 * p.an_il3;
      const float An = s1 * l1 + s2 * l2 + s3 * l3;
      abs_corr = 2.0f / ((p.an_b2 - nB) * An);
    }
    const float sca_budget = -logf(1.0f - u[4]);

    // ---------- tilt + layer walk (kernel.cl:598-696) ----------
    // The walk crosses layer boundaries until a budget runs out before the
    // next one: (tb - t_done) * rate >= budget, both rates positive, tests
    // the exit without a division; the distances are divided once, at the
    // step that ends the walk.
    const float z_eff = p.nz_tilt ? z - tilt_shift(p, tilt_zc, x, y, z) : z;
    const float j0f = fminf(
        fmaxf(floorf((z_eff - p.z_start) * p.inv_layer_h), 0.0f),
        (float)(L - 1));
    const int j0 = (int)j0f;
    const bool up = dz >= 0.0f;
    const int dirsign = up ? 1 : -1;
    const bool vertical = fabsf(dz) < EPS;
    const float bz = p.z_start + j0f * p.layer_h + (up ? p.layer_h : 0.0f);
    float tb = BIG, tstep = BIG;
    if (!vertical) {
      const float rdz = 1.0f / dz;
      tb = (bz - z_eff) * rdz;
      tstep = p.layer_h * fabsf(rdz);
    }
    if (tb < 0.0f) tb = BIG;
    float t_done = 0.0f, tau_s = sca_budget, tau_a = abs_left * abs_corr;
    float inv_s, inv_a;
    int k = 0, j = j0;
    float cb = lay_b[j], ca = lay_a[j], ct = lay_t[j];
    for (;; ++k) {
      // the next layer's entries are read before this step's exit test,
      // so that a crossing does not wait for them
      const int jn = min(max(j + dirsign, 0), L - 1);
      const float nb = lay_b[jn], na = lay_a[jn], nt = lay_t[jn];
      inv_s = gs * cb;
      inv_a = pa * ca + qa + ra * ct;
      const float seg = tb - t_done;
      const bool at_edge = up ? (j >= L - 1) : (j <= 0);
      if (at_edge || seg * inv_s >= tau_s || seg * inv_a >= tau_a ||
          tb >= p.max_seg || k >= p.K)
        break;
      tau_s -= seg * inv_s;
      tau_a -= seg * inv_a;
      t_done = tb;
      tb += tstep;
      j = jn; cb = nb; ca = na; ct = nt;
    }
    n_walk += k + 1;
    const float d_scat = t_done + tau_s / inv_s;
    const float d_abs = t_done + tau_a / inv_a;
    bool absorbed = d_abs < d_scat;
    float d_prop = fminf(fminf(d_scat, d_abs), p.max_seg);
    const bool capped = (!absorbed && d_scat > p.max_seg) ||
                        (absorbed && d_abs > p.max_seg);
    absorbed = absorbed && !capped;
    bool scattered = !absorbed && !capped;
    float abs_left_corr =
        absorbed ? 0.0f : fmaxf(tau_a - (d_prop - t_done) * inv_a, 0.0f);

    // ---------- SubPlan collision (sparse_collision_kernel.cl) ----------
    float best = d_prop;
    int best_dom = 0;
    const float dxy2 = dx * dx + dy * dy;
    if constexpr (COLL != COLL_SUBPLANS) {
      // ---------- global cell plan (kernel.py:947-1003, :1270-1456) ----
      const unsigned int t_c0 = (unsigned int)clock();
      if (dxy2 > 0.0f) {
        const float inv_dxy2 = 1.0f / fmaxf(dxy2, 1e-20f);
        const float cxi = fminf(fmaxf(floorf((x - p.c_x0) * p.c_inv_cell),
                                      0.0f), (float)(p.c_nx - 1));
        const float cyi = fminf(fmaxf(floorf((y - p.c_y0) * p.c_inv_cell),
                                      0.0f), (float)(p.c_ny - 1));
        // the azimuth sector by comparisons alone (kernel.py cull_sector):
        // the quadrant by the signs, within it the thresholds |dy| exceeds
        // times |dx| (unused ones are BIG, and j stops at c_m - 1)
        const float ax = fabsf(dx), ay = fabsf(dy);
        int sub = 0;
#pragma unroll
        for (int q = 0; q < CULL_TAN; ++q) sub += ay > p.c_tan[q] * ax;
        const int sec = ((dx < 0.0f) + 2 * (dy < 0.0f)) * p.c_qmul +
                        min(sub, p.c_m - 1);
        // the (cell, sector)'s list: its (offset, count) pair, then its
        // cull entries (sx, sy, maxr^2, string index) consecutive; per
        // string, (minz, maxz, z0, dz) at row sidx and (n doms, dom offset,
        // 1 / dz, window half-width) at row c_lad + sidx (kernel.py
        // card_cull_table)
        const int2 hd = reinterpret_cast<const int2*>(cells + p.c_hdr)[
            ((int)cxi * p.c_ny + (int)cyi) * p.c_sectors + sec];
        const float4* __restrict__ cull = cells + p.c_ent + hd.x;
        const float4* __restrict__ zext = cells;
        const float4* __restrict__ lad = cells + p.c_lad;
        const int n_c = hd.y;
        n_cand += n_c;
        // the cull ranks by the static segment cap; keep the n_rounds
        // closest culled strings sorted (ties keep the earlier candidate,
        // the lower string index, as in the JAX package's lists)
        float rd2[MAX_ROUNDS], rA2[MAX_ROUNDS], rBd[MAX_ROUNDS];
        int rci[MAX_ROUNDS];
#pragma unroll
        for (int r = 0; r < MAX_ROUNDS; ++r) {
          rd2[r] = BIG; rA2[r] = 0.0f; rBd[r] = 0.0f; rci[r] = 0;
        }
        // four consecutive entries a load group, issued together so that
        // their latencies overlap; past the list's end an entry with
        // maxr^2 = -1 (not loaded) passes no cull
        for (int c0 = 0; c0 < n_c; c0 += 4) {
          float4 e4[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            e4[q] = c0 + q < n_c ? cull[c0 + q]
                                 : make_float4(0.0f, 0.0f, -1.0f, 0.0f);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 e = e4[q];
            const float rx = e.x - x, ry = e.y - y;
            const float bd2 = rx * dx + ry * dy;
            const float t2d = fminf(fmaxf(bd2 * inv_dxy2, 0.0f), p.max_seg);
            const float cx = rx - dx * t2d, cy = ry - dy * t2d;
            float d2 = cx * cx + cy * cy;
            if (!(d2 <= e.z)) continue;
            ++n_cull;
            const int sidx = (int)e.w;
            const float4 ez = zext[sidx];  // the string's z extent
            if ((dz > 0.0f && z > ez.y + p.r) ||
                (dz < 0.0f && z < ez.x - p.r))
              continue;
            float a2 = rx * rx + ry * ry, bd = bd2;
            int ci = sidx;
#pragma unroll
            for (int r = 0; r < MAX_ROUNDS; ++r) {
              if (d2 < rd2[r]) {
                const float t0 = rd2[r], t1 = rA2[r], t2 = rBd[r];
                const int t3 = rci[r];
                rd2[r] = d2; rA2[r] = a2; rBd[r] = bd; rci[r] = ci;
                d2 = t0; a2 = t1; bd = t2; ci = t3;
              }
            }
          }
        }
        c_cull += (unsigned int)clock() - t_c0;
        const float margin = p.r + 1.0f;
#pragma unroll
        for (int r = 0; r < MAX_ROUNDS; ++r) {
          if (r >= p.n_rounds || !(rd2[r] < BIG)) break;
          ++n_tested;
          const float4 e2 = lad[rci[r]];  // nd, dom offset, 1/dz, half
          const int off = (int)e2.y;
          if constexpr (COLL == COLL_AFFINE) {
            // the n_dom_cand ladder DOMs of the z-window from the ceil
            // anchor, each string's (z0, dz, n, 1 / dz) from its entries
            const float4 e1 = zext[rci[r]];
            const float nd = e2.x, inv_dzf = e2.z;
            const float z0 = e1.z, dzf = e1.w;
            const float m1 = (z - z0) * inv_dzf;
            const float m2 = m1 + dz * d_prop * inv_dzf;
            const float mlo = ceilf(fminf(m1, m2) - margin * fabsf(inv_dzf));
            n_rows += p.n_dom_cand;
            for (int c = 0; c < p.n_dom_cand; ++c) {
              const float m = fminf(fmaxf(mlo + (float)c, 0.0f), nd - 1.0f);
              const float oz = z0 + dzf * m - z;
              const float urdot = rBd[r] + oz * dz;
              const float dr2 = rA2[r] + oz * oz;
              const float discr = urdot * urdot - dr2 + p.r2;
              if (discr >= 0.0f) {
                const float smin1 = urdot - sqrtf(discr) * p.inv_pancake;
                if (smin1 >= 0.0f && smin1 < best) {
                  best = smin1;
                  best_dom = off + (int)m;
                }
              }
            }
          } else {
            // the DOM rows of the segment's z-window: the string's fitted
            // ladder plus the residuals of the surveyed positions (its nd
            // valid rows come first, geometry.build_geometry); the rows
            // mlo..mhi of the segment's z-range on the ladder, widened by
            // e2.w = (r + 1 + rz) / |dz| rows (kernel.py general_window:
            // every row the full test would accept is inside; BIG keeps
            // every row)
            const int sidx = rci[r];
            const float4 sf = strings[sidx];  // x, y, z0, dz
            const float4* __restrict__ rows = rel + (size_t)sidx * p.m_rel;
            const float m1 = (z - sf.z) * e2.z;
            const float m2 = m1 + dz * d_prop * e2.z;
            const int mlo = (int)fmaxf(ceilf(fminf(m1, m2) - e2.w), 0.0f);
            const int mhi =
                (int)fminf(floorf(fmaxf(m1, m2) + e2.w), e2.x - 1.0f);
            n_rows += (unsigned int)max(mhi - mlo + 1, 0);
            for (int m = mlo; m <= mhi; ++m) {
              const float4 q = rows[m];  // dx, dy, dz, valid
              if (!(q.w > 0.5f)) continue;
              const float ox = sf.x + q.x - x;
              const float oy = sf.y + q.y - y;
              const float oz = sf.z + sf.w * (float)m + q.z - z;
              const float dr2 = ox * ox + oy * oy + oz * oz;
              const float urdot = ox * dx + oy * dy + oz * dz;
              const float discr = urdot * urdot - dr2 + p.r2;
              if (discr >= 0.0f) {
                const float smin1 = urdot - sqrtf(discr) * p.inv_pancake;
                if (smin1 >= 0.0f && smin1 < best) {
                  best = smin1;
                  best_dom = off + m;
                }
              }
            }
          }
        }
      }
      c_coll += (unsigned int)clock() - t_c0;
    } else if (dxy2 > 0.0f) {  // exactly vertical photons are invisible
      const float inv_dxy2 = 1.0f / fmaxf(dxy2, 1e-20f);
      const float margin = p.r + 1.0f;
      for (int pi = 0; pi < p.n_plans; ++pi) {
        const PlanParams& pp = p.plans[pi];
        if ((dz > 0.0f && z > pp.maxz + p.r) ||
            (dz < 0.0f && z < pp.minz - p.r))
          continue;
        const float cxi = fminf(fmaxf(floorf((x - pp.x0) * pp.inv_cell),
                                      0.0f), (float)(pp.nx - 1));
        const float cyi = fminf(fmaxf(floorf((y - pp.y0) * pp.inv_cell),
                                      0.0f), (float)(pp.ny - 1));
        const float4* __restrict__ cand =
            cells + pp.cell_off + ((int)cxi * pp.ny + (int)cyi) * pp.k_cand;
        // keep the `rounds` closest culled strings, sorted by 2-D distance
        // (ties keep the earlier candidate)
        float rd2[MAX_ROUNDS], rA2[MAX_ROUNDS], rBd[MAX_ROUNDS];
        int roff[MAX_ROUNDS];
#pragma unroll
        for (int r = 0; r < MAX_ROUNDS; ++r) {
          rd2[r] = BIG; rA2[r] = 0.0f; rBd[r] = 0.0f; roff[r] = 0;
        }
#pragma unroll 4
        for (int c = 0; c < pp.k_cand; ++c) {
          const float4 e = cand[c];  // sx, sy, maxr^2, dom offset
          const float rx = e.x - x, ry = e.y - y;
          const float bd2 = rx * dx + ry * dy;
          const float t2d = fminf(fmaxf(bd2 * inv_dxy2, 0.0f), p.max_seg);
          const float cx = rx - dx * t2d, cy = ry - dy * t2d;
          float d2 = cx * cx + cy * cy;
          if (!(d2 <= e.z)) continue;
          float a2 = rx * rx + ry * ry, bd = bd2;
          int off = (int)e.w;
#pragma unroll
          for (int r = 0; r < MAX_ROUNDS; ++r) {
            if (d2 < rd2[r]) {
              const float t0 = rd2[r], t1 = rA2[r], t2 = rBd[r];
              const int t3 = roff[r];
              rd2[r] = d2; rA2[r] = a2; rBd[r] = bd; roff[r] = off;
              d2 = t0; a2 = t1; bd = t2; off = t3;
            }
          }
        }
        // ray-sphere test against the z-window DOMs of each picked string
        const float m1 = (z - pp.uz_z0) * pp.inv_dz;
        const float m2 = m1 + dz * (d_prop * pp.inv_dz);
        const float mlo = ceilf(fminf(m1, m2) - margin * fabsf(pp.inv_dz));
#pragma unroll
        for (int r = 0; r < MAX_ROUNDS; ++r) {
          if (r >= pp.rounds || !(rd2[r] < BIG)) break;
          for (int c = 0; c < pp.n_dom_cand; ++c) {
            const float m = fminf(fmaxf(mlo + (float)c, 0.0f), pp.uz_nd - 1.0f);
            const float oz = pp.uz_z0 + pp.uz_dz * m - z;
            const float urdot = rBd[r] + oz * dz;
            const float dr2 = rA2[r] + oz * oz;
            const float discr = urdot * urdot - dr2 + p.r2;
            if (discr >= 0.0f) {
              const float smin1 = urdot - sqrtf(discr) * p.inv_pancake;
              if (smin1 >= 0.0f && smin1 < best) {
                best = smin1;
                best_dom = roff[r] + (int)m;
              }
            }
          }
        }
      }
    }
    const bool hit = best < d_prop;

    if constexpr (DEP == DEP_STOP) {
      // ---------- hit: deposit and stop (kernel.cl:307-404) ----------
      if (hit) {
        d_prop = best;
        absorbed = false;
        scattered = false;
        abs_left_corr = 0.0f;
        const float t_hit = t + inv_gv * best;
        const float tbf = fminf(fmaxf((t_hit - p.hist_t0) / p.hist_dt,
                                      0.0f), (float)(p.nbins - 1));
        atomicAdd(hist + (size_t)best_dom * p.nbins + (int)tbf, w0);
        ++n_hits;
        w_sum += (double)w0;
      }
    } else if constexpr (DEP == DEP_PASS) {
      // ---------- non-stopping detect: deposit, keep flying ----------
      if (hit) {
        const float t_hit = t + inv_gv * best;
        const float tbf = fminf(fmaxf((t_hit - p.hist_t0) / p.hist_dt,
                                      0.0f), (float)(p.nbins - 1));
        atomicAdd(hist + (size_t)best_dom * p.nbins + (int)tbf, w0);
        ++n_hits;
        w_sum += (double)w0;
      }
    } else {
      // ---------- expected: survival weight at the DOM entry, the photon
      // passes through (engine.py expected block) ----------
      if (hit) {
        const float tau_start = p.horizon - abs_left;
        const float tau_seg = abs_left - abs_left_corr / abs_corr;
        const float frac = d_prop > 0.0f ? best / d_prop : 0.0f;
        float w = w0 * expf(-(tau_start + frac * tau_seg));
        if (p.n_ang > 0) {
          const float ce = fminf(fmaxf(-(dx * p.pmt_ax + dy * p.pmt_ay +
                                         dz * p.pmt_az), -1.0f), 1.0f);
          float ang = 0.0f;
          for (int q = p.n_ang - 1; q >= 0; --q) ang = ang * ce + ang_tab[q];
          w *= fmaxf(ang, 0.0f);
        }
        const float t_hit = t + inv_gv * best;
        const float tbf = (t_hit - p.hist_t0) / p.hist_dt;
        float* __restrict__ h = hist + (size_t)best_dom * p.nbins;
        if (p.soft) {
          const float fl = floorf(tbf);
          const float fr_hi = fminf(fmaxf(tbf - fl, 0.0f), 1.0f);
          const float lo = fminf(fmaxf(fl, 0.0f), (float)(p.nbins - 1));
          const float hi = fminf(lo + 1.0f, (float)(p.nbins - 1));
          atomicAdd(h + (int)lo, w * (1.0f - fr_hi));
          atomicAdd(h + (int)hi, w * fr_hi);
        } else {
          atomicAdd(h + (int)fminf(fmaxf(tbf, 0.0f), (float)(p.nbins - 1)),
                    w);
        }
        ++n_hits;
        w_sum += (double)w;
      }
    }

    // ---------- record: at the hit, or (rec_all) at the absorption point,
    // prescaled on u7, dom 0 (engine._record_values) ----------
    bool rec_now = false;
    float rec_idx = 0.0f, rec_x = 0.0f, rec_y = 0.0f, rec_z = 0.0f;
    if constexpr (RECORDS) {
      int rdom = best_dom;
      if (p.rec_all) {
        rec_now = absorbed &&
                  (p.rec_prescale >= 1.0f || u[7] < p.rec_prescale);
        rdom = 0;
      } else {
        rec_now = hit;
      }
      if (rec_now) {
        // the time bin of t + inv_gv * d_prop (d_prop is the hit distance
        // for a hit)
        const float tbr = fminf(
            fmaxf((t + inv_gv * d_prop - p.hist_t0) / p.hist_dt, 0.0f),
            (float)(p.nbins - 1));
        rec_idx = (float)(rdom * p.nbins + (int)tbr);
        // position relative to the DOM centre moved toward the
        // closest-approach plane (the pancake un-correction)
        const float4 c = doms[rdom];
        const float pxr = x - c.x, pyr = y - c.y, pzr = z - c.z;
        const float par = pxr * dx + pyr * dy + pzr * dz;
        rec_x = x + d_prop * dx - (c.x + p.rec_fpk * (pxr - par * dx));
        rec_y = y + d_prop * dy - (c.y + p.rec_fpk * (pyr - par * dy));
        rec_z = z + d_prop * dz - (c.z + p.rec_fpk * (pzr - par * dz));
        rr.dabs = rr.abs0 - abs_left;
      }
    }

    // ---------- advance ----------
    x += dx * d_prop;
    y += dy * d_prop;
    z += dz * d_prop;
    t += inv_gv * d_prop;
    abs_left = abs_left_corr / abs_corr;

    // ---------- scatter survivors (HG / simplified-Liu mixture) ----------
    if (scattered) {
      float pdx = dx, pdy = dy, pdz = dz;
      if (p.aniso)
        aniso_transform(p, p.an_k1, p.an_k2, p.an_kz, &pdx, &pdy, &pdz);
      const float g = p.mean_cos;
      float cos_s;
      if constexpr (tabulated_angle<MED>()) {
        // Rayleigh mixed with the tabulated (Petzold) scattering angle, u5
        // the branch, u6 the sample, whatever the medium's wavelength
        // factors (kernel.py:1606-1629)
        ++n_scat;
        if (u[5] < p.liu_frac) {
          ++n_ray;
          cos_s = rayleigh_cos(u[6]);
        } else {
          const int ns2 = p.n_scat;
          const float* __restrict__ sx_ = scat;
          const float* __restrict__ sacu = scat + ns2;
          const float* __restrict__ sbeta = scat + 2 * ns2;
          const int kc = locate_cdf(sacu, ns2, u[6]);
          cos_s = cosf(interp_solve(u[6], sx_[kc], sx_[kc + 1], sbeta[kc],
                                    sbeta[kc + 1], sacu[kc]));
        }
      } else if (u[5] < p.liu_frac) {
        cos_s = fminf(fmaxf(2.0f * powf(u[6], p.liu_beta) - 1.0f, -1.0f),
                      1.0f);
      } else {
        const float svar = 2.0f * u[6] - 1.0f;
        if (fabsf(g) < 1e-6f) {
          cos_s = svar;
        } else {
          const float frac2 = (1.0f - g * g) / (1.0f + g * svar);
          cos_s = fminf(fmaxf((1.0f + g * g - frac2 * frac2) / (2.0f * g),
                              -1.0f), 1.0f);
        }
      }
      const float sin_s = sqrtf(fmaxf(1.0f - cos_s * cos_s, 0.0f));
      scatter_dir(cos_s, sin_s, pdx, pdy, pdz, u[7], &dx, &dy, &dz);
      if (p.aniso)
        aniso_transform(p, p.an_ik1, p.an_ik2, p.an_ikz, &dx, &dy, &dz);
      if constexpr (RECORDS) rr.nscat += 1.0f;
    }

    // ---------- retire ----------
    if (absorbed || abs_left < EPS || (DEP == DEP_STOP && hit))
      inflight = 0.0f;

    // ---------- append the record (the photon is dead: x/y/z keep the
    // record position, t the record time; a full buffer stalls) ----------
    if constexpr (RECORDS) {
      if (rec_now) {
        x = rec_x; y = rec_y; z = rec_z;
        if (!push_record(rec_buf, rec_cnt, p.rec_cap, rr, x, y, z, t, dx, dy,
                         dz, ident, inv_gv, rec_idx, p.rec_all ? 0.0f : w0,
                         slot)) {
          rr.pend = rec_idx;
          stalled = true;
        }
      }
    }
  }

  if (valid) {
    state[F_LEFT * N + slot] = left;
    state[F_INF * N + slot] = inflight;
    state[F_X * N + slot] = x;
    state[F_Y * N + slot] = y;
    state[F_Z * N + slot] = z;
    state[F_T * N + slot] = t;
    state[F_DX * N + slot] = dx;
    state[F_DY * N + slot] = dy;
    state[F_DZ * N + slot] = dz;
    state[F_W0 * N + slot] = w0;
    state[F_IGV * N + slot] = inv_gv;
    state[F_ABS * N + slot] = abs_left;
    state[F_GS * N + slot] = gs;
    state[F_PA * N + slot] = pa;
    state[F_QA * N + slot] = qa;
    state[F_RA * N + slot] = ra;
    n_alive = (inflight > 0.5f || left > 0.5f) ? 1 : 0;
    if constexpr (RECORDS) {
      rs[R_WLEN * N] = rr.wlen; rs[R_ABS0 * N] = rr.abs0;
      rs[R_NSCAT * N] = rr.nscat; rs[R_DABS * N] = rr.dabs;
      rs[R_SX * N] = rr.sx; rs[R_SY * N] = rr.sy; rs[R_SZ * N] = rr.sz;
      rs[R_ST * N] = rr.st; rs[R_SDX * N] = rr.sdx; rs[R_SDY * N] = rr.sdy;
      rs[R_SDZ * N] = rr.sdz; rs[R_PEND * N] = rr.pend;
      if (rr.pend >= 0.0f) n_alive = 1;
    }
  }

  // the block's last barrier: a warp that left the loop early waits here
  lap(c_prop);
  __syncthreads();
  lap(c_wait);

  // ---------- counters: warp, then block, then one atomic per block -------
  // (the global plans and the tabulated media add six: the bound's work;
  // the last NCYC, the cycle accounts, are lane 0's and need no warp sum)
  constexpr bool WIDE = !(COLL == COLL_SUBPLANS && MED == MED_CLOSED);
  constexpr int NC = 18, NCYC = 5;
  __shared__ long long s_cnt[NC][BLOCK / 32];
  __shared__ double s_w[BLOCK / 32];
  const bool l0 = lane == 0;
  long long v[NC] = {n_gen,  n_hits, n_alive, n_work, n_tested, n_cand, n_cull,
                     n_rows, n_scat, n_ray,   n_walk, n_warps,  n_swarps,
                     l0 ? c_wait : 0u, l0 ? c_prop : 0u, l0 ? c_spawn : 0u,
                     l0 ? c_coll : 0u, l0 ? c_cull : 0u};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < NC - NCYC && (WIDE || q < 4 || q >= 10))
        v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
    w_sum += __shfl_down_sync(0xffffffffu, w_sum, off);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NC; ++q) s_cnt[q][warp] = v[q];
    s_w[warp] = w_sum;
  }
  __syncthreads();
  if (tid == 0) {
    long long tot[NC] = {};
    double wt = 0.0;
    for (int wi = 0; wi < BLOCK / 32; ++wi) {
#pragma unroll
      for (int q = 0; q < NC; ++q) tot[q] += s_cnt[q][wi];
      wt += s_w[wi];
    }
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (tot[q]) atomicAdd(cnt_i + q, (unsigned long long)tot[q]);
    if (wt != 0.0) atomicAdd(cnt_w, wt);
  }
}

// Every pointer of a launch (device pointers allocated by the caller; the
// ones a mode does not read may be null).
struct LaunchArgs {
  const Params* params;
  float* state;
  const float* steps;
  const float* uniforms;
  const unsigned int* tf_keys;
  const float* layers;
  const float* spec_tab;
  const float* bias_tab;
  const float* tilt_zc;
  const float* cells;
  float* hist;
  long long* cnt_i;
  double* cnt_w;
  const float* doms;
  float* rec_buf;
  long long* rec_cnt;
  const float* rel;
  const float* strings;
  const float* wtab;
  const float* scat;
  const float* ang;
  void* stream;
};

template <bool RECORDS, int DEP, bool THREEFRY, bool FIXED, int COLL, int MED>
static int launch(const LaunchArgs& a) {
  const int n = a.params->n_active;
  if (n < 1 || n > a.params->n_slots) return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  propagate_kernel<RECORDS, DEP, THREEFRY, FIXED, COLL, MED>
      <<<grid, BLOCK, 0, (cudaStream_t)a.stream>>>(
          *a.params, a.state, a.steps, a.uniforms, a.tf_keys, a.layers,
          a.spec_tab, a.bias_tab, a.tilt_zc,
          reinterpret_cast<const float4*>(a.cells), a.hist,
          reinterpret_cast<unsigned long long*>(a.cnt_i), a.cnt_w,
          reinterpret_cast<const float4*>(a.doms), a.rec_buf,
          reinterpret_cast<unsigned long long*>(a.rec_cnt),
          reinterpret_cast<const float4*>(a.rel),
          reinterpret_cast<const float4*>(a.strings), a.wtab, a.scat, a.ang);
  return (int)cudaGetLastError();
}

// The twelve instantiations of one (COLL, MED) pair, by mode (kernel.py
// kernel_mode): stopping detect with and without records, stopping and
// non-stopping detect with and without the fixed horizon, the expected
// estimator, each of these six in Philox / external-stream form and in
// in-kernel threefry form.  -1 for a mode of another pair, or one that is
// not built (records with another deposit mode).
template <int COLL, int MED>
static int launch_family(int mode, const LaunchArgs& a) {
  constexpr int base = COLL << COLL_SHIFT | MED << MED_SHIFT;
  constexpr int TF = MODE_THREEFRY;
  switch (mode) {
    case base:
      return launch<false, DEP_STOP, false, false, COLL, MED>(a);
    case base | MODE_RECORDS:
      return launch<true, DEP_STOP, false, false, COLL, MED>(a);
    case base | MODE_FIXED:
      return launch<false, DEP_STOP, false, true, COLL, MED>(a);
    case base | DEP_PASS:
      return launch<false, DEP_PASS, false, false, COLL, MED>(a);
    case base | DEP_PASS | MODE_FIXED:
      return launch<false, DEP_PASS, false, true, COLL, MED>(a);
    case base | DEP_EXPECTED:
      return launch<false, DEP_EXPECTED, false, false, COLL, MED>(a);
    case base | TF:
      return launch<false, DEP_STOP, true, false, COLL, MED>(a);
    case base | TF | MODE_RECORDS:
      return launch<true, DEP_STOP, true, false, COLL, MED>(a);
    case base | TF | MODE_FIXED:
      return launch<false, DEP_STOP, true, true, COLL, MED>(a);
    case base | TF | DEP_PASS:
      return launch<false, DEP_PASS, true, false, COLL, MED>(a);
    case base | TF | DEP_PASS | MODE_FIXED:
      return launch<false, DEP_PASS, true, true, COLL, MED>(a);
    case base | TF | DEP_EXPECTED:
      return launch<false, DEP_EXPECTED, true, false, COLL, MED>(a);
    default:
      return -1;
  }
}

// One dispatcher per translation unit, each the family of one (COLL, MED)
// pair; each returns -1 for a mode it does not build.
int dispatch_main(int mode, const LaunchArgs& a);     // propagate.cu
int dispatch_affine(int mode, const LaunchArgs& a);   // propagate_affine.cu
int dispatch_general(int mode, const LaunchArgs& a);  // propagate_general.cu
int dispatch_tables(int mode, const LaunchArgs& a);   // propagate_tables.cu
int dispatch_water(int mode, const LaunchArgs& a);    // propagate_water.cu
int dispatch_affine_tables(int mode, const LaunchArgs& a);
int dispatch_affine_water(int mode, const LaunchArgs& a);
int dispatch_general_tables(int mode, const LaunchArgs& a);
int dispatch_general_water(int mode, const LaunchArgs& a);
int dispatch_scat(int mode, const LaunchArgs& a);          // propagate_scat.cu
int dispatch_affine_scat(int mode, const LaunchArgs& a);
int dispatch_general_scat(int mode, const LaunchArgs& a);
