// Photon tables on NVIDIA Hopper (sm_90a): the tabulator's propagation
// iterations as one kernel, in the reference's own design (the #ifdef
// TABULATE branch of propagation_kernel.c.cl:226-304, 540-785): each
// sub-step of the comb adds its weight straight into the one float64 table
// held in device memory with atomicAdd.
//
// Replaces the JAX package's jitted chunk (clsim_tpu/tabulator/table.py
// _make_tabulate_chunk, :143-315, body :158-258), which is not a Pallas
// kernel: on the TPU the chunk writes (bin, weight) entries that the host
// adds, because a TPU has no scattered atomic add into a large table.  Its
// plain PyTorch version is clsim_tpu_torch/tabulator/table.py
// tabulate_iterations_plain (the eager chunk body, one index_add_ an
// iteration).
//
// Design.  One thread owns one photon slot of the launch's slot list (the
// host passes the slots still live, so a launch runs no dead warps; every
// slot at the first launch) and keeps its photon's state in registers; the
// launch runs up to `iters` iterations from the caller's iteration i0 under
// the warp-independent loop of the propagation kernel's fixed-horizon
// modes (propagate.cuh warp_loop): no block barrier, a fresh lane makes
// its own photon, a warp leaves when no lane of it is live.  An iteration,
// in the JAX order:
//  1. spawn into a free slot (u0-u3: make_photon with the fixed horizon);
//  2. the first sub-step offset of a new photon, step_len * (1 - u8);
//  3. the scattering budget (u4) and one segment of the layer walk (the
//     propagation kernel's walk, copied below with its tilt and anisotropy);
//  4. the comb: sub-steps remainder + m * step_len < d_prop, each at the
//     source-relative coordinates (spherical or cylindrical, with the
//     optional impact cosine from two draws of sub-step m's key), weight
//     impact * exp(-(depth_start + frac * step_depth)); a sub-step out of
//     the table's bounds deposits nothing and stops the photon after the
//     comb;
//  5. the remainder carried to the next segment;
//  6. the advance;
//  7. the scatter (u5-u7, mixed HG / simplified Liu through the anisotropy
//     transforms, for every medium, as the JAX tabulator scatters);
//  8. death at absorption or when abs_left < EPS.
// The comb is the warp's, not the lane's: each lane counts its sub-steps
// (a closed form, corrected to the exact prefix), a warp prefix sum lays
// the warp's sub-steps end to end, and rounds of 32 deal them one to a
// lane, which reads its sub-step's owner's segment by shuffles; so lanes
// whose combs differ in length do not wait for the longest.  Each nonzero
// sub-step adds its weight with its own atomicAdd (CNT_ATOMICS counts the
// atomics, CNT_ENTRIES the nonzero sub-steps: equal).  The weight's
// division and exponential run on the fast intrinsics (__fdividef, __expf:
// ~1e-6 relative, no bin moves).
//
// Random numbers are the JAX package's, bit for bit: iteration i's key is
// keys[2i, 2i + 1] (host-folded, rng.fold_in(batch key, i0 + i)) and row r of
// slot s draws element r * N + s of uniforms(key, (N,), 9); sub-step m's
// impact draws are elements s and N + s under sub_keys[(i * n_sub + m) * 2]
// (fold_in(fold_in(iteration key, 0x1A7B), m)).
//
// What bounds it on this card (chip_smoke.py --tab-turns and phase 11a on
// an H100: the counters CNT_WARPS_T .. CNT_CYC_SCATTER): the comb's
// coordinates and bins.  Lane 0's clock puts ~73% of a warp's cycles in
// them, ~10% in the weights and atomics, ~7% in the walk, ~6% in the spawn
// and ~4% in the advance and scatter.  Each sub-step is a dependent chain
// (two square roots, an arccosine, three divisions, four bin indices,
// about 1e2 operations) and at the tabulator's 65,536 slots a SM holds
// ~15.5 warps, too few to hide it: the kernel runs ~14x above its
// operation bound.  What the design does: each lane walking its own comb
// kept the warp at 0.455 of its lanes (32 x the longest comb); dealt over
// the warp the comb runs at 0.970.  Compacted slot lists remove the
// launches' dead warps (live lanes 0.89 of a warp over a run).  Merging a
// round's sub-steps of one bin before the atomic (__match_any_sync) cost
// more than the atomics it saved (fire-and-forget, 15% of the kernel row),
// so every nonzero sub-step is its own atomic.  Hoisting the coordinates'
// linear parts per segment, and the azimuth's bin by compares against the
// cosines of its edges, measured within the noise or slower and are not
// used.  80 registers, no spills: 3 blocks a SM when there are slots
// enough; in turns it tied with 2 blocks at 65,536 and at 262,144 slots.

#include "propagate.cuh"

#define TAB_MAX_DIM 5
#define TAB_MAX_ANG 16

// the tabulator's parameter block, mirrored field for field by
// clsim_tpu_torch/tabulator/kernel.py _TabParams (8-byte fields first)
struct TabParams {
  long long n_bins;                 // bins of the flat table
  long long stride[TAB_MAX_DIM];    // row-major strides (axes.strides)
  double step_len;                  // comb spacing [m]
  int n_slots, iters, n_sub, n_ang;  // N, iterations, comb length, coeffs
  int n_list;                       // slots served (threads)
  int ax_n[TAB_MAX_DIM];            // data bins of each axis
  int ax_pow[TAB_MAX_DIM];          // 1 linear, 2 square root, else powf
  float ax_min[TAB_MAX_DIM], ax_max[TAB_MAX_DIM];
  float ax_scale[TAB_MAX_DIM], ax_off[TAB_MAX_DIM];  // Axis.index_constants
  float ax_ipow[TAB_MAX_DIM];       // 1 / power
  float src_x, src_y, src_z, src_t;    // the source frame
  float src_dx, src_dy, src_dz;
  float src_px, src_py, src_pz;        // perpendicular reference direction
  float min_inv_gv, tan_theta_c;
  float ang[TAB_MAX_ANG];           // angular acceptance, ascending powers
};

// counters of a launch (kernel.py TAB_COUNTERS): the weight sum is the
// separate double.  CNT_ATOMICS and those after it are kernel-only: warp-
// iterations run, the comb's lane-slots its rounds took (32 x rounds), and
// lane 0's clock cycles in each stage of the iteration
enum { CNT_ENTRIES, CNT_SUBSTEPS, CNT_WORK_T, CNT_WALK_T, CNT_ALIVE,
       CNT_GEN, CNT_ATOMICS, CNT_WARPS_T, CNT_COMB_SLOTS,
       CNT_CYC_SPAWN, CNT_CYC_WALK, CNT_CYC_COORDS, CNT_CYC_WEIGHT,
       CNT_CYC_SCATTER, N_TAB_CNT };
// the remainder's row after the NSF slot-state rows
enum { F_REM = NSF };

// float32 subnormals -> 0 (axes._flush: XLA's CPU backend flushes them)
__device__ __forceinline__ float tab_flush(float x) {
  return fabsf(x) < 1.17549435e-38f ? 0.0f : x;
}

// axes.Axis.bin_index: 0 underflow, 1..n, n + 1 overflow
__device__ __forceinline__ long long tab_bin(const TabParams& tp, int a,
                                             float v) {
  float s = tab_flush(v);
  if (tp.ax_pow[a] != 1) {  // inverse_transform: sign(v - min) |v - min|^(1/p)
    const float r = s - tp.ax_min[a];
    const float mag = tp.ax_pow[a] == 2 ? sqrtf(fabsf(r))
                                        : powf(fabsf(r), tp.ax_ipow[a]);
    s = r > 0.0f ? mag : (r < 0.0f ? -mag : 0.0f);
  }
  const float x = tab_flush(tp.ax_scale[a] * s);
  const float raw = floorf(x - tp.ax_off[a]);
  return (long long)fminf(fmaxf(raw, -1.0f), (float)tp.ax_n[a]) + 1;
}

// table.py _spherical_coords / _cylindrical_coords of one sub-step, with the
// impact cosine against the randomized direction (ix, iy, iz) when IMPACT
template <bool CYL, bool IMPACT>
__device__ __forceinline__ void tab_coords(const TabParams& tp, float px,
                                           float py, float pz, float pt,
                                           float ix, float iy, float iz,
                                           float* c) {
  const float rx = px - tp.src_x, ry = py - tp.src_y, rz = pz - tp.src_z;
  const float l = rx * tp.src_dx + ry * tp.src_dy + rz * tp.src_dz;
  const float hx = rx - l * tp.src_dx;
  const float hy = ry - l * tp.src_dy;
  const float hz = rz - l * tp.src_dz;
  const float rho = sqrtf(hx * hx + hy * hy + hz * hz);
  const float cos_az = (hx * tp.src_px + hy * tp.src_py + hz * tp.src_pz) /
                       fmaxf(rho, 1e-20f);
  const float az = rho > 0.0f ? acosf(fminf(fmaxf(cos_az, -1.0f), 1.0f))
                              : 0.0f;
  if constexpr (CYL) {
    c[0] = rho;
    c[1] = az;
    c[2] = tp.src_z + l * tp.src_dz;
    c[3] = (pt - tp.src_t) - (l + rho * tp.tan_theta_c) / C_LIGHT;
    if constexpr (IMPACT) {
      const float lc = l - rho / tp.tan_theta_c;
      const float cx = rx - lc * tp.src_dx;
      const float cy = ry - lc * tp.src_dy;
      const float cz = rz - lc * tp.src_dz;
      const float cd = sqrtf(cx * cx + cy * cy + cz * cz);
      const float ci = (ix * cx + iy * cy + iz * cz) / fmaxf(cd, 1e-20f);
      c[4] = cd > 0.0f ? fminf(fmaxf(ci, -1.0f), 1.0f) : 1.0f;
    }
  } else {
    const float r = sqrtf(rx * rx + ry * ry + rz * rz);
    c[0] = r;
    c[1] = rho > 0.0f ? az / (float)(3.141592653589793 / 180.0) : 0.0f;
    c[2] = r > 0.0f ? l / fmaxf(r, 1e-20f) : 0.0f;
    c[3] = (pt - tp.src_t) - r * tp.min_inv_gv;
    if constexpr (IMPACT) {
      const float ci = (ix * rx + iy * ry + iz * rz) / fmaxf(r, 1e-20f);
      c[4] = r > 0.0f ? fminf(fmaxf(ci, -1.0f), 1.0f) : 1.0f;
    }
  }
}

// sub-step m's distance along a segment whose comb starts at `rem`, as the
// plain version's offsets are rounded (m * step_len once to float32)
__device__ __forceinline__ float comb_d(float rem, int m, double step_len) {
  return rem + (float)((double)m * step_len);
}

// the sub-steps of a segment: the m < n_sub with comb_d(rem, m) < d_prop,
// a prefix since comb_d grows with m; an estimate corrected both ways
__device__ __forceinline__ int comb_count(float rem, float d_prop,
                                          const TabParams& tp, float inv_sl) {
  int m = (int)fminf(fmaxf(ceilf((d_prop - rem) * inv_sl), 0.0f),
                     (float)tp.n_sub);
  while (m > 0 && !(comb_d(rem, m - 1, tp.step_len) < d_prop)) --m;
  while (m < tp.n_sub && comb_d(rem, m, tp.step_len) < d_prop) ++m;
  return m;
}

// MED: MED_CLOSED (closed-form ice) or MED_TABLES (every tabulated medium:
// the photonics tables and water spawn alike, and the tabulator scatters
// all media by the HG / Liu mixture); CYL: cylindrical axes; IMPACT: the
// 5th impact-cosine axis.  Tilt and anisotropy are runtime branches.
template <int MED, bool CYL, bool IMPACT>
__global__ void __launch_bounds__(BLOCK, 3)
tabulate_kernel(const Params p, const TabParams tp, float* __restrict__ state,
                const float* __restrict__ steps,
                const int* __restrict__ slots,
                const unsigned int* __restrict__ keys,
                const unsigned int* __restrict__ sub_keys,
                const float* __restrict__ layers,
                const float* __restrict__ spec_tab,
                const float* __restrict__ bias_tab,
                const float* __restrict__ tilt_zc,
                const float* __restrict__ wtab, double* __restrict__ table,
                unsigned long long* __restrict__ cnt_i,
                double* __restrict__ cnt_w) {
  constexpr int ND = IMPACT ? 5 : 4;
  constexpr unsigned int FULL = 0xffffffffu;
  const int N = tp.n_slots;
  const int t_list = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = t_list < tp.n_list;
  // thread t serves slot slots[t] (every slot when there is no list)
  const int slot = valid ? (slots ? slots[t_list] : t_list) : 0;
  const int lane = threadIdx.x & 31;
  const unsigned int us = (unsigned int)slot, un = (unsigned int)N;
  const float sl = (float)tp.step_len;
  const float inv_sl = 1.0f / sl;

  unsigned int n_ent = 0, n_sub = 0, n_work = 0, n_walk = 0, n_gen = 0;
  unsigned int n_atom = 0, n_warps = 0, comb_slots = 0;
  double w_sum = 0.0;
  // lane 0's clock cycles in each stage (only its count is kept): each lap
  // adds the cycles since the last mark (32-bit deltas, wrap-safe; a
  // warp's account of one launch fits 32 bits)
  unsigned int c_spawn = 0, c_walk = 0, c_coords = 0, c_weight = 0;
  unsigned int c_scat = 0;
  unsigned int t_mark = 0;
  auto lap = [&](unsigned int& acc) {
    const unsigned int now = (unsigned int)clock();
    acc += now - t_mark;
    t_mark = now;
  };

  // the slot's state (benign values past the list's end)
  float left = 0.0f, inflight = 0.0f, x = 0.0f, y = 0.0f, z = 0.0f;
  float t = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f, w0 = 0.0f;
  float inv_gv = 5.0f, abs_left = 0.0f, gs = 1.0f, pa = 0.0f, qa = 1.0f;
  float ra = 0.0f, rem = 0.0f, s_w = 0.0f;
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
    rem = state[F_REM * N + slot];
    s_w = steps[S_W * N + slot];
  }
  const int L = p.L;
  const float* __restrict__ lay_b = layers;
  const float* __restrict__ lay_a = layers + L;
  const float* __restrict__ lay_t = layers + 2 * L;

  t_mark = (unsigned int)clock();
  for (int it = 0; it < tp.iters; ++it) {
    const bool live = valid && (inflight > 0.5f || left > 0.5f);
    const unsigned int lb = __ballot_sync(FULL, live);
    lap(c_scat);  // the last iteration's advance and scatter
    if (lb == 0u) break;  // the warp leaves when no lane of it is live
    ++n_warps;
    const unsigned int k0 = keys[2 * it], k1 = keys[2 * it + 1];
    auto draw = [&](unsigned int r) {
      return tf_u01(threefry_bits(k0, k1, r * un + us));
    };

    // ---------- 1-2. spawn, and the first sub-step offset ----------
    if (live && inflight < 0.5f) {
      float u[4], st[NSTEP];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = draw(r);
#pragma unroll
      for (int f = 0; f < NSTEP; ++f) st[f] = steps[f * N + slot];
      const Spawned q = make_photon<DEP_PASS, true, MED>(p, st, u, spec_tab,
                                                         bias_tab, wtab);
      x = q.x; y = q.y; z = q.z; t = q.t;
      dx = q.dx; dy = q.dy; dz = q.dz;
      w0 = q.w0; inv_gv = q.igv; abs_left = q.abs;
      gs = q.gs; pa = q.pa; qa = q.qa; ra = q.ra;
      inflight = 1.0f;
      left -= 1.0f;
      ++n_gen;
      rem = sl * (1.0f - draw(8));
    }
    __syncwarp();
    lap(c_spawn);

    // ---------- 3. budgets, anisotropy and the layer walk ----------
    // The twin of propagate.cuh's propagate_kernel (budgets + anisotropy
    // and the tilt + layer walk, :823-890), copied: K1's instantiations
    // stay as they are.  A lane without a photon keeps an empty segment.
    float d_prop = 0.0f, abs_corr = 1.0f, abs_new = abs_left;
    float depth_start = 0.0f, step_depth = 0.0f, impact = 0.0f;
    bool absorbed = false, scattered = false;
    int n_in = 0;
    if (live) {
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
      ++n_work;
      const float sca_budget = -logf(1.0f - draw(4));
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
      absorbed = d_abs < d_scat;
      d_prop = fminf(fminf(d_scat, d_abs), p.max_seg);
      const bool capped = (!absorbed && d_scat > p.max_seg) ||
                          (absorbed && d_abs > p.max_seg);
      absorbed = absorbed && !capped;
      scattered = !absorbed && !capped;
      abs_new =
          (absorbed ? 0.0f : fmaxf(tau_a - (d_prop - t_done) * inv_a, 0.0f)) /
          abs_corr;
      // under the fixed horizon every photon starts with p.horizon
      // absorption lengths, so the depth so far is horizon - abs_left
      depth_start = p.horizon - abs_left;
      step_depth = abs_left - abs_new;
      impact = s_w;
      if constexpr (!IMPACT) {
        // the angular acceptance (an impact axis replaces it)
        const float c = fminf(fmaxf(dz, -1.0f), 1.0f);
        float a = tp.ang[tp.n_ang - 1];
        for (int q = tp.n_ang - 2; q >= 0; --q) a = a * c + tp.ang[q];
        impact = s_w * a;
      }
      n_in = comb_count(rem, d_prop, tp, inv_sl);
      n_sub += n_in;
    }
    __syncwarp();
    lap(c_walk);

    // ---------- 4. the comb, dealt over the warp ----------
    // The warp's sub-steps in one sequence, lane by lane, and each round
    // gives the next 32 of them one to a lane: a lane finds the sub-step's
    // owner by a search of the inclusive prefix sum of n_in and reads the
    // owner's segment by shuffles.  Sub-step m draws and deposits as it
    // would in its owner's thread.
    int incl = n_in;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    const int excl = incl - n_in;
    const int total = __shfl_sync(FULL, incl, 31);
    comb_slots += 32u * (unsigned int)((total + 31) >> 5);
    bool stop = false;
    for (int base = 0; base < total; base += 32) {
      const int jj = base + lane;
      const bool act = jj < total;
      // the owner: the number of lanes whose prefix ends at or before jj
      int o = 0;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        if (__shfl_sync(FULL, incl, o + s - 1) <= jj) o += s;
      const int oexcl = __shfl_sync(FULL, excl, o);
      const int m = act ? jj - oexcl : 0;
      const float orem = __shfl_sync(FULL, rem, o);
      const float ox = __shfl_sync(FULL, x, o);
      const float oy = __shfl_sync(FULL, y, o);
      const float oz = __shfl_sync(FULL, z, o);
      const float ot = __shfl_sync(FULL, t, o);
      const float odx = __shfl_sync(FULL, dx, o);
      const float ody = __shfl_sync(FULL, dy, o);
      const float odz = __shfl_sync(FULL, dz, o);
      const float oigv = __shfl_sync(FULL, inv_gv, o);
      const float d = comb_d(orem, m, tp.step_len);
      float ix = 0.0f, iy = 0.0f, iz = 0.0f;
      if constexpr (IMPACT) {
        const unsigned int ous = __shfl_sync(FULL, us, o);
        const unsigned int* sk = sub_keys + 2 * (it * tp.n_sub + m);
        const unsigned int s0 = sk[0], s1 = sk[1];
        const float u_sin = tf_u01(threefry_bits(s0, s1, ous));
        const float u_az = tf_u01(threefry_bits(s0, s1, un + ous));
        scatter_dir(sqrtf(fmaxf(1.0f - u_sin, 0.0f)), sqrtf(u_sin), odx, ody,
                    odz, u_az, &ix, &iy, &iz);
      }
      float c[ND];
      tab_coords<CYL, IMPACT>(tp, ox + d * odx, oy + d * ody, oz + d * odz,
                              ot + d * oigv, ix, iy, iz, c);
      const bool oob = act && (CYL ? c[3] > tp.ax_max[3]
                                   : (c[0] > tp.ax_max[0] ||
                                      c[3] > tp.ax_max[3]));
      long long idx = 0;
#pragma unroll
      for (int a = 0; a < ND; ++a) idx += tp.stride[a] * tab_bin(tp, a, c[a]);
      idx = idx < 0 ? 0 : (idx >= tp.n_bins ? tp.n_bins - 1 : idx);
      // a sub-step out of the table's bounds deposits nothing and stops its
      // owner after the comb: each lane reads its own range of the round
      const unsigned int ob = __ballot_sync(FULL, oob);
      const int lo = max(excl - base, 0), hi = min(incl - base, 32);
      if (lo < hi) {
        const unsigned int mine =
            (hi == 32 ? FULL : (1u << hi) - 1u) & ~((1u << lo) - 1u);
        stop = stop || (ob & mine) != 0u;
      }
      lap(c_coords);

      // d / max(d_prop, 1e-20) as the plain version divides, and the
      // survival weight, both by the fast intrinsics (d_prop <= max_seg)
      const float odp = __shfl_sync(FULL, d_prop, o);
      const float ods = __shfl_sync(FULL, depth_start, o);
      const float osd = __shfl_sync(FULL, step_depth, o);
      const float oimp = __shfl_sync(FULL, impact, o);
      const float frac = __fdividef(d, fmaxf(odp, 1e-20f));
      const float w = oimp * __expf(-(ods + frac * osd));
      const bool dep = act && !oob && w != 0.0f;
      if (dep) {
        ++n_ent;
        w_sum += (double)w;
        atomicAdd(table + idx, (double)w);
        ++n_atom;
      }
      lap(c_weight);
    }

    // ---------- 5-8. carry the remainder, advance, scatter, retire ----------
    if (live) {
      if (n_in > 0) {
        const float d_last = comb_d(rem, n_in - 1, tp.step_len);
        rem = d_last + sl - d_prop;
      }
      x += dx * d_prop;
      y += dy * d_prop;
      z += dz * d_prop;
      t += inv_gv * d_prop;
      abs_left = abs_new;

      // scatter (HG / simplified-Liu mixture)
      if (scattered) {
        float pdx = dx, pdy = dy, pdz = dz;
        if (p.aniso)
          aniso_transform(p, p.an_k1, p.an_k2, p.an_kz, &pdx, &pdy, &pdz);
        const float g = p.mean_cos;
        const float u5 = draw(5), u6 = draw(6);
        float cos_s;
        if (u5 < p.liu_frac) {
          cos_s = fminf(fmaxf(2.0f * powf(u6, p.liu_beta) - 1.0f, -1.0f),
                        1.0f);
        } else {
          const float svar = 2.0f * u6 - 1.0f;
          if (fabsf(g) < 1e-6f) {
            cos_s = svar;
          } else {
            const float frac2 = (1.0f - g * g) / (1.0f + g * svar);
            cos_s = fminf(fmaxf((1.0f + g * g - frac2 * frac2) / (2.0f * g),
                                -1.0f), 1.0f);
          }
        }
        const float sin_s = sqrtf(fmaxf(1.0f - cos_s * cos_s, 0.0f));
        scatter_dir(cos_s, sin_s, pdx, pdy, pdz, draw(7), &dx, &dy, &dz);
        if (p.aniso)
          aniso_transform(p, p.an_ik1, p.an_ik2, p.an_ikz, &dx, &dy, &dz);
      }
      if (stop || absorbed || abs_left < EPS) inflight = 0.0f;
    }
  }

  unsigned int n_alive = 0;
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
    state[F_REM * N + slot] = rem;
    n_alive = (inflight > 0.5f || left > 0.5f) ? 1u : 0u;
  }

  // ---------- counters: a warp's sums, one atomic each ----------
  // (the warp-level counts and clocks are lane 0's alone)
  const bool l0 = lane == 0;
  unsigned long long v[N_TAB_CNT] = {
      n_ent,  n_sub, n_work, n_walk, n_alive, n_gen, n_atom,
      l0 ? n_warps : 0u, l0 ? comb_slots : 0u, l0 ? c_spawn : 0u,
      l0 ? c_walk : 0u, l0 ? c_coords : 0u, l0 ? c_weight : 0u,
      l0 ? c_scat : 0u};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < N_TAB_CNT; ++q)
      v[q] += __shfl_down_sync(FULL, v[q], off);
    w_sum += __shfl_down_sync(FULL, w_sum, off);
  }
  if (l0) {
#pragma unroll
    for (int q = 0; q < N_TAB_CNT; ++q)
      if (v[q]) atomicAdd(cnt_i + q, v[q]);
    if (w_sum != 0.0) atomicAdd(cnt_w, w_sum);
  }
}

template <int MED, bool CYL, bool IMPACT>
static int tab_launch(const Params* p, const TabParams* tp, float* state,
                      const float* steps, const int* slots,
                      const unsigned int* keys, const unsigned int* sub_keys,
                      const float* layers, const float* spec_tab,
                      const float* bias_tab, const float* tilt_zc,
                      const float* wtab, double* table, long long* cnt_i,
                      double* cnt_w, void* stream) {
  const int grid = (tp->n_list + BLOCK - 1) / BLOCK;
  tabulate_kernel<MED, CYL, IMPACT><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      *p, *tp, state, steps, slots, keys, sub_keys, layers, spec_tab,
      bias_tab, tilt_zc, wtab, table,
      reinterpret_cast<unsigned long long*>(cnt_i), cnt_w);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch tp->iters tabulator iterations on `stream`.  `mode` is MED | CYL << 1
// | IMPACT << 2 (kernel.py tab_mode; MED 0 closed-form ice, 1 a tabulated
// medium).  `state` is the (NSF + 1, N) slot state (the propagation
// kernel's rows, then the comb's remainder), `steps` the (NST, N) step rows,
// `slots` the tp->n_list int32 slots to serve (null: every slot, n_list N),
// `keys` the (2 * iters,) iteration keys and `sub_keys` the (iters, n_sub, 2)
// impact keys (may be null without IMPACT), all uint32.  `params` is the
// propagation kernel's block (the medium, spectrum and walk fields are
// read).  `table` (tp->n_bins float64) receives the deposits; `cnt_i` holds
// N_TAB_CNT zeroed int64 (kernel.py TAB_COUNTERS without the weight) and
// `cnt_w` one zeroed double (the weight sum).  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an unknown mode or an empty list.
int clsim_tabulate(int mode, const Params* params, const TabParams* tab,
                   float* state, const float* steps, const int* slots,
                   const unsigned int* keys,
                   const unsigned int* sub_keys, const float* layers,
                   const float* spec_tab, const float* bias_tab,
                   const float* tilt_zc, const float* wtab, double* table,
                   long long* cnt_i, double* cnt_w, void* stream) {
#define TAB_CASE(M, C, I)                                                   \
  case (M) | ((C) << 1) | ((I) << 2):                                       \
    return tab_launch<M, C, I>(params, tab, state, steps, slots, keys,      \
                               sub_keys, layers, spec_tab, bias_tab,        \
                               tilt_zc, wtab, table, cnt_i, cnt_w, stream);
  if (tab->n_list <= 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    TAB_CASE(MED_CLOSED, false, false)
    TAB_CASE(MED_CLOSED, true, false)
    TAB_CASE(MED_CLOSED, false, true)
    TAB_CASE(MED_CLOSED, true, true)
    TAB_CASE(MED_TABLES, false, false)
    TAB_CASE(MED_TABLES, true, false)
    TAB_CASE(MED_TABLES, false, true)
    TAB_CASE(MED_TABLES, true, true)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TAB_CASE
}

int clsim_tab_params_size(void) { return (int)sizeof(TabParams); }
int clsim_tab_counters(void) { return N_TAB_CNT; }

}  // extern "C"
