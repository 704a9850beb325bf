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
// Design.  One thread owns one photon slot and keeps its photon's state in
// registers for the launch; the launch runs up to `iters` iterations from
// the caller's iteration i0 under the warp-independent loop of the
// propagation kernel's fixed-horizon modes (propagate.cuh warp_loop): no
// block barrier, a fresh lane makes its own photon, a warp leaves when no
// lane of it is live.  An iteration, in the JAX order:
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
// Consecutive sub-steps of one thread that fall in the same bin are summed
// in a double register and added once, when the bin changes or at the end
// of the launch (CNT_ATOMICS counts the atomics, CNT_ENTRIES the nonzero
// sub-steps).
//
// Random numbers are the JAX package's, bit for bit: iteration i's key is
// keys[2i, 2i + 1] (host-folded, rng.fold_in(batch key, i0 + i)) and row r of
// slot s draws element r * N + s of uniforms(key, (N,), 9); sub-step m's
// impact draws are elements s and N + s under sub_keys[(i * n_sub + m) * 2]
// (fold_in(fold_in(iteration key, 0x1A7B), m)).
//
// What bounds it on this card: the comb.  Each tested sub-step computes its
// coordinates (two square roots, an arccosine, a division), up to five bin
// indices (a square root each on the power-2 axes) and an exponential, about
// 1e2 operations, and ends in a float64 atomic at a data-dependent address
// of a table of up to 83.8M bins (670 MB, far beyond L2): the atomics wait on
// device memory, and lanes of one warp walk combs of different lengths.  The
// design keeps the state in registers, reads the key tables and steps once,
// merges runs of sub-steps in one bin before their atomic, and reduces the
// counters per warp to one atomic each.

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
// separate double
enum { CNT_ENTRIES, CNT_SUBSTEPS, CNT_WORK_T, CNT_WALK_T, CNT_ALIVE,
       CNT_GEN, CNT_ATOMICS, N_TAB_CNT };
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

// MED: MED_CLOSED (closed-form ice) or MED_TABLES (every tabulated medium:
// the photonics tables and water spawn alike, and the tabulator scatters
// all media by the HG / Liu mixture); CYL: cylindrical axes; IMPACT: the
// 5th impact-cosine axis.  Tilt and anisotropy are runtime branches.
template <int MED, bool CYL, bool IMPACT>
__global__ void __launch_bounds__(BLOCK, 2)
tabulate_kernel(const Params p, const TabParams tp, float* __restrict__ state,
                const float* __restrict__ steps,
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
  const int N = tp.n_slots;
  const int slot = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = slot < N;
  const int lane = threadIdx.x & 31;
  const unsigned int us = (unsigned int)slot, un = (unsigned int)N;
  const float sl = (float)tp.step_len;

  unsigned int n_ent = 0, n_sub = 0, n_work = 0, n_walk = 0, n_gen = 0;
  unsigned int n_atom = 0;
  double w_sum = 0.0;
  // the run of sub-steps in one bin not yet added to the table
  long long run_bin = -1;
  double run_w = 0.0;

  // the slot's state (benign values past the last slot)
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

  for (int it = 0; it < tp.iters; ++it) {
    const bool live = valid && (inflight > 0.5f || left > 0.5f);
    if (__ballot_sync(0xffffffffu, live) == 0u) break;
    if (!live) continue;
    const unsigned int k0 = keys[2 * it], k1 = keys[2 * it + 1];
    auto draw = [&](unsigned int r) {
      return tf_u01(threefry_bits(k0, k1, r * un + us));
    };

    // ---------- 1-2. spawn, and the first sub-step offset ----------
    if (inflight < 0.5f) {
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

    // ---------- 3. budgets, anisotropy and the layer walk ----------
    // The twin of propagate.cuh's propagate_kernel (budgets + anisotropy
    // and the tilt + layer walk, :823-890), copied: K1's instantiations
    // stay as they are.
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
    bool absorbed = d_abs < d_scat;
    const float d_prop = fminf(fminf(d_scat, d_abs), p.max_seg);
    const bool capped = (!absorbed && d_scat > p.max_seg) ||
                        (absorbed && d_abs > p.max_seg);
    absorbed = absorbed && !capped;
    const bool scattered = !absorbed && !capped;
    const float abs_new =
        (absorbed ? 0.0f : fmaxf(tau_a - (d_prop - t_done) * inv_a, 0.0f)) /
        abs_corr;

    // ---------- 4. the comb ----------
    // under the fixed horizon every photon starts with p.horizon absorption
    // lengths, so the depth so far is horizon - abs_left
    const float depth_start = p.horizon - abs_left;
    const float step_depth = abs_left - abs_new;
    float impact = s_w;
    if constexpr (!IMPACT) {
      // the angular acceptance (an impact axis replaces it)
      const float c = fminf(fmaxf(dz, -1.0f), 1.0f);
      float a = tp.ang[tp.n_ang - 1];
      for (int q = tp.n_ang - 2; q >= 0; --q) a = a * c + tp.ang[q];
      impact = s_w * a;
    }
    bool stop = false;
    int n_in = 0;
    float d_last = 0.0f;
    for (int m = 0; m < tp.n_sub; ++m) {
      // d grows with m, so the sub-steps inside the segment are a prefix
      const float d = rem + (float)((double)m * tp.step_len);
      if (!(d < d_prop)) break;
      ++n_in;
      d_last = d;
      float ix = 0.0f, iy = 0.0f, iz = 0.0f;
      if constexpr (IMPACT) {
        const unsigned int* sk = sub_keys + 2 * (it * tp.n_sub + m);
        const unsigned int s0 = sk[0], s1 = sk[1];
        const float u_sin = tf_u01(threefry_bits(s0, s1, us));
        const float u_az = tf_u01(threefry_bits(s0, s1, un + us));
        scatter_dir(sqrtf(fmaxf(1.0f - u_sin, 0.0f)), sqrtf(u_sin), dx, dy,
                    dz, u_az, &ix, &iy, &iz);
      }
      float c[ND];
      tab_coords<CYL, IMPACT>(tp, x + d * dx, y + d * dy, z + d * dz,
                              t + d * inv_gv, ix, iy, iz, c);
      const bool oob = CYL ? c[3] > tp.ax_max[3]
                           : (c[0] > tp.ax_max[0] || c[3] > tp.ax_max[3]);
      if (oob) {  // the photon leaves the table after this comb
        stop = true;
        continue;
      }
      // d / max(d_prop, 1e-20) as the plain version divides
      const float frac = d / fmaxf(d_prop, 1e-20f);
      const float w = impact * expf(-(depth_start + frac * step_depth));
      if (w == 0.0f) continue;
      long long idx = 0;
#pragma unroll
      for (int a = 0; a < ND; ++a) idx += tp.stride[a] * tab_bin(tp, a, c[a]);
      idx = idx < 0 ? 0 : (idx >= tp.n_bins ? tp.n_bins - 1 : idx);
      ++n_ent;
      w_sum += (double)w;
      if (idx != run_bin) {
        if (run_bin >= 0) {
          atomicAdd(table + run_bin, run_w);
          ++n_atom;
        }
        run_bin = idx;
        run_w = 0.0;
      }
      run_w += (double)w;
    }
    n_sub += n_in;

    // ---------- 5-6. carry the remainder, advance ----------
    if (n_in > 0) rem = d_last + sl - d_prop;
    x += dx * d_prop;
    y += dy * d_prop;
    z += dz * d_prop;
    t += inv_gv * d_prop;
    abs_left = abs_new;

    // ---------- 7. scatter (HG / simplified-Liu mixture) ----------
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

    // ---------- 8. retire ----------
    if (stop || absorbed || abs_left < EPS) inflight = 0.0f;
  }
  if (run_bin >= 0) {
    atomicAdd(table + run_bin, run_w);
    ++n_atom;
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
  __syncwarp();
  unsigned long long v[N_TAB_CNT] = {n_ent,   n_sub, n_work, n_walk,
                                     n_alive, n_gen, n_atom};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < N_TAB_CNT; ++q)
      v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
    w_sum += __shfl_down_sync(0xffffffffu, w_sum, off);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < N_TAB_CNT; ++q)
      if (v[q]) atomicAdd(cnt_i + q, v[q]);
    if (w_sum != 0.0) atomicAdd(cnt_w, w_sum);
  }
}

template <int MED, bool CYL, bool IMPACT>
static int tab_launch(const Params* p, const TabParams* tp, float* state,
                      const float* steps, const unsigned int* keys,
                      const unsigned int* sub_keys, const float* layers,
                      const float* spec_tab, const float* bias_tab,
                      const float* tilt_zc, const float* wtab, double* table,
                      long long* cnt_i, double* cnt_w, void* stream) {
  const int grid = (tp->n_slots + BLOCK - 1) / BLOCK;
  tabulate_kernel<MED, CYL, IMPACT><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      *p, *tp, state, steps, keys, sub_keys, layers, spec_tab, bias_tab,
      tilt_zc, wtab, table, reinterpret_cast<unsigned long long*>(cnt_i),
      cnt_w);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch tp->iters tabulator iterations on `stream`.  `mode` is MED | CYL << 1
// | IMPACT << 2 (kernel.py tab_mode; MED 0 closed-form ice, 1 a tabulated
// medium).  `state` is the (NSF + 1, N) slot state (the propagation
// kernel's rows, then the comb's remainder), `steps` the (NST, N) step rows,
// `keys` the (2 * iters,) iteration keys and `sub_keys` the (iters, n_sub, 2)
// impact keys (may be null without IMPACT), all uint32.  `params` is the
// propagation kernel's block (the medium, spectrum and walk fields are
// read).  `table` (tp->n_bins float64) receives the deposits; `cnt_i` holds
// N_TAB_CNT zeroed int64 (nonzero sub-steps, sub-steps tested, live
// slot-iterations, walk steps, alive slots, photons made, atomics) and `cnt_w` one zeroed double (the
// weight sum).  Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unknown mode.
int clsim_tabulate(int mode, const Params* params, const TabParams* tab,
                   float* state, const float* steps, const unsigned int* keys,
                   const unsigned int* sub_keys, const float* layers,
                   const float* spec_tab, const float* bias_tab,
                   const float* tilt_zc, const float* wtab, double* table,
                   long long* cnt_i, double* cnt_w, void* stream) {
#define TAB_CASE(M, C, I)                                                   \
  case (M) | ((C) << 1) | ((I) << 2):                                       \
    return tab_launch<M, C, I>(params, tab, state, steps, keys, sub_keys,   \
                               layers, spec_tab, bias_tab, tilt_zc, wtab,   \
                               table, cnt_i, cnt_w, stream);
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
