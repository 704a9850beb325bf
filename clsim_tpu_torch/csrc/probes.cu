// Probe kernels for NVIDIA Hopper (sm_90a): the counterparts of the fifteen
// Pallas cost-model probes of the JAX package (scripts/probe_pallas*.py,
// P1-P15), rewritten as four kernels that measure what bounds the photon
// propagation kernel (propagate.cuh) on this card.  Each is one __global__
// template over its variant; every variant computes the function its TPU
// probe computes (the same inputs give the same outputs, up to the
// tolerances clsim_tpu_torch/probes.py states), without the TPU's layout
// tricks (one-hot MXU gathers, bf16 splits, pltpu.roll, (8, 128) tiles).
// The plain PyTorch versions, the ctypes wrappers and the launch counts are
// in clsim_tpu_torch/probes.py.
//
//   probe_fetch   (H1) table reads, latency hiding and divergence: P1 (a
//                 per-lane select and last arg-min), P2 and P7 k7/k8
//                 (gathers), P6 (a sin chain through a fetch), P8 k_fetch
//                 and P9 (a dependent chain of table reads: the table in
//                 global memory through __ldg, staged in shared memory by
//                 the block, or in __constant__ memory; the row read as
//                 scalars, float2 or float4; a constant index), P8 k_cull
//                 (88 strings' distance, min and last arg-min), P10/P11
//                 (the chain beside independent ALU work, or two lanes a
//                 thread), P12 (candidate loops of uniform or per-lane trip
//                 counts: divergence).  Dynamic shared memory caps the
//                 resident blocks per SM, so the same chain runs at the
//                 occupancy of the propagation kernel or at the card's most.
//   probe_state   (H2) P13/P14: NF floats of state a thread, kept in
//                 registers, in shared memory or in a local array, under
//                 __launch_bounds__(256, m) for m = 1..4.
//   probe_ops     (H3) the cost of an op: P15's multiply-add chains of n =
//                 5..40 and its IEEE division against __fdividef; P7 k6/k10,
//                 P8 k_elem and P12's flat chain as separately rounded
//                 multiply and add; P7 k13's transcendental chain with the
//                 CUDA math library (the propagation kernel builds without
//                 fast-math) against the intrinsics; P3's random draws as the
//                 propagation kernel's own Philox4x32-10 (philox.cuh).
//   probe_deposit (H4) appends and deposits: float atomicAdd into a (DOM x
//                 512-bin) histogram, one atomic a deposit or warp-aggregated
//                 (__match_any_sync, one add per distinct bin); P4's cursor
//                 and the record append by one atomicAdd a record or a
//                 warp-aggregated __ballot_sync / __popc append; P8's
//                 compaction and P7 k12's (and P3's) scan by a block scan
//                 with warp shuffles; P5's transpose through shared memory;
//                 P7 k9's broadcast store and k11's count.
//
// What bounds them: each is built to expose one cost, so each is bound by
// what it measures: dependent-read latency (H1's chains), ALU
// throughput (H2, H3), atomics and memory bandwidth (H4).  None is a design to
// make fast; their times are the numbers that choose the propagation
// kernel's redesign.
//
// Build: compiled with the other csrc/*.cu into the one library
// (clsim_tpu_torch/_build.py: sm_90a, -O3, no fast-math).

#include <cuda_runtime.h>

#include "philox.cuh"

#define PB 256               // threads per block of every probe launch
#define CONST_FLOATS 16000   // 64,000 bytes of __constant__ table

__constant__ __align__(16) float c_tab[CONST_FLOATS];

// One argument block for the four kernels, mirrored by probes.py's ctypes
// structure (pointers first, then 4-byte fields).
struct ProbeArgs {
  const float* a;          // per-lane inputs
  const float* b;
  const float* tab;        // table (global memory)
  const int* idx;          // per-lane int inputs
  float* out;
  unsigned int* bits;
  int* cnt;
  int L, T, S, C;          // lanes, iterations, table rows, table columns
  int n, idx_mode, seg, tab_floats;
  int wrap, key0, key1, threads;
  float m, c0;
};

enum { MEM_GLOBAL = 0, MEM_SHARED = 1, MEM_CONST = 2 };
enum { F_SELECT_MIN = 0, F_GATHER = 1, F_GATHER_SUM = 2, F_CHAIN_SIN = 3,
       F_CHAIN = 4, F_OVERLAP = 5, F_CULL = 6, F_CANDIDATES = 7 };
enum { S_REG = 0, S_SHARED = 1, S_LOCAL = 2 };
enum { O_FMA = 0, O_MULADD = 1, O_RESHAPE = 2, O_DIV = 3, O_DIV_FAST = 4,
       O_TRANSC = 5, O_TRANSC_FAST = 6, O_PHILOX = 7 };
enum { D_HIST_ATOMIC = 0, D_HIST_WARP = 1, D_APPEND_ATOMIC = 2,
       D_APPEND_WARP = 3, D_CURSOR = 4, D_COMPACT = 5, D_SCAN = 6,
       D_TRANSPOSE = 7, D_STORE = 8, D_COUNT = 9 };

// ---------------------------------------------------------------------------
// H1 probe_fetch
// ---------------------------------------------------------------------------

template <int MEM>
__device__ __forceinline__ float tload(const float* __restrict__ g,
                                       const float* s, int i) {
  if constexpr (MEM == MEM_GLOBAL) return __ldg(g + i);
  else if constexpr (MEM == MEM_SHARED) return s[i];
  else return c_tab[i];
}

template <int MEM>
__device__ __forceinline__ float2 tload2(const float* __restrict__ g,
                                         const float* s, int i) {
  if constexpr (MEM == MEM_GLOBAL)
    return __ldg(reinterpret_cast<const float2*>(g) + i);
  else if constexpr (MEM == MEM_SHARED)
    return reinterpret_cast<const float2*>(s)[i];
  else
    return reinterpret_cast<const float2*>(c_tab)[i];
}

template <int MEM>
__device__ __forceinline__ float4 tload4(const float* __restrict__ g,
                                         const float* s, int i) {
  if constexpr (MEM == MEM_GLOBAL)
    return __ldg(reinterpret_cast<const float4*>(g) + i);
  else if constexpr (MEM == MEM_SHARED)
    return reinterpret_cast<const float4*>(s)[i];
  else
    return reinterpret_cast<const float4*>(c_tab)[i];
}

// P8/P9's index of the chain: int(|a| * 37) % S, floor(frac(|a|) * S)
// (P9's packed variants, P10, P11) or the constant row 3 (P9 k_const)
__device__ __forceinline__ int chain_index(float a, int mode, int S) {
  const float aa = fabsf(a);
  if (mode == 0) return (int)__fmul_rn(aa, 37.0f) % S;
  if (mode == 1) return (int)floorf(__fmul_rn(__fsub_rn(aa, floorf(aa)),
                                              (float)S));
  return 3;
}

// one step of the fetch chain: a = w0 * 1e-3 + w5 * 1e-4 + a * 0.999, each
// product and sum rounded on its own (the order of the TPU probe), with
// (w0, w5) read from the table in layout W: 1 = (C, S) fields (rows 0 and
// 5), 2 = (S, 2) pairs, 4 = (S, 4) quads (w0, w5, -, -)
template <int MEM, int W>
__device__ __forceinline__ float fetch_step(float a, const ProbeArgs& p,
                                            const float* s) {
  const int j = chain_index(a, p.idx_mode, p.S);
  float w0, w5;
  if constexpr (W == 1) {
    w0 = tload<MEM>(p.tab, s, j);
    w5 = tload<MEM>(p.tab, s, 5 * p.S + j);
  } else if constexpr (W == 2) {
    const float2 v = tload2<MEM>(p.tab, s, j);
    w0 = v.x; w5 = v.y;
  } else {
    const float4 v = tload4<MEM>(p.tab, s, j);
    w0 = v.x; w5 = v.y;
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, 1e-3f), __fmul_rn(w5, 1e-4f)),
                   __fmul_rn(a, 0.999f));
}

// P10's vpu_step: 20 x (b * 1.0000001 + 1e-9, then b - 1 where b > 2)
__device__ __forceinline__ float vpu_step(float b) {
#pragma unroll
  for (int k = 0; k < 20; ++k) {
    b = __fadd_rn(__fmul_rn(b, 1.0000001f), 1e-9f);
    b = b > 2.0f ? __fsub_rn(b, 1.0f) : b;
  }
  return b;
}

template <int VAR, int MEM, int W>
__global__ void __launch_bounds__(PB) probe_fetch(const ProbeArgs p) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  if constexpr (MEM == MEM_SHARED) {
    for (int i = threadIdx.x; i < p.tab_floats; i += blockDim.x)
      s[i] = __ldg(p.tab + i);
    __syncthreads();
  }
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int L = p.L;
  if (l >= p.threads) return;
  if constexpr (VAR == F_SELECT_MIN) {
    // P1: tab (S, L) per lane; tab[idx, l], the column min, its last index
    const int j = p.idx[l];
    float sel = 0.0f, mi = 3.0e38f;
    int im = -1;
    for (int r = 0; r < p.S; ++r) {
      const float v = __ldg(p.tab + (size_t)r * L + l);
      if (r == j) sel = v;
      if (v <= mi) { mi = v; im = r; }
    }
    p.out[l] = sel;
    p.out[L + l] = mi;
    p.out[2 * L + l] = (float)im;
  } else if constexpr (VAR == F_GATHER) {
    // P2, P7 k7: out[c, l] = tab[c, idx[l]] for the C fields
    const int j = p.idx[l];
    for (int c = 0; c < p.C; ++c)
      p.out[(size_t)c * L + l] = tload<MEM>(p.tab, s, c * p.S + j);
  } else if constexpr (VAR == F_GATHER_SUM) {
    // P7 k8: T x acc += tab[0, idx + i % 3]
    const int j = p.idx[l];
    float acc = 0.0f;
    for (int i = 0; i < p.T; ++i)
      acc = __fadd_rn(acc, tload<MEM>(p.tab, s, j + i % 3));
    p.out[l] = acc;
  } else if constexpr (VAR == F_CHAIN_SIN) {
    // P6: idx = int(|x| * 7) % S, v = the sum of fields 0-3 at idx,
    // x = sin x + 1e-3 v
    float x = p.a[l];
    for (int i = 0; i < p.T; ++i) {
      const int j = (int)__fmul_rn(fabsf(x), 7.0f) % p.S;
      const float v = __fadd_rn(__fadd_rn(__fadd_rn(
          tload<MEM>(p.tab, s, j), tload<MEM>(p.tab, s, p.S + j)),
          tload<MEM>(p.tab, s, 2 * p.S + j)), tload<MEM>(p.tab, s, 3 * p.S + j));
      x = __fadd_rn(sinf(x), __fmul_rn(0.001f, v));
    }
    p.out[l] = x;
  } else if constexpr (VAR == F_CHAIN) {
    // P8 k_fetch, P9: T dependent reads
    float a = p.a[l];
    for (int i = 0; i < p.T; ++i) a = fetch_step<MEM, W>(a, p, s);
    p.out[l] = a;
  } else if constexpr (VAR == F_OVERLAP) {
    // P10/P11: out = a + b after T steps of the fetch chain (n = 0), of the
    // ALU chain (n = 1), of both in one thread (n = 2), or the chain of two
    // lanes in one thread (n = 3: lanes l and l + threads)
    if (p.n == 3) {
      float a0 = p.a[l], a1 = p.a[l + p.threads];
      const float b0 = __fmul_rn(a0, 0.5f), b1 = __fmul_rn(a1, 0.5f);
      for (int i = 0; i < p.T; ++i) {
        a0 = fetch_step<MEM, W>(a0, p, s);
        a1 = fetch_step<MEM, W>(a1, p, s);
      }
      p.out[l] = __fadd_rn(a0, b0);
      p.out[l + p.threads] = __fadd_rn(a1, b1);
    } else {
      const float x = p.a[l];
      float a = x, b = __fmul_rn(x, 0.5f);
      for (int i = 0; i < p.T; ++i) {
        if (p.n != 1) a = fetch_step<MEM, W>(a, p, s);
        if (p.n != 0) b = vpu_step(b);
      }
      p.out[l] = __fadd_rn(a, b);
    }
  } else if constexpr (VAR == F_CULL) {
    // P8 k_cull: per string (cols (S, 8): sx, sy), rx = sx - a, ry = sy -
    // a/2, t = clip(0.3 rx + 0.7 ry, 0, 50), d2 = (rx + t)^2 + (ry - t)^2,
    // ranked below 1e4; the last arg-min's sx moves a
    float a = p.a[l];
    for (int i = 0; i < p.T; ++i) {
      float mi = 3.0e38f;
      int im = 0;
      const float ah = __fmul_rn(a, 0.5f);
      for (int r = 0; r < p.S; ++r) {
        const float rx = __fsub_rn(tload<MEM>(p.tab, s, 8 * r), a);
        const float ry = __fsub_rn(tload<MEM>(p.tab, s, 8 * r + 1), ah);
        const float t2 = fminf(fmaxf(__fadd_rn(__fmul_rn(rx, 0.3f),
                                               __fmul_rn(ry, 0.7f)), 0.0f),
                               50.0f);
        const float u = __fadd_rn(rx, t2), v = __fsub_rn(ry, t2);
        const float d2 = __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v));
        const float ranked = d2 < 1e4f ? d2 : 1e30f;
        if (ranked <= mi) { mi = ranked; im = r; }
      }
      a = __fadd_rn(__fmul_rn(a, 0.999f),
                    __fmul_rn(tload<MEM>(p.tab, s, 8 * im), 1e-6f));
    }
    p.out[l] = a;
  } else if constexpr (VAR == F_CANDIDATES) {
    // P12: the min over idx[l] candidates of a 21-op chain (P12's "small"
    // and "big" at 10 candidates; per-lane counts make warps diverge)
    float a = p.a[l];
    const int nc = p.idx[l];
    for (int i = 0; i < p.T; ++i) {
      float acc = a;
      for (int c = 0; c < nc; ++c) {
        float b = __fmul_rn(a, (float)(1.0 + 1e-7 * (double)c));
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          b = __fadd_rn(__fmul_rn(b, 1.0000001f), 1e-9f);
          b = fmaxf(__fsub_rn(b, 1e-9f), 0.0f);
          b = b > 2.0f ? __fsub_rn(b, 1.0f) : b;
        }
        acc = fminf(acc, b);
      }
      a = acc;
    }
    p.out[l] = a;
  }
}

// ---------------------------------------------------------------------------
// H2 probe_state
// ---------------------------------------------------------------------------

// P13/P14: NF state floats a thread; T steps of c = c * 1.0000001 + k on
// the first C fields (k = 1e-9, or i * 1e-9 with n = 1); out = the fields
// (idx_mode 0) or their sum in field order (idx_mode 1)
template <int SPACE, int NF, int MINB>
__global__ void __launch_bounds__(PB, MINB) probe_state(const ProbeArgs p) {
  __shared__ float sst[SPACE == S_SHARED ? NF * PB : 1];
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int L = p.L;
  if (l >= L) return;
  const int touched = p.C;
  if constexpr (SPACE == S_REG) {
    float st[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) st[f] = p.a[(size_t)f * L + l];
    for (int i = 0; i < p.T; ++i) {
      const float k = p.n ? __fmul_rn((float)i, 1e-9f) : 1e-9f;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        if (f < touched) st[f] = __fadd_rn(__fmul_rn(st[f], 1.0000001f), k);
    }
    if (p.idx_mode) {
      float acc = st[0];
#pragma unroll
      for (int f = 1; f < NF; ++f) acc = __fadd_rn(acc, st[f]);
      p.out[l] = acc;
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f) p.out[(size_t)f * L + l] = st[f];
    }
  } else {
    // shared: [field][thread]; local: a per-thread array indexed at run
    // time (the loops are not unrolled), so it lives in local memory
    float lst[SPACE == S_LOCAL ? NF : 1];
    auto at = [&](int f) -> float& {
      if constexpr (SPACE == S_SHARED) return sst[f * PB + threadIdx.x];
      else return lst[f];
    };
#pragma unroll 1
    for (int f = 0; f < NF; ++f) at(f) = p.a[(size_t)f * L + l];
    for (int i = 0; i < p.T; ++i) {
      const float k = p.n ? __fmul_rn((float)i, 1e-9f) : 1e-9f;
#pragma unroll 1
      for (int f = 0; f < touched; ++f)
        at(f) = __fadd_rn(__fmul_rn(at(f), 1.0000001f), k);
    }
    if (p.idx_mode) {
      float acc = at(0);
#pragma unroll 1
      for (int f = 1; f < NF; ++f) acc = __fadd_rn(acc, at(f));
      p.out[l] = acc;
    } else {
#pragma unroll 1
      for (int f = 0; f < NF; ++f) p.out[(size_t)f * L + l] = at(f);
    }
  }
}

// ---------------------------------------------------------------------------
// H3 probe_ops
// ---------------------------------------------------------------------------

// P7 k13's step: sin + 0.1 cos, exp(-|a|) + log1p|a|, |a|^0.73 + sqrt|a|,
// halved; FAST takes the intrinsics (__sinf, __cosf, __expf, __logf,
// __powf; sqrt stays IEEE)
template <bool FAST>
__device__ __forceinline__ float transc_step(float a) {
  if constexpr (FAST) {
    a = __fadd_rn(__sinf(a), __fmul_rn(__cosf(a), 0.1f));
    const float aa = fabsf(a);
    a = __fadd_rn(__expf(-aa), __logf(__fadd_rn(1.0f, aa)));
    const float ab = fabsf(a);
    a = __fadd_rn(__powf(ab, 0.73f), __fsqrt_rn(ab));
  } else {
    a = __fadd_rn(sinf(a), __fmul_rn(cosf(a), 0.1f));
    const float aa = fabsf(a);
    a = __fadd_rn(expf(-aa), log1pf(aa));
    const float ab = fabsf(a);
    a = __fadd_rn(powf(ab, 0.73f), sqrtf(ab));
  }
  return __fmul_rn(a, 0.5f);
}

__device__ __forceinline__ float u01_24(unsigned int bits) {
  return __fmul_rn((float)(bits >> 8), 1.0f / 16777216.0f);
}

template <int VAR, int N>
__global__ void __launch_bounds__(PB) probe_ops(const ProbeArgs p) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int L = p.L;
  if (l >= L) return;
  if constexpr (VAR == O_FMA) {
    // P15: n fused multiply-adds a = a * 1.0000001 + (b + i * 1e-9) a step
    float a = p.a[l];
    const float b = p.b[l];
    for (int i = 0; i < p.T; ++i) {
      const float k = __fadd_rn(b, __fmul_rn((float)i, 1e-9f));
#pragma unroll
      for (int j = 0; j < N; ++j) a = fmaf(a, 1.0000001f, k);
    }
    p.out[l] = a;
  } else if constexpr (VAR == O_MULADD) {
    // P7 k10, P8 k_elem, P12 flat: n x (a * m + c0, separately rounded;
    // with wrap, then a - 1 where a > 2)
    float a = p.a[l];
    for (int i = 0; i < p.T; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a = __fadd_rn(__fmul_rn(a, p.m), p.c0);
        if (p.wrap) a = a > 2.0f ? __fsub_rn(a, 1.0f) : a;
      }
    }
    p.out[l] = a;
  } else if constexpr (VAR == O_RESHAPE) {
    // P7 k6: a = (a + 1) * 1.0000001
    float a = p.a[l];
    for (int i = 0; i < p.T; ++i)
      a = __fmul_rn(__fadd_rn(a, 1.0f), 1.0000001f);
    p.out[l] = a;
  } else if constexpr (VAR == O_DIV || VAR == O_DIV_FAST) {
    // P15 div: n x a = a / (b + i * 1e-9 + 1.001)
    float a = p.a[l];
    const float b = p.b[l];
    for (int i = 0; i < p.T; ++i) {
      const float d = __fadd_rn(__fadd_rn(b, __fmul_rn((float)i, 1e-9f)),
                                1.001f);
#pragma unroll
      for (int j = 0; j < N; ++j)
        a = VAR == O_DIV ? __fdiv_rn(a, d) : __fdividef(a, d);
    }
    p.out[l] = a;
  } else if constexpr (VAR == O_TRANSC || VAR == O_TRANSC_FAST) {
    float a = p.a[l];
    for (int i = 0; i < p.T; ++i) a = transc_step<VAR == O_TRANSC_FAST>(a);
    p.out[l] = a;
  } else if constexpr (VAR == O_PHILOX) {
    // P3: T draws of Philox4x32-10 at counter (i, l, 0, 0) under key
    // (key0, key1), u = (x >> 8) 2^-24 accumulated; out = sin + cos +
    // exp(-acc) + log1p(acc); bits = the four words of the first draw
    const uint2 key = make_uint2((unsigned)p.key0, (unsigned)p.key1);
    float acc = 0.0f;
    for (int i = 0; i < p.T; ++i) {
      const uint4 r = philox4x32_10(make_uint4((unsigned)i, (unsigned)l, 0u,
                                               0u), key);
      if (i == 0) {
        p.bits[l] = r.x;
        p.bits[L + l] = r.y;
        p.bits[2 * L + l] = r.z;
        p.bits[3 * L + l] = r.w;
      }
      acc = __fadd_rn(acc, u01_24(r.x));
    }
    p.out[l] = __fadd_rn(__fadd_rn(__fadd_rn(sinf(acc), cosf(acc)),
                                   expf(-acc)), log1pf(acc));
  }
}

// ---------------------------------------------------------------------------
// H4 probe_deposit
// ---------------------------------------------------------------------------

// block-wide exclusive scan of one int or float a thread (PB threads) with
// warp shuffles; `total` receives the block's sum
template <typename V>
__device__ __forceinline__ V block_exclusive_scan(V v, V* warp_tot,
                                                  V* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  V inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_tot[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    V w = lane < nw ? warp_tot[lane] : (V)0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < nw) warp_tot[lane] = w;  // inclusive warp prefix
  }
  __syncthreads();
  const V before = wid ? warp_tot[wid - 1] : (V)0;
  *total = warp_tot[nw - 1];
  __syncthreads();
  return before + inc - v;
}

template <int VAR>
__global__ void __launch_bounds__(PB) probe_deposit(const ProbeArgs p) {
  const int L = p.L;
  const int lane = threadIdx.x & 31;
  if constexpr (VAR == D_HIST_ATOMIC || VAR == D_HIST_WARP) {
    // T deposits a lane: (bin idx[i, l], weight a[i, l]), bin -1 = none
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    __shared__ float wbuf[PB];
    for (int i = 0; i < p.T; ++i) {
      const int bin = l < L ? p.idx[(size_t)i * L + l] : -1;
      const float w = bin >= 0 ? p.a[(size_t)i * L + l] : 0.0f;
      if constexpr (VAR == D_HIST_ATOMIC) {
        if (bin >= 0) atomicAdd(p.out + bin, w);
      } else {
        // one add per distinct bin of the warp: the peers' weights summed
        // in lane order by the lowest peer
        const unsigned active = __ballot_sync(0xffffffffu, bin >= 0);
        wbuf[threadIdx.x] = w;
        __syncwarp();
        if (bin >= 0) {
          const unsigned peers = __match_any_sync(active, bin);
          if (lane == __ffs(peers) - 1) {
            float sum = 0.0f;
            for (unsigned m = peers; m; m &= m - 1)
              sum += wbuf[(threadIdx.x & ~31) + __ffs(m) - 1];
            atomicAdd(p.out + bin, sum);
          }
        }
        __syncwarp();
      }
    }
  } else if constexpr (VAR == D_APPEND_ATOMIC || VAR == D_APPEND_WARP) {
    // T append chances a lane (idx[i, l] >= 0): record (l, i, a[i, l], 0)
    // at a position taken from the counter cnt[0]; at most n records
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    float4* rec = reinterpret_cast<float4*>(p.out);
    for (int i = 0; i < p.T; ++i) {
      const bool want = l < L && p.idx[(size_t)i * L + l] >= 0;
      int pos;
      if constexpr (VAR == D_APPEND_ATOMIC) {
        if (!want) continue;
        pos = atomicAdd(p.cnt, 1);
      } else {
        const unsigned ballot = __ballot_sync(0xffffffffu, want);
        if (!ballot) continue;
        const int leader = __ffs(ballot) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(p.cnt, __popc(ballot));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (!want) continue;
        pos = base + __popc(ballot & ((1u << lane) - 1u));
      }
      if (pos < p.n)
        rec[pos] = make_float4((float)l, (float)i, p.a[(size_t)i * L + l],
                               0.0f);
    }
  } else if constexpr (VAR == D_CURSOR) {
    // P4: a row cursor that advances every other step; out[row, l] +=
    // a[l] * (i + 1) over T steps (out is (8, L), zeroed first)
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const float x = p.a[l];
    for (int r = 0; r < 8; ++r) p.out[(size_t)r * L + l] = 0.0f;
    int row = 0;
    for (int i = 0; i < p.T; ++i) {
      float* o = p.out + (size_t)row * L + l;
      *o = __fadd_rn(*o, __fmul_rn(x, (float)(i + 1)));
      row += (i % 2 == 0);
    }
  } else if constexpr (VAR == D_COMPACT || VAR == D_SCAN) {
    // one block a segment of seg lanes, seg / blockDim consecutive lanes a
    // thread: compaction of the lanes with a > c0 in order (out, the count
    // in cnt[segment]), or the inclusive scan of a (out)
    __shared__ float ftot[32];
    __shared__ int itot[32];
    const int per = p.seg / blockDim.x;
    const size_t base = (size_t)blockIdx.x * p.seg + (size_t)threadIdx.x * per;
    if constexpr (VAR == D_COMPACT) {
      int n = 0;
      for (int k = 0; k < per; ++k) n += p.a[base + k] > p.c0;
      int total;
      int pos = block_exclusive_scan<int>(n, itot, &total);
      float* o = p.out + (size_t)blockIdx.x * p.seg;
      for (int k = 0; k < per; ++k) {
        const float v = p.a[base + k];
        if (v > p.c0) o[pos++] = v;
      }
      if (threadIdx.x == 0) p.cnt[blockIdx.x] = total;
    } else {
      float s = 0.0f;
      for (int k = 0; k < per; ++k) s += p.a[base + k];
      float total;
      float run = block_exclusive_scan<float>(s, ftot, &total);
      for (int k = 0; k < per; ++k) {
        run += p.a[base + k];
        p.out[base + k] = run;
      }
    }
  } else if constexpr (VAR == D_TRANSPOSE) {
    // P5: (S, C) -> (C, S) through a 32 x 33 shared tile, 32 x 8 threads
    __shared__ float tile[32][33];
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
    for (int k = ty; k < 32; k += 8) {
      const int r = r0 + k, c = c0 + tx;
      if (r < p.S && c < p.C) tile[k][tx] = p.a[(size_t)r * p.C + c];
    }
    __syncthreads();
    for (int k = ty; k < 32; k += 8) {
      const int c = c0 + k, r = r0 + tx;
      if (r < p.S && c < p.C) p.out[(size_t)c * p.S + r] = tile[tx][k];
    }
  } else if constexpr (VAR == D_STORE) {
    // P7 k9: out[r, l] = col[r] * 2 for the S rows
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    for (int r = 0; r < p.S; ++r)
      p.out[(size_t)r * L + l] = __fmul_rn(__ldg(p.tab + r), 2.0f);
  } else if constexpr (VAR == D_COUNT) {
    // P7 k11: cnt[c] = the lanes whose value equals c, c < C (shared-memory
    // counters, one global add a counter a block)
    __shared__ int sc[256];
    for (int c = threadIdx.x; c < p.C; c += blockDim.x) sc[c] = 0;
    __syncthreads();
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l < L) {
      const float v = p.a[l];
      const int c = (int)v;
      if (v >= 0.0f && c < p.C && (float)c == v) atomicAdd(sc + c, 1);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < p.C; c += blockDim.x)
      if (sc[c]) atomicAdd(p.cnt + c, sc[c]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
static int launch_probe(K kernel, dim3 grid, dim3 block, int smem,
                        const ProbeArgs& p, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename K>
static int occupancy_of(K kernel, int smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, PB, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

// the H1 instantiations: (variant, memory space, load width)
#define FETCH_CASES(X)                                                      \
  X(F_SELECT_MIN, MEM_GLOBAL, 1) X(F_GATHER, MEM_GLOBAL, 1)                  \
  X(F_GATHER, MEM_SHARED, 1) X(F_GATHER, MEM_CONST, 1)                       \
  X(F_GATHER_SUM, MEM_GLOBAL, 1) X(F_CHAIN_SIN, MEM_GLOBAL, 1)               \
  X(F_CHAIN, MEM_GLOBAL, 1) X(F_CHAIN, MEM_SHARED, 1)                        \
  X(F_CHAIN, MEM_CONST, 1) X(F_CHAIN, MEM_GLOBAL, 2)                         \
  X(F_CHAIN, MEM_GLOBAL, 4) X(F_CHAIN, MEM_SHARED, 4)                        \
  X(F_CHAIN, MEM_CONST, 4) X(F_OVERLAP, MEM_GLOBAL, 1)                       \
  X(F_CULL, MEM_GLOBAL, 1) X(F_CULL, MEM_SHARED, 1) X(F_CULL, MEM_CONST, 1)  \
  X(F_CANDIDATES, MEM_GLOBAL, 1)

#define STATE_CASES(X)                                                      \
  X(S_REG, 18, 1) X(S_REG, 18, 2) X(S_REG, 18, 3) X(S_REG, 18, 4)            \
  X(S_REG, 24, 1) X(S_REG, 24, 2) X(S_REG, 24, 3) X(S_REG, 24, 4)            \
  X(S_SHARED, 18, 1) X(S_SHARED, 24, 1) X(S_LOCAL, 18, 1) X(S_LOCAL, 24, 1)

#define OPS_CASES(X)                                                        \
  X(O_FMA, 5) X(O_FMA, 10) X(O_FMA, 20) X(O_FMA, 40) X(O_MULADD, 21)         \
  X(O_MULADD, 25) X(O_RESHAPE, 1) X(O_DIV, 5) X(O_DIV, 10)                   \
  X(O_DIV_FAST, 10) X(O_TRANSC, 1) X(O_TRANSC_FAST, 1) X(O_PHILOX, 1)

#define DEPOSIT_CASES(X)                                                    \
  X(D_HIST_ATOMIC) X(D_HIST_WARP) X(D_APPEND_ATOMIC) X(D_APPEND_WARP)        \
  X(D_CURSOR) X(D_COMPACT) X(D_SCAN) X(D_TRANSPOSE) X(D_STORE) X(D_COUNT)

extern "C" {

int clsim_probe_args_size(void) { return (int)sizeof(ProbeArgs); }

int clsim_probe_const_floats(void) { return CONST_FLOATS; }

// Copy `n` floats from the device pointer `src` into the constant table.
int clsim_probe_set_const(const float* src, int n, void* stream) {
  if (n > CONST_FLOATS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbolAsync(c_tab, src, (size_t)n * sizeof(float),
                                      0, cudaMemcpyDeviceToDevice,
                                      (cudaStream_t)stream);
}

// Launch H1 (variant, mem, width) over p->threads threads with `smem` bytes
// of dynamic shared memory (the staged table, or more to cap the resident
// blocks); occupancy != 0 returns the resident blocks per SM instead.
int clsim_probe_fetch(int var, int mem, int width, const ProbeArgs* p,
                      int smem, int occupancy, void* stream) {
  const dim3 grid((p->threads + PB - 1) / PB);
#define X(V, M, W)                                                          \
  if (var == V && mem == M && width == W)                                   \
    return occupancy ? occupancy_of(probe_fetch<V, M, W>, smem)            \
                     : launch_probe(probe_fetch<V, M, W>, grid, PB, smem, *p, \
                                    stream);
  FETCH_CASES(X)
#undef X
  return occupancy ? -1 : (int)cudaErrorInvalidValue;
}

int clsim_probe_state(int space, int nf, int minb, const ProbeArgs* p,
                      int occupancy, void* stream) {
  const dim3 grid((p->L + PB - 1) / PB);
#define X(S, F, B)                                                          \
  if (space == S && nf == F && minb == B)                                   \
    return occupancy ? occupancy_of(probe_state<S, F, B>, 0)               \
                     : launch_probe(probe_state<S, F, B>, grid, PB, 0, *p,   \
                                    stream);
  STATE_CASES(X)
#undef X
  return occupancy ? -1 : (int)cudaErrorInvalidValue;
}

int clsim_probe_ops(int var, int n, const ProbeArgs* p, int smem,
                    int occupancy, void* stream) {
  const dim3 grid((p->L + PB - 1) / PB);
#define X(V, N)                                                             \
  if (var == V && n == N)                                                   \
    return occupancy ? occupancy_of(probe_ops<V, N>, smem)                 \
                     : launch_probe(probe_ops<V, N>, grid, PB, smem, *p,     \
                                    stream);
  OPS_CASES(X)
#undef X
  return occupancy ? -1 : (int)cudaErrorInvalidValue;
}

// H4: the grid follows the variant (segments for the scans, 32 x 32 tiles
// for the transpose, one thread a lane otherwise); the scans take
// min(PB, seg) threads a block
int clsim_probe_deposit(int var, const ProbeArgs* p, int occupancy,
                        void* stream) {
  dim3 grid((p->L + PB - 1) / PB), block(PB);
  if (var == D_COMPACT || var == D_SCAN) {
    if (p->seg < 32 || (p->seg & (p->seg - 1)) || p->L % p->seg)
      return (int)cudaErrorInvalidValue;
    grid = dim3(p->L / p->seg);
    block = dim3(p->seg < PB ? p->seg : PB);
  } else if (var == D_TRANSPOSE) {
    grid = dim3((p->C + 31) / 32, (p->S + 31) / 32);
  } else if (var == D_COUNT && p->C > 256) {
    return (int)cudaErrorInvalidValue;
  }
#define X(V)                                                                \
  if (var == V)                                                             \
    return occupancy ? occupancy_of(probe_deposit<V>, 0)                   \
                     : launch_probe(probe_deposit<V>, grid, block, 0, *p,    \
                                    stream);
  DEPOSIT_CASES(X)
#undef X
  return occupancy ? -1 : (int)cudaErrorInvalidValue;
}

}  // extern "C"
