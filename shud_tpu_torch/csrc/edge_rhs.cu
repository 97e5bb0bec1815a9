// The edge path's primal RHS for Hopper (sm_90a), with a plain C interface.
//
// Off the mega path the RHS is rhs._rhs: PyTorch around the edge kernels
// (edge_flux.cu), some 480 elementwise kernels a call on the card (the
// cell update, ET, infiltration and recharge, the segment and river
// stencils, five fixed-width gather sums and the assembly).  JAX has no
// kernel here: XLA fuses the RHS.  Two kernels compute the same values on
// a lake-free mesh, around the unchanged edge kernel between them:
//   rhs_cell_kernel      one thread per cell: the head-BC override of gw,
//                        updateElement, ET, infiltration and recharge
//                        (rhs.update_element, et_flux, flux_infiltration,
//                        flux_recharge), every row the edge kernel and the
//                        assembly read;
//   rhs_assemble_kernel  one thread per cell, then one per segment, then
//                        one per reach: each cell's lateral sums and
//                        dsf/dus/dgw with the BC and SS terms, each
//                        segment's weir and bed fluxes (local datum), each
//                        reach's geometry, downstream discharge, inflow
//                        sums and dA -> dy with the river BCs.
// The edge kernel reads the cell kernel's eff_kh at the neighbours, and
// the assembly the edge fluxes, so they are three launches on one stream.
// A cell's or a reach's sum over its segments, and a reach's over its
// upstream reaches, recomputes each term from the cell kernel's rows
// (each term is the same function of the same inputs, so the same bits as
// the segment's own thread writes), so no launch waits on another thread
// of its own grid.
//
// Every expression keeps rhs._rhs's order of operations, a Python number
// enters as PyTorch rounds it to float32, maximum and minimum propagate
// NaN as torch.maximum does, the calls are the CUDA math functions
// PyTorch's kernels call (powf, cosf, sqrtf; the cube root as
// physics.cbrt), and a fixed-width sum adds in the order of PyTorch's CUDA
// reduction over a row (torch_row_sum).  That order is kept up to 127
// elements a row (edge.sum_in_order); a gather list wider is summed by
// torch itself between two launches of the
// assembly, the first (pre) writing the segments' and reaches' rows those
// sums read, the second reading the sums (given).  The build fuses no
// multiply-add (--fmad=false), so each output is rhs._rhs's to the last
// bit.
//
// What bounds them: bytes, every input and every output once.  The cell
// kernel reads 29 float32 fields and one int64 flag of a cell and writes
// 17 rows: 192 B a cell, 25.2 MB at 131,072 cells.  The assembly reads 19
// float32 fields, six edge fluxes, two int64 flags and a seg_to_ele row of
// a cell and writes dsf, dus, dgw, three subsurface edge fluxes and four
// sums, and reads and writes its segments' and reaches' fields and rows:
// 21.5 MB at 131,072 cells (chip_smoke.py's bound).  Both run a
// grid-stride loop, so a block count capped below the mesh's size covers
// the 2M-cell mesh as well.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue, launching nothing, for a sum
// it cannot keep in order); the caller allocates every output.  Each
// kernel adds one to *count (a device counter of edge.py's) where it runs,
// so that a launch replayed from a CUDA graph is counted as well.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Python numbers as PyTorch rounds them to float32
constexpr float kTiny = static_cast<float>(1.0e-30);    // physics._TINY
constexpr float kZero = static_cast<float>(1.0e-10);    // config.ZERO
constexpr float kNegZero = static_cast<float>(-1.0e-10);
constexpr float kEps = static_cast<float>(0.005);       // config.EPSILON
constexpr float kGrav = static_cast<float>(9.8);        // config.GRAV
constexpr float k2Grav = static_cast<float>(2.0 * 9.8);
constexpr float kPi = static_cast<float>(3.1415926);    // Macros.hpp's PI
constexpr float kSatHi = static_cast<float>(0.99);
constexpr float kClipLo = static_cast<float>(1e-12);
constexpr float kClipHi = static_cast<float>(1.0 - 1e-12);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kFlatSlope = static_cast<float>(0.05e-6);
constexpr float kRsFloor = static_cast<float>(1e-30);
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
// the most threads a row of torch's sum that torch_row_sum follows (torch
// gives a row of at most 127 elements no more): its tree of
// kMaxSumThreads leaves is kSumDepth levels deep
constexpr int kMaxSumThreads = 64;
constexpr int kSumDepth = 7;
static_assert(1 << (kSumDepth - 1) == kMaxSumThreads,
              "torch_row_sum's stack holds a tree of kMaxSumThreads leaves");

// the cell kernel's float32 inputs, [ne] each (rhs._RHS_CELL_FIELDS); sf,
// us and gw are the state's (gw before the head BC)
enum CellField {
  SF, US, GW, ELE_YBC, POT_EVAP, LAI, E_IC, POT_TRAN, NET_PRCP, FU_SURF,
  FU_SUB, AQ_DEPTH, MAC_D, MAC_KSAT_H, GEO_V_AREA_F, KSAT_H, INF_KSAT_V,
  H_AREA_F, MAC_KSAT_V, THETA_S, THETA_R, BETA, VEG_FRAC, IMP_AF,
  WETLAND_LEVEL, ROOTREACH_LEVEL, INF_D, KSAT_V, THETA_FC, N_CELL_FIELDS
};
// its int64 inputs, [ne] each
enum CellFlag { I_BC, N_CELL_FLAGS };
// its output rows, [ne] each (rhs._RHS_CELL_OUT): gw after the head BC,
// the cell update, ET, the vertical fluxes
enum CellOut {
  O_GW, O_EFF_KH, O_DEFICIT, O_SATN, O_SAT_KR, O_THETA, O_KMAX, O_ES, O_EU,
  O_EG, O_TU, O_TG, O_E_IC, O_IBETA, O_Q_INFIL, O_Q_EXFIL, O_Q_RECH,
  N_CELL_OUT
};

// the assembly's float32 inputs (rhs._RHS_ASSEMBLE_FIELDS): per cell [ne]
// (the state, the forcing, the mesh, the cell kernel's rows), the edge
// fluxes [ne, 3], per segment [ns], per reach [nr] (the state's stages
// first)
enum AsmField {
  A_SF, A_NET_PRCP, A_FU_SUB, A_ELE_QBC, A_ELE_QSS, A_AREA, A_SY,
  A_AQ_DEPTH, A_DEPRESSION, A_GW, A_EFF_KH, A_ES, A_EU, A_EG, A_TU, A_TG,
  A_Q_INFIL, A_Q_EXFIL, A_Q_RECH,
  A_Q_SURF, A_Q_SUB,
  A_SEG_CWR, A_SEG_LENGTH,
  A_RIV, A_RIV_YBC, A_RIV_QBC, A_RIV_DEPTH, A_RIV_KSAT_H, A_RIV_BED_THICK,
  A_RIV_BANK_SLOPE, A_RIV_BOTTOM_WIDTH, A_RIV_BED_SLOPE, A_RIV_DIST2DOWN,
  A_RIV_AVG_ROUGH, A_RIV_LENGTH, N_ASM_FIELDS
};
// its int64 inputs: per cell, per segment, per reach, then the gather
// lists [n, k] (padded with the index of the values' appended zero: ns,
// ns, nr)
enum AsmFlag {
  A_I_BC, A_I_SS, A_SEG_ELE, A_SEG_RIV, A_RIV_BC, A_RIV_DOWN,
  A_RIV_TO_LAKE, A_RIV_OUTLET_CODE, A_SEG_TO_ELE, A_SEG_TO_RIV,
  A_RIV_TO_DOWN, N_ASM_FLAGS
};
// its output rows in one buffer: per cell [ne], per segment [ns], per
// reach [nr] (rhs._RHS_CELL_SUMS, _RHS_SEG_OUT, _RHS_RIV_OUT)
enum CellSum { Q_SURF_TOT, Q_SUB_TOT, Q_E2R_SURF, Q_E2R_SUB, N_CELL_SUMS };
enum SegOut { SEG_ISF_RAW, SEG_ISF, Q_SEG_SURF, Q_SEG_SUB, N_SEG_OUT };
enum RivOut {
  RIV_STAGE, R_TOPW, R_CSA, R_PER, R_HYD, S_DOWN, S_OUT, Q_RIV_DOWN,
  Q_RIV_SURF, Q_RIV_SUB, Q_RIV_UP, D_AREA_RAW, D_AREA, N_RIV_OUT
};
// the gather sums torch may take in the assembly's place (rhs._RHS_GIVEN):
// [ne] the first two, [nr] the rest
enum Given {
  G_E2R_SURF, G_E2R_SUB, G_RIV_SURF, G_RIV_SUB, G_RIV_UP, N_GIVEN
};

struct CellArgs {
  const float* f[N_CELL_FIELDS];
  const long long* i[N_CELL_FLAGS];
  float* out;  // [N_CELL_OUT, ne]
  int ne;
};

struct AsmArgs {
  const float* f[N_ASM_FIELDS];
  const long long* i[N_ASM_FLAGS];
  float* dy;     // [3 ne + nr]: dsf, dus, dgw, driv
  float* q_esub;  // [ne, 3]
  float* out;    // [N_CELL_SUMS, ne], [N_SEG_OUT, ns], [N_RIV_OUT, nr]
  int ne, ns, nr;
  int k_ele, k_riv, k_up;  // the gather lists' widths
  int w_ele, w_riv, w_up;  // torch's threads a row of each list's sum
  const float* given[N_GIVEN];  // each null, or torch's sum to take
  int pre;  // 1: only the segments' rows and the reaches' first 8 rows
};

// ---------------------------------------------------------------------------
// physics.py's helpers as PyTorch's kernels compute them
// ---------------------------------------------------------------------------

// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}
// physics.absolute: where(x >= 0, x, -x)
__device__ __forceinline__ float absolute(float x) {
  return x >= 0.f ? x : -x;
}
// physics.cbrt: powf and one Newton step, 0 unless x > 0
__device__ __forceinline__ float cbrt_plain(float x) {
  if (!(x > 0.f)) return 0.f;
  const float t = powf(x, kThird);
  return (2.f * t + x / (t * t)) * kThird;
}
__device__ __forceinline__ float pow23(float x) {
  const float t = cbrt_plain(tmax(x, kTiny));
  return t * t;
}
// physics.sat_k_fun
__device__ __forceinline__ float sat_k_fun(float satn, float n) {
  const float temp = -1.f + powf(1.f - powf(satn, n / (n - 1.f)),
                                 (n - 1.f) / n);
  return sqrtf(satn) * temp * temp;
}
// physics.manning_equation
__device__ __forceinline__ float manning(float area, float rough, float r,
                                         float s) {
  const float q = sqrtf(tmax(absolute(s), kTiny)) * area * pow23(r) / rough;
  return s > 0.f ? q : -q;
}

// torch.sum over the last dimension of a contiguous [n, k] float32 tensor
// on CUDA, one row: PyTorch's reduce kernel gives a row *width* threads (a
// power of two, edge.sum_threads); thread t adds elements t, t + width,
// ... into four accumulators from 0 (four at a time, then the rest one
// each) and combines them in order; the threads' sums meet in a tree of
// halving offsets (width / 2, ..., 2, 1: thread t adds thread t + offset's
// sum), so thread 0 holds ((t0 + t2) + (t1 + t3)) at width 4.  That tree is
// the pairwise one of neighbours over the threads in bit-reversed order,
// which is how it is summed here, leaf by leaf.  load(j, x) gives the
// row's element j as N values, summed alongside.  This is torch's order
// up to 127 elements a row (from 128 each thread loads four neighbours at
// a time), which torch sums over at most kMaxSumThreads threads (the
// depth of the stack).
template <int N, class Load>
__device__ __forceinline__ void torch_row_sum(int k, int width,
                                              const Load& load,
                                              float (&sum)[N]) {
  int bits = 0;
  while ((1 << bits) < width) ++bits;
  float stack[kSumDepth][N];
  int depth = 0;
  for (int leaf = 0; leaf < width; ++leaf) {
    const int t =
        bits == 0 ? 0 : static_cast<int>(__brev(leaf) >> (32 - bits));
    float v[4][N];
    for (int a = 0; a < 4; ++a)
      for (int j = 0; j < N; ++j) v[a][j] = 0.f;
    float x[N];
    int idx = t;
    while (idx + 3 * width < k) {
      for (int a = 0; a < 4; ++a) {
        load(idx + a * width, x);
        for (int j = 0; j < N; ++j) v[a][j] = v[a][j] + x[j];
      }
      idx += 4 * width;
    }
    for (int a = 0; a < 4 && idx < k; ++a, idx += width) {
      load(idx, x);
      for (int j = 0; j < N; ++j) v[a][j] = v[a][j] + x[j];
    }
    float cur[N];
    for (int j = 0; j < N; ++j)
      cur[j] = ((v[0][j] + v[1][j]) + v[2][j]) + v[3][j];
    // a left neighbour's sum waits for each trailing one bit of leaf
    for (int m = leaf; m & 1; m >>= 1) {
      --depth;
      for (int j = 0; j < N; ++j) cur[j] = stack[depth][j] + cur[j];
    }
    for (int j = 0; j < N; ++j) stack[depth][j] = cur[j];
    ++depth;
  }
  for (int j = 0; j < N; ++j) sum[j] = stack[0][j];
}

// ---------------------------------------------------------------------------
// the cell kernel: the head BC, update_element, et_flux, flux_infiltration
// and flux_recharge of rhs._rhs on a lake-free mesh
// ---------------------------------------------------------------------------

__device__ __forceinline__ void rhs_cell(const CellArgs& a, int i) {
  const float* const* f = a.f;
  const float sf = f[SF][i], us = f[US][i];
  const float gw = a.i[I_BC][i] > 0 ? f[ELE_YBC][i] : f[GW][i];
  const float aq = f[AQ_DEPTH][i], ts = f[THETA_S][i], tr = f[THETA_R][i];

  // update_element: physics.eff_kh
  const float mac_d = f[MAC_D][i], k_mac = f[MAC_KSAT_H][i];
  const float af = f[GEO_V_AREA_F][i], k_mx = f[KSAT_H][i];
  const bool below_mac = (mac_d <= kZero) || (gw < aq - mac_d);
  const float full = (k_mac * mac_d * af + k_mx * (aq - mac_d * af)) / aq;
  const float part_num = k_mac * (gw - (aq - mac_d)) * af +
                         k_mx * (aq - mac_d + (gw - (aq - mac_d)) * (1.f - af));
  const float part = part_num / (gw == 0.f ? 1.f : gw);
  const float eff_kh = below_mac ? k_mx : (gw > aq ? full : part);
  // deficit, theta, satn, the van Genuchten conductivity
  const float ksv_i = f[INF_KSAT_V][i], haf = f[H_AREA_F][i];
  const float ksv_m = f[MAC_KSAT_V][i];
  const float kmax = ksv_i * (1.f - haf) + ksv_m * haf;
  const float def_raw = aq - gw;
  const bool saturated = def_raw <= 0.f;
  const float deficit = tmax(def_raw, 0.f);
  const float theta_raw = us / (saturated ? 1.f : deficit) * ts;
  float theta = saturated ? ts : theta_raw;
  float satn = saturated ? 1.f : (theta - tr) / (ts - tr);
  const bool hi = satn > kSatHi;
  const bool lo = satn <= kZero;
  const float sat_kr_mid = sat_k_fun(clip(satn, kClipLo, kClipHi), f[BETA][i]);
  satn = hi ? 1.f : (lo ? 0.f : satn);
  const float sat_kr = hi ? 1.f : (lo ? 0.f : sat_kr_mid);
  theta = hi ? ts : (lo ? tr : theta);

  // et_flux
  const float va = f[VEG_FRAC][i], vb = 1.f - va;
  const float pj = 1.f - f[IMP_AF][i];
  const float fc = ts * 0.75f;
  const float beta_s = clip((satn * (ts - tr) - tr) / (fc - tr), 0.f, 1.f);
  const float ibeta = 0.5f * (1.f - cosf(kPi * beta_s));
  const float pe = f[POT_EVAP][i];
  const float es = tmin(tmax(sf, 0.f), pe) * vb;
  const float rem = pe - es;
  const bool some_left = es < pe;
  const bool gw_high = gw > f[WETLAND_LEVEL][i];
  const float eg =
      (some_left && gw_high) ? tmin(tmax(gw, 0.f), rem) * pj * vb : 0.f;
  const float eu = (some_left && !gw_high)
                       ? tmin(tmax(us, 0.f), ibeta * rem) * pj * vb
                       : 0.f;
  const float pot_tran = f[POT_TRAN][i], e_ic = f[E_IC][i];
  const bool has_veg = f[LAI][i] > kZero;
  const bool ic_dominates = e_ic >= pot_tran;
  const bool root_deep = gw > f[ROOTREACH_LEVEL][i];
  const float tg = (has_veg && !ic_dominates && root_deep)
                       ? tmin(tmax(gw, 0.f), pot_tran - e_ic) * pj * va
                       : 0.f;
  const float tu =
      (has_veg && !ic_dominates && !root_deep)
          ? tmin(tmax(us, 0.f), ibeta * (pot_tran - e_ic)) * pj * va
          : 0.f;
  const float e_ic_out =
      has_veg ? (ic_dominates ? pot_tran * pj * va : e_ic) : 0.f;

  // flux_infiltration
  const float inf_d = f[INF_D][i];
  const float av = sf + f[NET_PRCP][i];
  const bool gw_at_surface = (gw + us > aq) || (deficit < us);
  const float qex_raw = absolute(gw + us - aq) / aq * kmax;
  const float grad = 1.f + av / inf_d;
  const bool heavy = av > kmax, medium = av > ksv_i;
  const float effk =
      heavy ? ksv_i * (1.f - haf) + haf * ksv_m * satn
            : (medium ? sat_kr * ksv_i * (1.f - haf) + haf * ksv_m * satn
                      : sat_kr * ksv_i * (1.f - haf));
  float qi = tmin(av, tmax(grad * effk, 0.f));
  qi = (av > 0.f && deficit > inf_d) ? qi : 0.f;
  qi = gw_at_surface ? 0.f : qi;
  const float qex = gw_at_surface ? qex_raw : 0.f;
  const float fu_surf = f[FU_SURF][i];

  // flux_recharge
  const float ksv = f[KSAT_V][i], tfc = f[THETA_FC][i];
  const bool skip = (gw > aq - inf_d) && (us < deficit);
  const float grad_r = (theta > tr && us > kEps)
                           ? tmax((theta - tr) / (tfc - tr), 0.f)
                           : 0.f;
  const float ku = ksv_i * sat_kr;
  const float denom = deficit * ksv + gw * ku;
  const float ke0 = ku * ksv * (deficit + gw) / (denom == 0.f ? 1.f : denom);
  const float ke = denom == 0.f ? 0.f : ke0;
  float qr = (ksv_i <= 0.f || ksv <= 0.f) ? 0.f : grad_r * ke;
  qr = skip ? 0.f : qr;

  const int n = a.ne;
  float* o = a.out;
  o[O_GW * n + i] = gw;
  o[O_EFF_KH * n + i] = eff_kh;
  o[O_DEFICIT * n + i] = deficit;
  o[O_SATN * n + i] = satn;
  o[O_SAT_KR * n + i] = sat_kr;
  o[O_THETA * n + i] = theta;
  o[O_KMAX * n + i] = kmax;
  o[O_ES * n + i] = es;
  o[O_EU * n + i] = eu;
  o[O_EG * n + i] = eg;
  o[O_TU * n + i] = tu;
  o[O_TG * n + i] = tg;
  o[O_E_IC * n + i] = e_ic_out;
  o[O_IBETA * n + i] = ibeta;
  o[O_Q_INFIL * n + i] = qi * fu_surf;
  o[O_Q_EXFIL * n + i] = qex * fu_surf;
  o[O_Q_RECH * n + i] = qr * f[FU_SUB][i];
}

__global__ void rhs_cell_kernel(CellArgs a, unsigned long long* count) {
  const int start = blockIdx.x * blockDim.x + threadIdx.x;
  if (start == 0) atomicAdd(count, 1ULL);
  for (int i = start; i < a.ne; i += gridDim.x * blockDim.x) rhs_cell(a, i);
}

// ---------------------------------------------------------------------------
// the assembly: segments, reaches, and each cell's sums and derivatives
// ---------------------------------------------------------------------------

// a reach's stage after the stage BC
__device__ __forceinline__ float stage(const AsmArgs& a, int r) {
  return a.i[A_RIV_BC][r] > 0 ? a.f[A_RIV_YBC][r] : a.f[A_RIV][r];
}

struct Segment {
  float isf_raw, isf, surf, sub;
};

// one segment's fluxes, river -> cell positive: physics.weir_flow_jtoi and
// physics.flux_r2e_gw in the local-datum form (z_surf and z_bottom
// subtracted), the bed flux times the cell's fu_sub
__device__ __forceinline__ Segment segment(const AsmArgs& a, int s) {
  const float* const* f = a.f;
  const int e = static_cast<int>(a.i[A_SEG_ELE][s]);
  const int r = static_cast<int>(a.i[A_SEG_RIV][s]);
  Segment g;
  g.isf_raw = f[A_SF][e] - f[A_Q_INFIL][e] + f[A_Q_EXFIL][e];
  g.isf = tmax(g.isf_raw, 0.f);
  const float depth = f[A_RIV_DEPTH][r];
  const float rs = stage(a, r);
  const float cwr = f[A_SEG_CWR][s], length = f[A_SEG_LENGTH][s];
  const float thr = f[A_DEPRESSION][e];
  // weir_flow_jtoi(0, isf, -depth, rs, 0, cwr, length, depression)
  const float hi = g.isf + 0.f;
  const float hj = rs + -depth;
  const float dh = hj - hi;
  const float y0 = hi - 0.f;
  const float y_pos = hi > 0.f ? dh : y0;
  const float q_pos = (y0 > 0.f && rs > thr)
                          ? cwr * sqrtf(k2Grav * tmax(y_pos, kTiny)) *
                                length * y_pos * 60.f
                          : 0.f;
  const float y_neg = hj > 0.f ? -dh : y0;
  const float q_neg = (y0 > 0.f && g.isf > thr)
                          ? -cwr * sqrtf(k2Grav * tmax(y_neg, kTiny)) *
                                length * y_neg * 60.f
                          : 0.f;
  g.surf = dh > 0.f ? q_pos : q_neg;
  // flux_r2e_gw(rs, aq_depth - depth, gw, 0, eff_kh, ksat_h, length, bed)
  const float yr = rs, zr = f[A_AQ_DEPTH][e] - depth, ye = f[A_GW][e];
  const float k_ele = f[A_EFF_KH][e], k_riv = f[A_RIV_KSAT_H][r];
  const float k = 0.5f * (k_ele + k_riv);
  const float he = ye + 0.f;
  const float hr = yr + zr;
  const float dhr = hr - he;
  const float grad = dhr / f[A_RIV_BED_THICK][r];
  const float a_r2e =
      he > zr ? (yr + (he - zr)) * 0.5f * length : yr * length;
  const float q_r2e = yr < kEps ? 0.f : a_r2e * k * grad;
  const float a_e2r = (yr + (he - zr)) * 0.5f * length;
  const float q_e2r = ye > kZero ? a_e2r * k * grad : 0.f;
  float q = dhr > kZero ? q_r2e : (dhr < kNegZero ? q_e2r : 0.f);
  q = (k_ele < kZero || k_riv < kZero) ? 0.f : q;
  g.sub = q * f[A_FU_SUB][e];
  return g;
}

struct Reach {
  float rs, topw, csa, per, hyd, s_down, s_out, down;
};

// one reach's geometry (River.cpp:49-62) and downstream discharge
// (Flux_RiverDown): Manning down the chain, the outlets' zero-depth
// gradient and critical depth, lake-bound reaches' zero-depth gradient
__device__ __forceinline__ Reach reach(const AsmArgs& a, int r) {
  const float* const* f = a.f;
  Reach c;
  const float rs = stage(a, r);
  const float bs = f[A_RIV_BANK_SLOPE][r], bw = f[A_RIV_BOTTOM_WIDTH][r];
  c.rs = rs;
  c.topw = tmax(rs * bs * 2.f + bw, 0.f);
  c.csa = tmax(rs * (bw + rs * bs), 0.f);
  c.per = tmax(2.f * absolute(rs) * sqrtf(1.f + bs * bs) + bw, 0.f);
  const long long down = a.i[A_RIV_DOWN][r];
  const bool has_down = down >= 0;
  const int dn = has_down ? static_cast<int>(down) : 0;
  const float* slope = f[A_RIV_BED_SLOPE];
  const float* depth = f[A_RIV_DEPTH];
  const float s_mean = 0.5f * (slope[r] + slope[dn]);
  c.s_down = ((rs - depth[r]) - (stage(a, dn) - depth[dn])) /
                 f[A_RIV_DIST2DOWN][r] + s_mean;
  const bool small = c.per <= kZero;
  c.hyd = small ? 0.f : c.csa / (small ? 1.f : c.per);
  const float rough = f[A_RIV_AVG_ROUGH][r];
  const float q_int = manning(c.csa, rough, c.hyd, c.s_down);
  c.s_out = slope[r] + rs * 2.f / f[A_RIV_LENGTH][r];
  const float q_zdg = manning(c.csa, rough, c.hyd, c.s_out);
  const float q_crit = c.csa * sqrtf(kGrav * tmax(rs, kRsFloor)) * 60.f;
  const bool to_lake = a.i[A_RIV_TO_LAKE][r] >= 0;
  c.down = to_lake
               ? q_zdg
               : (has_down ? q_int
                           : (a.i[A_RIV_OUTLET_CODE][r] == -4 ? q_crit
                                                                : q_zdg));
  return c;
}

__device__ __forceinline__ void assemble_cell(const AsmArgs& a, int i) {
  const float* const* f = a.f;
  const int ns = a.ns;
  // the segments' fluxes into the cell, as gather_sum(-q_seg_*, seg_to_ele)
  const long long* list = a.i[A_SEG_TO_ELE] + static_cast<long long>(i) *
                                                   a.k_ele;
  float e2r[2];
  if (a.given[G_E2R_SURF]) {
    e2r[0] = a.given[G_E2R_SURF][i];
    e2r[1] = a.given[G_E2R_SUB][i];
  } else {
    torch_row_sum<2>(a.k_ele, a.w_ele, [&](int j, float (&x)[2]) {
      const long long s = list[j];
      if (s == ns) {
        x[0] = x[1] = 0.f;
      } else {
        const Segment g = segment(a, static_cast<int>(s));
        x[0] = -g.surf;
        x[1] = -g.sub;
      }
    }, e2r);
  }
  // the three edges: q_esub = q_sub * fu_sub, then each row's sum
  const float fu_sub = f[A_FU_SUB][i];
  const float* q_surf = f[A_Q_SURF] + 3 * static_cast<long long>(i);
  const float* q_sub = f[A_Q_SUB] + 3 * static_cast<long long>(i);
  float q_esub[3];
  for (int j = 0; j < 3; ++j) q_esub[j] = q_sub[j] * fu_sub;
  float edge[2];
  torch_row_sum<2>(3, 2, [&](int j, float (&x)[2]) {
    x[0] = q_surf[j];
    x[1] = q_esub[j];
  }, edge);
  const float q_surf_tot = e2r[0] + edge[0];
  const float q_sub_tot = e2r[1] + edge[1];

  const float area = f[A_AREA][i];
  const float qi = f[A_Q_INFIL][i], qx = f[A_Q_EXFIL][i];
  const float qr = f[A_Q_RECH][i];
  float dsf = f[A_NET_PRCP][i] - qi + qx - q_surf_tot / area - f[A_ES][i];
  float dus = qi - qr - f[A_EU][i] - f[A_TU][i];
  float dgw = qr - qx - q_sub_tot / area - f[A_EG][i] - f[A_TG][i];
  // BC / SS terms
  const long long i_bc = a.i[A_I_BC][i], i_ss = a.i[A_I_SS][i];
  const float qss = f[A_ELE_QSS][i] / area;
  dgw = i_bc > 0 ? 0.f : dgw;
  dgw = dgw + (i_bc < 0 ? f[A_ELE_QBC][i] / area : 0.f);
  dsf = dsf + (i_ss > 0 ? qss : 0.f);
  dgw = dgw + (i_ss < 0 ? qss : 0.f);
  const float sy = f[A_SY][i];

  const int n = a.ne;
  a.dy[i] = dsf;
  a.dy[n + i] = dus / sy;
  a.dy[2 * n + i] = dgw / sy;
  for (int j = 0; j < 3; ++j) a.q_esub[3 * static_cast<long long>(i) + j] =
      q_esub[j];
  float* o = a.out;
  o[Q_SURF_TOT * n + i] = q_surf_tot;
  o[Q_SUB_TOT * n + i] = q_sub_tot;
  o[Q_E2R_SURF * n + i] = e2r[0];
  o[Q_E2R_SUB * n + i] = e2r[1];
}

__device__ __forceinline__ void assemble_segment(const AsmArgs& a, int s) {
  const Segment g = segment(a, s);
  const int ns = a.ns;
  float* o = a.out + N_CELL_SUMS * a.ne;
  o[SEG_ISF_RAW * ns + s] = g.isf_raw;
  o[SEG_ISF * ns + s] = g.isf;
  o[Q_SEG_SURF * ns + s] = g.surf;
  o[Q_SEG_SUB * ns + s] = g.sub;
}

// a reach's rows that no gather sum reads: its geometry and discharge
__device__ __forceinline__ void reach_rows(const AsmArgs& a, int r,
                                           const Reach& c) {
  const int nr = a.nr;
  float* o = a.out + N_CELL_SUMS * a.ne + N_SEG_OUT * a.ns;
  o[RIV_STAGE * nr + r] = c.rs;
  o[R_TOPW * nr + r] = c.topw;
  o[R_CSA * nr + r] = c.csa;
  o[R_PER * nr + r] = c.per;
  o[R_HYD * nr + r] = c.hyd;
  o[S_DOWN * nr + r] = c.s_down;
  o[S_OUT * nr + r] = c.s_out;
  o[Q_RIV_DOWN * nr + r] = c.down;
}

__device__ __forceinline__ void assemble_reach(const AsmArgs& a, int r) {
  const float* const* f = a.f;
  const int ns = a.ns, nr = a.nr;
  const Reach c = reach(a, r);
  // gather_sum(q_seg_*, seg_to_riv), gather_sum(-q_riv_down, riv_to_down)
  const long long* segs = a.i[A_SEG_TO_RIV] + static_cast<long long>(r) *
                                                  a.k_riv;
  float in[2];
  if (a.given[G_RIV_SURF]) {
    in[0] = a.given[G_RIV_SURF][r];
    in[1] = a.given[G_RIV_SUB][r];
  } else {
    torch_row_sum<2>(a.k_riv, a.w_riv, [&](int j, float (&x)[2]) {
      const long long s = segs[j];
      if (s == ns) {
        x[0] = x[1] = 0.f;
      } else {
        const Segment g = segment(a, static_cast<int>(s));
        x[0] = g.surf;
        x[1] = g.sub;
      }
    }, in);
  }
  const long long* ups = a.i[A_RIV_TO_DOWN] + static_cast<long long>(r) *
                                                  a.k_up;
  float up[1];
  if (a.given[G_RIV_UP]) {
    up[0] = a.given[G_RIV_UP][r];
  } else {
    torch_row_sum<1>(a.k_up, a.w_up, [&](int j, float (&x)[1]) {
      const long long u = ups[j];
      x[0] = u == nr ? 0.f : -reach(a, static_cast<int>(u)).down;
    }, up);
  }
  // dA -> dy (physics.fun_da_to_dy) and the stage BC
  const float da_raw =
      (-up[0] - in[0] - in[1] - c.down + f[A_RIV_QBC][r]) /
      f[A_RIV_LENGTH][r];
  const float da = tmax(da_raw, -c.csa);
  const float w = c.topw;
  const float s_abs = absolute(f[A_RIV_BANK_SLOPE][r]);
  const float cc = w * w + 4.f * s_abs * da;
  const float denom = w + sqrtf(tmax(cc, kTiny));
  const float quad =
      cc < kZero ? -w / (2.f * s_abs) : 2.f * da / (denom <= 0.f ? 1.f : denom);
  float driv = s_abs < kFlatSlope ? da / w : quad;
  driv = da == 0.f ? 0.f : driv;
  driv = a.i[A_RIV_BC][r] > 0 ? 0.f : driv;

  a.dy[3 * a.ne + r] = driv;
  reach_rows(a, r, c);
  float* o = a.out + N_CELL_SUMS * a.ne + N_SEG_OUT * ns;
  o[Q_RIV_SURF * nr + r] = in[0];
  o[Q_RIV_SUB * nr + r] = in[1];
  o[Q_RIV_UP * nr + r] = up[0];
  o[D_AREA_RAW * nr + r] = da_raw;
  o[D_AREA * nr + r] = da;
}

__global__ void rhs_assemble_kernel(AsmArgs a, unsigned long long* count) {
  const int start = blockIdx.x * blockDim.x + threadIdx.x;
  if (start == 0) atomicAdd(count, 1ULL);
  // the pre launch skips the cells and the reaches' sums
  const int first = a.pre ? a.ne : 0;
  const int total = a.ne + a.ns + a.nr;
  for (int k = first + start; k < total; k += gridDim.x * blockDim.x) {
    if (k < a.ne)
      assemble_cell(a, k);
    else if (k < a.ne + a.ns)
      assemble_segment(a, k - a.ne);
    else if (a.pre)
      reach_rows(a, k - a.ne - a.ns, reach(a, k - a.ne - a.ns));
    else
      assemble_reach(a, k - a.ne - a.ns);
  }
}

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace

extern "C" {

// fields: N_CELL_FIELDS float32 [ne] pointers, then N_CELL_FLAGS int64
// [ne] pointers; out: [N_CELL_OUT, ne]
int shud_rhs_cell(const void* const* fields, float* out,
                  unsigned long long* count, int ne, cudaStream_t stream) {
  CellArgs a;
  for (int k = 0; k < N_CELL_FIELDS; ++k)
    a.f[k] = static_cast<const float*>(fields[k]);
  for (int k = 0; k < N_CELL_FLAGS; ++k)
    a.i[k] = static_cast<const long long*>(fields[N_CELL_FIELDS + k]);
  a.out = out;
  a.ne = ne;
  rhs_cell_kernel<<<blocks_for(ne), kThreads, 0, stream>>>(a, count);
  return static_cast<int>(cudaGetLastError());
}

// fields: N_ASM_FIELDS float32 pointers, then N_ASM_FLAGS int64 pointers;
// dims: ne, ns, nr, the widths of seg_to_ele, seg_to_riv and riv_to_down,
// torch's threads a row of each one's sum, and pre (1: the first of two
// launches);
// given: N_GIVEN pointers, each null or torch's sum (Given);
// dy: [3 ne + nr]; q_esub: [ne, 3]; out: the rows of the sums, segments
// and reaches
int shud_rhs_assemble(const void* const* fields, const int* dims,
                      const void* const* given, float* dy, float* q_esub,
                      float* out, unsigned long long* count,
                      cudaStream_t stream) {
  AsmArgs a;
  for (int k = 0; k < N_ASM_FIELDS; ++k)
    a.f[k] = static_cast<const float*>(fields[k]);
  for (int k = 0; k < N_ASM_FLAGS; ++k)
    a.i[k] = static_cast<const long long*>(fields[N_ASM_FIELDS + k]);
  a.dy = dy;
  a.q_esub = q_esub;
  a.out = out;
  a.ne = dims[0];
  a.ns = dims[1];
  a.nr = dims[2];
  a.k_ele = dims[3];
  a.k_riv = dims[4];
  a.k_up = dims[5];
  a.w_ele = dims[6];
  a.w_riv = dims[7];
  a.w_up = dims[8];
  a.pre = dims[9];
  for (int k = 0; k < N_GIVEN; ++k)
    a.given[k] = static_cast<const float*>(given[k]);
  // a list's sums are torch's (a pair both given) or the kernel's, and
  // then in an order it keeps
  if (!a.given[G_E2R_SURF] != !a.given[G_E2R_SUB] ||
      !a.given[G_RIV_SURF] != !a.given[G_RIV_SUB])
    return static_cast<int>(cudaErrorInvalidValue);
  const bool own[3] = {!a.given[G_E2R_SURF], !a.given[G_RIV_SURF],
                       !a.given[G_RIV_UP]};
  const int width[3] = {a.w_ele, a.w_riv, a.w_up};
  for (int k = 0; k < 3; ++k)
    if (!a.pre && own[k] && (width[k] < 1 || width[k] > kMaxSumThreads))
      return static_cast<int>(cudaErrorInvalidValue);
  rhs_assemble_kernel<<<blocks_for(a.ne + a.ns + a.nr), kThreads, 0,
                        stream>>>(a, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
