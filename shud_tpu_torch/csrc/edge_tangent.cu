// The edge path's tangent factors for Hopper (sm_90a), with a plain C
// interface.
//
// rhs.linearize runs the primal RHS once per Newton iteration and keeps the
// chain-rule factors of every term of the RHS beside the edge kernels'
// coefficients; its J.v closure (rhs._tangent) is tensor arithmetic on
// them.  Their plain version is PyTorch on the primal's intermediates
// (rhs._tangent_factors: _cell_update_lin, _vertical_lin, the segment weir
// and bed factors, _reach_lin, fun_da_to_dy_lin), some 870 elementwise
// kernels a call on the card.  JAX has no kernel here: XLA fuses
// jax.linearize of rhs.  Two kernels compute the same factors:
//   tangent_cell_kernel   one thread per cell: the 3x3 local Jacobian of
//                         (dsf, dus, dgw), a_surf, a_sub, d eff_kh / d gw,
//                         the head-BC mask, and the three per-cell sums
//                         the segment factors gather;
//   tangent_reach_kernel  one thread per segment, then one per reach: the
//                         weir and bed factors of each segment, each
//                         reach's downstream discharge and dA -> dy
//                         factors, the river-BC mask and the downstream
//                         index.
// The second reads the first's outputs, so they are two launches on one
// stream.  Lake-bank edges and lakes keep their PyTorch factors.
//
// Every expression keeps the plain version's order of operations, a
// Python number enters as PyTorch rounds it to float32 (the constants
// below), x / t with a number x is PyTorch's reciprocal(t) * x, maximum and
// minimum propagate NaN as torch.maximum does, and the calls are the CUDA
// math functions PyTorch's kernels call (powf with a tensor exponent,
// sinf, sqrtf; the cube root as physics.cbrt).  The build fuses no
// multiply-add (--fmad=false), so each output is its plain version's to
// the last bit and a solve on the kernels follows the plain solve exactly.
//
// What bounds them: bytes.  The cell kernel reads 36 float32 fields and
// two int64 flags of a cell once, coalesced (one array a field), and
// writes 16 float32 rows: 224 B a cell, 29.4 MB at 131,072 cells, 8.8 us
// at 3.35 TB/s.  Its arithmetic (four powf, one sinf, a dozen divides) is
// far below the card's rate.  The reach kernel works on a few hundred
// segments and reaches; it costs about one launch.  Both run a
// grid-stride loop, so a block count capped below the mesh's size covers
// the 2M-cell mesh as well.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the caller allocates every output.  Each kernel adds
// one to *count (a device counter of edge.py's) where it runs, so that a
// launch replayed from a CUDA graph is counted as well.

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
constexpr float kTwoThirds = static_cast<float>(2.0 / 3.0);
constexpr float kFlatSlope = static_cast<float>(0.05e-6);
constexpr float kRsFloor = static_cast<float>(1e-30);
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

// the cell kernel's float32 inputs, [ne] each (rhs._TANGENT_CELL_FIELDS)
enum CellField {
  SF, US, GW, DEFICIT, SATN, SAT_KR, THETA, KMAX, IBETA,
  POT_EVAP, LAI, E_IC, POT_TRAN, NET_PRCP, FU_SURF, FU_SUB,
  AQ_DEPTH, THETA_S, THETA_R, MAC_D, MAC_KSAT_H, GEO_V_AREA_F, KSAT_H, BETA,
  VEG_FRAC, IMP_AF, WETLAND_LEVEL, ROOTREACH_LEVEL, INF_D, INF_KSAT_V,
  H_AREA_F, MAC_KSAT_V, KSAT_V, THETA_FC, SY, AREA, N_CELL_FIELDS
};
// its int64 inputs, [ne] each
enum CellFlag { I_BC, I_LAKE, N_CELL_FLAGS };
// its output rows, [ne] each (rhs._TANGENT_CELL_OUT)
enum CellOut {
  LJ_SSF, LJ_SUS, LJ_SGW, LJ_USF, LJ_UUS, LJ_UGW, LJ_GSF, LJ_GUS, LJ_GGW,
  A_SURF, A_SUB, KH_GW, KEEP_GW, SUM_SF, SUM_US, SUM_GW, N_CELL_OUT
};

// the reach kernel's float32 inputs (rhs._TANGENT_REACH_FIELDS): per
// segment [ns], per cell [ne] (gathered at a segment's cell), per reach
// [nr]
enum ReachField {
  SEG_ISF, SEG_ISF_RAW, SEG_CWR, SEG_LENGTH,
  C_DEPRESSION, C_AQ_DEPTH, C_GW, C_EFF_KH, C_FU_SUB, C_KH_GW, C_SUM_SF,
  C_SUM_US, C_SUM_GW,
  R_STAGE, R_DEPTH, R_KSAT_H, R_BED_THICK, R_BANK_SLOPE, R_BOTTOM_WIDTH,
  R_CSA, R_PER, R_HYD, R_S_DOWN, R_S_OUT, R_D_AREA_RAW, R_D_AREA, R_TOPW,
  R_AVG_ROUGH, R_DIST2DOWN, R_LENGTH, N_REACH_FIELDS
};
// its int64 inputs: per segment, then per reach
enum ReachFlag {
  SEG_ELE, SEG_RIV, RIV_BC, RIV_DOWN, RIV_TO_LAKE, RIV_OUTLET_CODE,
  N_REACH_FLAGS
};
// its output rows: per segment [ns], then per reach [nr]
enum SegOut { W_J, B_SF, B_US, B_GW, SB_RS, SB_GW, N_SEG_OUT };
enum RivOut { P_SELF, P_DN, DR_AREA, DR_RS, KEEP_RS, N_RIV_OUT };

struct CellArgs {
  const float* f[N_CELL_FIELDS];
  const long long* i[N_CELL_FLAGS];
  float* out;
  int ne;
  int lake;  // the mesh has lakes: lake cells' factors are 0
};

struct ReachArgs {
  const float* f[N_REACH_FIELDS];
  const long long* i[N_REACH_FLAGS];
  float* out;  // [N_SEG_OUT, ns] then [N_RIV_OUT, nr]
  long long* dn;
  int ns;
  int nr;
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
// physics.d_max, d_min, d_abs
__device__ __forceinline__ float d_max(float x, float v) {
  return x > v ? 1.f : (x == v ? 0.5f : 0.f);
}
__device__ __forceinline__ float d_min(float x, float v) {
  return x < v ? 1.f : (x == v ? 0.5f : 0.f);
}
__device__ __forceinline__ float d_abs(float x) {
  return x >= 0.f ? 1.f : -1.f;
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
__device__ __forceinline__ float pow23_lin(float x) {
  return d_max(x, kTiny) * kTwoThirds / cbrt_plain(tmax(x, kTiny));
}

// physics.sat_k_fun_lin
__device__ __forceinline__ float sat_k_fun_lin(float satn, float n) {
  const float p = n / (n - 1.f);
  const float q = (n - 1.f) / n;
  const float b = 1.f - powf(satn, p);
  const float temp = -1.f + powf(b, q);
  const float dtemp = q * powf(b, q - 1.f) * -(p * powf(satn, p - 1.f));
  const float root = sqrtf(satn);
  return temp * temp / (2.f * root) + 2.f * root * temp * dtemp;
}

// physics.manning_equation_lin: (d/d area, d/d r, d/d s)
struct Manning {
  float area, r, s;
};
__device__ __forceinline__ Manning manning_lin(float area, float rough,
                                               float r, float s) {
  const float abs_s = absolute(s);
  const float sqrt_s = sqrtf(tmax(abs_s, kTiny));
  const float p23 = pow23(r);
  const float sgn = s > 0.f ? 1.f : -1.f;
  Manning c;
  c.area = sgn * sqrt_s * p23 / rough;
  c.r = sgn * sqrt_s * area * pow23_lin(r) / rough;
  c.s = sgn * d_max(abs_s, kTiny) * d_abs(s) / (2.f * sqrt_s) * area * p23 /
        rough;
  return c;
}

// physics._weir_f_lin
__device__ __forceinline__ float weir_f_lin(float y, float cwr, float width) {
  const float root = sqrtf(k2Grav * tmax(y, kTiny));
  return cwr * (kGrav * d_max(y, kTiny) / root * y + root) * width * 60.f;
}

// ---------------------------------------------------------------------------
// the cell kernel: rhs._cell_update_lin, rhs._vertical_lin and the cell
// factors of rhs._tangent_factors
// ---------------------------------------------------------------------------

// d/d sf, d/d us, d/d gw of one vertical flux
struct D3 {
  float sf, us, gw;
};

__device__ __forceinline__ void tangent_cell(const CellArgs& a, int i) {
  const float* const* f = a.f;
  const float sf = f[SF][i], us = f[US][i], gw = f[GW][i];
  const float aq = f[AQ_DEPTH][i], ts = f[THETA_S][i], tr = f[THETA_R][i];
  const bool is_lake = a.lake && a.i[I_LAKE][i] > 0;

  // _cell_update_lin: eff_kh's d part / d gw
  const float mac_d = f[MAC_D][i];
  const bool below = (mac_d <= kZero) || (gw < aq - mac_d);
  const float g = gw == 0.f ? 1.f : gw;
  const float k_mac = f[MAC_KSAT_H][i], af = f[GEO_V_AREA_F][i];
  const float k_mx = f[KSAT_H][i];
  const float aqm = aq - mac_d;
  const float part =
      (k_mac * (gw - aqm) * af + k_mx * (aqm + (gw - aqm) * (1.f - af))) / g;
  const float dpn = k_mac * af + k_mx * (1.f - af);
  float kh_gw = (below || gw > aq) ? 0.f : (gw == 0.f ? dpn : dpn - part) / g;
  // deficit, theta, satn
  const float def_raw = aq - gw;
  const bool sat = def_raw <= 0.f;
  float def_gw = -d_max(def_raw, 0.f);
  const float dd = sat ? 1.f : tmax(def_raw, 0.f);
  float th_us = sat ? 0.f : ts / dd;
  float th_gw = sat ? 0.f : -(us / dd) / dd * def_gw * ts;
  const float theta_l = sat ? ts : us / dd * ts;
  const float satn_l = sat ? 1.f : (theta_l - tr) / (ts - tr);
  float sn_us = th_us / (ts - tr), sn_gw = th_gw / (ts - tr);
  // the clip and van Genuchten branch, then the hi/lo overrides
  const bool edge = (satn_l > kSatHi) || (satn_l <= kZero);
  const float fclip =
      d_min(tmax(satn_l, kClipLo), kClipHi) * d_max(satn_l, kClipLo);
  const float kr_s =
      sat_k_fun_lin(clip(satn_l, kClipLo, kClipHi), f[BETA][i]) * fclip;
  float kr_us = kr_s * sn_us, kr_gw = kr_s * sn_gw;
  if (edge) sn_us = sn_gw = kr_us = kr_gw = th_us = th_gw = 0.f;
  if (is_lake) kh_gw = def_gw = sn_us = sn_gw = kr_us = kr_gw = th_us =
      th_gw = 0.f;

  // _vertical_lin: et_flux's ibeta through the clipped soil-moisture stress
  const float satn = f[SATN][i], ibeta = f[IBETA][i];
  const float va = f[VEG_FRAC][i], vb = 1.f - va;
  const float pj = 1.f - f[IMP_AF][i];
  const float fc = ts * 0.75f;
  const float bs_raw = (satn * (ts - tr) - tr) / (fc - tr);
  const float bs_f = d_min(tmax(bs_raw, 0.f), 1.f) * d_max(bs_raw, 0.f) *
                     (ts - tr) / (fc - tr);
  const float ib_f =
      0.5f * sinf(kPi * clip(bs_raw, 0.f, 1.f)) * kPi * bs_f;
  const float ib_us = ib_f * sn_us, ib_gw = ib_f * sn_gw;
  const float pe = f[POT_EVAP][i];
  const float a_sf = tmax(sf, 0.f);
  const float es_sf = d_min(a_sf, pe) * d_max(sf, 0.f) * vb;
  const float es_v = tmin(a_sf, pe) * vb;
  const float rem = pe - es_v;
  const bool some_left = es_v < pe;
  const bool gw_high = gw > f[WETLAND_LEVEL][i];
  const float a_gw = tmax(gw, 0.f), a_us = tmax(us, 0.f);
  const float m_gw = d_max(gw, 0.f), m_us = d_max(us, 0.f);
  float fv = pj * vb;
  bool on = some_left && gw_high;
  D3 eg = {on ? d_min(rem, a_gw) * -es_sf * fv : 0.f, 0.f,
           on ? d_min(a_gw, rem) * m_gw * fv : 0.f};
  on = some_left && !gw_high;
  float b = ibeta * rem;
  float w_a = d_min(a_us, b), w_b = d_min(b, a_us);
  D3 eu = {on ? w_b * ibeta * -es_sf * fv : 0.f,
           on ? (w_a * m_us + w_b * ib_us * rem) * fv : 0.f,
           on ? w_b * ib_gw * rem * fv : 0.f};
  const float pot_tran = f[POT_TRAN][i], e_ic = f[E_IC][i];
  const bool live = (f[LAI][i] > kZero) && !(e_ic >= pot_tran);
  const bool deep = gw > f[ROOTREACH_LEVEL][i];
  const float room = pot_tran - e_ic;
  fv = pj * va;
  on = live && deep;
  D3 tg = {0.f, 0.f, on ? d_min(a_gw, room) * m_gw * fv : 0.f};
  on = live && !deep;
  b = ibeta * room;
  w_a = d_min(a_us, b);
  w_b = d_min(b, a_us);
  D3 tu = {0.f, on ? (w_a * m_us + w_b * ib_us * room) * fv : 0.f,
           on ? w_b * ib_gw * room * fv : 0.f};
  D3 es = {es_sf, 0.f, 0.f};

  // flux_infiltration (no tangent across the gw + us > aq_depth switch)
  const float inf_d = f[INF_D][i], ksv_i = f[INF_KSAT_V][i];
  const float deficit = f[DEFICIT][i], kmax = f[KMAX][i];
  const float sat_kr = f[SAT_KR][i];
  const float av = sf + f[NET_PRCP][i];
  const bool gas = (gw + us > aq) || (deficit < us);
  const float qex_f = gas ? d_abs(gw + us - aq) / aq * kmax : 0.f;
  const float grad = 1.f + av / inf_d;
  const bool heavy = av > kmax, medium = av > ksv_i;
  const float haf = f[H_AREA_F][i];
  const float a1 = ksv_i * (1.f - haf), a2 = haf * f[MAC_KSAT_V][i];
  const float kr_a1 = sat_kr * ksv_i * (1.f - haf);
  const float effk =
      heavy ? a1 + a2 * satn : (medium ? kr_a1 + a2 * satn : kr_a1);
  const float effk_us =
      heavy ? a2 * sn_us : (medium ? kr_us * a1 + a2 * sn_us : kr_us * a1);
  const float effk_gw =
      heavy ? a2 * sn_gw : (medium ? kr_gw * a1 + a2 * sn_gw : kr_gw * a1);
  const float x = grad * effk;
  const float top = tmax(x, 0.f);
  const float w_av = d_min(av, top), w_x = d_min(top, av) * d_max(x, 0.f);
  on = (av > 0.f) && (deficit > inf_d) && !gas;
  const float fu = f[FU_SURF][i];
  D3 qi = {(on ? w_av + w_x * effk / inf_d : 0.f) * fu,
           (on ? w_x * grad * effk_us : 0.f) * fu,
           (on ? w_x * grad * effk_gw : 0.f) * fu};
  D3 qx = {0.f, qex_f * fu, qex_f * fu};

  // flux_recharge: the harmonic mean through d num and d denom
  const float ksv = f[KSAT_V][i], tfc = f[THETA_FC][i];
  const float theta = f[THETA][i];
  const float z = (theta - tr) / (tfc - tr);
  const bool cond = (theta > tr) && (us > kEps);
  const float grad_r = cond ? tmax(z, 0.f) : 0.f;
  const float ku = ksv_i * sat_kr;
  const float dsum = deficit + gw;
  const float denom = deficit * ksv + gw * ku;
  const bool flat = denom == 0.f;
  const float dsafe = flat ? 1.f : denom;
  const float ke0 = ku * ksv * dsum / dsafe;
  const float ke = flat ? 0.f : ke0;
  const bool off = (ksv_i <= 0.f) || (ksv <= 0.f) ||
                   ((gw > aq - inf_d) && (us < deficit));
  const float fu_sub = f[FU_SUB][i];
  D3 qr;
  qr.sf = 0.f;
  {  // x = us: d deficit / d us = 0, d gw / d us = 0
    const float dku = ksv_i * kr_us;
    const float dden = 0.f * ksv + ku * 0.f + gw * dku;
    const float dnum = dku * ksv * dsum + ku * ksv * (0.f + 0.f);
    const float dke = flat ? 0.f : (dnum - ke0 * dden) / dsafe;
    const float dgrad = cond ? d_max(z, 0.f) * th_us / (tfc - tr) : 0.f;
    qr.us = (off ? 0.f : dgrad * ke + grad_r * dke) * fu_sub;
  }
  {  // x = gw
    const float dku = ksv_i * kr_gw;
    const float dden = def_gw * ksv + ku * 1.f + gw * dku;
    const float dnum = dku * ksv * dsum + ku * ksv * (def_gw + 1.f);
    const float dke = flat ? 0.f : (dnum - ke0 * dden) / dsafe;
    const float dgrad = cond ? d_max(z, 0.f) * th_gw / (tfc - tr) : 0.f;
    qr.gw = (off ? 0.f : dgrad * ke + grad_r * dke) * fu_sub;
  }
  if (is_lake) {
    const D3 z3 = {0.f, 0.f, 0.f};
    qi = qx = qr = es = eu = eg = tu = tg = z3;
  }

  // rhs._tangent_factors: the 3x3 local Jacobian of (dsf, dus, dgw)
  const float keep_gw = a.i[I_BC][i] <= 0 ? 1.f : 0.f;
  const float keep_cell = is_lake ? 0.f : 1.f;
  const float inv_sy = keep_cell / f[SY][i];
  const float bc_sy = keep_gw * inv_sy;
  const float area = f[AREA][i];
  const int n = a.ne;
  float* o = a.out;
  o[LJ_SSF * n + i] = (-qi.sf + qx.sf - es.sf) * keep_cell;
  o[LJ_SUS * n + i] = (-qi.us + qx.us - es.us) * keep_cell;
  o[LJ_SGW * n + i] = (-qi.gw + qx.gw - es.gw) * keep_cell;
  o[LJ_USF * n + i] = (qi.sf - qr.sf - eu.sf - tu.sf) * inv_sy;
  o[LJ_UUS * n + i] = (qi.us - qr.us - eu.us - tu.us) * inv_sy;
  o[LJ_UGW * n + i] = (qi.gw - qr.gw - eu.gw - tu.gw) * inv_sy;
  o[LJ_GSF * n + i] = (qr.sf - qx.sf - eg.sf - tg.sf) * bc_sy;
  o[LJ_GUS * n + i] = (qr.us - qx.us - eg.us - tg.us) * bc_sy;
  o[LJ_GGW * n + i] = (qr.gw - qx.gw - eg.gw - tg.gw) * bc_sy;
  o[A_SURF * n + i] = -keep_cell / area;
  o[A_SUB * n + i] = -bc_sy / area;
  o[KH_GW * n + i] = kh_gw;
  o[KEEP_GW * n + i] = keep_gw;
  // seg_isf = sf - q_infil + q_exfil at a segment's cell
  o[SUM_SF * n + i] = 1.f - qi.sf + qx.sf;
  o[SUM_US * n + i] = -qi.us + qx.us;
  o[SUM_GW * n + i] = -qi.gw + qx.gw;
}

__global__ void tangent_cell_kernel(CellArgs a,
                                    unsigned long long* count) {
  const int start = blockIdx.x * blockDim.x + threadIdx.x;
  if (start == 0) atomicAdd(count, 1ULL);
  for (int i = start; i < a.ne; i += gridDim.x * blockDim.x)
    tangent_cell(a, i);
}

// ---------------------------------------------------------------------------
// the reach kernel: the segment and reach factors of rhs._tangent_factors
// ---------------------------------------------------------------------------

// physics.weir_flow_jtoi_lin with zi = zbank = 0 and physics.flux_r2e_gw_lin
// with ze = 0, the segment's local-datum laws
__device__ __forceinline__ void tangent_segment(const ReachArgs& a, int s) {
  const float* const* f = a.f;
  const int e = static_cast<int>(a.i[SEG_ELE][s]);
  const int r = static_cast<int>(a.i[SEG_RIV][s]);
  const float yi = f[SEG_ISF][s], yj = f[R_STAGE][r];
  const float depth = f[R_DEPTH][r];
  const float zj = -depth;
  const float cwr = f[SEG_CWR][s], length = f[SEG_LENGTH][s];
  const float thr = f[C_DEPRESSION][e];
  const float hi = yi + 0.f;
  const float hj = yj + zj;
  const float dh = hj - hi;
  const float y0 = hi - 0.f;
  const float y_pos = hi > 0.f ? dh : y0;
  const float f_pos =
      (y0 > 0.f && yj > thr) ? weir_f_lin(y_pos, cwr, length) : 0.f;
  const float y_neg = hj > 0.f ? -dh : y0;
  const float f_neg =
      (y0 > 0.f && yi > thr) ? -weir_f_lin(y_neg, cwr, length) : 0.f;
  const bool up = dh > 0.f;
  const float c_yi = up ? f_pos * (hi > 0.f ? -1.f : 1.f) : f_neg;
  const float c_yj = up ? f_pos * (hi > 0.f ? 1.f : 0.f)
                        : f_neg * (hj > 0.f ? -1.f : 0.f);
  const float w_i = c_yi * d_max(f[SEG_ISF_RAW][s], 0.f);

  // flux_r2e_gw_lin
  const float yr = yj, zr = f[C_AQ_DEPTH][e] - depth, ye = f[C_GW][e];
  const float k_ele = f[C_EFF_KH][e], k_riv = f[R_KSAT_H][r];
  const float d_riv = f[R_BED_THICK][r];
  const float k = 0.5f * (k_ele + k_riv);
  const float he = ye + 0.f;
  const float hr = yr + zr;
  const float dhr = hr - he;
  const float g = dhr / d_riv;
  const bool above = he > zr;
  const float a_r2e =
      above ? (yr + (he - zr)) * 0.5f * length : yr * length;
  const float a_e2r = (yr + (he - zr)) * 0.5f * length;
  const float half = 0.5f * length;
  const float kg = k * g;
  const bool live_r2e = (dhr > kZero) && !(yr < kEps);
  const bool live_e2r = (dhr < kNegZero) && (ye > kZero);
  const bool dead = (k_ele < kZero) || (k_riv < kZero);
  float r_yr = 0.f, r_ye = 0.f, r_k = 0.f;
  if (!dead && live_r2e) {
    r_yr = (above ? half : length) * kg + a_r2e * k / d_riv;
    r_ye = (above ? half : 0.f) * kg - a_r2e * k / d_riv;
    r_k = a_r2e * 0.5f * g;
  } else if (!dead && live_e2r) {
    r_yr = half * kg + a_e2r * k / d_riv;
    r_ye = half * kg - a_e2r * k / d_riv;
    r_k = a_e2r * 0.5f * g;
  }
  const float fu_seg = f[C_FU_SUB][e];

  const int ns = a.ns;
  float* o = a.out;
  o[W_J * ns + s] = c_yj;
  o[B_SF * ns + s] = w_i * f[C_SUM_SF][e];
  o[B_US * ns + s] = w_i * f[C_SUM_US][e];
  o[B_GW * ns + s] = w_i * f[C_SUM_GW][e];
  o[SB_RS * ns + s] = r_yr * fu_seg;
  o[SB_GW * ns + s] = (r_ye + r_k * f[C_KH_GW][e]) * fu_seg;
}

// rhs._reach_lin, physics.fun_da_to_dy_lin and the reach factors
__device__ __forceinline__ void tangent_river(const ReachArgs& a, int r) {
  const float* const* f = a.f;
  const float rs = f[R_STAGE][r];
  const float bs = f[R_BANK_SLOPE][r], bw = f[R_BOTTOM_WIDTH][r];
  const float keep_rs = a.i[RIV_BC][r] <= 0 ? 1.f : 0.f;
  const float topw_rs = d_max(rs * bs * 2.f + bw, 0.f) * (bs * 2.f);

  // _reach_lin
  const float csa_rs = d_max(rs * (bw + rs * bs), 0.f) * (bw + 2.f * rs * bs);
  const float root = sqrtf(1.f + bs * bs);
  const float per_rs = d_max(2.f * absolute(rs) * root + bw, 0.f) * 2.f *
                       d_abs(rs) * root;
  const float r_csa = f[R_CSA][r], r_per = f[R_PER][r], r_hyd = f[R_HYD][r];
  const bool small = r_per <= kZero;
  const float psafe = small ? 1.f : r_per;
  const float hyd_rs = small ? 0.f : (csa_rs - r_hyd * per_rs) / psafe;
  const float rough = f[R_AVG_ROUGH][r];
  const long long down = a.i[RIV_DOWN][r];
  const bool has_down = down >= 0;
  const bool to_lake = a.i[RIV_TO_LAKE][r] >= 0;
  const float length = f[R_LENGTH][r];
  float p_self, p_dn = 0.f;
  const Manning md = manning_lin(r_csa, rough, r_hyd, f[R_S_DOWN][r]);
  const float int_dn = -md.s / f[R_DIST2DOWN][r];
  if (!to_lake && has_down) {
    p_self = md.area * csa_rs + md.r * hyd_rs - int_dn;
    p_dn = int_dn;
  } else if (!to_lake && a.i[RIV_OUTLET_CODE][r] == -4) {
    const float sq = sqrtf(kGrav * tmax(rs, kRsFloor));
    p_self = (csa_rs * sq + r_csa * (kGrav * d_max(rs, kRsFloor)) /
                                (2.f * sq)) * 60.f;
  } else {
    const Manning mz = manning_lin(r_csa, rough, r_hyd, f[R_S_OUT][r]);
    p_self = mz.area * csa_rs + mz.r * hyd_rs + mz.s * 2.f / length;
  }

  // fun_da_to_dy_lin(d_area, r_topw, bank slope)
  const float da = f[R_D_AREA][r], w = f[R_TOPW][r];
  const float s_abs = absolute(bs);
  const float cc = w * w + 4.f * s_abs * da;
  const float croot = sqrtf(tmax(cc, kTiny));
  const float denom = w + croot;
  const bool bad = denom <= 0.f;
  const float dd = bad ? 1.f : denom;
  const float rr = d_max(cc, kTiny) / (2.f * croot);
  const float den_da = bad ? 0.f : rr * 4.f * s_abs;
  const float den_w = bad ? 0.f : 1.f + rr * 2.f * w;
  const float q = 2.f * da / dd;
  const bool neg = cc < kZero;
  const float quad_da = neg ? 0.f : (2.f - q * den_da) / dd;
  const float quad_w = neg ? (1.f / (2.f * s_abs)) * -1.f : -q * den_w / dd;
  const bool flat = s_abs < kFlatSlope;
  const float c_da = flat ? (1.f / w) * 1.f : quad_da;
  const float c_w = flat ? -da / w / w : quad_w;
  const bool zero = da == 0.f;
  const float f_da = zero ? 0.f : c_da, f_w = zero ? 0.f : c_w;

  // d_area = maximum(d_area_raw, -r_csa), then the dA -> dy quadratic
  const float da_raw = f[R_D_AREA_RAW][r], floor_ = -r_csa;
  const int nr = a.nr;
  float* o = a.out + N_SEG_OUT * a.ns;
  o[P_SELF * nr + r] = p_self;
  o[P_DN * nr + r] = p_dn;
  o[DR_AREA * nr + r] = keep_rs * f_da * d_max(da_raw, floor_) / length;
  o[DR_RS * nr + r] =
      keep_rs * (f_w * topw_rs - f_da * d_max(floor_, da_raw) * csa_rs);
  o[KEEP_RS * nr + r] = keep_rs;
  a.dn[r] = has_down ? down : 0;
}

__global__ void tangent_reach_kernel(ReachArgs a,
                                     unsigned long long* count) {
  const int start = blockIdx.x * blockDim.x + threadIdx.x;
  if (start == 0) atomicAdd(count, 1ULL);
  for (int k = start; k < a.ns + a.nr; k += gridDim.x * blockDim.x) {
    if (k < a.ns)
      tangent_segment(a, k);
    else
      tangent_river(a, k - a.ns);
  }
}

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace

extern "C" {

// fields: N_CELL_FIELDS float32 [ne] pointers, then N_CELL_FLAGS int64
// [ne] pointers (i_lake unread unless lake); out: [N_CELL_OUT, ne]
int shud_tangent_cell(const void* const* fields, float* out,
                      unsigned long long* count, int ne, int lake,
                      cudaStream_t stream) {
  CellArgs a;
  for (int k = 0; k < N_CELL_FIELDS; ++k)
    a.f[k] = static_cast<const float*>(fields[k]);
  for (int k = 0; k < N_CELL_FLAGS; ++k)
    a.i[k] = static_cast<const long long*>(fields[N_CELL_FIELDS + k]);
  a.out = out;
  a.ne = ne;
  a.lake = lake;
  tangent_cell_kernel<<<blocks_for(ne), kThreads, 0, stream>>>(a, count);
  return static_cast<int>(cudaGetLastError());
}

// fields: N_REACH_FIELDS float32 pointers, then N_REACH_FLAGS int64
// pointers; out: [N_SEG_OUT, ns] then [N_RIV_OUT, nr] float32; dn: [nr]
int shud_tangent_reach(const void* const* fields, float* out, long long* dn,
                       unsigned long long* count, int ns, int nr,
                       cudaStream_t stream) {
  ReachArgs a;
  for (int k = 0; k < N_REACH_FIELDS; ++k)
    a.f[k] = static_cast<const float*>(fields[k]);
  for (int k = 0; k < N_REACH_FLAGS; ++k)
    a.i[k] = static_cast<const long long*>(fields[N_REACH_FIELDS + k]);
  a.out = out;
  a.dn = dn;
  a.ns = ns;
  a.nr = nr;
  tangent_reach_kernel<<<blocks_for(ns + nr), kThreads, 0, stream>>>(a,
                                                                     count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
