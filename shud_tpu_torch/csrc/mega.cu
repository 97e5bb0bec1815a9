// The whole right-hand side for Hopper (sm_90a), with a plain C interface.
//
// It replaces the Pallas TPU megakernels of shud_tpu/core/pallas_mega.py:
//   shud_mega_rhs   <- _mega_kernel       (dY/dt of the flat state)
//   shud_mega_jvp   <- _mega_kernel_jvp   (hand tangent J.v, recomputing
//                                          the primal)
//   shud_mega_diag  <- _mega_diag_kernel  (the window diagnostics)
// They share the stage functions below, as _mega_core serves the three
// Pallas kernels.  Their plain PyTorch versions are in
// shud_tpu_torch/core/mega.py (same stages, same tie conventions: 0.5 at
// min/max ties, sign(0) = 0 for abs), which builds this file with nvcc and
// binds it with ctypes.  Every expression keeps the plain version's order
// of operations and calls the CUDA math function PyTorch calls (expf, logf,
// powf, sqrtf, cosf, sinf; the cube root as physics.cbrt), and the build
// fuses no multiply-add (--fmad=false), so a kernel returns its plain
// version's result to the last bit: a solve on the kernels follows the
// solve on the plain versions exactly, even where a storm brings cells to
// a threshold and any other rounding would part.
//
// What bounds them.  One evaluation at 32,768 cells with a closed boundary
// and no lake reads about 7.9 MB of tables, forcing and state once and
// writes the state-sized result (chip_smoke.py's mega_work counts what each
// kernel reads): 2.35 us at 3.35 TB/s.  The few hundred f32 operations per
// cell take ~0.2 us at 67 TFLOP/s, so the bound is bytes, and between the
// solver's back-to-back calls the 7.9 MB stay in the 50 MB L2.  What a call
// spends its time on is latency: launches, grid-wide dependencies, and
// chains of dependent loads (an edge's neighbour index, then the
// neighbour's values; a cell's segment list, then the segment) on about
// 33k threads, two or three 128-thread blocks per SM.  Tensor cores
// (wgmma) and TMA bring nothing to this: there is no matrix product, and
// the loads are gathers through index tables, not tiles.
//
// Design: each entry point is one cooperative launch of fused<T, D>
// (T: the tangent, for shud_mega_jvp; D: the diagnostics, for
// shud_mega_diag), one thread per cell and reach (and a block per lake in
// stage C).  The thread that owns cell i keeps the cell in registers
// through every stage:
//   A  the cell's pointwise physics (BC overlay, effective conductivity,
//      ET, infiltration, recharge), then the cell's own segments: row i of
//      seg_to_ele holds exactly the segments on cell i, in ascending order,
//      and a segment's weir and Darcy laws read only its cell's stage-A
//      values and the river stage in the state.  A reach thread computes
//      its downstream discharge.  Published to scratch: gw and kh (and
//      their tangents) for the neighbours' stencil, the segment fluxes and
//      the discharge for the reaches;
//   -- grid barrier --
//   B  the cell's three edges (surface, subsurface, open boundary, lake
//      bank), which read the neighbours' gw and kh, and the cell's
//      assembly from registers, its segment sum in list order; a reach
//      sums its segment and upstream lists and assembles;
//   -- on lake meshes only, a second grid barrier --
//   C  one block per lake (block b takes lakes b, b + gridDim.x, ...): the
//      block's threads gather the lake's bank-edge and inflow-reach lists
//      into shared memory, kChunk entries a round with every load of a
//      round issued before any add, and its thread 0 adds each round into
//      running sums in list order (list_sum's order, so bitwise the plain
//      version), then scans the bathymetry and writes dStage; given a
//      clock (lake_ns, mega.py's lake_stage_ns, passed only while
//      shud_tpu_torch.trace is on), that thread adds each of its lakes'
//      nanoseconds from the barrier to the lake's last write, and without
//      one it reads no clock.
// The assembly writes dY (or J.v), or with D the 13 cell, 4 reach and 6
// lake diagnostic fields (mega.py DIAG_CELL, DIAG_RIV, DIAG_LAKE); the
// stages before it are the same code for all three.
// A grid barrier needs every block resident at once.  __launch_bounds__
// holds the kernels to 128 registers a thread, so an SM holds 4 blocks of
// 128 threads (stage C's 1.8-3.3 KB of static shared memory a block does
// not lower that) and 132 SMs hold 67,584 threads, above the 32,768-cell
// ceiling plus the reaches and lakes; mega.py's launch_plan sizes the grid
// from the occupancy query and refuses a mesh the card cannot hold, and
// cudaLaunchCooperativeKernel refuses such a grid too.  Nothing falls
// back.  Scratch written before a barrier is read after it with plain
// coherent loads (no __ldg, no const __restrict__ on scratch).  Every list
// is summed in ascending order from 0 with no atomics, so every output is
// bitwise repeatable.
//
// Each entry point returns a CUDA error code (0 on success); the caller
// allocates every output and the scratch (shud_mega_scratch_floats).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kTiny = 1.0e-30f;      // _TINY
constexpr float kZero = 1.0e-10f;      // config.ZERO
constexpr float kEpsilon = 0.005f;     // config.EPSILON
constexpr float kGrav = 9.8f;          // config.GRAV
constexpr float kMaxYSurf = 0.5f;      // config.MAXYSURF
constexpr float kEpsSlope = 0.05e-6f;  // mega._EPS_SLOPE
constexpr float kPi = 3.1415926f;      // the reference's truncated pi
constexpr int kBlock = 128;            // fused kernels: mega.py FUSED_BLOCK
constexpr int kMinBlocks = 4;          // fused blocks per SM: <= 128 registers
constexpr int kChunk = kBlock;  // lake-list entries a stage-C round gathers:
                                // mega.py STAGE_C_CHUNK

// field orders: mega.py CELL_F, CELL_I, EDGE_F, EDGE_I, SEG_F, SEG_I,
// RIV_F, RIV_I, FORC_CELL, FORC_RIV
enum CellF {
  AREA, SY, AQ_DEPTH, INF_D, INF_KSAT_V, KSAT_V, KSAT_H, MAC_KSAT_V,
  MAC_KSAT_H, MAC_D, H_AREA_F, GEO_V_AREA_F, THETA_S, THETA_R, THETA_FC,
  BETA, VEG_FRAC, IMP_AF, WETLAND_LEVEL, ROOTREACH_LEVEL, DEPRESSION, ROUGH
};
enum CellI { IBC_POS, IBC_NEG, ISS_POS, ISS_NEG, IS_LAKE };
enum EdgeF { E_B, E_DIST, E_RAVG, E_DZS, E_DZB, E_D2E, E_LK_DZL, E_LK_DZB };
enum EdgeI { E_NBQ, E_M_INT, E_M_BND, E_M_LAKE, E_LK_ID };
enum SegF { S_LENGTH, S_CWR, S_DEP_E, S_ZR_LOC, S_NEG_DEPTH, S_KSAT_RIV,
            S_BED_THICK };
enum SegI { S_SE, S_SR };
enum RivF { R_BANK_SLOPE, R_BOTTOM_WIDTH, R_LENGTH, R_BED_SLOPE,
            R_DIST2DOWN, R_AVG_ROUGH, R_DEPTH, R_DEPTH_DN, R_S_MEAN };
enum RivI { R_HAS_DOWN, R_DN, R_CRIT_OUT, R_TO_LAKE, R_LAKE_ID, R_BC_POS };
enum ForcCell { F_NET_PRCP, F_POT_EVAP, F_POT_TRAN, F_E_IC, F_LAI,
                F_FU_SURF, F_FU_SUB, F_ELE_YBC, F_ELE_QBC, F_ELE_QSS };
enum ForcRiv { F_RIV_YBC, F_RIV_QBC };

// scratch: per cell (tangent copies follow at +kCellFields), per reach,
// per segment, and per edge on lake meshes
enum ScratchCell { C_GW, C_KH, kCellFields };
enum ScratchSeg { G_SURF, G_SUB, G_T_SURF, G_T_SUB, kSegFields };
enum ScratchEdge { L_SURF, L_SUB, L_T_SURF, L_T_SUB, kEdgeFields };
constexpr int kDiagCell = 13, kDiagRiv = 4;

struct Args {
  const float* cell_f; const int* cell_i;
  const float* edge_f; const int* edge_i;
  const float* seg_f; const int* seg_i;
  const float* riv_f; const int* riv_i;
  const int* seg_to_ele; const int* seg_to_riv; const int* riv_up;
  const int* edge_to_lake; const int* riv_to_lake;
  const float* lake_zmin; const float* bathy_y; const float* bathy_a;
  const float* fcell; const float* friv; const float* segfu;
  const float* flake;
  const float* y; const float* ty;
  float* out; float* s;
  unsigned long long* count;  // mega.py's device launch counter
  long long* lake_ns;  // stage C's nanoseconds per lake, or null: no clock
  int ne, nr, ns, nl, kc, kr, kup, kel, krl, kb, close_boundary;

  __device__ float cf(int f, int i) const { return cell_f[f * ne + i]; }
  __device__ bool ci(int f, int i) const { return cell_i[f * ne + i] > 0; }
  __device__ float fc(int f, int i) const { return fcell[f * ne + i]; }
  __device__ float rf(int f, int r) const { return riv_f[f * nr + r]; }
  __device__ int ri(int f, int r) const { return riv_i[f * nr + r]; }
  __device__ float sfl(int f, int k) const { return seg_f[f * ns + k]; }
  // scratch addressing
  __device__ float& sc(int f, int i) const { return s[f * ne + i]; }
  __device__ float& sr(int f, int r) const {
    return s[2 * kCellFields * ne + f * nr + r];
  }
  __device__ float& sg(int f, int k) const {
    return s[2 * kCellFields * ne + 2 * nr + f * ns + k];
  }
  __device__ float& se(int f, int e) const {
    return s[2 * kCellFields * ne + 2 * nr + kSegFields * ns + f * 3 * ne +
             e];
  }
  // river stage after the BC overlay, and its tangent
  __device__ float rstage(int r) const {
    return ri(R_BC_POS, r) > 0 ? friv[F_RIV_YBC * nr + r] : y[3 * ne + r];
  }
  __device__ float t_rstage(int r) const {
    return ri(R_BC_POS, r) > 0 ? 0.f : ty[3 * ne + r];
  }
};

// what stage A gives one cell; the t_ fields are the tangent's (0 without)
struct CellA {
  float sf, gw, kh, acell, qinf, qexf, qrech, es, eu, eg, tu, tg;
  float t_sf, t_gw, t_kh, t_acell, t_qinf, t_qexf, t_qrech, t_es, t_eu,
      t_eg, t_tu, t_tg;
};
// a surface and a subsurface flux with their tangents: one segment's
// laws, a cell's segment sums, or a cell's three-edge sums
struct Flux {
  float surf, sub, t_surf, t_sub;
};
// a reach's downstream discharge and its tangent
struct Down {
  float q, t_q;
};

// ---------------------------------------------------------------------------
// helpers (mega.py: _powp, _cbrt_pos, _pow23, _dmax0, _dmin, _dmax, _dabs)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float powp(float x, float p) {
  return expf(p * logf(x));
}
// physics.cbrt: powf and one Newton step, as the plain versions round it
__device__ __forceinline__ float cbrt_pos(float x) {
  const float xs = fmaxf(x, kTiny);
  const float t = powf(xs, 1.f / 3.f);
  return (2.f * t + xs / (t * t)) * (1.f / 3.f);
}
__device__ __forceinline__ float pow23(float x) {
  float t = cbrt_pos(x);
  return t * t;
}
__device__ __forceinline__ float dmax0(float x, float tx) {
  return x > 0.f ? tx : (x == 0.f ? 0.5f * tx : 0.f);
}
__device__ __forceinline__ float dmin(float a, float b, float ta, float tb) {
  return a < b ? ta : (a == b ? 0.5f * (ta + tb) : tb);
}
__device__ __forceinline__ float dmax(float a, float b, float ta, float tb) {
  return a > b ? ta : (a == b ? 0.5f * (ta + tb) : tb);
}
__device__ __forceinline__ float dabs(float x, float tx) {
  return x > 0.f ? tx : (x < 0.f ? -tx : 0.f);
}

__device__ __forceinline__ float manning(float area, float rough, float r,
                                         float s) {
  float q_pos = sqrtf(fmaxf(fabsf(s), kTiny)) * area * pow23(r) / rough;
  return s > 0.f ? q_pos : -q_pos;
}

__device__ __forceinline__ float manning_t(float area, float rough, float r,
                                           float s, float t_area, float t_r,
                                           float t_s) {
  float abs_s = fabsf(s);
  float sq = sqrtf(fmaxf(abs_s, kTiny));
  float t_sq = abs_s > kTiny ? dabs(s, t_s) / (2.f * sq) : 0.f;
  float p23 = pow23(r);
  float t_p23 = r > kTiny ? (2.f / 3.f) * t_r / cbrt_pos(r) : 0.f;
  float t_qpos =
      (t_sq * area * p23 + sq * t_area * p23 + sq * area * t_p23) / rough;
  return s > 0.f ? t_qpos : -t_qpos;
}

// ---------------------------------------------------------------------------
// stage A: cells (update_element, ET, infiltration, recharge) and reaches
// ---------------------------------------------------------------------------

template <bool T>
__device__ __forceinline__ CellA cell_pointwise(const Args& a, int i) {
  const int ne = a.ne;
  CellA c = {};
  const bool ibc_pos = a.ci(IBC_POS, i);
  const bool is_lake = a.nl > 0 && a.ci(IS_LAKE, i);
  const float sf = a.y[i], us = a.y[ne + i];
  const float gw = ibc_pos ? a.fc(F_ELE_YBC, i) : a.y[2 * ne + i];
  float t_sf = 0.f, t_us = 0.f, t_gw = 0.f;
  if constexpr (T) {
    t_sf = a.ty[i];
    t_us = a.ty[ne + i];
    t_gw = ibc_pos ? 0.f : a.ty[2 * ne + i];
  }

  // update_element (Element.cpp:347-384)
  const float aqd = a.cf(AQ_DEPTH, i), mac_d = a.cf(MAC_D, i);
  const float af = a.cf(GEO_V_AREA_F, i);
  const float k_mx = a.cf(KSAT_H, i), k_mac = a.cf(MAC_KSAT_H, i);
  const bool below = (mac_d <= kZero) || (gw < aqd - mac_d);
  const float full = (k_mac * mac_d * af + k_mx * (aqd - mac_d * af)) / aqd;
  const float part_num = k_mac * (gw - (aqd - mac_d)) * af +
                         k_mx * (aqd - mac_d + (gw - (aqd - mac_d)) * (1.f - af));
  const float gw_safe = gw == 0.f ? 1.f : gw;
  const float part = part_num / gw_safe;
  float effkh = below ? k_mx : (gw > aqd ? full : part);

  const float deficit_raw = aqd - gw;
  const float ikv = a.cf(INF_KSAT_V, i), haf = a.cf(H_AREA_F, i);
  const float mkv = a.cf(MAC_KSAT_V, i);
  const float kmax = ikv * (1.f - haf) + mkv * haf;
  const bool saturated = deficit_raw <= 0.f;
  const float deficit = fmaxf(deficit_raw, 0.f);
  const float ts = a.cf(THETA_S, i), tr = a.cf(THETA_R, i);
  const float theta_raw = us / (saturated ? 1.f : deficit) * ts;
  const float theta0 = saturated ? ts : theta_raw;
  const float satn_pre = saturated ? 1.f : (theta0 - tr) / (ts - tr);
  const bool hi = satn_pre > 0.99f, lo = satn_pre <= kZero;
  const float satn_mid = fminf(fmaxf(satn_pre, 1e-12f), 1.f - 1e-12f);
  const float n = a.cf(BETA, i);
  const float p1 = n / (n - 1.f), p2 = (n - 1.f) / n;
  const float inner = powp(satn_mid, p1);
  const float omi = fmaxf(1.f - inner, kTiny);
  const float temp = -1.f + powp(omi, p2);
  const float sat_kr_mid = sqrtf(satn_mid) * temp * temp;
  const float satn = hi ? 1.f : (lo ? 0.f : satn_pre);
  const float sat_kr = hi ? 1.f : (lo ? 0.f : sat_kr_mid);
  const float theta = hi ? ts : (lo ? tr : theta0);

  float t_effkh = 0.f, t_deficit = 0.f, t_satn = 0.f, t_sat_kr = 0.f;
  float t_theta = 0.f;
  if constexpr (T) {
    const float pn = part * gw_safe;
    const float t_part_num = (k_mac * af + k_mx * (1.f - af)) * t_gw;
    const float t_part =
        gw == 0.f ? 0.f
                  : (t_part_num * gw_safe - pn * t_gw) / (gw_safe * gw_safe);
    t_effkh = below ? 0.f : (gw > aqd ? 0.f : t_part);
    t_deficit = dmax0(deficit_raw, -t_gw);
    const float den = saturated ? 1.f : fmaxf(deficit_raw, 0.f);
    const float t_th =
        saturated ? 0.f : (t_us * den - us * t_deficit) / (den * den) * ts;
    const float t_sn = saturated ? 0.f : t_th / (ts - tr);
    const bool in_rng = (satn_pre >= 1e-12f) && (satn_pre <= 1.f - 1e-12f);
    const float t_smid = in_rng ? t_sn : 0.f;
    const float t_inner = p1 * inner / satn_mid * t_smid;
    const float t_omi = (1.f - inner > kTiny) ? -t_inner : 0.f;
    const float t_temp = p2 * powp(omi, p2) / omi * t_omi;
    const float t_skr = (0.5f / sqrtf(satn_mid)) * t_smid * temp * temp +
                        sqrtf(satn_mid) * 2.f * temp * t_temp;
    const bool hl = hi || lo;
    t_satn = hl ? 0.f : t_sn;
    t_sat_kr = hl ? 0.f : t_skr;
    t_theta = hl ? 0.f : t_th;
  }
  if (is_lake) {  // updateLakeElement (Element.cpp:373-383)
    effkh = k_mx;
    t_effkh = 0.f;
  }

  // ET (MD_ET.cpp:343-404)
  const float va = a.cf(VEG_FRAC, i), vb = 1.f - va;
  const float pj = 1.f - a.cf(IMP_AF, i);
  const float fcap = ts * 0.75f;
  const float beta_raw = (satn * (ts - tr) - tr) / (fcap - tr);
  const float beta_s = fminf(fmaxf(beta_raw, 0.f), 1.f);
  const float ibeta = 0.5f * (1.f - cosf(kPi * beta_s));
  const float pe = a.fc(F_POT_EVAP, i);
  const float sf0 = fmaxf(sf, 0.f);
  const float es = fminf(sf0, pe) * vb;
  const float rem = pe - es;
  const bool some_left = es < pe;
  const bool gw_high = gw > a.cf(WETLAND_LEVEL, i);
  const float gw0 = fmaxf(gw, 0.f), us0 = fmaxf(us, 0.f);
  const float eg = (some_left && gw_high) ? fminf(gw0, rem) * pj * vb : 0.f;
  const float eu =
      (some_left && !gw_high) ? fminf(us0, ibeta * rem) * pj * vb : 0.f;
  const float pot_tran = a.fc(F_POT_TRAN, i), e_ic = a.fc(F_E_IC, i);
  const bool has_veg = a.fc(F_LAI, i) > kZero;
  const bool ic_dom = e_ic >= pot_tran;
  const bool root_deep = gw > a.cf(ROOTREACH_LEVEL, i);
  const float ptr = pot_tran - e_ic;
  const bool act_t = has_veg && !ic_dom;
  const float tg = (act_t && root_deep) ? fminf(gw0, ptr) * pj * va : 0.f;
  const float tu =
      (act_t && !root_deep) ? fminf(us0, ibeta * ptr) * pj * va : 0.f;

  // infiltration (Element.cpp:271-303)
  const float fu_surf = a.fc(F_FU_SURF, i), fu_sub = a.fc(F_FU_SUB, i);
  const float av = sf + a.fc(F_NET_PRCP, i);
  const bool gw_at_surface = (gw + us > aqd) || (deficit < us);
  const float ex = gw + us - aqd;
  const float inf_d = a.cf(INF_D, i);
  const float grad = 1.f + av / inf_d;
  const bool heavy = av > kmax, medium = av > ikv;
  const float effk =
      heavy ? ikv * (1.f - haf) + haf * mkv * satn
            : (medium ? sat_kr * ikv * (1.f - haf) + haf * mkv * satn
                      : sat_kr * ikv * (1.f - haf));
  const float ge = fmaxf(grad * effk, 0.f);
  const bool act_i = (av > 0.f) && (deficit > inf_d);
  const float qi = gw_at_surface ? 0.f : (act_i ? fminf(av, ge) : 0.f);
  const float qex = gw_at_surface ? fabsf(ex) / aqd * kmax : 0.f;
  float q_infil = qi * fu_surf, q_exfil = qex * fu_surf;

  // recharge (Element.cpp:304-334)
  const float tfc = a.cf(THETA_FC, i), ksv = a.cf(KSAT_V, i);
  const bool skip = (gw > aqd - inf_d) && (us < deficit);
  const bool g_act = (theta > tr) && (us > kEpsilon);
  const float gr_raw = (theta - tr) / (tfc - tr);
  const float rgrad = g_act ? fmaxf(gr_raw, 0.f) : 0.f;
  const float ku = ikv * sat_kr;
  const float denom = deficit * ksv + gw * ku;
  const float den_s = denom == 0.f ? 1.f : denom;
  const float num = ku * ksv * (deficit + gw);
  const float ke = denom == 0.f ? 0.f : num / den_s;
  const bool zerok = (ikv <= 0.f) || (ksv <= 0.f);
  float q_rech = (skip ? 0.f : (zerok ? 0.f : rgrad * ke)) * fu_sub;
  if (is_lake) q_infil = q_exfil = q_rech = 0.f;

  c.sf = sf;
  c.gw = gw;
  c.kh = effkh;
  c.acell = sf - q_infil + q_exfil;
  c.qinf = q_infil;
  c.qexf = q_exfil;
  c.qrech = q_rech;
  c.es = es;
  c.eu = eu;
  c.eg = eg;
  c.tu = tu;
  c.tg = tg;
  if constexpr (!T) return c;

  // tangents of ET, infiltration and recharge
  const float t_beta_raw = t_satn * (ts - tr) / (fcap - tr);
  const float t_beta =
      (beta_raw >= 0.f && beta_raw <= 1.f) ? t_beta_raw : 0.f;
  const float t_ibeta = 0.5f * sinf(kPi * beta_s) * kPi * t_beta;
  const float t_sf0 = dmax0(sf, t_sf), t_gw0 = dmax0(gw, t_gw);
  const float t_us0 = dmax0(us, t_us);
  const float t_es = dmin(sf0, pe, t_sf0, 0.f) * vb;
  const float t_rem = -t_es;
  const float t_eg =
      (some_left && gw_high) ? dmin(gw0, rem, t_gw0, t_rem) * pj * vb : 0.f;
  const float t_ib_rem = t_ibeta * rem + ibeta * t_rem;
  const float t_eu = (some_left && !gw_high)
                         ? dmin(us0, ibeta * rem, t_us0, t_ib_rem) * pj * vb
                         : 0.f;
  const float t_tg =
      (act_t && root_deep) ? dmin(gw0, ptr, t_gw0, 0.f) * pj * va : 0.f;
  const float t_tu = (act_t && !root_deep)
                         ? dmin(us0, ibeta * ptr, t_us0, t_ibeta * ptr) * pj * va
                         : 0.f;

  const float t_grad = t_sf / inf_d;
  const float t_effk =
      heavy ? haf * mkv * t_satn
            : (medium ? t_sat_kr * ikv * (1.f - haf) + haf * mkv * t_satn
                      : t_sat_kr * ikv * (1.f - haf));
  const float t_ge = dmax0(grad * effk, t_grad * effk + grad * t_effk);
  const float t_qi =
      gw_at_surface ? 0.f : (act_i ? dmin(av, ge, t_sf, t_ge) : 0.f);
  const float t_qex =
      gw_at_surface ? dabs(ex, t_gw + t_us) / aqd * kmax : 0.f;
  float t_qinf = t_qi * fu_surf, t_qexf = t_qex * fu_surf;

  const float t_grad_r = g_act ? dmax0(gr_raw, t_theta / (tfc - tr)) : 0.f;
  const float t_ku = ikv * t_sat_kr;
  const float t_denom = t_deficit * ksv + t_gw * ku + gw * t_ku;
  const float t_num = (t_ku * (deficit + gw) + ku * (t_deficit + t_gw)) * ksv;
  const float t_ke = denom == 0.f
                         ? 0.f
                         : (t_num * den_s - num * t_denom) / (den_s * den_s);
  float t_qrech =
      (skip ? 0.f : (zerok ? 0.f : t_grad_r * ke + rgrad * t_ke)) * fu_sub;
  if (is_lake) t_qinf = t_qexf = t_qrech = 0.f;

  c.t_sf = t_sf;
  c.t_gw = t_gw;
  c.t_kh = t_effkh;
  c.t_acell = t_sf - t_qinf + t_qexf;
  c.t_qinf = t_qinf;
  c.t_qexf = t_qexf;
  c.t_qrech = t_qrech;
  c.t_es = t_es;
  c.t_eu = t_eu;
  c.t_eg = t_eg;
  c.t_tu = t_tu;
  c.t_tg = t_tg;
  return c;
}

// Flux_RiverDown (MD_RiverFlux.cpp:5-63): the reach's downstream discharge
template <bool T>
__device__ __forceinline__ Down reach_pointwise(const Args& a, int r) {
  const float rstage = a.rstage(r);
  const float bs = a.rf(R_BANK_SLOPE, r), bw = a.rf(R_BOTTOM_WIDTH, r);
  const float csa_raw = rstage * (bw + rstage * bs);
  const float r_csa = fmaxf(csa_raw, 0.f);
  const float sq_bs = sqrtf(1.f + bs * bs);
  const float per_raw = 2.f * fabsf(rstage) * sq_bs + bw;
  const float r_per = fmaxf(per_raw, 0.f);
  const int dn = a.ri(R_DN, r);
  const float rstage_dn = a.rstage(dn);
  const float d2d = a.rf(R_DIST2DOWN, r), len = a.rf(R_LENGTH, r);
  const float rough = a.rf(R_AVG_ROUGH, r);
  const float s_down = ((rstage - a.rf(R_DEPTH, r)) -
                        (rstage_dn - a.rf(R_DEPTH_DN, r))) / d2d +
                       a.rf(R_S_MEAN, r);
  const bool per_z = r_per <= kZero;
  const float r_hyd = per_z ? 0.f : r_csa / (per_z ? 1.f : r_per);
  const float s_out = a.rf(R_BED_SLOPE, r) + rstage * 2.f / len;
  const float sq_g = sqrtf(kGrav * fmaxf(rstage, 1e-30f));
  const bool to_lake = a.ri(R_TO_LAKE, r) > 0;
  const bool has_down = a.ri(R_HAS_DOWN, r) > 0;
  const bool crit = a.ri(R_CRIT_OUT, r) > 0;
  Down d = {0.f, 0.f};
  if (to_lake || (!has_down && !crit))
    d.q = manning(r_csa, rough, r_hyd, s_out);
  else if (has_down)
    d.q = manning(r_csa, rough, r_hyd, s_down);
  else
    d.q = r_csa * sq_g * 60.f;
  if constexpr (!T) return d;

  const float t_rst = a.t_rstage(r), t_rdn = a.t_rstage(dn);
  const float t_csa = dmax0(csa_raw, t_rst * (bw + 2.f * rstage * bs));
  const float t_per = dmax0(per_raw, 2.f * dabs(rstage, t_rst) * sq_bs);
  const float t_rhyd =
      per_z ? 0.f : (t_csa * r_per - r_csa * t_per) / (per_z ? 1.f
                                                              : r_per * r_per);
  if (to_lake || (!has_down && !crit)) {
    d.t_q = manning_t(r_csa, rough, r_hyd, s_out, t_csa, t_rhyd,
                      t_rst * 2.f / len);
  } else if (has_down) {
    d.t_q = manning_t(r_csa, rough, r_hyd, s_down, t_csa, t_rhyd,
                      (t_rst - t_rdn) / d2d);
  } else {
    const float t_sqg = rstage > 1e-30f ? kGrav * t_rst / (2.f * sq_g) : 0.f;
    d.t_q = (t_csa * sq_g + r_csa * t_sqg) * 60.f;
  }
  return d;
}

// weir (local datum) and river-aquifer Darcy exchange of segment k, from
// its cell's stage-A values (MD_RiverFlux.cpp:65-126)
template <bool T>
__device__ __forceinline__ Flux segment(const Args& a, int k,
                                        const CellA& c) {
  const int sr = a.seg_i[S_SR * a.ns + k];
  const float sfe_raw = c.acell, gwe = c.gw, khe = c.kh;
  const float rstage = a.rstage(sr);
  const float len = a.sfl(S_LENGTH, k), cwr = a.sfl(S_CWR, k);
  const float dep_e = a.sfl(S_DEP_E, k), zr = a.sfl(S_ZR_LOC, k);
  const float k_riv = a.sfl(S_KSAT_RIV, k), d_riv = a.sfl(S_BED_THICK, k);
  const float fu = a.segfu[k];
  const float seg_isf = fmaxf(sfe_raw, 0.f);
  Flux g = {0.f, 0.f, 0.f, 0.f};

  // weir_flow_jtoi, zi = zbank = 0, zj = -riv_depth
  const float hi = seg_isf, hj = rstage + a.sfl(S_NEG_DEPTH, k);
  const float dh = hj - hi;
  const float y_pos = hi > 0.f ? dh : hi;
  const bool c_pos = (hi > 0.f) && (rstage > dep_e);
  const float sq_pos = sqrtf(2.f * kGrav * fmaxf(y_pos, kTiny));
  const float q_pos = c_pos ? cwr * sq_pos * len * y_pos * 60.f : 0.f;
  const float y_neg = hj > 0.f ? -dh : hi;
  const bool c_neg = (hi > 0.f) && (seg_isf > dep_e);
  const float sq_neg = sqrtf(2.f * kGrav * fmaxf(y_neg, kTiny));
  const float q_neg = c_neg ? -cwr * sq_neg * len * y_neg * 60.f : 0.f;
  g.surf = dh > 0.f ? q_pos : q_neg;

  // flux_r2e_gw, ze = 0, zr = aq_depth - riv_depth
  const float kk = 0.5f * (khe + k_riv);
  const float he = gwe, hr = rstage + zr;
  const float dhr = hr - he;
  const float gr = dhr / d_riv;
  const float a_r2e = he > zr ? (rstage + (he - zr)) * 0.5f * len : rstage * len;
  const float a_e2r = (rstage + (he - zr)) * 0.5f * len;
  const bool zerok = (khe < kZero) || (k_riv < kZero);
  float q = 0.f;
  if (dhr > kZero)
    q = rstage < kEpsilon ? 0.f : a_r2e * kk * gr;
  else if (dhr < -kZero)
    q = gwe > kZero ? a_e2r * kk * gr : 0.f;
  g.sub = (zerok ? 0.f : q) * fu;
  if constexpr (!T) return g;

  const float t_acell = c.t_acell, t_gwe = c.t_gw, t_khe = c.t_kh;
  const float t_rst = a.t_rstage(sr);
  const float t_isf = dmax0(sfe_raw, t_acell);
  const float t_dh = t_rst - t_isf;
  const float t_ypos = hi > 0.f ? t_dh : t_isf;
  const float t_sqpos =
      y_pos > kTiny ? 2.f * kGrav * t_ypos / (2.f * sq_pos) : 0.f;
  const float t_qpos =
      c_pos ? cwr * (t_sqpos * y_pos + sq_pos * t_ypos) * len * 60.f : 0.f;
  const float t_yneg = hj > 0.f ? -t_dh : t_isf;
  const float t_sqneg =
      y_neg > kTiny ? 2.f * kGrav * t_yneg / (2.f * sq_neg) : 0.f;
  const float t_qneg =
      c_neg ? -cwr * (t_sqneg * y_neg + sq_neg * t_yneg) * len * 60.f : 0.f;
  g.t_surf = dh > 0.f ? t_qpos : t_qneg;

  const float t_k = 0.5f * t_khe;
  const float t_g = (t_rst - t_gwe) / d_riv;
  float t_q = 0.f;
  if (dhr > kZero) {
    const float t_ar2e =
        he > zr ? (t_rst + t_gwe) * 0.5f * len : t_rst * len;
    t_q = rstage < kEpsilon ? 0.f
                            : t_ar2e * kk * gr + a_r2e * (t_k * gr + kk * t_g);
  } else if (dhr < -kZero) {
    const float t_ae2r = (t_rst + t_gwe) * 0.5f * len;
    t_q = gwe > kZero ? t_ae2r * kk * gr + a_e2r * (t_k * gr + kk * t_g)
                      : 0.f;
  }
  g.t_sub = (zerok ? 0.f : t_q) * fu;
  return g;
}

// ---------------------------------------------------------------------------
// stage B: the 3-edge stencil per cell (MD_ElementFlux.cpp:35-156, lake
// banks :46-53,122)
// ---------------------------------------------------------------------------

struct Edge {
  float q_surf, q_sub, t_surf, t_sub;  // selected law; sub before fu_sub
  float lk_surf, lk_sub, t_lk_surf, t_lk_sub;  // lake-bank totals' terms
};

template <bool T>
__device__ __forceinline__ Edge one_edge(const Args& a, int e, float sf,
                                         float t_sf, float gw, float t_gw,
                                         float kh, float t_kh, float dep,
                                         float rcell) {
  const int ne = a.ne, n3 = 3 * ne;
  Edge o = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float B = a.edge_f[E_B * n3 + e];
  const float dist = a.edge_f[E_DIST * n3 + e];
  const bool m_int = a.edge_i[E_M_INT * n3 + e] > 0;
  // closed boundary: the boundary flag and d2e are never read
  const bool m_bnd = !a.close_boundary && a.edge_i[E_M_BND * n3 + e] > 0;
  const bool m_lake = a.nl > 0 && a.edge_i[E_M_LAKE * n3 + e] > 0;
  const int nb = a.edge_i[E_NBQ * n3 + e];
  const float isf = fmaxf(sf, 0.f);
  const float t_isf = T ? dmax0(sf, t_sf) : 0.f;
  const float nkh = a.sc(C_KH, nb);
  const float t_nkh = T ? a.sc(kCellFields + C_KH, nb) : 0.f;

  if (m_lake) {
    // weir and Darcy laws against the lake stage (pallas_mega.py:1078-1099)
    const int lk = a.edge_i[E_LK_ID * n3 + e];
    const float lake_e = a.y[3 * ne + a.nr + lk];
    const float lake_nsf = fmaxf(lake_e, 0.f);
    const float hi0 = lake_nsf + a.edge_f[E_LK_DZL * n3 + e];
    const float dh_w = isf - hi0;
    const float y_pos = hi0 > 0.f ? dh_w : hi0;
    const float sq_pos = sqrtf(2.f * kGrav * fmaxf(y_pos, kTiny));
    const bool c_pos = (hi0 > 0.f) && (isf > 0.01f);
    const float q_pos = c_pos ? 0.6f * sq_pos * B * y_pos * 60.f : 0.f;
    const float y_neg = isf > 0.f ? -dh_w : hi0;
    const float sq_neg = sqrtf(2.f * kGrav * fmaxf(y_neg, kTiny));
    const bool c_neg = (hi0 > 0.f) && (lake_nsf > 0.01f);
    const float q_neg = c_neg ? -0.6f * sq_neg * B * y_neg * 60.f : 0.f;
    o.q_surf = dh_w > 0.f ? q_pos : q_neg;
    const float dh_lk = (gw - lake_e) + a.edge_f[E_LK_DZB * n3 + e];
    const float ymean = 0.5f * (fmaxf(gw, 0.f) + fmaxf(lake_e, 0.f));
    const float kmean = 0.5f * (kh + nkh);
    const bool cut = (dh_lk > 0.f && gw <= 0.02f) ||
                     (dh_lk < 0.f && lake_e <= 0.02f);
    o.q_sub = cut ? 0.f : kmean * (dh_lk / dist) * ymean * B;
    o.lk_surf = o.q_surf;
    o.lk_sub = o.q_sub;
    if constexpr (T) {
      const float t_lake_e = a.ty[3 * ne + a.nr + lk];
      const float t_hi0 = dmax0(lake_e, t_lake_e);
      const float t_dh_w = t_isf - t_hi0;
      const float t_y_pos = hi0 > 0.f ? t_dh_w : t_hi0;
      const float t_sq_pos =
          y_pos > kTiny ? 2.f * kGrav * t_y_pos / (2.f * sq_pos) : 0.f;
      const float t_q_pos =
          c_pos ? 0.6f * (t_sq_pos * y_pos + sq_pos * t_y_pos) * B * 60.f
                : 0.f;
      const float t_y_neg = isf > 0.f ? -t_dh_w : t_hi0;
      const float t_sq_neg =
          y_neg > kTiny ? 2.f * kGrav * t_y_neg / (2.f * sq_neg) : 0.f;
      const float t_q_neg =
          c_neg ? -0.6f * (t_sq_neg * y_neg + sq_neg * t_y_neg) * B * 60.f
                : 0.f;
      o.t_surf = dh_w > 0.f ? t_q_pos : t_q_neg;
      const float t_dh_lk = t_gw - t_lake_e;
      const float t_ymean =
          0.5f * (dmax0(gw, t_gw) + dmax0(lake_e, t_lake_e));
      const float t_kmean = 0.5f * (t_kh + t_nkh);
      o.t_sub = cut ? 0.f
                    : (t_kmean * (dh_lk / dist) * ymean +
                       kmean * (t_dh_lk / dist) * ymean +
                       kmean * (dh_lk / dist) * t_ymean) * B;
      o.t_lk_surf = o.t_surf;
      o.t_lk_sub = o.t_sub;
    }
  } else if (m_int) {
    const float nsf_raw = a.y[nb];
    const float nsf = fmaxf(nsf_raw, 0.f);
    const float ngw = a.sc(C_GW, nb);
    const float ravg = a.edge_f[E_RAVG * n3 + e];
    // diffusive-wave surface flux (pallas_edge._flux_surface_int)
    const float dh = (isf - nsf) + a.edge_f[E_DZS * n3 + e];
    const float up1 = isf > dep ? isf : 0.f;
    const float up2 = nsf > dep ? nsf : 0.f;
    const float w = dh > 0.f ? up1 : up2;
    const float ymean = fminf(w, kMaxYSurf);
    const float s = dh / dist;
    const float sqrt_s = sqrtf(fmaxf(fabsf(s), kTiny));
    const float p23 = pow23(ymean);
    const float q_pos = sqrt_s * (ymean * B) * p23 / ravg;
    const bool dead = (s > 0.f && isf <= 0.f) || (s < 0.f && nsf <= 0.f) ||
                      ymean <= 0.f;
    o.q_surf = dead ? 0.f : (s > 0.f ? q_pos : -q_pos);
    // Darcy subsurface flux (pallas_edge._flux_sub_int)
    const float dh_s = (gw - ngw) + a.edge_f[E_DZB * n3 + e];
    const float ym_s = 0.5f * (fmaxf(gw, 0.f) + fmaxf(ngw, 0.f));
    const float grad_s = dh_s / dist;
    const float kmean = 0.5f * (kh + nkh);
    const bool cut = (dh_s > 0.f && gw <= 0.02f) || (dh_s < 0.f && ngw <= 0.02f);
    o.q_sub = cut ? 0.f : kmean * grad_s * ym_s * B;
    if constexpr (T) {
      const float t_nsf = dmax0(nsf_raw, a.ty[nb]);
      const float t_ngw = a.sc(kCellFields + C_GW, nb);
      const float t_dh = t_isf - t_nsf;
      const float t_w = dh > 0.f ? (isf > dep ? t_isf : 0.f)
                                 : (nsf > dep ? t_nsf : 0.f);
      const float t_ym =
          w < kMaxYSurf ? t_w : (w == kMaxYSurf ? 0.5f * t_w : 0.f);
      const float t_s = t_dh / dist;
      const float t_abs_s = s >= 0.f ? t_s : -t_s;
      const float t_sqrt_s =
          fabsf(s) > kTiny ? t_abs_s / (2.f * sqrt_s) : 0.f;
      const float t_p23 =
          ymean > kTiny ? (2.f / 3.f) * t_ym / cbrt_pos(ymean) : 0.f;
      const float cross = ymean * B;
      const float t_qpos = (t_sqrt_s * cross * p23 +
                            sqrt_s * (t_ym * B * p23 + cross * t_p23)) / ravg;
      o.t_surf = dead ? 0.f : (s > 0.f ? t_qpos : -t_qpos);
      const float t_ym_s = 0.5f * (dmax0(gw, t_gw) + dmax0(ngw, t_ngw));
      const float t_grad = (t_gw - t_ngw) / dist;
      const float t_km = 0.5f * (t_kh + t_nkh);
      o.t_sub = cut ? 0.f
                    : (t_km * grad_s * ym_s + kmean * t_grad * ym_s +
                       kmean * grad_s * t_ym_s) * B;
    }
  } else if (m_bnd) {
    // kinematic free drainage (pallas_edge._flux_surface_bnd/_sub_bnd)
    const float d2e = a.edge_f[E_D2E * n3 + e];
    const float sb = isf / d2e * 0.5f;
    const float isf5 = cbrt_pos(isf * isf * isf * isf * isf);
    const float sqrt_sb = sqrtf(fmaxf(sb, 0.f));
    const bool act_s = (isf > dep) && (sb > 0.f);
    o.q_surf = act_s ? sqrt_sb * isf5 * B / rcell : 0.f;
    const float grad_b = gw / d2e * 0.5f;
    const bool act_b = (gw > dep * 10.f) && (grad_b > 0.f);
    o.q_sub = act_b ? kh * grad_b : 0.f;
    if constexpr (T) {
      const float t_sb = t_isf / d2e * 0.5f;
      const float t_sqrt_sb = sb > 0.f ? t_sb / (2.f * sqrt_sb) : 0.f;
      const float u4 = isf * isf * isf * isf;
      const float t_isf5 =
          isf > 0.f ? 5.f * u4 * t_isf / (3.f * isf5 * isf5) : 0.f;
      o.t_surf = act_s ? (t_sqrt_sb * isf5 + sqrt_sb * t_isf5) * B / rcell
                       : 0.f;
      o.t_sub = act_b ? t_kh * grad_b + kh * (t_gw / d2e * 0.5f) : 0.f;
    }
  }
  return o;
}

// a cell's three edges summed in slot order (the subsurface ones scaled by
// fu_sub); on lake meshes each edge's lake-bank terms go to scratch
template <bool T>
__device__ __forceinline__ Flux cell_edges(const Args& a, int i,
                                           const CellA& c) {
  const float dep = a.cf(DEPRESSION, i);
  const float rcell = a.close_boundary ? 1.f : a.cf(ROUGH, i);
  const float fu_sub = a.fc(F_FU_SUB, i);
  Edge q[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int e = 3 * i + j;
    q[j] = one_edge<T>(a, e, c.sf, c.t_sf, c.gw, c.t_gw, c.kh, c.t_kh, dep,
                       rcell);
    if (a.nl > 0) {
      a.se(L_SURF, e) = q[j].lk_surf;
      a.se(L_SUB, e) = q[j].lk_sub;
      if constexpr (T) {
        a.se(L_T_SURF, e) = q[j].t_lk_surf;
        a.se(L_T_SUB, e) = q[j].t_lk_sub;
      }
    }
  }
  Flux o = {q[0].q_surf + q[1].q_surf + q[2].q_surf,
            q[0].q_sub * fu_sub + q[1].q_sub * fu_sub + q[2].q_sub * fu_sub,
            0.f, 0.f};
  if constexpr (T) {
    o.t_surf = q[0].t_surf + q[1].t_surf + q[2].t_surf;
    o.t_sub = q[0].t_sub * fu_sub + q[1].t_sub * fu_sub + q[2].t_sub * fu_sub;
  }
  return o;
}

// ---------------------------------------------------------------------------
// reductions, lake bucket, assembly (f_applyDY, MD_f.cpp:52-215) or the
// window diagnostics
// ---------------------------------------------------------------------------

// 0 - v[l0] - v[l1] - ... over one padded list row (pad index >= n)
__device__ __forceinline__ float neg_list_sum(const float* v, const int* row,
                                              int width, int n) {
  float acc = 0.f;
  for (int k = 0; k < width; ++k) {
    int idx = row[k];
    if (idx < n) acc = acc - v[idx];
  }
  return acc;
}

__device__ __forceinline__ float list_sum(const float* v, const int* row,
                                          int width, int n) {
  float acc = 0.f;
  for (int k = 0; k < width; ++k) {
    int idx = row[k];
    if (idx < n) acc = acc + v[idx];
  }
  return acc;
}

// *own*: the cell's three-edge sums; *e2r*: 0 minus its segments' fluxes
template <bool T, bool D>
__device__ __forceinline__ void cell_assembly(const Args& a, int i,
                                              const CellA& c, const Flux& own,
                                              const Flux& e2r) {
  const int ne = a.ne;
  const bool is_lake = a.nl > 0 && a.ci(IS_LAKE, i);
  const float area = a.cf(AREA, i), sy = a.cf(SY, i);
  float* out = a.out;
  if constexpr (D) {
    const float pj = 1.f - a.cf(IMP_AF, i), va = a.cf(VEG_FRAC, i);
    const float pot_tran = a.fc(F_POT_TRAN, i), e_ic = a.fc(F_E_IC, i);
    const bool has_veg = a.fc(F_LAI, i) > kZero;
    const float e_ic_out =
        has_veg ? (e_ic >= pot_tran ? pot_tran * pj * va : e_ic) : 0.f;
    const float own_surf = is_lake ? 0.f : own.surf;
    const float own_sub = is_lake ? 0.f : own.sub;
    const float vals[kDiagCell] = {
        c.qrech, e2r.sub + own_sub, e2r.surf + own_surf, e2r.sub,
        e2r.surf, c.qinf, c.qexf,
        is_lake ? 0.f : c.es, is_lake ? 0.f : c.eu,
        is_lake ? 0.f : c.eg, is_lake ? 0.f : c.tu,
        is_lake ? 0.f : c.tg, is_lake ? 0.f : e_ic_out};
#pragma unroll
    for (int f = 0; f < kDiagCell; ++f) out[f * ne + i] = vals[f];
  } else if constexpr (!T) {
    float dsf = a.fc(F_NET_PRCP, i) - c.qinf + c.qexf -
                (e2r.surf + own.surf) / area - c.es;
    float dus = c.qinf - c.qrech - c.eu - c.tu;
    float dgw = c.qrech - c.qexf - (e2r.sub + own.sub) / area - c.eg - c.tg;
    if (a.ci(IBC_POS, i)) dgw = 0.f;
    if (a.ci(IBC_NEG, i)) dgw = dgw + a.fc(F_ELE_QBC, i) / area;
    if (a.ci(ISS_POS, i)) dsf = dsf + a.fc(F_ELE_QSS, i) / area;
    if (a.ci(ISS_NEG, i)) dgw = dgw + a.fc(F_ELE_QSS, i) / area;
    dus = dus / sy;
    dgw = dgw / sy;
    out[i] = is_lake ? 0.f : dsf;
    out[ne + i] = is_lake ? 0.f : dus;
    out[2 * ne + i] = is_lake ? 0.f : dgw;
  } else {
    const float t_dsf = -c.t_qinf + c.t_qexf -
                        (e2r.t_surf + own.t_surf) / area - c.t_es;
    float t_dus = c.t_qinf - c.t_qrech - c.t_eu - c.t_tu;
    float t_dgw = c.t_qrech - c.t_qexf - (e2r.t_sub + own.t_sub) / area -
                  c.t_eg - c.t_tg;
    if (a.ci(IBC_POS, i)) t_dgw = 0.f;
    t_dus = t_dus / sy;
    t_dgw = t_dgw / sy;
    out[i] = is_lake ? 0.f : t_dsf;
    out[ne + i] = is_lake ? 0.f : t_dus;
    out[2 * ne + i] = is_lake ? 0.f : t_dgw;
  }
}

// *own*: the reach's downstream discharge; the upstream ones and the
// segment fluxes are read from scratch
template <bool T, bool D>
__device__ __forceinline__ void reach_assembly(const Args& a, int r,
                                               const Down& own) {
  const int ne = a.ne, nr = a.nr, ns = a.ns;
  const float* seg0 = &a.sg(0, 0);
  const float* qdown = &a.sr(0, 0);
  const int* srow = a.seg_to_riv + r * a.kr;
  const int* urow = a.riv_up + r * a.kup;
  const float q_riv_surf = list_sum(seg0 + G_SURF * ns, srow, a.kr, ns);
  const float q_riv_sub = list_sum(seg0 + G_SUB * ns, srow, a.kr, ns);
  const float q_riv_up = neg_list_sum(qdown, urow, a.kup, nr);
  const float q_riv_down = own.q;
  if constexpr (D) {
    float* out = a.out + kDiagCell * ne;
    out[r] = q_riv_up;
    out[nr + r] = q_riv_down;
    out[2 * nr + r] = q_riv_sub;
    out[3 * nr + r] = q_riv_surf;
    return;
  }
  const float rstage = a.rstage(r);
  const float bs = a.rf(R_BANK_SLOPE, r), bw = a.rf(R_BOTTOM_WIDTH, r);
  const float len = a.rf(R_LENGTH, r);
  const float topw_raw = rstage * bs * 2.f + bw;
  const float r_topw = fmaxf(topw_raw, 0.f);
  const float csa_raw = rstage * (bw + rstage * bs);
  const float r_csa = fmaxf(csa_raw, 0.f);
  const float da_raw =
      (-q_riv_up - q_riv_surf - q_riv_sub - q_riv_down +
       a.friv[F_RIV_QBC * nr + r]) / len;
  const float da = fmaxf(da_raw, -r_csa);
  // fun_dAtodY in the Citardauq form 2 da / (w + sqrt(w^2 + 4 s da))
  const float s_abs = fabsf(bs);
  const float cc = r_topw * r_topw + 4.f * s_abs * da;
  const float sq = sqrtf(fmaxf(cc, kTiny));
  const float denom = r_topw + sq;
  const float den_s = denom <= 0.f ? 1.f : denom;
  const bool bcpos = a.ri(R_BC_POS, r) > 0;
  float* out = a.out + 3 * ne;
  if constexpr (!T) {
    const float quad =
        cc < kZero ? -r_topw / (2.f * s_abs) : 2.f * da / den_s;
    const float dy = s_abs < kEpsSlope ? da / r_topw : quad;
    out[r] = (bcpos || da == 0.f) ? 0.f : dy;
  } else {
    const float* t_qdown = &a.sr(1, 0);
    const float t_rst = a.t_rstage(r);
    const float t_surf = list_sum(seg0 + G_T_SURF * ns, srow, a.kr, ns);
    const float t_sub = list_sum(seg0 + G_T_SUB * ns, srow, a.kr, ns);
    const float t_up = neg_list_sum(t_qdown, urow, a.kup, nr);
    const float t_topw = dmax0(topw_raw, t_rst * bs * 2.f);
    const float t_csa = dmax0(csa_raw, t_rst * (bw + 2.f * rstage * bs));
    const float t_da_raw = (-t_up - t_surf - t_sub - own.t_q) / len;
    const float t_da = dmax(da_raw, -r_csa, t_da_raw, -t_csa);
    const float t_cc = 2.f * r_topw * t_topw + 4.f * s_abs * t_da;
    const float t_sq = cc > kTiny ? t_cc / (2.f * sq) : 0.f;
    const float t_den = t_topw + t_sq;
    const float t_quad =
        cc < kZero ? -t_topw / (2.f * s_abs)
                   : (2.f * t_da * den_s - 2.f * da * t_den) / (den_s * den_s);
    const float t_dy =
        s_abs < kEpsSlope ? (t_da * r_topw - da * t_topw) / (r_topw * r_topw)
                          : t_quad;
    out[r] = (bcpos || da == 0.f) ? 0.f : t_dy;
  }
}

// the card's nanosecond clock (%globaltimer, the interval graph's stamps'
// clock); the memory clobber keeps the stage's loads and stores between
// two readings
__device__ __forceinline__ long long global_ns() {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now) : : "memory");
  return now;
}

// lake bucket dStage (MD_f.cpp:44-47,180-191; Lake.cpp:toparea) of lake l
// from its sums (lake_stage): *bank* the bank-edge surface and subsurface
// inflows, *riv* the routed reaches' discharge, with their tangents
template <bool T, bool D>
__device__ __forceinline__ void lake_assembly(const Args& a, int l,
                                              const Flux& bank,
                                              const Down& riv) {
  const int ne = a.ne, nr = a.nr, nl = a.nl;
  const float p_l = a.flake[l], e_l = a.flake[nl + l];
  const float stg = a.y[3 * ne + nr + l];
  const float avail = p_l + stg;
  const float inner = fminf(e_l, avail);
  const float evap = fmaxf(inner, 0.f);
  const float surf_l = bank.surf, sub_l = bank.sub, rivin_l = riv.q;
  // piecewise-linear stage -> area, a sequential scan with a done flag
  const float* by = a.bathy_y + l * a.kb;
  const float* ba = a.bathy_a + l * a.kb;
  const float yq = stg + a.lake_zmin[l];
  const float t_stg = T ? a.ty[3 * ne + nr + l] : 0.f;
  float ta = ba[0], t_ta = 0.f;
  bool done = yq <= by[0];
  for (int k = 1; k < a.kb; ++k) {
    const float yi = by[k], yim = by[k - 1], ai = ba[k];
    const bool below = yq < yi, eq = yi == yq;
    const float denom = eq ? 1.f : yi - yq;
    const float u = ai - ta;
    const float v = (yq - yim) / denom;
    const float new_ta = below ? u * v + ta : ai;
    if constexpr (T) {
      const float t_denom = eq ? 0.f : -t_stg;
      const float t_v = (t_stg * denom - (yq - yim) * t_denom) /
                        (denom * denom);
      const float t_new = below ? -t_ta * v + u * t_v + t_ta : 0.f;
      t_ta = done ? t_ta : t_new;
    }
    ta = done ? ta : new_ta;
    done = done || below;
  }
  const float inflow = rivin_l + sub_l + surf_l;
  if constexpr (D) {
    float* out = a.out + kDiagCell * ne + kDiagRiv * nr;
    const float vals[6] = {ta, evap, p_l, rivin_l, surf_l, sub_l};
#pragma unroll
    for (int f = 0; f < 6; ++f) out[f * nl + l] = vals[f];
  } else if constexpr (!T) {
    a.out[3 * ne + nr + l] = p_l - evap + inflow / ta;
  } else {
    const float t_evap = dmax0(inner, dmin(e_l, avail, 0.f, t_stg));
    const float t_inflow = riv.t_q + bank.t_sub + bank.t_surf;
    a.out[3 * ne + nr + l] =
        -t_evap + (t_inflow * ta - inflow * t_ta) / (ta * ta);
  }
}

// stage C (see the top): block b takes lakes b, b + gridDim.x, ...  A round
// is kChunk entries of the lake's lists: each thread loads one bank-edge
// entry (its index, then each field the instantiation reads) and one
// inflow-reach entry into shared memory, so that a round costs two
// dependent loads and not two a list entry; after the block's barrier
// thread 0 adds the round's entries in list order into its running sums,
// list_sum's order (a pad slot adds nothing; a reach not routed to the lake
// adds 0), so every sum is its plain version's to the bit.  That thread
// then finishes the lake (lake_assembly) and, given lake_ns, adds the
// nanoseconds from the barrier to the lake's last write.
template <bool T, bool D>
__device__ __forceinline__ void lake_stage(const Args& a) {
  constexpr int kE = T ? 4 : 2, kR = T ? 2 : 1;  // bank, reach fields read
  __shared__ float e_val[kChunk][kE], r_val[kChunk][kR];
  __shared__ bool e_ok[kChunk], r_ok[kChunk];
  const int j = threadIdx.x, b = blockIdx.x, n3 = 3 * a.ne, nr = a.nr;
  const int width = max(a.kel, a.krl);
  const bool timed = a.lake_ns != nullptr && j == 0;
  const long long t0 = timed && b < a.nl ? global_ns() : 0;
  for (int l = b; l < a.nl; l += gridDim.x) {
    const int* erow = a.edge_to_lake + l * a.kel;
    const int* rrow = a.riv_to_lake + l * a.krl;
    Flux bank = {0.f, 0.f, 0.f, 0.f};
    Down riv = {0.f, 0.f};
    for (int k0 = 0; k0 < width; k0 += kChunk) {
      const int k = k0 + j;
      if (k < a.kel) {
        const int idx = erow[k];
        e_ok[j] = idx < n3;
        if (idx < n3) {
          e_val[j][0] = a.se(L_SURF, idx);
          e_val[j][1] = a.se(L_SUB, idx);
          if constexpr (T) {
            e_val[j][2] = a.se(L_T_SURF, idx);
            e_val[j][3] = a.se(L_T_SUB, idx);
          }
        }
      }
      if (k < a.krl) {
        const int idx = rrow[k];
        r_ok[j] = idx < nr;
        if (idx < nr) {
          const bool to = a.ri(R_TO_LAKE, idx) > 0;
          r_val[j][0] = to ? a.sr(0, idx) : 0.f;
          if constexpr (T) r_val[j][1] = to ? a.sr(1, idx) : 0.f;
        }
      }
      __syncthreads();
      if (j == 0) {
        // a pad slot keeps the sum as it is (no value was loaded for it)
        const int ke = min(kChunk, a.kel - k0), kr = min(kChunk, a.krl - k0);
#pragma unroll 8
        for (int m = 0; m < ke; ++m) {
          const bool ok = e_ok[m];
          bank.surf = ok ? bank.surf + e_val[m][0] : bank.surf;
          bank.sub = ok ? bank.sub + e_val[m][1] : bank.sub;
          if constexpr (T) {
            bank.t_surf = ok ? bank.t_surf + e_val[m][2] : bank.t_surf;
            bank.t_sub = ok ? bank.t_sub + e_val[m][3] : bank.t_sub;
          }
        }
        for (int m = 0; m < kr; ++m) {
          const bool ok = r_ok[m];
          riv.q = ok ? riv.q + r_val[m][0] : riv.q;
          if constexpr (T) riv.t_q = ok ? riv.t_q + r_val[m][1] : riv.t_q;
        }
      }
      __syncthreads();
    }
    if (j == 0) {
      lake_assembly<T, D>(a, l, bank, riv);
      if (timed) a.lake_ns[l] += global_ns() - t0;
    }
  }
}

// ---------------------------------------------------------------------------
// the one cooperative launch of every entry point (see the top)
// ---------------------------------------------------------------------------

template <bool T, bool D>
__global__ void __launch_bounds__(kBlock, kMinBlocks) fused(Args a) {
  static_assert(!(T && D), "the diagnostics carry no tangent");
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int ne = a.ne, nr = a.nr;
  const bool is_cell = t < ne, is_reach = !is_cell && t < ne + nr;
  if (t == 0) atomicAdd(a.count, 1ULL);  // also counts a graph's replays
  CellA c = {};
  Flux e2r = {0.f, 0.f, 0.f, 0.f};
  Down own = {0.f, 0.f};
  // stage A
  if (is_cell) {
    c = cell_pointwise<T>(a, t);
    a.sc(C_GW, t) = c.gw;
    a.sc(C_KH, t) = c.kh;
    if constexpr (T) {
      a.sc(kCellFields + C_GW, t) = c.t_gw;
      a.sc(kCellFields + C_KH, t) = c.t_kh;
    }
    // the cell's segments, in its seg_to_ele row's (ascending) order
    const int* row = a.seg_to_ele + t * a.kc;
    for (int j = 0; j < a.kc; ++j) {
      const int k = row[j];
      if (k >= a.ns) continue;
      const Flux g = segment<T>(a, k, c);
      a.sg(G_SURF, k) = g.surf;
      a.sg(G_SUB, k) = g.sub;
      e2r.surf = e2r.surf - g.surf;
      e2r.sub = e2r.sub - g.sub;
      if constexpr (T) {
        a.sg(G_T_SURF, k) = g.t_surf;
        a.sg(G_T_SUB, k) = g.t_sub;
        e2r.t_surf = e2r.t_surf - g.t_surf;
        e2r.t_sub = e2r.t_sub - g.t_sub;
      }
    }
  } else if (is_reach) {
    own = reach_pointwise<T>(a, t - ne);
    a.sr(0, t - ne) = own.q;
    if constexpr (T) a.sr(1, t - ne) = own.t_q;
  }
  cg::this_grid().sync();
  // stage B
  if (is_cell) {
    const Flux edges = cell_edges<T>(a, t, c);
    cell_assembly<T, D>(a, t, c, edges, e2r);
  } else if (is_reach) {
    reach_assembly<T, D>(a, t - ne, own);
  }
  // stage C: the lakes read stage B's bank-edge fluxes, a block a lake
  // (nl and the block index are uniform in a block: its barriers are safe)
  if (a.nl > 0) {
    cg::this_grid().sync();
    lake_stage<T, D>(a);
  }
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
    barrier_probe(int n_sync) {
  for (int k = 0; k < n_sync; ++k) cg::this_grid().sync();
}

// pointer order of the entry points (mega.py _KERNEL_TABLES, then the
// forcing, the state, its tangent, the output, the scratch, the launch
// counter and the lakes' stage-C clock, null when not timed)
Args make_args(void* const* p, const int* d) {
  Args a;
  a.cell_f = static_cast<const float*>(p[0]);
  a.cell_i = static_cast<const int*>(p[1]);
  a.edge_f = static_cast<const float*>(p[2]);
  a.edge_i = static_cast<const int*>(p[3]);
  a.seg_f = static_cast<const float*>(p[4]);
  a.seg_i = static_cast<const int*>(p[5]);
  a.riv_f = static_cast<const float*>(p[6]);
  a.riv_i = static_cast<const int*>(p[7]);
  a.seg_to_ele = static_cast<const int*>(p[8]);
  a.seg_to_riv = static_cast<const int*>(p[9]);
  a.riv_up = static_cast<const int*>(p[10]);
  a.edge_to_lake = static_cast<const int*>(p[11]);
  a.riv_to_lake = static_cast<const int*>(p[12]);
  a.lake_zmin = static_cast<const float*>(p[13]);
  a.bathy_y = static_cast<const float*>(p[14]);
  a.bathy_a = static_cast<const float*>(p[15]);
  a.fcell = static_cast<const float*>(p[16]);
  a.friv = static_cast<const float*>(p[17]);
  a.segfu = static_cast<const float*>(p[18]);
  a.flake = static_cast<const float*>(p[19]);
  a.y = static_cast<const float*>(p[20]);
  a.ty = static_cast<const float*>(p[21]);
  a.out = static_cast<float*>(p[22]);
  a.s = static_cast<float*>(p[23]);
  a.count = static_cast<unsigned long long*>(p[24]);
  a.lake_ns = static_cast<long long*>(p[25]);
  a.ne = d[0]; a.nr = d[1]; a.ns = d[2]; a.nl = d[3];
  a.kc = d[4]; a.kr = d[5]; a.kup = d[6]; a.kel = d[7]; a.krl = d[8];
  a.kb = d[9]; a.close_boundary = d[10];
  return a;
}

// dims[11] is the grid in blocks of kBlock threads (mega.py launch_plan);
// a grid that does not cover every cell, reach and lake is refused, and so
// is one the card cannot hold resident (cudaLaunchCooperativeKernel)
template <bool T, bool D>
int launch_fused(void* const* ptrs, const int* dims, cudaStream_t stream) {
  Args a = make_args(ptrs, dims);
  const long long grid = dims[11];
  if (grid * kBlock < static_cast<long long>(a.ne) + a.nr + a.nl)
    return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&fused<T, D>), dim3(dims[11]),
      dim3(kBlock), params, 0, stream);
  cudaGetLastError();  // a refused launch leaves no sticky error behind
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// floats of scratch one evaluation needs
long long shud_mega_scratch_floats(int ne, int nr, int ns, int nl) {
  long long n = 2LL * kCellFields * ne + 2LL * nr + 1LL * kSegFields * ns;
  if (nl > 0) n += 3LL * kEdgeFields * ne;
  return n;
}

// what the card holds of the kernel of *kernel* (0 shud_mega_rhs, 1
// shud_mega_jvp, 2 shud_mega_diag): out = {blocks per SM (the occupancy
// query at kBlock threads), SMs, cooperative launch supported, registers
// a thread}
int shud_mega_occupancy(int kernel, int* out) {
  const void* fns[] = {reinterpret_cast<const void*>(&fused<false, false>),
                       reinterpret_cast<const void*>(&fused<true, false>),
                       reinterpret_cast<const void*>(&fused<false, true>)};
  if (kernel < 0 || kernel > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fns[kernel],
                                                        kBlock, 0);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fns[kernel]);
  if (err == cudaSuccess) out[3] = attr.numRegs;
  return static_cast<int>(err);
}

int shud_mega_rhs(void* const* ptrs, const int* dims, cudaStream_t stream) {
  return launch_fused<false, false>(ptrs, dims, stream);
}

int shud_mega_jvp(void* const* ptrs, const int* dims, cudaStream_t stream) {
  return launch_fused<true, false>(ptrs, dims, stream);
}

int shud_mega_diag(void* const* ptrs, const int* dims, cudaStream_t stream) {
  return launch_fused<false, true>(ptrs, dims, stream);
}

// A measurement, called only by chip_smoke.py: one cooperative launch of
// *grid* empty blocks of kBlock threads that meet at *n_sync* grid
// barriers, the fixed cost of the fused kernels' design.
int shud_mega_barrier_probe(int grid, int n_sync, cudaStream_t stream) {
  void* params[] = {&n_sync};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&barrier_probe), dim3(grid), dim3(kBlock),
      params, 0, stream);
  cudaGetLastError();
  return static_cast<int>(err);
}

}  // extern "C"
