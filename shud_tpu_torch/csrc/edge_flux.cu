// Edge-flux kernels for Hopper (sm_90a), with a plain C interface.
//
// They replace the Pallas TPU kernels of shud_tpu/core/pallas_edge.py:
//   edge_flux_kernel   <- _edge_kernel        (primal surface + subsurface q)
//   edge_coeff_kernel  <- _edge_kernel_coeff  (primal + six tangent coeffs)
//   edge_apply_kernel  <- _edge_kernel_apply  (J.v multiply-add)
// Their plain PyTorch versions are in shud_tpu_torch/core/edge.py, which
// builds this file with nvcc and binds it with ctypes.
//
// What bounds them: memory bandwidth.  Per edge the primal reads about
// 60 B (seven f32 tables, the neighbour index, two masks, the three own
// and three neighbour cell fields) and writes 8 B; the coefficient kernel
// writes 32 B on top; the apply kernel reads six coefficients and the
// tangents.  The arithmetic (one sqrt, one cbrt, a few divides) is far
// below the card's rate.  This first design does nothing yet about that
// bound: one thread per (cell, edge) over the flat [Ne,3] tables, the
// neighbour loaded straight from global memory (an RCM cell numbering
// keeps those loads close in L2), and per-edge outputs written back in
// full.  Later work: fuse the row sum into the epilogue, structure-of-
// arrays tables, and reuse the coefficients across Krylov vectors.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the caller allocates every output.  Each kernel adds
// one to *count (a device counter of edge.py's) where it runs, so that a
// launch replayed from a CUDA graph is counted as well.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kTiny = 1.0e-30f;   // physics._TINY
constexpr float kMaxYSurf = 0.5f;   // config.MAXYSURF
constexpr int kThreads = 256;

struct Tables {
  const int* nabr;        // [Ne,3] neighbour, -1 where not gathered
  const float* edge;      // [Ne,3] edge length
  const float* dist;      // [Ne,3] dist2nabor (1.0 off-interior)
  const float* avg_rough; // [Ne,3]
  const float* dzs;       // [Ne,3] z_surf_i - z_surf_nb
  const float* dzb;       // [Ne,3] z_bottom_i - z_bottom_nb
  const float* d2e;       // [Ne,3] centroid-to-edge distance
  const uint8_t* m_int;   // [Ne,3] interior law
  const uint8_t* m_bnd;   // [Ne,3] open-boundary law
  const float* dep;       // [Ne] depression threshold
  const float* rough;     // [Ne] cell roughness
};

// physics.cbrt: powf and one Newton step, 0 unless x > 0, rounded as the
// plain versions round it (cbrtf rounds differently, and one ulp parted the
// kernel and plain solves at the infiltration switch at 2.1M cells)
__device__ __forceinline__ float cbrt_plain(float x) {
  if (!(x > 0.f)) return 0.f;
  const float t = powf(x, 1.f / 3.f);
  return (2.f * t + x / (t * t)) * (1.f / 3.f);
}

__device__ __forceinline__ float pow23(float x) {
  float t = cbrt_plain(fmaxf(x, kTiny));
  return t * t;
}

__device__ __forceinline__ float mask_max0(float x) {
  return x > 0.f ? 1.f : (x == 0.f ? 0.5f : 0.f);
}

// Everything one edge needs, loaded once.
struct Edge {
  float sfi, gwi, khi, sfj, gwj, khj;
  float B, dist, ravg, dzs, dzb, d2e, dep, rcell;
  bool interior, boundary;
};

__device__ __forceinline__ Edge load_edge(const float* sf, const float* gw,
                                          const float* kh, const Tables& t,
                                          int e, int close_boundary) {
  Edge d;
  int i = e / 3;
  d.sfi = sf[i];
  d.gwi = gw[i];
  d.khi = kh[i];
  d.dep = t.dep[i];
  d.B = t.edge[e];
  d.interior = t.m_int[e] != 0;
  d.boundary = !close_boundary && t.m_bnd[e] != 0;
  d.sfj = d.gwj = d.khj = 0.f;
  d.dist = d.ravg = d.dzs = d.dzb = d.d2e = d.rcell = 1.f;
  if (d.interior) {
    int j = t.nabr[e];
    d.sfj = sf[j];
    d.gwj = gw[j];
    d.khj = kh[j];
    d.dist = t.dist[e];
    d.ravg = t.avg_rough[e];
    d.dzs = t.dzs[e];
    d.dzb = t.dzb[e];
  } else if (d.boundary) {
    d.d2e = t.d2e[e];
    d.rcell = t.rough[i];
  }
  return d;
}

// Interior diffusive-wave surface flux (pallas_edge._flux_surface_int).
struct SurfInt {
  float q, dh, w, ymean, s, sqrt_s, p23;
};

__device__ __forceinline__ SurfInt surface_int(float isf, float nsf,
                                               const Edge& d) {
  SurfInt r;
  r.dh = (isf - nsf) + d.dzs;
  float up1 = isf > d.dep ? isf : 0.f;
  float up2 = nsf > d.dep ? nsf : 0.f;
  r.w = r.dh > 0.f ? up1 : up2;
  r.ymean = fminf(r.w, kMaxYSurf);
  r.s = r.dh / d.dist;
  r.sqrt_s = sqrtf(fmaxf(fabsf(r.s), kTiny));
  r.p23 = pow23(r.ymean);
  float q_pos = r.sqrt_s * (r.ymean * d.B) * r.p23 / d.ravg;
  float q = r.s > 0.f ? q_pos : -q_pos;
  if (r.s > 0.f && isf <= 0.f) q = 0.f;
  if (r.s < 0.f && nsf <= 0.f) q = 0.f;
  if (r.ymean <= 0.f) q = 0.f;
  r.q = q;
  return r;
}

// Interior Darcy subsurface flux (pallas_edge._flux_sub_int).
struct SubInt {
  float q, ymean, grad, kmean;
  bool cut;
};

__device__ __forceinline__ SubInt sub_int(const Edge& d) {
  SubInt r;
  float dh = (d.gwi - d.gwj) + d.dzb;
  r.ymean = 0.5f * (fmaxf(d.gwi, 0.f) + fmaxf(d.gwj, 0.f));
  r.grad = dh / d.dist;
  r.kmean = 0.5f * (d.khi + d.khj);
  r.cut = (dh > 0.f && d.gwi <= 0.02f) || (dh < 0.f && d.gwj <= 0.02f);
  r.q = r.cut ? 0.f : r.kmean * r.grad * r.ymean * d.B;
  return r;
}

__global__ void edge_flux_kernel(const float* __restrict__ sf,
                                 const float* __restrict__ gw,
                                 const float* __restrict__ kh, Tables t,
                                 float* __restrict__ q_surf,
                                 float* __restrict__ q_sub,
                                 unsigned long long* count, int n_edges,
                                 int close_boundary) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) atomicAdd(count, 1ULL);
  if (e >= n_edges) return;
  Edge d = load_edge(sf, gw, kh, t, e, close_boundary);
  float isf = fmaxf(d.sfi, 0.f);
  float qs = 0.f, qb = 0.f;
  if (d.interior) {
    qs = surface_int(isf, fmaxf(d.sfj, 0.f), d).q;
    qb = sub_int(d).q;
  } else if (d.boundary) {
    // kinematic free drainage (pallas_edge._flux_surface_bnd/_sub_bnd)
    float sb = isf / d.d2e * 0.5f;
    float isf5 = cbrt_plain(isf * isf * isf * isf * isf);
    if (isf > d.dep && sb > 0.f)
      qs = sqrtf(fmaxf(sb, 0.f)) * isf5 * d.B / d.rcell;
    float grad_b = d.gwi / d.d2e * 0.5f;
    if (d.gwi > d.dep * 10.f && grad_b > 0.f) qb = d.khi * grad_b;
  }
  q_surf[e] = qs;
  q_sub[e] = qb;
}

// Primal + linearisation coefficients (pallas_edge._edge_kernel_coeff):
//   tq_surf = S_i t_sf_i + S_j t_sf_j
//   tq_sub  = G1 t_gw_i + G2 t_gw_j + K_i t_kh_i + K_j t_kh_j
__global__ void edge_coeff_kernel(
    const float* __restrict__ sf, const float* __restrict__ gw,
    const float* __restrict__ kh, Tables t, float* __restrict__ q_surf,
    float* __restrict__ q_sub, float* __restrict__ c_si,
    float* __restrict__ c_sj, float* __restrict__ c_g1,
    float* __restrict__ c_g2, float* __restrict__ c_ki,
    float* __restrict__ c_kj, unsigned long long* count, int n_edges,
    int close_boundary) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) atomicAdd(count, 1ULL);
  if (e >= n_edges) return;
  Edge d = load_edge(sf, gw, kh, t, e, close_boundary);
  float isf = fmaxf(d.sfi, 0.f);
  float m_i = mask_max0(d.sfi);  // d isf / d sf_i
  float qs = 0.f, qb = 0.f, si = 0.f, sj = 0.f, g1 = 0.f, g2 = 0.f;
  float ki = 0.f, kj = 0.f;
  if (d.interior) {
    float nsf = fmaxf(d.sfj, 0.f);
    float m_j = mask_max0(d.sfj);
    SurfInt r = surface_int(isf, nsf, d);
    qs = r.q;
    float cross = r.ymean * d.B;
    float gate = 1.f;
    if (r.s > 0.f && isf <= 0.f) gate = 0.f;
    if (r.s < 0.f && nsf <= 0.f) gate = 0.f;
    if (r.ymean <= 0.f) gate = 0.f;
    float sgn_q = r.s > 0.f ? 1.f : -1.f;
    float sgn_s = r.s >= 0.f ? 1.f : -1.f;
    float a = fabsf(r.s) > kTiny
                  ? sgn_s / (2.f * r.sqrt_s * d.dist) * cross * r.p23 / d.ravg
                  : 0.f;
    float c_p = r.ymean > kTiny
                    ? (2.f / 3.f) / cbrt_plain(fmaxf(r.ymean, kTiny)) : 0.f;
    float m_ym = r.w < kMaxYSurf ? 1.f : (r.w == kMaxYSurf ? 0.5f : 0.f);
    float b = r.sqrt_s * (d.B * r.p23 + cross * c_p) / d.ravg * m_ym;
    float u_i = (r.dh > 0.f && isf > d.dep) ? 1.f : 0.f;
    float u_j = (r.dh <= 0.f && nsf > d.dep) ? 1.f : 0.f;
    float gs = gate * sgn_q;
    si = gs * (a + b * u_i) * m_i;
    sj = gs * (-a + b * u_j) * m_j;

    SubInt u = sub_int(d);
    qb = u.q;
    float live = u.cut ? 0.f : 1.f;
    float km_ym_d = u.kmean * u.ymean / d.dist;
    float half_kg = 0.5f * u.kmean * u.grad;
    g1 = live * d.B * (km_ym_d + half_kg * mask_max0(d.gwi));
    g2 = live * d.B * (-km_ym_d + half_kg * mask_max0(d.gwj));
    ki = kj = live * d.B * 0.5f * u.grad * u.ymean;
  } else if (d.boundary) {
    float sb = isf / d.d2e * 0.5f;
    float isf5 = cbrt_plain(isf * isf * isf * isf * isf);
    float sqrt_sb = sqrtf(fmaxf(sb, 0.f));
    if (isf > d.dep && sb > 0.f) {
      qs = sqrt_sb * isf5 * d.B / d.rcell;
      float c_sqrt_sb = 0.5f / (d.d2e * 2.f * sqrt_sb);
      float u4 = isf * isf * isf * isf;
      float c_isf5 = 5.f * u4 / (3.f * isf5 * isf5);
      si = (c_sqrt_sb * isf5 + sqrt_sb * c_isf5) * d.B / d.rcell * m_i;
    }
    float grad_b = d.gwi / d.d2e * 0.5f;
    if (d.gwi > d.dep * 10.f && grad_b > 0.f) {
      qb = d.khi * grad_b;
      g1 = d.khi * 0.5f / d.d2e;
      ki = grad_b;
    }
  }
  q_surf[e] = qs;
  q_sub[e] = qb;
  c_si[e] = si;
  c_sj[e] = sj;
  c_g1[e] = g1;
  c_g2[e] = g2;
  c_ki[e] = ki;
  c_kj[e] = kj;
}

// J.v: gather the tangent fields and apply the coefficients
// (pallas_edge._edge_kernel_apply); no flux-law recompute.
__global__ void edge_apply_kernel(
    const float* __restrict__ tsf, const float* __restrict__ tgw,
    const float* __restrict__ tkh, const int* __restrict__ nabr,
    const float* __restrict__ c_si, const float* __restrict__ c_sj,
    const float* __restrict__ c_g1, const float* __restrict__ c_g2,
    const float* __restrict__ c_ki, const float* __restrict__ c_kj,
    float* __restrict__ tq_surf, float* __restrict__ tq_sub,
    unsigned long long* count, int n_edges) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) atomicAdd(count, 1ULL);
  if (e >= n_edges) return;
  int i = e / 3;
  int j = nabr[e];
  float tsf_j = 0.f, tgw_j = 0.f, tkh_j = 0.f;
  if (j >= 0) {
    tsf_j = tsf[j];
    tgw_j = tgw[j];
    tkh_j = tkh[j];
  }
  tq_surf[e] = c_si[e] * tsf[i] + c_sj[e] * tsf_j;
  tq_sub[e] = c_g1[e] * tgw[i] + c_g2[e] * tgw_j + c_ki[e] * tkh[i] +
              c_kj[e] * tkh_j;
}

Tables make_tables(const int* nabr, const float* edge, const float* dist,
                   const float* avg_rough, const float* dzs, const float* dzb,
                   const float* d2e, const uint8_t* m_int,
                   const uint8_t* m_bnd, const float* dep,
                   const float* rough) {
  return Tables{nabr, edge, dist, avg_rough, dzs, dzb,
                d2e,  m_int, m_bnd, dep,      rough};
}

int blocks_for(int n_edges) { return (n_edges + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int shud_edge_flux(const float* sf, const float* gw, const float* kh,
                   const int* nabr, const float* edge, const float* dist,
                   const float* avg_rough, const float* dzs, const float* dzb,
                   const float* d2e, const uint8_t* m_int,
                   const uint8_t* m_bnd, const float* dep, const float* rough,
                   float* q_surf, float* q_sub, unsigned long long* count,
                   int ne, int close_boundary, cudaStream_t stream) {
  int n_edges = 3 * ne;
  if (n_edges > 0) {
    Tables t = make_tables(nabr, edge, dist, avg_rough, dzs, dzb, d2e, m_int,
                           m_bnd, dep, rough);
    edge_flux_kernel<<<blocks_for(n_edges), kThreads, 0, stream>>>(
        sf, gw, kh, t, q_surf, q_sub, count, n_edges, close_boundary);
  }
  return static_cast<int>(cudaGetLastError());
}

int shud_edge_coeff(const float* sf, const float* gw, const float* kh,
                    const int* nabr, const float* edge, const float* dist,
                    const float* avg_rough, const float* dzs, const float* dzb,
                    const float* d2e, const uint8_t* m_int,
                    const uint8_t* m_bnd, const float* dep, const float* rough,
                    float* q_surf, float* q_sub, float* c_si, float* c_sj,
                    float* c_g1, float* c_g2, float* c_ki, float* c_kj,
                    unsigned long long* count, int ne, int close_boundary,
                    cudaStream_t stream) {
  int n_edges = 3 * ne;
  if (n_edges > 0) {
    Tables t = make_tables(nabr, edge, dist, avg_rough, dzs, dzb, d2e, m_int,
                           m_bnd, dep, rough);
    edge_coeff_kernel<<<blocks_for(n_edges), kThreads, 0, stream>>>(
        sf, gw, kh, t, q_surf, q_sub, c_si, c_sj, c_g1, c_g2, c_ki, c_kj,
        count, n_edges, close_boundary);
  }
  return static_cast<int>(cudaGetLastError());
}

int shud_edge_apply(const float* tsf, const float* tgw, const float* tkh,
                    const int* nabr, const float* c_si, const float* c_sj,
                    const float* c_g1, const float* c_g2, const float* c_ki,
                    const float* c_kj, float* tq_surf, float* tq_sub,
                    unsigned long long* count, int ne, cudaStream_t stream) {
  int n_edges = 3 * ne;
  if (n_edges > 0) {
    edge_apply_kernel<<<blocks_for(n_edges), kThreads, 0, stream>>>(
        tsf, tgw, tkh, nabr, c_si, c_sj, c_g1, c_g2, c_ki, c_kj, tq_surf,
        tq_sub, count, n_edges);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
