// K1 cellpack: per-cell black-oil property pack with forward-mode jets.
//
// Replaces the TPU kernel opm_autodiff_tpu/ops/pallas_cellpack.py
// (cellpack_planes / _make_kernel). One thread per cell evaluates the
// whole property chain of models/structured.pack_cell — PVT (PVTW, PVTO
// 2-D undersaturated table, PVDG or PVTG 2-D table), SWOF/SGOF with
// end-point scaling, three-phase kro, densities, mobilities, rock
// compaction, accumulation — carrying value + 3 tangents (po, sw, x3) in
// registers, and writes the 17 channels in plane layout:
//   q [nz, 17, ny*nx], dq [nz, 17, 3, ny*nx]   (x fastest: coalesced).
// Tables live in one float buffer in device memory; ``meta`` holds the
// region counts, padded lengths and offsets (layout in ops/cellpack.py).
// Table lookups are a binary search (a point on a node belongs to the
// right segment), max/min follow the reference's tie rule.
//
// Bound: bytes. Per cell it reads ~100 B of inputs and writes 272 B of
// outputs; the table reads hit L1/L2. The jet arithmetic (~2k flops) is
// far below the card's f32 rate, so the design keeps all of it in
// registers and makes every global store coalesced along x.

#include "common.cuh"

namespace {

enum Meta {
  M_R_SAT = 0, M_R_OIL, M_R_GAS, M_R_WAT, M_R_ROCK, M_R_RHO, M_WET,
  M_NSW, M_NSG, M_NPS, M_MPO, M_NPG, M_MPG,
  M_O_SW, M_O_KRW, M_O_KROW, M_O_PCOW, M_O_SG, M_O_KRG, M_O_KROG, M_O_PCOG,
  M_O_PSAT, M_O_RS, M_O_UP, M_O_UB, M_O_UBM,
  M_O_PG, M_O_G1, M_O_G2, M_O_G3, M_O_G4,
  M_O_WAT, M_O_ROCK, M_O_RHO, M_O_EP,
  M_NB_REAL,               // 8 entries: real PVTO branches per region
  M_NP_REAL = M_NB_REAL + 8,  // 8 entries: real PVTG lines per region
  M_SIZE = M_NP_REAL + 8
};

__device__ __forceinline__ int reg_row(int R, int reg) {
  return R == 1 ? 0 : reg;
}

// 2-D undersaturated table: the two lines bracketing ``b`` on the blend
// axis (nodes ``bn``, real line count ``nreal``), each interpolated at
// ``a`` along its own rows (linear extrapolation), blended linearly in b
// (LiveOilPvt._usat / WetGasPvt._usat)
__device__ J usat2d(J a, J b, const float* bn, int nb, int nreal,
                    const float* rows_x, const float* rows_v, int m) {
  int hi = nreal - 2;
  if (hi < 0) hi = 0;
  int i = seg_right(bn, nb, b.v, hi);
  J v0 = jinterp(a, rows_x + i * m, rows_v + i * m, m, true);
  J v1 = jinterp(a, rows_x + (i + 1) * m, rows_v + (i + 1) * m, m, true);
  float x0 = bn[i], x1 = bn[i + 1];
  float k = 1.f / (x1 - x0);
  return jadd(v0, jmul(jscale(k, jsub(v1, v0)), jaddc(b, -x0)));
}

// two-point horizontal EPS remap of a jet: cell [ac, bc] -> table [at, bt]
__device__ __forceinline__ J remap(J s, float ac, float bc, float at,
                                   float bt) {
  float den = fmaxf(bc - ac, 1e-12f);
  float f = (bt - at) / den;
  return jaddc(jscale(f, jaddc(s, -ac)), at);
}

__device__ __forceinline__ float ech(const float* e, int ch, float dflt) {
  if (e == nullptr) return dflt;
  float v = e[ch];
  return isnan(v) ? dflt : v;
}

__global__ void cellpack_kernel(const float* __restrict__ u,
                                const int* __restrict__ flag,
                                const float* __restrict__ pv_ref,
                                const float* __restrict__ mob_mult,
                                const int* __restrict__ regs,
                                const float* __restrict__ eps,
                                const float* __restrict__ tab,
                                const int* __restrict__ meta,
                                float* __restrict__ q,
                                float* __restrict__ dq,
                                long long n_cells, long long nxy) {
  long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int R_SAT = meta[M_R_SAT], R_OIL = meta[M_R_OIL],
            R_GAS = meta[M_R_GAS], R_WAT = meta[M_R_WAT],
            R_ROCK = meta[M_R_ROCK], R_RHO = meta[M_R_RHO];
  const bool wet = meta[M_WET] != 0;
  const int NSW = meta[M_NSW], NSG = meta[M_NSG], NPS = meta[M_NPS],
            MPO = meta[M_MPO], NPG = meta[M_NPG], MPG = meta[M_MPG];
  const int sreg = regs[2 * c], preg = regs[2 * c + 1];
  const int rs_ = reg_row(R_SAT, sreg), ro = reg_row(R_OIL, preg),
            rg = reg_row(R_GAS, preg), rw = reg_row(R_WAT, preg),
            rr = reg_row(R_ROCK, preg), rd = reg_row(R_RHO, preg);
  const float* e = eps ? eps + 12 * c : nullptr;

  // --- per-region table rows ---
  const float* sw_n = tab + meta[M_O_SW] + rs_ * NSW;
  const float* krw_v = tab + meta[M_O_KRW] + rs_ * NSW;
  const float* krow_v = tab + meta[M_O_KROW] + rs_ * NSW;
  const float* pcow_v = tab + meta[M_O_PCOW] + rs_ * NSW;
  const float* sg_n = tab + meta[M_O_SG] + rs_ * NSG;
  const float* krg_v = tab + meta[M_O_KRG] + rs_ * NSG;
  const float* krog_v = tab + meta[M_O_KROG] + rs_ * NSG;
  const float* pcog_v = tab + meta[M_O_PCOG] + rs_ * NSG;
  const float* psat_n = tab + meta[M_O_PSAT] + ro * NPS;
  const float* rs_v = tab + meta[M_O_RS] + ro * NPS;
  const float* up = tab + meta[M_O_UP] + ro * NPS * MPO;
  const float* ub = tab + meta[M_O_UB] + ro * NPS * MPO;
  const float* ubm = tab + meta[M_O_UBM] + ro * NPS * MPO;
  const float* pg_n = tab + meta[M_O_PG] + rg * NPG;
  const float* wat = tab + meta[M_O_WAT];
  const float* rock = tab + meta[M_O_ROCK];
  const float* rho = tab + meta[M_O_RHO] + 3 * rd;
  const float* ep = tab + meta[M_O_EP];
  const int nb_real = meta[M_NB_REAL + ro];

  // unscaled end points of the cell's SATNUM region (EPS frame)
  const float swl_t = ep[0 * R_SAT + rs_], swcr_t = ep[1 * R_SAT + rs_],
              swu_t = ep[2 * R_SAT + rs_], sw0w_t = ep[3 * R_SAT + rs_],
              sgcr_t = ep[4 * R_SAT + rs_], sgu_t = ep[5 * R_SAT + rs_],
              sg0g_t = ep[6 * R_SAT + rs_], krwmx_t = ep[7 * R_SAT + rs_],
              kromx_t = ep[8 * R_SAT + rs_], krgmx_t = ep[9 * R_SAT + rs_],
              swco_t = ep[10 * R_SAT + rs_];
  const bool has_eps = e != nullptr;

  const J po = J{u[3 * c], 1.f, 0.f, 0.f};
  const J sw = J{u[3 * c + 1], 0.f, 1.f, 0.f};
  const J x3 = J{u[3 * c + 2], 0.f, 0.f, 1.f};
  const int fl = flag[c];
  const bool is_sg = fl == 0, is_rs = fl == 1, is_rv = fl == 2;
  const J one = jc(1.f), zero = jc(0.f);

  J sg = is_sg ? x3 : (is_rv ? jsub(one, sw) : zero);
  J so = jsub(jsub(one, sw), sg);

  // saturated Rs (linear extrapolation, >= 0), capped by the DRSDT channel
  J rs_sat = jmax(jinterp(po, psat_n, rs_v, NPS, true), zero);
  J rs = is_rs ? x3 : jmin(rs_sat, jc(mob_mult[5 * c + 3]));

  // --- capillary pressures (SatFunc.pcow / pcog) ---
  J pcow;
  {
    J s_in = sw;
    float mult = 1.f;
    if (has_eps) {
      s_in = remap(sw, ech(e, 0, swl_t), ech(e, 2, swu_t), swl_t, swu_t);
      mult = ech(e, 10, 1.f);
    }
    pcow = jscale(mult, jinterp(s_in, sw_n, pcow_v, NSW, false));
  }
  J pcog = jscale(has_eps ? ech(e, 11, 1.f) : 1.f,
                  jinterp(sg, sg_n, pcog_v, NSG, false));
  J pw = jsub(po, pcow);
  J pg = jadd(po, pcog);

  // --- vaporized oil ---
  J rv = zero, rv_sat = zero;
  if (wet) {
    const float* rvt = tab + meta[M_O_G1] + rg * NPG;
    rv_sat = jmax(jinterp(pg, pg_n, rvt, NPG, true), zero);
    rv = is_rv ? x3 : jmin(rv_sat, jc(mob_mult[5 * c + 4]));
  }

  // --- water (PVTW second-order expansions) ---
  const float w_pref = wat[0 * R_WAT + rw], w_invb = wat[1 * R_WAT + rw],
              w_comp = wat[2 * R_WAT + rw], w_mu = wat[3 * R_WAT + rw],
              w_visco = wat[4 * R_WAT + rw];
  J xw = jscale(w_comp, jaddc(pw, -w_pref));
  J inv_bw = jscale(w_invb, jadd(jaddc(xw, 1.f), jscale(0.5f, jmul(xw, xw))));
  J yw = jscale(-w_visco, jaddc(pw, -w_pref));
  J mu_w = jdiv(jc(w_mu), jadd(jaddc(yw, 1.f), jscale(0.5f, jmul(yw, yw))));

  // --- live oil: the 2-D table at rs clamped to RsSat(po) ---
  J rs_eff = jmin(rs, rs_sat);
  J inv_bo = usat2d(po, rs_eff, rs_v, NPS, nb_real, up, ub, MPO);
  J ibmu_o = usat2d(po, rs_eff, rs_v, NPS, nb_real, up, ubm, MPO);
  J mu_o = jdiv(inv_bo, jmax(ibmu_o, jc(1e-12f)));

  // --- gas: dry (PVDG) or wet (PVTG 2-D table at rv clamped to RvSat) ---
  J inv_bg, mu_g;
  if (wet) {
    const int np_real = meta[M_NP_REAL + rg];
    const float* urv = tab + meta[M_O_G2] + rg * NPG * MPG;
    const float* ugb = tab + meta[M_O_G3] + rg * NPG * MPG;
    const float* ugbm = tab + meta[M_O_G4] + rg * NPG * MPG;
    J rv_eff = jmin(rv, rv_sat);
    inv_bg = usat2d(rv_eff, pg, pg_n, NPG, np_real, urv, ugb, MPG);
    J ibmu_g = usat2d(rv_eff, pg, pg_n, NPG, np_real, urv, ugbm, MPG);
    mu_g = jdiv(inv_bg, jmax(ibmu_g, jc(1e-12f)));
  } else {
    const float* gb = tab + meta[M_O_G1] + rg * NPG;
    const float* gbm = tab + meta[M_O_G2] + rg * NPG;
    inv_bg = jinterp(pg, pg_n, gb, NPG, true);
    J ibmu_g = jinterp(pg, pg_n, gbm, NPG, true);
    mu_g = jdiv(inv_bg, jmax(ibmu_g, jc(1e-12f)));
  }

  // --- relative permeabilities (SatFunc.krw/krow/krog/krg/kro) ---
  float s_krw = 1.f, s_kro = 1.f, s_krg = 1.f;
  float swl_c = swl_t, swcr_c = swcr_t, swu_c = swu_t, sw0w_c = sw0w_t;
  float sgcr_c = sgcr_t, sgu_c = sgu_t, sg0g_c = sg0g_t, swco_c = swco_t;
  if (has_eps) {
    swl_c = ech(e, 0, swl_t); swcr_c = ech(e, 1, swcr_t);
    swu_c = ech(e, 2, swu_t); sw0w_c = ech(e, 3, sw0w_t);
    sgcr_c = ech(e, 4, sgcr_t); sgu_c = ech(e, 5, sgu_t);
    sg0g_c = ech(e, 6, sg0g_t);
    s_krw = ech(e, 7, krwmx_t) / fmaxf(krwmx_t, 1e-12f);
    s_kro = ech(e, 8, kromx_t) / fmaxf(kromx_t, 1e-12f);
    s_krg = ech(e, 9, krgmx_t) / fmaxf(krgmx_t, 1e-12f);
    swco_c = ech(e, 0, swco_t);
  }
  auto krow_of = [&](J s) {
    J s_in = has_eps ? remap(s, swl_c, sw0w_c, swl_t, sw0w_t) : s;
    return jscale(s_kro, jmax(jinterp(s_in, sw_n, krow_v, NSW, false), zero));
  };
  J s_w = has_eps ? remap(sw, swcr_c, swu_c, swcr_t, swu_t) : sw;
  J krw = jscale(s_krw, jmax(jinterp(s_w, sw_n, krw_v, NSW, false), zero));
  J krow = krow_of(sw);
  J s_og = has_eps ? remap(sg, 0.f, sg0g_c, 0.f, sg0g_t) : sg;
  J krog = jscale(s_kro, jmax(jinterp(s_og, sg_n, krog_v, NSG, false), zero));
  J s_g = has_eps ? remap(sg, sgcr_c, sgu_c, sgcr_t, sgu_t) : sg;
  J krg = jscale(s_krg, jmax(jinterp(s_g, sg_n, krg_v, NSG, false), zero));
  J swn = jmax(jaddc(sw, -swco_c), zero);
  J den = jadd(sg, swn);
  bool ok = den.v > 1e-12f;
  // (sg krog + swn krow) / den written as krow + sg (krog - krow) / den:
  // the same function, but its float32 derivative does not cancel as
  // swn -> 0 (sw just above connate water)
  J mixed = jadd(krow, jdiv(jmul(sg, jsub(krog, krow)), ok ? den : one));
  J kro = ok ? mixed : krow_of(jc(swco_c));

  // --- densities, mobilities ---
  const float rho_w_s = rho[0], rho_o_s = rho[1], rho_g_s = rho[2];
  J rho_w = jscale(rho_w_s, inv_bw);
  J rho_o = jmul(jaddc(jscale(rho_g_s, rs), rho_o_s), inv_bo);
  J rho_g = jmul(jaddc(jscale(rho_o_s, rv), rho_g_s), inv_bg);
  J mob_w = jscale(mob_mult[5 * c + 0], jdiv(krw, mu_w));
  J mob_o = jscale(mob_mult[5 * c + 1], jdiv(kro, mu_o));
  J mob_g = jscale(mob_mult[5 * c + 2], jdiv(krg, mu_g));

  // --- pore volume with rock compaction, accumulation ---
  const float r_pref = rock[0 * R_ROCK + rr], r_comp = rock[1 * R_ROCK + rr];
  J xr = jscale(r_comp, jaddc(po, -r_pref));
  J pv = jscale(pv_ref[c], jadd(jaddc(xr, 1.f), jscale(0.5f, jmul(xr, xr))));
  J aw = jmul(pv, jmul(sw, inv_bw));
  J so_bo = jmul(so, inv_bo);
  J sg_bg = jmul(sg, inv_bg);
  J ao = jmul(pv, jadd(so_bo, jmul(rv, sg_bg)));
  J ag = jmul(pv, jadd(sg_bg, jmul(rs, so_bo)));

  const J outs[17] = {pw, po, pg, inv_bw, inv_bo, inv_bg, mob_w, mob_o,
                      mob_g, rho_w, rho_o, rho_g, rs, rv, aw, ao, ag};
  const long long k = c / nxy, p = c % nxy;
#pragma unroll
  for (int ch = 0; ch < 17; ++ch) {
    q[(k * 17 + ch) * nxy + p] = outs[ch].v;
    float* d = dq + ((k * 17 + ch) * 3) * nxy + p;
    d[0] = outs[ch].d0;
    d[nxy] = outs[ch].d1;
    d[2 * nxy] = outs[ch].d2;
  }
}

}  // namespace

OPM_API int opm_cellpack(const float* u, const int* flag, const float* pv,
                         const float* mob, const int* regs, const float* eps,
                         const float* tab, const int* meta, float* q,
                         float* dq, long long n_cells, long long nxy,
                         void* stream) {
  if (n_cells <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n_cells + threads - 1) / threads;
  cellpack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      u, flag, pv, mob, regs, eps, tab, meta, q, dq, n_cells, nxy);
  return (int)cudaGetLastError();
}

OPM_API int opm_cellpack_meta_size() { return M_SIZE; }
