// Neighbor-pass kernel for Hopper (sm_90a): one SPH pair-sum traversal of
// the lane-major flat cell grid.
//
// Replaces cpp_fluid_particles_tpu/ops/pallas_passes.py:107 `column_pass`
// (the Pallas kernel that evaluates a pass body over (CZ, K_i, 27K_j) pair
// blocks per (x, y) cell column). It computes what that kernel computes with
// `_std_body` (pallas_passes.py:780): the one-sided 27-cell fluid pair sum
// plus the boundary term, for sixteen pass instances (template functors
// below), every instance of that Pallas kernel. WCSPH: density,
// density_colorgrad_visc, surface_pressure and, with surface effects off,
// density_visc and pressure_force. DFSPH: density_alpha_colorgrad
// (density_alpha with surface effects off), divergence, stiffness_accel,
// and the fluid-only viscosity and surface. PBD: pbd_lambda and
// stiffness_accel in every projection iteration, then xsph_colorgrad and
// surface (the fluid-only xsph with surface effects off). color_gradient
// and density_colorgrad, which no step runs, complete the set.
//
// Layout (ops/dense.py): fl (Fi, K, G) and bd (Fb=4, Kb, G), float32,
// contiguous, G = GX*GY*GZ the flattened ghosted cell axis (x-major). Slot k
// of cell c holds the particle of rank k; ranks fill slots contiguously
// from 0 and empty slots hold POS_PAD positions. Output (n_out, K, G). A
// fluid-only pass (kBoundary false) takes no boundary operand: the wrapper
// passes bd = nullptr and kb = 0, and the boundary loop is compiled out.
//
// Design. One thread per (k_i, c), t = k_i*G + c, so neighbouring threads
// read neighbouring cells and the i loads and the j loads at c+d coalesce.
// For each of the 27 offsets in the reference's m-order, the thread walks
// the neighbour cell's slots and stops at the first padding position, then
// does the same over the boundary window. The n_out sums live in registers
// and are stored once: no atomics and no shared memory, so results are
// bitwise reproducible run to run. Ghost cells and empty i slots store 0.
//
// Bound: pair evaluations (about 27*K per real i slot, cut at each cell's
// occupancy by the early exit) and the neighbour loads, which hit L2 — each
// j cell is re-read by the 27 cells around it. Every instance shares that
// traversal; they differ in the rows loaded per pair (4 to 9 floats), in
// the i-side values held (3 to 6, positions plus velocities or derived
// scalars) and in the sums kept in registers (1 to 9,
// density_alpha_colorgrad the most; xsph_colorgrad holds 7 sums beside
// six i values), which set the register count and so the occupancy.
//
// flat_pass_kernel (below) replaces exp/flat_pallas_proto.py:67
// `flat_pallas_pass`, the prototype that serves all 27 offsets of a tile
// from one VMEM window of the flat cell axis. Its three bodies are the fluid
// halves of density, stiffness_accel and density_colorgrad_visc
// (FluidOnly<P>). A flat-axis window cannot fit a Hopper block (its halo is
// a whole x-plane, 1.3 MB at the dam's shapes), so each block stages a 3-D
// brick of cells with a one-cell halo into shared memory and serves every
// offset from there: each staged cell is read from device memory once per
// brick instead of once per neighbour. The same three functors also run
// untiled (column_pass_kernel<FluidOnly<P>>) as its timing yardstick; the
// times of both, on each brick, are in PERF.md's kernel table.
//
// particle_pass_kernel (below) has fourteen instances and runs six on
// the main path: divergence, density_colorgrad_visc,
// density_alpha_colorgrad, the surface-off density_visc, (PBD with
// surface effects off) the fluid-only xsph, and the scene build's density
// over the boundary grid. A group of lanes per particle of the slot list
// splits that particle's 27-cell walk, and the group's sums are reduced by
// an xor butterfly or, for passes with many sums, a transpose reduction.
// record_pass_kernel (below) runs four more, surface_pressure,
// xsph_colorgrad and the fluid-only surface and viscosity, in the same
// groups over a cell-packed copy of the operand that pack_kernel writes
// once per call, and counted_pass_kernel the last four, pbd_lambda,
// stiffness_accel and the surface-off pressure_force and density_alpha,
// over one position pack (count_pack_kernel) that serves every pass on the
// same positions; their particle-list instances stay as their bitwise
// yardstick. No path
// launches column_pass_kernel any more: it runs only as the yardstick of
// those fourteen (the note above the particle template says why it is
// slower) and for color_gradient and density_colorgrad, which nothing
// runs.
//
// Support is tested BEFORE the kernel polynomials are evaluated: against a
// POS_PAD slot r ~ 1.7e6 and the Akinci piece overflows float32 to inf,
// which a zero mass would turn into NaN. The float constants are computed
// on the host in double, as the Python does, and passed in as float.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

// Order and count must match ops/column_pass_cuda.py:_consts.
struct Consts {
  float h;          // smoothing radius
  float eps_k;      // kernel support epsilon (ops/kernels.py EPS)
  float eps;        // cfg.epsilon
  float pi;         // float(PI)
  float w_a;        // 0.25 / (pi h^3)
  float h5;         // h^5
  float pih6;       // pi h^6
  float pih9;       // pi h^9
  float c0156h6;    // 0.0156 h^6
  float rho0;
  float rho_b;      // cfg.rho_boundary
  float st_coef;    // 0.25 / rho0^2 * surface_tension
  float air_coef;   // air_pressure / rho0^2
  float pos_guard;  // POS_PAD / 2: a slot is real iff its x < pos_guard
  float r2_cut;     // (h (1 + 1e-4))^2: no pair farther apart is in_support
};

constexpr int kThreads = 256;

// --- smoothing kernels (ops/kernels.py), same operation order ---

__device__ __forceinline__ float w_cubic(float r, const Consts& c) {
  const float q = 2.f * r / c.h;
  if (!(q >= c.eps_k && q <= 2.f)) return 0.f;
  const float t = 2.f - q;
  const float v = (q > 1.f) ? t * (t * t) : (3.f * q - 6.f) * q * q + 4.f;
  return c.w_a * v;
}

__device__ __forceinline__ float grad_w_cubic_coef(float r, const Consts& c) {
  const float q = 2.f * r / c.h;
  if (!(q <= 2.f)) return 0.f;
  const float f = (q > 1.f) ? (12.f - 3.f * q) * q - 12.f : (9.f * q - 12.f) * q;
  return f / (c.pi * (q + c.eps_k) * c.h5);
}

__device__ __forceinline__ float w_visc_laplacian(float r, const Consts& c) {
  return (r <= c.h) ? 45.f * (c.h - r) / c.pih6 : 0.f;
}

__device__ __forceinline__ float grad_w_surface_coef(float r, const Consts& c) {
  if (!(r >= c.eps_k && r <= c.h)) return 0.f;
  const float hx = c.h - r;
  const float hx3 = hx * (hx * hx);
  const float r3 = r * (r * r);
  const float piece = (2.f * r <= c.h) ? 2.f * hx3 * r3 - c.c0156h6 : hx3 * r3;
  return -136.0241f * piece / (c.pih9 * fmaxf(r, c.eps_k));
}

// A pair can contribute only inside the widest support of the kernels
// above (cubic: q <= 2; viscosity and Akinci: r <= h). Each kernel still
// applies its own exact guard.
__device__ __forceinline__ bool in_support(float r, const Consts& c) {
  return (2.f * r / c.h <= 2.f) || (r <= c.h);
}

// --- pass functors. Row r of a grid with slot stride kg is at r*kg + t.
// kBoundary: whether the pass sums over the boundary operand (bdry). ---

// p / max(eps, rho^2) from rows [.., rho (4), p (5)]
__device__ __forceinline__ float p_over_rho2(const float* f, int64_t t,
                                             int64_t kg, const Consts& c) {
  const float rho = f[4 * kg + t];
  return f[5 * kg + t] / fmaxf(c.eps, rho * rho);
}
// the same in 32-bit indices, for the counted walk (f's Fi*K*G under 2^31)
__device__ __forceinline__ float p_over_rho2(const float* f, int t, int kg,
                                             const Consts& c) {
  const float rho = f[4 * kg + t];
  return f[5 * kg + t] / fmaxf(c.eps, rho * rho);
}

// |cg|^2 from the three rows starting at row, each product and sum rounded
// once, in the plain executor's order, and never contracted into an fma:
// the record kernel's pack (pack_kernel) forms it once per slot and the
// other kernels per pair, and all of them, and the pack's plain version,
// must give the same bits
__device__ __forceinline__ float cg2(const float* f, int64_t t, int64_t kg,
                                     int row) {
  const float gx = f[row * kg + t], gy = f[(row + 1) * kg + t],
              gz = f[(row + 2) * kg + t];
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// i-side loads shared by the instances below
struct Pos {
  float x, y, z;
};
struct PosVel {
  float x, y, z, vx, vy, vz;
};
__device__ __forceinline__ Pos load_pos(const float* fl, int64_t t,
                                        int64_t kg) {
  return {fl[t], fl[kg + t], fl[2 * kg + t]};
}
__device__ __forceinline__ PosVel load_pos_vel(const float* fl, int64_t t,
                                               int64_t kg) {
  return {fl[t],          fl[kg + t],     fl[2 * kg + t],
          fl[4 * kg + t], fl[5 * kg + t], fl[6 * kg + t]};
}

// rho = sum m_j W (pallas_passes.py:874); fl = bd = [pos3, mass].
struct DensityPass {
  static constexpr int kOut = 1;
  static constexpr bool kBoundary = true;
  using I = Pos;
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos(fl, t, kg);
  }
  __device__ static void fluid(float* acc, const I&, const float* fl,
                               int64_t tj, int64_t kg, float, float, float,
                               float r, const Consts& c) {
    acc[0] += fl[3 * kg + tj] * w_cubic(r, c);
  }
  __device__ static void bdry(float* acc, const I& i, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    fluid(acc, i, bd, tj, kbg, dx, dy, dz, r, c);
  }
};

// WCSPH traversal 1 (pallas_passes.py:1238): fl = [pos3, mass, vel3].
// Outputs [rho, numx, numy, numz, den, dvx, dvy, dvz].
struct DensityColorgradViscPass {
  static constexpr int kOut = 8;
  static constexpr bool kBoundary = true;
  using I = PosVel;
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos_vel(fl, t, kg);
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    const float mj = fl[3 * kg + tj];
    const float w = w_cubic(r, c);
    const float cw = grad_w_cubic_coef(r, c);
    const float lap = w_visc_laplacian(r, c) / c.rho0;
    const float volj = mj / c.rho0;
    const float cj = volj * cw;
    acc[0] += mj * w;
    acc[1] += cj * dx;
    acc[2] += cj * dy;
    acc[3] += cj * dz;
    acc[4] += volj * w;
    acc[5] += mj * (lap * (fl[4 * kg + tj] - i.vx));
    acc[6] += mj * (lap * (fl[5 * kg + tj] - i.vy));
    acc[7] += mj * (lap * (fl[6 * kg + tj] - i.vz));
  }
  __device__ static void bdry(float* acc, const I&, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    const float mb = bd[3 * kbg + tj];
    const float w = w_cubic(r, c);
    const float volj = mb / c.rho_b;
    const float cj = volj * grad_w_cubic_coef(r, c);
    acc[0] += mb * w;
    acc[1] += cj * dx;
    acc[2] += cj * dy;
    acc[3] += cj * dz;
    acc[4] += volj * w;
  }
};

// WCSPH traversal 2 (pallas_passes.py:1316): fl = [pos3, mass, rho, p,
// cg3]. Outputs [sax, say, saz, pax, pay, paz] (pa before the MAX_A clamp).
// J is a slot's j side, {|cg|^2, p / max(eps, rho^2)}: the functor forms it
// per pair from the rows (side), record_pass_kernel once per slot in the
// pack (pack_kernel); terms and bdry_terms then run the same float
// operations on either.
struct SurfacePressurePass {
  static constexpr int kOut = 6;
  static constexpr bool kBoundary = true;
  struct I {
    float x, y, z, c2, gate, p_rho2;
  };
  using J = float2;
  __device__ static J side(const float* f, int64_t t, int64_t kg,
                           const Consts& c) {
    return make_float2(cg2(f, t, kg, 6), p_over_rho2(f, t, kg, c));
  }
  __device__ static I make_i(float x, float y, float z, J j,
                             const Consts& c) {
    const float n = sqrtf(j.x);
    return {x, y, z, j.x, n / fmaxf(c.eps, n), j.y};
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts& c) {
    return make_i(fl[t], fl[kg + t], fl[2 * kg + t], side(fl, t, kg, c), c);
  }
  __device__ static void terms(float* acc, const I& i, float mj, J j,
                               float dx, float dy, float dz, float r,
                               const Consts& c) {
    const float cw = grad_w_cubic_coef(r, c);
    const float st = c.st_coef * (i.c2 + j.x) * grad_w_surface_coef(r, c);
    const float ms = mj * (st + c.air_coef * i.gate * cw);
    const float mp = mj * ((i.p_rho2 + j.y) * cw);
    acc[0] += ms * dx;
    acc[1] += ms * dy;
    acc[2] += ms * dz;
    acc[3] -= mp * dx;
    acc[4] -= mp * dy;
    acc[5] -= mp * dz;
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    terms(acc, i, fl[3 * kg + tj], side(fl, tj, kg, c), dx, dy, dz, r, c);
  }
  __device__ static void bdry_terms(float* acc, const I& i, float mb,
                                    float dx, float dy, float dz, float r,
                                    const Consts& c) {
    const float coefb = -mb * i.p_rho2 * grad_w_cubic_coef(r, c);
    acc[3] += coefb * dx;
    acc[4] += coefb * dy;
    acc[5] += coefb * dz;
  }
  __device__ static void bdry(float* acc, const I& i, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    bdry_terms(acc, i, bd[3 * kbg + tj], dx, dy, dz, r, c);
  }
};

// DFSPH [rho, gsumx, gsumy, gsumz, slam] (src/DFSPHSolver.cu:212-249) into
// acc[0..4]; slam is a fluid-only sum.
__device__ __forceinline__ void alpha_fluid(float* acc, float mj, float w,
                                            float cw, float dx, float dy,
                                            float dz) {
  const float mcj = mj * cw;
  acc[0] += mj * w;
  acc[1] += mcj * dx;
  acc[2] += mcj * dy;
  acc[3] += mcj * dz;
  acc[4] += mj * mj * (cw * cw * (dx * dx + dy * dy + dz * dz));
}
__device__ __forceinline__ void alpha_bdry(float* acc, float mb, float w,
                                           float cw, float dx, float dy,
                                           float dz) {
  const float mcb = mb * cw;
  acc[0] += mb * w;
  acc[1] += mcb * dx;
  acc[2] += mcb * dy;
  acc[3] += mcb * dz;
}

// He-2014 color-field sums [numx, numy, numz, den] into acc[0..3]
__device__ __forceinline__ void colorgrad(float* acc, float m, float rho_ref,
                                          float w, float cw, float dx,
                                          float dy, float dz) {
  const float vol = m / rho_ref;
  const float cj = vol * cw;
  acc[0] += cj * dx;
  acc[1] += cj * dy;
  acc[2] += cj * dz;
  acc[3] += vol * w;
}

// DFSPH density + alpha terms (pallas_passes.py:1047): fl = bd = [pos3,
// mass]. Outputs [rho, gsumx, gsumy, gsumz, slam]. The counted record
// interface (kCounted; see counted_pass_kernel): as PbdLambdaPass's, the
// pass reads nothing of j but its position and mass, so make_i and terms
// ignore the operand's planes; terms is fluid's alpha_fluid, bdry_terms
// bdry's alpha_bdry, over a record's mass.
struct DensityAlphaPass {
  static constexpr int kOut = 5;
  static constexpr bool kBoundary = true;
  static constexpr bool kCounted = true;
  static constexpr int kRows = 4;
  using I = Pos;
  __device__ static I make_i(float x, float y, float z, const float*, int,
                             int) {
    return {x, y, z};
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos(fl, t, kg);
  }
  __device__ static void terms(float* acc, const I&, float mj, const float*,
                               int, int, float dx, float dy, float dz,
                               float r, const Consts& c) {
    alpha_fluid(acc, mj, w_cubic(r, c), grad_w_cubic_coef(r, c), dx, dy,
                dz);
  }
  __device__ static void bdry_terms(float* acc, const I&, float mb,
                                    float dx, float dy, float dz, float r,
                                    const Consts& c) {
    alpha_bdry(acc, mb, w_cubic(r, c), grad_w_cubic_coef(r, c), dx, dy, dz);
  }
  __device__ static void fluid(float* acc, const I&, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    alpha_fluid(acc, fl[3 * kg + tj], w_cubic(r, c), grad_w_cubic_coef(r, c),
                dx, dy, dz);
  }
  __device__ static void bdry(float* acc, const I&, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    alpha_bdry(acc, bd[3 * kbg + tj], w_cubic(r, c), grad_w_cubic_coef(r, c),
               dx, dy, dz);
  }
};

// DFSPH rho+alpha terms + color field (pallas_passes.py:1416): fl = bd =
// [pos3, mass]. Outputs [rho, gsumx, gsumy, gsumz, slam, numx, numy, numz,
// den].
struct DensityAlphaColorgradPass {
  static constexpr int kOut = 9;
  static constexpr bool kBoundary = true;
  using I = Pos;
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos(fl, t, kg);
  }
  __device__ static void fluid(float* acc, const I&, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    const float mj = fl[3 * kg + tj];
    const float w = w_cubic(r, c);
    const float cw = grad_w_cubic_coef(r, c);
    alpha_fluid(acc, mj, w, cw, dx, dy, dz);
    colorgrad(acc + 5, mj, c.rho0, w, cw, dx, dy, dz);
  }
  __device__ static void bdry(float* acc, const I&, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    const float mb = bd[3 * kbg + tj];
    const float w = w_cubic(r, c);
    const float cw = grad_w_cubic_coef(r, c);
    alpha_bdry(acc, mb, w, cw, dx, dy, dz);
    colorgrad(acc + 5, mb, c.rho_b, w, cw, dx, dy, dz);
  }
};

// Velocity divergence (src/DFSPHSolver.cu:74-92; pallas_passes.py:1097):
// fl = [pos3, mass, vel3]. sum_f m_j (v_i - v_j).gradW + sum_b m_b
// v_i.gradW.
struct DivergencePass {
  static constexpr int kOut = 1;
  static constexpr bool kBoundary = true;
  using I = PosVel;
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos_vel(fl, t, kg);
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    const float t = grad_w_cubic_coef(r, c) *
                    ((i.vx - fl[4 * kg + tj]) * dx +
                     (i.vy - fl[5 * kg + tj]) * dy +
                     (i.vz - fl[6 * kg + tj]) * dz);
    acc[0] += fl[3 * kg + tj] * t;
  }
  __device__ static void bdry(float* acc, const I& i, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    const float cwb = bd[3 * kbg + tj] * grad_w_cubic_coef(r, c);
    acc[0] += cwb * (i.vx * dx + i.vy * dy + i.vz * dz);
  }
};

// Stiffness acceleration (src/DFSPHSolver.cu:118-136; pallas_passes.py:
// 1124): fl = [pos3, mass, stiff]. sum_f m_j (s_i + s_j) gradW + sum_b m_b
// s_i gradW. The counted record interface (kCounted; see
// counted_pass_kernel): make_i takes x, y, z from a record and s_i from
// the operand's plane f (row stride kg) at the particle's slot t; terms
// takes m_j from a record and loads s_j from the plane at the pair's slot
// tj after the support test, as fluid does; bdry_terms takes m_b.
struct StiffnessAccelPass {
  static constexpr int kOut = 3;
  static constexpr bool kBoundary = true;
  static constexpr bool kCounted = true;
  static constexpr int kRows = 5;
  struct I {
    float x, y, z, s;
  };
  __device__ static I make_i(float x, float y, float z, const float* f,
                             int64_t t, int64_t kg) {
    return {x, y, z, f[4 * kg + t]};
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return make_i(fl[t], fl[kg + t], fl[2 * kg + t], fl, t, kg);
  }
  __device__ static void terms(float* acc, const I& i, float mj,
                               const float* f, int64_t tj, int64_t kg,
                               float dx, float dy, float dz, float r,
                               const Consts& c) {
    const float s = (i.s + f[4 * kg + tj]) * grad_w_cubic_coef(r, c);
    acc[0] += mj * (s * dx);
    acc[1] += mj * (s * dy);
    acc[2] += mj * (s * dz);
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    terms(acc, i, fl[3 * kg + tj], fl, tj, kg, dx, dy, dz, r, c);
  }
  __device__ static void bdry_terms(float* acc, const I& i, float mb,
                                    float dx, float dy, float dz, float r,
                                    const Consts& c) {
    const float coefb = mb * i.s * grad_w_cubic_coef(r, c);
    acc[0] += coefb * dx;
    acc[1] += coefb * dy;
    acc[2] += coefb * dz;
  }
  __device__ static void bdry(float* acc, const I& i, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    bdry_terms(acc, i, bd[3 * kbg + tj], dx, dy, dz, r, c);
  }
};

// Mueller viscosity sum m_j lap (v_j - v_i) into acc[0..2]; vj = the j
// velocity, {vx, vy, vz, 0}
__device__ __forceinline__ void visc(float* acc, const PosVel& i, float4 vj,
                                     float mj, float r, const Consts& c) {
  const float lap = w_visc_laplacian(r, c) / c.rho0;
  acc[0] += mj * (lap * (vj.x - i.vx));
  acc[1] += mj * (lap * (vj.y - i.vy));
  acc[2] += mj * (lap * (vj.z - i.vz));
}

// The record interface of a pass whose j side is the slot's velocity
// alone (viscosity): J = {vx, vy, vz, 0}, copied from the rows with no
// arithmetic, so the record kernel's walk takes it in one 16-byte load;
// the i side takes its velocity from its own slot's J. density_visc's
// functor loads its j velocity through side too.
struct VelocitySide {
  using I = PosVel;
  using J = float4;
  __device__ static J side(const float* f, int64_t t, int64_t kg,
                           const Consts&) {
    return make_float4(f[4 * kg + t], f[5 * kg + t], f[6 * kg + t], 0.f);
  }
  __device__ static I make_i(float x, float y, float z, J j, const Consts&) {
    return {x, y, z, j.x, j.y, j.z};
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos_vel(fl, t, kg);
  }
};

// Mueller viscosity (src/BasicSPHSolver.cu:183-225; pallas_passes.py:929),
// fluid only: fl = [pos3, mass, vel3]. Outputs [dvx, dvy, dvz].
struct ViscosityPass : VelocitySide {
  static constexpr int kOut = 3;
  static constexpr bool kBoundary = false;
  __device__ static void terms(float* acc, const I& i, float mj, J j, float,
                               float, float, float r, const Consts& c) {
    visc(acc, i, j, mj, r, c);
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    terms(acc, i, fl[3 * kg + tj], side(fl, tj, kg, c), dx, dy, dz, r, c);
  }
};

// Surface tension + air pressure from a carried color gradient
// (src/BasicSPHSolver.cu:332-370; pallas_passes.py:1013), fluid only:
// fl = [pos3, mass, cg3]. Outputs [sax, say, saz]. J, a slot's j side, is
// |cg|^2, formed as SurfacePressurePass forms its J.
struct SurfacePass {
  static constexpr int kOut = 3;
  static constexpr bool kBoundary = false;
  struct I {
    float x, y, z, c2, gate;
  };
  using J = float;
  __device__ static J side(const float* f, int64_t t, int64_t kg,
                           const Consts&) {
    return cg2(f, t, kg, 4);
  }
  __device__ static I make_i(float x, float y, float z, J j,
                             const Consts& c) {
    const float n = sqrtf(j);
    return {x, y, z, j, n / fmaxf(c.eps, n)};
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts& c) {
    return make_i(fl[t], fl[kg + t], fl[2 * kg + t], side(fl, t, kg, c), c);
  }
  __device__ static void terms(float* acc, const I& i, float mj, J j,
                               float dx, float dy, float dz, float r,
                               const Consts& c) {
    const float st = c.st_coef * (i.c2 + j) * grad_w_surface_coef(r, c);
    const float ms = mj * (st + c.air_coef * i.gate * grad_w_cubic_coef(r, c));
    acc[0] += ms * dx;
    acc[1] += ms * dy;
    acc[2] += ms * dz;
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    terms(acc, i, fl[3 * kg + tj], side(fl, tj, kg, c), dx, dy, dz, r, c);
  }
};

// rho + Mueller viscosity (pallas_passes.py:1284), the surface-off WCSPH
// traversal 1: fl = [pos3, mass, vel3]. Outputs [rho, dvx, dvy, dvz]; the
// boundary contributes to rho only. It has no record instance (it lost
// through the records; see the record kernel's note), but its fluid term
// loads the j velocity as viscosity's does, one float4 (side) before the
// sums: its particle-list kernel ran 8% faster that way than with each row
// loaded inside visc (0.0451-0.0460 against 0.0492-0.0503 ms at W 8
// transposed on one frozen WCSPH state; PERF.md section 6).
struct DensityViscPass : VelocitySide {
  static constexpr int kOut = 4;
  static constexpr bool kBoundary = true;
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float, float, float,
                               float r, const Consts& c) {
    const float mj = fl[3 * kg + tj];
    const J vj = side(fl, tj, kg, c);
    acc[0] += mj * w_cubic(r, c);
    visc(acc + 1, i, vj, mj, r, c);
  }
  __device__ static void bdry(float* acc, const I&, const float* bd,
                              int64_t tj, int64_t kbg, float, float, float,
                              float r, const Consts& c) {
    acc[0] += bd[3 * kbg + tj] * w_cubic(r, c);
  }
};

// Symmetric pressure acceleration (src/BasicSPHSolver.cu:113-165;
// pallas_passes.py:893), the surface-off WCSPH traversal 2: fl = [pos3,
// mass, rho, p]. Outputs [pax, pay, paz] before the MAX_A clamp. The
// counted record interface (kCounted; see counted_pass_kernel), as
// StiffnessAccelPass's but in 32-bit indices: make_i takes x, y, z from a
// record and p_i / max(eps, rho_i^2) from the operand's planes 4 and 5 at
// the particle's slot t; terms takes m_j from a record and loads rho_j and
// p_j from the planes at the pair's slot tj after the support test, in
// fluid's float operations and order; bdry_terms is bdry over m_b.
struct PressureForcePass {
  static constexpr int kOut = 3;
  static constexpr bool kBoundary = true;
  static constexpr bool kCounted = true;
  static constexpr bool kIConsts = true;
  static constexpr int kRows = 6;
  struct I {
    float x, y, z, p_rho2;
  };
  __device__ static I make_i(float x, float y, float z, const float* f,
                             int t, int kg, const Consts& c) {
    return {x, y, z, p_over_rho2(f, t, kg, c)};
  }
  __device__ static void terms(float* acc, const I& i, float mj,
                               const float* f, int tj, int kg, float dx,
                               float dy, float dz, float r, const Consts& c) {
    const float s =
        (i.p_rho2 + p_over_rho2(f, tj, kg, c)) * grad_w_cubic_coef(r, c);
    acc[0] -= mj * (s * dx);
    acc[1] -= mj * (s * dy);
    acc[2] -= mj * (s * dz);
  }
  __device__ static void bdry_terms(float* acc, const I& i, float mb,
                                    float dx, float dy, float dz, float r,
                                    const Consts& c) {
    const float coefb = -mb * i.p_rho2 * grad_w_cubic_coef(r, c);
    acc[0] += coefb * dx;
    acc[1] += coefb * dy;
    acc[2] += coefb * dz;
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts& c) {
    return {fl[t], fl[kg + t], fl[2 * kg + t], p_over_rho2(fl, t, kg, c)};
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    const float s = (i.p_rho2 + p_over_rho2(fl, tj, kg, c)) * grad_w_cubic_coef(r, c);
    const float mj = fl[3 * kg + tj];
    acc[0] -= mj * (s * dx);
    acc[1] -= mj * (s * dy);
    acc[2] -= mj * (s * dz);
  }
  __device__ static void bdry(float* acc, const I& i, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    const float coefb = -bd[3 * kbg + tj] * i.p_rho2 * grad_w_cubic_coef(r, c);
    acc[0] += coefb * dx;
    acc[1] += coefb * dy;
    acc[2] += coefb * dz;
  }
};

// PBD density + lambda sums (src/PBDSolver.cu:127-168; pallas_passes.py:
// 1156-1198): fl = bd = [pos3, mass]. Outputs [rho, gsumx, gsumy, gsumz,
// slam] with the gradient divided by rho0 once per pair. Fluid and boundary
// take the same form, so the boundary adds to slam too (unlike alpha_bdry).
// The counted record interface (kCounted; see counted_pass_kernel): the
// pass reads nothing of j but its position and mass, so make_i and terms
// ignore the operand's planes.
struct PbdLambdaPass {
  static constexpr int kOut = 5;
  static constexpr bool kBoundary = true;
  static constexpr bool kCounted = true;
  static constexpr int kRows = 4;
  using I = Pos;
  __device__ static I make_i(float x, float y, float z, const float*,
                             int64_t, int64_t) {
    return {x, y, z};
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos(fl, t, kg);
  }
  __device__ static void terms(float* acc, const I&, float mj, const float*,
                               int64_t, int64_t, float dx, float dy,
                               float dz, float r, const Consts& c) {
    alpha_fluid(acc, mj, w_cubic(r, c), grad_w_cubic_coef(r, c) / c.rho0,
                dx, dy, dz);
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    terms(acc, i, fl[3 * kg + tj], fl, tj, kg, dx, dy, dz, r, c);
  }
  __device__ static void bdry_terms(float* acc, const I& i, float mb,
                                    float dx, float dy, float dz, float r,
                                    const Consts& c) {
    terms(acc, i, mb, nullptr, 0, 0, dx, dy, dz, r, c);
  }
  __device__ static void bdry(float* acc, const I& i, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    bdry_terms(acc, i, bd[3 * kbg + tj], dx, dy, dz, r, c);
  }
};

// XSPH sum m_j (v_j - v_i) W into acc[0..2]
__device__ __forceinline__ void xsph(float* acc, const PosVel& i,
                                     const float* fl, int64_t tj, int64_t kg,
                                     float mj, float w) {
  acc[0] += mj * (w * (fl[4 * kg + tj] - i.vx));
  acc[1] += mj * (w * (fl[5 * kg + tj] - i.vy));
  acc[2] += mj * (w * (fl[6 * kg + tj] - i.vz));
}

// XSPH viscosity + color field (pallas_passes.py:1377), PBD with surface
// effects on: fl = [pos3, mass, vel3]. Outputs [dvx, dvy, dvz, numx, numy,
// numz, den]; the boundary adds to the color field only. J, a slot's j
// side, is {vx, vy, vz, m / rho0}, the volume formed before it multiplies
// as colorgrad forms it, so the pack (pack_kernel) forms it once per slot
// and the other kernels per pair (side) with the same bits; the i side
// takes its velocity from its own slot's J. The boundary's volume m_b /
// rho_b stays a division per pair: its record is {x, y, z, m} alone.
struct XsphColorgradPass {
  static constexpr int kOut = 7;
  static constexpr bool kBoundary = true;
  using I = PosVel;
  using J = float4;
  __device__ static J side(const float* f, int64_t t, int64_t kg,
                           const Consts& c) {
    return make_float4(f[4 * kg + t], f[5 * kg + t], f[6 * kg + t],
                       __fdiv_rn(f[3 * kg + t], c.rho0));
  }
  __device__ static I make_i(float x, float y, float z, J j, const Consts&) {
    return {x, y, z, j.x, j.y, j.z};
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts& c) {
    return make_i(fl[t], fl[kg + t], fl[2 * kg + t], side(fl, t, kg, c), c);
  }
  __device__ static void terms(float* acc, const I& i, float mj, J j,
                               float dx, float dy, float dz, float r,
                               const Consts& c) {
    const float w = w_cubic(r, c);
    acc[0] += mj * (w * (j.x - i.vx));
    acc[1] += mj * (w * (j.y - i.vy));
    acc[2] += mj * (w * (j.z - i.vz));
    const float cj = j.w * grad_w_cubic_coef(r, c);
    acc[3] += cj * dx;
    acc[4] += cj * dy;
    acc[5] += cj * dz;
    acc[6] += j.w * w;
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    terms(acc, i, fl[3 * kg + tj], side(fl, tj, kg, c), dx, dy, dz, r, c);
  }
  __device__ static void bdry_terms(float* acc, const I&, float mb, float dx,
                                    float dy, float dz, float r,
                                    const Consts& c) {
    colorgrad(acc + 3, mb, c.rho_b, w_cubic(r, c), grad_w_cubic_coef(r, c),
              dx, dy, dz);
  }
  __device__ static void bdry(float* acc, const I& i, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    bdry_terms(acc, i, bd[3 * kbg + tj], dx, dy, dz, r, c);
  }
};

// XSPH viscosity (src/PBDSolver.cu:89-125; pallas_passes.py:953), PBD with
// surface effects off, fluid only: fl = [pos3, mass, vel3]. Outputs [dvx,
// dvy, dvz].
struct XsphPass {
  static constexpr int kOut = 3;
  static constexpr bool kBoundary = false;
  using I = PosVel;
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos_vel(fl, t, kg);
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float, float, float,
                               float r, const Consts& c) {
    xsph(acc, i, fl, tj, kg, fl[3 * kg + tj], w_cubic(r, c));
  }
};

// He-2014 color field (src/BasicSPHSolver.cu:277-318; pallas_passes.py:992):
// fl = bd = [pos3, mass]. Outputs [numx, numy, numz, den], the fluid with
// rho0 and the boundary with rho_boundary. No step runs it.
struct ColorGradientPass {
  static constexpr int kOut = 4;
  static constexpr bool kBoundary = true;
  using I = Pos;
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos(fl, t, kg);
  }
  __device__ static void fluid(float* acc, const I&, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    colorgrad(acc, fl[3 * kg + tj], c.rho0, w_cubic(r, c),
              grad_w_cubic_coef(r, c), dx, dy, dz);
  }
  __device__ static void bdry(float* acc, const I&, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    colorgrad(acc, bd[3 * kbg + tj], c.rho_b, w_cubic(r, c),
              grad_w_cubic_coef(r, c), dx, dy, dz);
  }
};

// rho + color field (pallas_passes.py:1207): fl = bd = [pos3, mass].
// Outputs [rho, numx, numy, numz, den]. No step runs it.
struct DensityColorgradPass {
  static constexpr int kOut = 5;
  static constexpr bool kBoundary = true;
  using I = Pos;
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return load_pos(fl, t, kg);
  }
  __device__ static void fluid(float* acc, const I&, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    const float mj = fl[3 * kg + tj];
    const float w = w_cubic(r, c);
    acc[0] += mj * w;
    colorgrad(acc + 1, mj, c.rho0, w, grad_w_cubic_coef(r, c), dx, dy, dz);
  }
  __device__ static void bdry(float* acc, const I&, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    const float mb = bd[3 * kbg + tj];
    const float w = w_cubic(r, c);
    acc[0] += mb * w;
    colorgrad(acc + 1, mb, c.rho_b, w, grad_w_cubic_coef(r, c), dx, dy, dz);
  }
};

// One candidate pair of every kernel below: i particle iv against slot tj
// of f (row stride kg, row 0 already loaded as xj): the separation, its
// length, and inside the support the functor's fluid or boundary terms.
// Every kernel runs these float operations in this order. Most candidates
// (over 80% on the dam) lie outside the support; the squared-distance test
// turns them away before the square root and in_support's division.
template <class P, bool kFluid>
__device__ __forceinline__ void pair_terms(float* acc,
                                           const typename P::I& iv,
                                           const float* f, int64_t tj,
                                           int64_t kg, float xj,
                                           const Consts& c) {
  const float dx = iv.x - xj;
  const float dy = iv.y - f[kg + tj];
  const float dz = iv.z - f[2 * kg + tj];
  const float d2 = dx * dx + dy * dy + dz * dz;
  // in_support needs r <= h (1 + 2^-23), so d2 <= h^2 (1 + 3 * 2^-23): a
  // pair past r2_cut is rejected without its square root and division,
  // and every other pair is tested exactly as before
  if (!(d2 <= c.r2_cut)) return;
  const float r = sqrtf(d2);
  if (!in_support(r, c)) return;
  if constexpr (kFluid)
    P::fluid(acc, iv, f, tj, kg, dx, dy, dz, r, c);
  else
    P::bdry(acc, iv, f, tj, kg, dx, dy, dz, r, c);
}

// Neighbour cell cj of the grids in device memory (slot stride g): its
// fluid slots up to the first padding slot (ranks fill a cell from slot 0),
// then its boundary slots the same way.
template <class P>
__device__ __forceinline__ void walk_cell(float* acc, const typename P::I& iv,
                                          const float* fl, const float* bd,
                                          int64_t cj, int64_t g, int64_t kg,
                                          int k, int64_t kbg, int kb,
                                          const Consts& c) {
  for (int s = 0; s < k; ++s) {
    const int64_t tj = s * g + cj;
    const float xj = fl[tj];
    if (!(xj < c.pos_guard)) break;
    pair_terms<P, true>(acc, iv, fl, tj, kg, xj, c);
  }
  if constexpr (P::kBoundary) {
    for (int s = 0; s < kb; ++s) {
      const int64_t tj = s * g + cj;
      const float xj = bd[tj];
      if (!(xj < c.pos_guard)) break;
      pair_terms<P, false>(acc, iv, bd, tj, kbg, xj, c);
    }
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads)
    column_pass_kernel(const float* __restrict__ fl,
                       const float* __restrict__ bd, float* __restrict__ out,
                       int k, int kb, int gx, int gy, int gz, Consts c) {
  const int64_t g = static_cast<int64_t>(gx) * gy * gz;
  const int64_t kg = k * g;
  const int64_t kbg = kb * g;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= kg) return;
  const int64_t cell = t % g;
  const int64_t gyz = static_cast<int64_t>(gy) * gz;
  const int x = static_cast<int>(cell / gyz);
  const int y = static_cast<int>((cell / gz) % gy);
  const int z = static_cast<int>(cell % gz);
  const bool interior =
      x > 0 && x < gx - 1 && y > 0 && y < gy - 1 && z > 0 && z < gz - 1;

  float acc[P::kOut];
#pragma unroll
  for (int n = 0; n < P::kOut; ++n) acc[n] = 0.f;

  if (interior && fl[t] < c.pos_guard) {
    const typename P::I iv = P::load_i(fl, t, kg, c);
    for (int o = 0; o < 27; ++o) {
      const int64_t cj =
          cell + (o / 9 - 1) * gyz + ((o % 9) / 3 - 1) * gz + (o % 3 - 1);
      walk_cell<P>(acc, iv, fl, bd, cj, g, kg, k, kbg, kb, c);
    }
  }
#pragma unroll
  for (int n = 0; n < P::kOut; ++n) out[n * kg + t] = acc[n];
}

template <class P>
cudaError_t launch(const float* fl, const float* bd, float* out, int k, int kb,
                   int gx, int gy, int gz, const Consts& c,
                   cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(k) * gx * gy * gz;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  column_pass_kernel<P><<<blocks, kThreads, 0, stream>>>(fl, bd, out, k, kb,
                                                         gx, gy, gz, c);
  return cudaGetLastError();
}

// --- the particle-list kernel (PbdLambdaPass, StiffnessAccelPass,
// DivergencePass, SurfacePressurePass, DensityColorgradViscPass,
// XsphColorgradPass, DensityAlphaColorgradPass, DensityViscPass,
// PressureForcePass, DensityAlphaPass, ViscosityPass, SurfacePass,
// XsphPass and DensityPass) ---
//
// Replaces the same TPU kernel as column_pass_kernel, pallas_passes.py:107
// `column_pass`, for fourteen instances: the PBD projection passes
// pbd_lambda and stiffness_accel and the DFSPH Jacobi pass stiffness_accel
// (which the steps run through counted_pass_kernel, below, with these
// instances as its yardstick, as they run WCSPH's surface-off
// pressure_force and DFSPH's surface-off density_alpha), the DFSPH Jacobi
// pass divergence (each runs in every iteration of its solve), WCSPH's two
// traversals density_colorgrad_visc and surface_pressure, PBD's
// xsph_colorgrad, DFSPH's density_alpha_colorgrad, WCSPH's surface-off
// density_visc and pressure_force, DFSPH's surface-off density_alpha, and
// the fluid-only viscosity (DFSPH), surface (DFSPH and PBD) and xsph (PBD,
// surface effects off), each once a frame; and density once a scene, the
// Akinci boundary mass, over the boundary grid with its own slot list
// (ops/dense.py DenseIndex.slots, trash K*G as here) and a zero-mass clone
// of that grid as the boundary operand, so its boundary terms add +0.0.
// column_pass_kernel gives every (slot,
// cell) of the ghosted grid a thread: at these shapes (27^3 cells, K 16-22)
// that is 315k-354k threads of which 6% hold a particle, scattered over the
// warps, and each busy thread walks its 27 neighbour cells alone, a chain of
// some 300-400 dependent load-and-test steps; a warp waits on its densest
// lane. What bounds that kernel is the latency of the chain, not bytes or
// operations (PERF.md section 6). Here the chain is about 27/W cells long.
// What bounds the fourteen instances is the pair step and where its loads
// are served from. Cut-down copies of this kernel (divergence, device
// time; PERF.md section 6 gives the method) spend 12% of a launch on the
// launch, memset, slot decode and store, 21% on the walk's row-0 tests,
// 31% on the pair geometry (rows 1-2 loaded after row 0's test, sqrtf,
// in_support) and 36% on the functor (its rows loaded after the support
// test): each lane's slots form a chain of dependent loads. The same
// kernel took 13% less time on divergence with the slot list in
// cell-major order (ops/box.py BoxIndex.work, which the steps hand it),
// and 17% less at W 8: the four particles of a warp then mostly share
// their cell, so one load serves them all, and a block's neighbour rows
// stay in L1. A second design that split each particle's candidate pairs
// evenly over its lanes, with 32-bit indexing, did not beat this one
// (PERF.md, section 6).
//
// The three fluid-only instances (kBoundary false: viscosity, surface and
// xsph, 3 sums each) take bd = nullptr and kb = 0 and walk the 27 fluid
// cells only,
// the boundary loop compiled out: at W 32, 27 lanes take one cell each and
// 5 hold zeros. Their i side is per lane: every lane of a group loads the
// particle's rows itself (surface also forms |cg|^2 and its sqrtf gate),
// which costs no shuffle but repeats that work W times.
//
// Here a group of W lanes (8, 16 or 32, inside one warp) serves one
// particle of the list islots (the step's ops/box.py BoxIndex.work, for
// surface_pressure BoxIndex.slots, or for the scene's density the
// boundary's DenseIndex.slots: (N,) int64 into the
// flat (K, G) slot axis; an invalid particle holds the trash value K*G and
// its group does nothing). Lane l takes the offsets l, l+W,
// l+2W, ... < 27 in the reference's m-order and walks each neighbour cell
// exactly as column_pass_kernel does (fluid slots up to the first padding
// slot, then the boundary slots, the same functor), which cuts the chain to
// about 27/W cells. The group's P::kOut sums are then reduced over its
// lanes in a fixed order, by one of two reductions chosen at compile time:
//
// - kTranspose false, the xor butterfly: log2 W xor steps, each adding
//   every sum, so kOut * log2 W shuffles per lane (40 at W 32 for 8 sums);
//   every lane then holds every sum, and lane n % W stores sum n, so in a
//   group narrower than kOut (density_alpha_colorgrad's 9 sums at W 8)
//   lane 0 stores sums 0 and 8.
// - kTranspose true, the transpose reduction for passes with many sums: the
//   sums are padded with zeros to S, the least power of two >= kOut. At the
//   xor steps m = W/2, W/4, ..., W/S a lane keeps half of the sums it still
//   holds (the upper half where lane & m is set), sends its partner the
//   other half and adds the partner's copy of the half it keeps; after
//   those log2 S steps it holds the one sum whose index has the bits of
//   lane / (W/S), and plain xor adds over the remaining log2(W/S) steps
//   complete it. S - 1 + log2(W/S) shuffles per lane (7 at W 8 and 9 at
//   W 32 for 8 sums, where the butterfly takes 24 and 40); lane n * W/S
//   stores sum n. The sums are indexed with compile-time constants only
//   (transpose_step below), so acc stays in registers. Each lane ends
//   with one sum, so the transpose needs S <= W: for 9 sums S is 16 and
//   only W 16 and 32 take it (launch_reduction refuses W 8), where lanes
//   n * W/16 for n < 9 store and the lanes of the padded sums 9-15 do not.
//
// Both add the same pairs of lanes in the same order, so their outputs are
// bitwise equal; they differ only in the shuffles each lane issues.
//
// No lane returns before the shuffles: they take the full-warp mask, and
// lanes without a particle join them with zero sums. No atomics, so two
// launches are bitwise equal; the sum order differs from
// column_pass_kernel's, so the two agree to rounding, not bitwise. A sum no
// pair contributes to stays +-0 (a reduction over zeros), which PBD's exact
// all-lambda-zero exit relies on. The kernel writes only the listed slots:
// the caller zeroes the output (ops/column_pass_cuda.py
// particle_pass_cuda), so ghost cells and empty slots read 0.

// the least power of two >= n
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// the halving steps of the transpose reduction: at xor distance M a lane
// keeps sums [0, H) or [H, 2H) of the 2H it holds (the upper half where
// lane & M is set), moved to acc[0..H), and adds its partner's copy
template <int H, int M, int S>
__device__ __forceinline__ void transpose_step(float (&acc)[S], int lane) {
  if constexpr (H > 0) {
    const bool upper = (lane & M) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = upper ? acc[j] : acc[j + H];
      const float keep = upper ? acc[j + H] : acc[j];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    transpose_step<H / 2, M / 2>(acc, lane);
  }
}

// A group's S sums (kOut, padded to S where kTranspose) reduced over its W
// lanes as set out above, and stored at slot t of out (row stride kg) if
// active: the record kernel's reduction. particle_pass_kernel writes the
// same steps out itself; calling this instead changed its SASS (see
// separation below). Groups are W-aligned inside the warp, so xor by m < W
// stays in the group.
template <int kOut, int W, bool kTranspose, int S>
__device__ __forceinline__ void reduce_store(float (&acc)[S], int lane,
                                             bool active,
                                             float* __restrict__ out,
                                             int64_t t, int64_t kg) {
  if constexpr (kTranspose) {
    transpose_step<S / 2, W / 2>(acc, lane);
#pragma unroll
    for (int m = W / (2 * S); m > 0; m >>= 1)
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], m);
    constexpr int kStride = W / S;  // lane n * kStride holds sum n
    if (active && lane % kStride == 0 && lane / kStride < kOut)
      out[(lane / kStride) * kg + t] = acc[0];
  } else {
#pragma unroll
    for (int m = W / 2; m > 0; m >>= 1) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (lane == j % W) out[j * kg + t] = acc[j];
    }
  }
}

template <class P, int W, bool kTranspose>
__global__ void __launch_bounds__(kThreads)
    particle_pass_kernel(const float* __restrict__ fl,
                         const float* __restrict__ bd,
                         const int64_t* __restrict__ islots,
                         float* __restrict__ out, int n, int k, int kb,
                         int gx, int gy, int gz, Consts c) {
  static_assert(W == 8 || W == 16 || W == 32,
                "a group is 8, 16 or 32 lanes of one warp");
  // the sums held per lane: kOut, padded to a power of two to transpose
  constexpr int S = kTranspose ? pow2_at_least(P::kOut) : P::kOut;
  static_assert(!kTranspose || S <= W,
                "the transpose leaves each lane one sum: every sum needs a "
                "lane to store it");
  static_assert(kThreads % 32 == 0, "blocks hold whole warps");
  const int64_t g = static_cast<int64_t>(gx) * gy * gz;
  const int64_t kg = k * g;
  const int64_t kbg = kb * g;
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / W;
  const int lane = static_cast<int>(threadIdx.x % W);
  const int64_t t = p < n ? islots[p] : kg;  // kg: the trash slot

  // every test below reads only t, so it is uniform across the group
  bool active = t >= 0 && t < kg;
  int64_t cell = 0;
  const int64_t gyz = static_cast<int64_t>(gy) * gz;
  if (active) {
    cell = t % g;
    const int x = static_cast<int>(cell / gyz);
    const int y = static_cast<int>((cell / gz) % gy);
    const int z = static_cast<int>(cell % gz);
    active = x > 0 && x < gx - 1 && y > 0 && y < gy - 1 && z > 0 &&
             z < gz - 1 && fl[t] < c.pos_guard;
  }

  float acc[S];
#pragma unroll
  for (int j = 0; j < S; ++j) acc[j] = 0.f;

  if (active) {
    const typename P::I iv = P::load_i(fl, t, kg, c);
    for (int o = lane; o < 27; o += W) {
      const int64_t cj =
          cell + (o / 9 - 1) * gyz + ((o % 9) / 3 - 1) * gz + (o % 3 - 1);
      walk_cell<P>(acc, iv, fl, bd, cj, g, kg, k, kbg, kb, c);
    }
  }

  // groups are W-aligned inside the warp, so xor by m < W stays in the group
  if constexpr (kTranspose) {
    transpose_step<S / 2, W / 2>(acc, lane);
#pragma unroll
    for (int m = W / (2 * S); m > 0; m >>= 1)
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], m);
    constexpr int kStride = W / S;  // lane n * kStride holds sum n
    if (active && lane % kStride == 0 && lane / kStride < P::kOut)
      out[(lane / kStride) * kg + t] = acc[0];
  } else {
#pragma unroll
    for (int m = W / 2; m > 0; m >>= 1) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (lane == j % W) out[j * kg + t] = acc[j];
    }
  }
}

// the blocks of a group kernel: n particles of W lanes each
template <int W>
unsigned group_blocks(int n) {
  const int64_t threads = static_cast<int64_t>(n) * W;
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// the launcher of particle_pass_kernel<P, W, kTranspose>
template <class P, int W, bool kTranspose>
struct Particles {
  static cudaError_t run(const float* fl, const float* bd,
                         const int64_t* islots, float* out, int n, int k,
                         int kb, int gx, int gy, int gz, const Consts& c,
                         cudaStream_t stream) {
    if (n == 0) return cudaSuccess;
    particle_pass_kernel<P, W, kTranspose>
        <<<group_blocks<W>(n), kThreads, 0, stream>>>(fl, bd, islots, out, n,
                                                      k, kb, gx, gy, gz, c);
    return cudaGetLastError();
  }
};

// the reduction: 0 the xor butterfly, 1 the transpose reduction, which is
// instantiated only where its padded sums fit the group (ops/
// column_pass_cuda.py:variants gives the same pairs); L is the group
// kernel's launcher
template <template <class, int, bool> class L, class P, int W, class... A>
cudaError_t launch_reduction(int reduction, A... a) {
  switch (reduction) {
    case 0:
      return L<P, W, false>::run(a...);
    case 1:
      if constexpr (pow2_at_least(P::kOut) <= W)
        return L<P, W, true>::run(a...);
      else
        return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// the group width W, instantiated for 8, 16 and 32 only
template <template <class, int, bool> class L, class P, class... A>
cudaError_t launch_lanes(int lanes, int reduction, A... a) {
  switch (lanes) {
    case 8:
      return launch_reduction<L, P, 8>(reduction, a...);
    case 16:
      return launch_reduction<L, P, 16>(reduction, a...);
    case 32:
      return launch_reduction<L, P, 32>(reduction, a...);
    default:
      return cudaErrorInvalidValue;
  }
}

// --- the cell-packed record kernel (SurfacePass, SurfacePressurePass,
// XsphColorgradPass, ViscosityPass) ---
//
// Replaces the same TPU kernel, pallas_passes.py:107 `column_pass`, for
// surface (:1013) and surface_pressure (:1316), the second traversal of
// the PBD, DFSPH and WCSPH frames, and for xsph_colorgrad (:1377) and
// viscosity (:929), PBD's and DFSPH's once-a-frame passes, in place of
// particle_pass_kernel on those instances. It computes what
// particle_pass_kernel computes: the same slot list, groups of W lanes,
// offsets in m-order, slots in rank order, float operations (the
// functors' terms and bdry_terms) and reductions, so its output is
// bitwise that kernel's at the same (W, reduction).
//
// What it changes is where the walk's loads come from. particle_pass_kernel
// reads the operand's planes (row r of slot s of cell c at r*K*G + s*G + c):
// per candidate x, y and z from three planes, three lines, the padding test
// on x first; per pair in support mass and the functor's j rows (|cg|^2's
// three for surface, rho and p too for surface_pressure, vel3 for
// xsph_colorgrad and viscosity), up to six more lines, and the j side's
// arithmetic (|cg|^2, p / max(eps, rho^2), m / rho0) again for every i,
// some 30-40 times per particle. Consecutive slots of a cell are G floats
// apart.
// Where the functor reads only the mass, which the walk's row-0 test
// already brings in, the records buy less than their pack costs:
// density_alpha_colorgrad took 0.0512 ms through them against the
// particle-list kernel's 0.0485, and 1.268 against 1.235 at 1M (PERF.md
// section 6), so it has no record instance; nor has the surface-off
// density_visc, whose walk through them only tied its particle-list
// kernel's best (0.0456 against 0.0457 ms), so that the pack (0.0042) made
// it lose.
//
// pack_kernel, one launch per pass call on the operand as the executor
// gets it (after a mesh's ghost exchange), over every (cell, slot) of the
// grid, ghost cells included, writes the records the walk reads, at c*K +
// s: for a real slot geo = {x, y, z, m} and side = the pass's J (P::side:
// |cg|^2, {|cg|^2, p / max(eps, rho^2)}, {vx, vy, vz, m / rho0} or {vx,
// vy, vz, 0}); for a cell's first padding slot, where every walk of the
// cell stops, geo =
// {x, 0, 0, 0} with its POS_PAD x; and the boundary window's the same way
// at c*Kb + s. It writes no other record (the
// buffers come from torch.empty), and no walk reads one: a walk stops at
// its cell's first padding slot, and a cell full to K has none. The walk
// then reads per candidate one 16-byte record, which shares its line with
// the cell's next slots, and per pair in support one 4- to 16-byte J with
// no division. Its U-slot batches (U = 1 or 2) load the next record before
// the padding test of the first, so a walk does not wait on one slot's
// test to issue the next slot's load; a batch needs no guard but s < K.
// Where the first of a batch is the cell's first padding slot, the second
// is a record the pack did not write: its load is discarded, since the
// walk returns at the first. Batches of 4 lost to both on every state
// (more registers, loads past the cell's last particle; PERF.md section 6)
// and were dropped.
//
// Bound: as particle_pass_kernel's, the chain of dependent loads per slot
// (PERF.md section 6). The pack reads row 0 of every slot, once, and the
// other rows of the real slots, and writes 16 bytes and the J of each real
// slot and 16 bytes per cell that is not full: by an estimate from this
// access pattern (not a measurement), 1.7-2.1x the bytes a walk needs of
// it (the row-0 reads of empty slots); 3.1-4.1 us a call on the dam
// (PERF.md section 6).

// the records of one grid, each indexed c*K + s (boundary c*Kb + s)
template <class P>
struct Records {
  const float4* geo;             // {x, y, z, m}
  const typename P::J* side;     // the pass's j side
  const float4* bgeo;            // the boundary's {x, y, z, m}, or null
};

// slot s of cell `cell` of grid f (K slots a cell, G cells): a real slot's
// {x, y, z, m} (and, kSide, its J), or {x, 0, 0, 0} at the cell's first
// padding slot (slot 0, or the slot before it real), else nothing. Thread
// (s, cell) reads row 0 of slot s and, at a padding slot, of slot s - 1:
// both coalesce across the warp's consecutive cells.
template <class P, bool kSide>
__device__ __forceinline__ void pack_slot(const float* __restrict__ f,
                                          float4* __restrict__ geo,
                                          typename P::J* __restrict__ side,
                                          int s, int64_t cell, int k,
                                          int64_t g, const Consts& c) {
  const int64_t kg = k * g;
  const int64_t t = s * g + cell;
  const int64_t rec = cell * k + s;
  const float x = f[t];
  if (x < c.pos_guard) {
    geo[rec] = make_float4(x, f[kg + t], f[2 * kg + t], f[3 * kg + t]);
    if constexpr (kSide) side[rec] = P::side(f, t, kg, c);
  } else if (s == 0 || f[t - g] < c.pos_guard) {
    geo[rec] = make_float4(x, 0.f, 0.f, 0.f);
  }
}

// one thread per (slot, cell): blockIdx.y the slot, the fluid's K and
// then (kBoundary) the boundary's Kb; consecutive threads take consecutive
// cells of one slot plane
template <class P>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const float* __restrict__ fl, const float* __restrict__ bd,
                float4* __restrict__ geo, typename P::J* __restrict__ side,
                float4* __restrict__ bgeo, int k, int kb, int64_t g,
                Consts c) {
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= g) return;
  const int s = static_cast<int>(blockIdx.y);
  if (s < k) {
    pack_slot<P, true>(fl, geo, side, s, cell, k, g, c);
  } else if constexpr (P::kBoundary) {
    pack_slot<P, false>(bd, bgeo, nullptr, s - k, cell, kb, g, c);
  }
}

struct Pair {
  float dx, dy, dz, r;
};

// pair_terms's geometry on a record's x, y, z: the separation i - j and
// its length -> false outside the support. The particle-list kernel keeps
// its own copy in pair_terms: written through this helper it compiled to
// other SASS, and its twelve other instances lost 7-12% (PERF.md section 6)
template <class I>
__device__ __forceinline__ bool separation(const I& iv, float xj, float yj,
                                           float zj, const Consts& c,
                                           Pair* q) {
  q->dx = iv.x - xj;
  q->dy = iv.y - yj;
  q->dz = iv.z - zj;
  const float d2 = q->dx * q->dx + q->dy * q->dy + q->dz * q->dz;
  // in_support needs r <= h (1 + 2^-23), so d2 <= h^2 (1 + 3 * 2^-23): a
  // pair past r2_cut is rejected without its square root and division,
  // and every other pair is tested exactly as before
  if (!(d2 <= c.r2_cut)) return false;
  q->r = sqrtf(d2);
  return in_support(q->r, c);
}

// One cell's records from base (its slot 0) up to the first padding slot
// (ranks fill a cell from slot 0), U at a time: the fluid's through
// P::terms with the slot's J, the boundary's (kFluid false) through
// P::bdry_terms. A batch may load a record past the cell's first padding
// slot, which the pack did not write: that load is discarded, since the
// walk returns at the padding slot before it looks at the next.
template <class P, bool kFluid, int U>
__device__ __forceinline__ void walk_records(
    float* acc, const typename P::I& iv, const float4* __restrict__ geo,
    const typename P::J* __restrict__ side, int64_t base, int k,
    const Consts& c) {
  for (int s0 = 0; s0 < k; s0 += U) {
    float4 rj[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      rj[u] = s0 + u < k ? geo[base + s0 + u]
                         : make_float4(c.pos_guard, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!(rj[u].x < c.pos_guard)) return;
      Pair q;
      if (!separation(iv, rj[u].x, rj[u].y, rj[u].z, c, &q)) continue;
      if constexpr (kFluid)
        P::terms(acc, iv, rj[u].w, side[base + s0 + u], q.dx, q.dy, q.dz,
                 q.r, c);
      else
        P::bdry_terms(acc, iv, rj[u].w, q.dx, q.dy, q.dz, q.r, c);
    }
  }
}

// particle_pass_kernel's groups over the records: islots names plane
// slots s*G + c (the trash value K*G for an invalid particle), the i side
// comes from record c*K + s, each lane walks its offsets' cells with
// walk_records, and the sums are reduced and stored as there. The steps
// list only slots that hold a particle (ops/box.py BoxIndex), whose
// records the pack wrote.
template <class P, int W, bool kTranspose, int U>
__global__ void __launch_bounds__(kThreads)
    record_pass_kernel(Records<P> rec, const int64_t* __restrict__ islots,
                       float* __restrict__ out, int n, int k, int kb, int gx,
                       int gy, int gz, Consts c) {
  static_assert(W == 8 || W == 16 || W == 32,
                "a group is 8, 16 or 32 lanes of one warp");
  static_assert(U == 1 || U == 2, "a batch is 1 or 2 slots");
  constexpr int S = kTranspose ? pow2_at_least(P::kOut) : P::kOut;
  static_assert(!kTranspose || S <= W,
                "the transpose leaves each lane one sum: every sum needs a "
                "lane to store it");
  const int64_t g = static_cast<int64_t>(gx) * gy * gz;
  const int64_t kg = k * g;
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / W;
  const int lane = static_cast<int>(threadIdx.x % W);
  const int64_t t = p < n ? islots[p] : kg;  // kg: the trash slot

  // every test below reads only t, so it is uniform across the group
  bool active = t >= 0 && t < kg;
  int64_t cell = 0, ri = 0;
  float4 gi = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t gyz = static_cast<int64_t>(gy) * gz;
  if (active) {
    cell = t % g;
    ri = cell * k + t / g;
    const int x = static_cast<int>(cell / gyz);
    const int y = static_cast<int>((cell / gz) % gy);
    const int z = static_cast<int>(cell % gz);
    gi = rec.geo[ri];
    active = x > 0 && x < gx - 1 && y > 0 && y < gy - 1 && z > 0 &&
             z < gz - 1 && gi.x < c.pos_guard;
  }

  float acc[S];
#pragma unroll
  for (int j = 0; j < S; ++j) acc[j] = 0.f;

  if (active) {
    const typename P::I iv = P::make_i(gi.x, gi.y, gi.z, rec.side[ri], c);
    for (int o = lane; o < 27; o += W) {
      const int64_t cj =
          cell + (o / 9 - 1) * gyz + ((o % 9) / 3 - 1) * gz + (o % 3 - 1);
      walk_records<P, true, U>(acc, iv, rec.geo, rec.side, cj * k, k, c);
      if constexpr (P::kBoundary)
        walk_records<P, false, U>(acc, iv, rec.bgeo, rec.side, cj * kb, kb,
                                  c);
    }
  }

  reduce_store<P::kOut, W, kTranspose>(acc, lane, active, out, t, kg);
}

// the launchers of record_pass_kernel<P, W, kTranspose, U>
template <int U>
struct RecordsIn {
  template <class P, int W, bool kTranspose>
  struct L {
    static cudaError_t run(Records<P> rec, const int64_t* islots, float* out,
                           int n, int k, int kb, int gx, int gy, int gz,
                           const Consts& c, cudaStream_t stream) {
      if (n == 0) return cudaSuccess;
      record_pass_kernel<P, W, kTranspose, U>
          <<<group_blocks<W>(n), kThreads, 0, stream>>>(
              rec, islots, out, n, k, kb, gx, gy, gz, c);
      return cudaGetLastError();
    }
  };
};

// --- the counted record walk (PbdLambdaPass, StiffnessAccelPass,
// PressureForcePass, DensityAlphaPass) ---
//
// Replaces the same TPU kernel, pallas_passes.py:107 `column_pass`, for
// pbd_lambda (:1185) and stiffness_accel (:1124), the two passes of every
// PBD projection iteration and the correction pass of both DFSPH Jacobi
// loops, and for the surface-off pressure_force (:893, WCSPH's second
// traversal) and density_alpha (:1047, DFSPH's first), in place of
// particle_pass_kernel on those instances. It computes
// what particle_pass_kernel computes: the same slot list, groups of W
// lanes, offsets l, l+W, ... in m-order, slots in rank order, fluid before
// boundary per cell, float operations (the functors' terms and bdry_terms)
// and reductions, so its output is bitwise that kernel's at the same (W,
// reduction).
//
// Bound: as particle_pass_kernel's, the chain of dependent loads of each
// lane's walk (the bound of PERF.md section 6, bytes and operations, is
// unchanged; these kernels run 20-30x above it). In particle_pass_kernel
// the chain is per slot: load the slot's x, test it against the padding,
// only then load its y and z and the next slot's x, each G floats from the
// last. Here count_pack_kernel, once per operand, writes each real slot's
// {x, y, z, m} as one 16-byte record at c*K + s, so that a cell's slots are
// consecutive, and each cell's count of real slots (ranks fill a cell from
// slot 0, so the count is its first padding slot, or K). A lane reads the
// cell's counts as it reaches the cell, then takes the cell's records U
// at a time (U = 1, 2 or 4): all U loads issued before
// any arithmetic, no padding test, no load past the cell's last real slot
// and no record of a padding slot, which the pack does not write. The
// loads of a batch do not wait on a test, and the batches do not wait on
// each other: the only chain left is from a pair's support test to the
// functor's own j loads (stiffness_accel's s_j, pressure_force's rho_j
// and p_j, from the operand's planes, as particle_pass_kernel loads them).
// The walk indexes in 32 bits (pressure_force's terms too: the launcher
// refuses an operand of 2^31 floats or more) and is
// held to 48 registers (kCountedBlocks): its first form, with 64-bit
// indices and 50-62 registers, lost to particle_pass_kernel on every
// state (pbd_lambda's walk 0.0562-0.0568 against 0.0492-0.0503 ms on one
// frozen PBD state), where this one takes 0.0470-0.0474 at W 16 and the
// 0.0444 / 0.0447 of its default on the 300-frame state (PERF.md section
// 6). The pack holds positions and masses
// only, so one pack serves every pass on the same positions: pbd_lambda
// and stiffness_accel within a PBD projection iteration, and the
// surface-off density_alpha and every stiffness_accel of a DFSPH frame,
// whose positions stay fixed across the Jacobi iterations (ops/passes.py
// SharedPack); WCSPH's surface-off pressure_force packs its own once a
// frame. On the 300-frame dam states the pressure_force walk took
// 0.0461-0.0467 ms and its pack 0.0034 against the particle-list kernel's
// best 0.0506-0.0508, and the density_alpha walk 0.0408-0.0425 against
// 0.0490 (PERF.md section 6).

// the counted records of one operand, each indexed c*K + s (boundary c*Kb
// + s), and the operand's planes
struct Counted {
  const float4* geo;    // {x, y, z, m} of each real slot
  const int* count;     // each cell's real slots
  const float4* bgeo;   // the boundary's {x, y, z, m}
  const int* bcount;    // each cell's real boundary slots
  const float* fl;      // the operand (Fi, K, G): row 0, the i side,
                        // P::terms's j
};

// whether P has the counted record interface (make_i from a record and the
// planes, terms and bdry_terms over a record's mass)
template <class P, class = void>
struct counted : std::false_type {};
template <class P>
struct counted<P, std::void_t<decltype(P::kCounted)>>
    : std::bool_constant<P::kCounted> {};

// slot s of cell `cell` of grid f (K slots a cell, G cells): a real slot's
// {x, y, z, m} at record cell*K + s, and the cell's count, written by the
// thread of its first padding slot (slot 0, or the slot after a real one)
// or, in a cell full to K, of slot K - 1. Thread (s, cell) reads row 0 of
// slot s and, at a padding slot, of slot s - 1: both coalesce across the
// warp's consecutive cells.
__device__ __forceinline__ void count_slot(const float* __restrict__ f,
                                           float4* __restrict__ geo,
                                           int* __restrict__ count, int s,
                                           int64_t cell, int k, int64_t g,
                                           const Consts& c) {
  const int64_t kg = k * g;
  const int64_t t = s * g + cell;
  const float x = f[t];
  if (x < c.pos_guard) {
    geo[cell * k + s] =
        make_float4(x, f[kg + t], f[2 * kg + t], f[3 * kg + t]);
    if (s == k - 1) count[cell] = k;
  } else if (s == 0 || f[t - g] < c.pos_guard) {
    count[cell] = s;
  }
}

// the position pack of counted_pass_kernel: one thread per (slot, cell),
// blockIdx.y the slot, the fluid's K and then the boundary's Kb, as
// pack_kernel; fl and bd [pos3, mass, ...] (rows 0-3 read)
__global__ void __launch_bounds__(kThreads)
    count_pack_kernel(const float* __restrict__ fl,
                      const float* __restrict__ bd, float4* __restrict__ geo,
                      int* __restrict__ count, float4* __restrict__ bgeo,
                      int* __restrict__ bcount, int k, int kb, int64_t g,
                      Consts c) {
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= g) return;
  const int s = static_cast<int>(blockIdx.y);
  if (s < k)
    count_slot(fl, geo, count, s, cell, k, g, c);
  else
    count_slot(bd, bgeo, bcount, s - k, cell, kb, g, c);
}

// One cell's n real records cr[0..n), U at a time: the fluid's through
// P::terms (the pair's slot s*G in the planes fj, the operand offset to the
// cell), the boundary's (kFluid false) through P::bdry_terms. 32-bit
// indices (the launcher refuses K*G or Kb*G of 2^31 or more)
template <class P, bool kFluid, int U>
__device__ __forceinline__ void walk_counted(float* acc,
                                             const typename P::I& iv,
                                             const float4* __restrict__ cr,
                                             const float* __restrict__ fj,
                                             int n, int g, int kg,
                                             const Consts& c) {
  for (int s0 = 0; s0 < n; s0 += U) {
    float4 rj[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      rj[u] = s0 + u < n ? cr[s0 + u] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u >= n) break;
      Pair q;
      if (!separation(iv, rj[u].x, rj[u].y, rj[u].z, c, &q)) continue;
      if constexpr (kFluid)
        P::terms(acc, iv, rj[u].w, fj, (s0 + u) * g, kg, q.dx, q.dy, q.dz,
                 q.r, c);
      else
        P::bdry_terms(acc, iv, rj[u].w, q.dx, q.dy, q.dz, q.r, c);
    }
  }
}

// whether P::make_i takes the constants too (pressure_force's p_i /
// max(eps, rho_i^2)): P::kIConsts. The kernel picks the call with if
// constexpr; a helper function in between changed the machine code of the
// other counted instances (pbd_lambda's at U 1)
template <class P, class = void>
struct i_takes_consts : std::false_type {};
template <class P>
struct i_takes_consts<P, std::void_t<decltype(P::kIConsts)>>
    : std::bool_constant<P::kIConsts> {};

// blocks of counted_pass_kernel resident on an SM at the least, which caps
// its registers at 48 (some instances spill up to 24 bytes): uncapped, the
// walk took 50-62 registers, 4 blocks an SM
constexpr int kCountedBlocks = 5;

// particle_pass_kernel's groups over the counted records: islots names
// plane slots s*G + c (the trash value K*G for an invalid particle), the
// i side comes from record c*K + s and the planes, each lane walks its
// offsets' cells with walk_counted, each cell's counts read as the lane
// reaches it, and the sums are reduced and stored as there. Whether t
// holds a particle is read from the operand's row 0, as
// particle_pass_kernel reads it, since the pack writes no record for a
// padding slot: a listed padding slot stores nothing, and its record (never
// written) is loaded but not used.
template <class P, int W, bool kTranspose, int U>
__global__ void __launch_bounds__(kThreads, kCountedBlocks)
    counted_pass_kernel(Counted rec, const int64_t* __restrict__ islots,
                        float* __restrict__ out, int n, int k, int kb, int gx,
                        int gy, int gz, Consts c) {
  static_assert(W == 8 || W == 16 || W == 32,
                "a group is 8, 16 or 32 lanes of one warp");
  static_assert(U == 1 || U == 2 || U == 4, "a batch is 1, 2 or 4 slots");
  static_assert(P::kBoundary, "the counted passes have a boundary term");
  constexpr int S = kTranspose ? pow2_at_least(P::kOut) : P::kOut;
  static_assert(!kTranspose || S <= W,
                "the transpose leaves each lane one sum: every sum needs a "
                "lane to store it");
  const int g = gx * gy * gz;
  const int kg = k * g;
  const int p = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / W);
  const int lane = static_cast<int>(threadIdx.x % W);
  const int64_t ts = p < n ? islots[p] : kg;  // kg: the trash slot

  // every test below reads only t, so it is uniform across the group
  bool active = ts >= 0 && ts < kg;
  const int t = active ? static_cast<int>(ts) : kg;
  int cell = 0;
  float4 gi = make_float4(0.f, 0.f, 0.f, 0.f);
  const int gyz = gy * gz;
  if (active) {
    cell = t % g;
    const int x = cell / gyz;
    const int y = (cell / gz) % gy;
    const int z = cell % gz;
    gi = rec.geo[cell * k + t / g];
    active = x > 0 && x < gx - 1 && y > 0 && y < gy - 1 && z > 0 &&
             z < gz - 1 && rec.fl[t] < c.pos_guard;
  }

  float acc[S];
#pragma unroll
  for (int j = 0; j < S; ++j) acc[j] = 0.f;

  if (active) {
    typename P::I iv;
    if constexpr (i_takes_consts<P>::value)
      iv = P::make_i(gi.x, gi.y, gi.z, rec.fl, t, kg, c);
    else
      iv = P::make_i(gi.x, gi.y, gi.z, rec.fl, t, kg);
    for (int o = lane; o < 27; o += W) {
      const int cj =
          cell + (o / 9 - 1) * gyz + ((o % 9) / 3 - 1) * gz + (o % 3 - 1);
      const int nf = rec.count[cj], nb = rec.bcount[cj];
      walk_counted<P, true, U>(acc, iv, rec.geo + cj * k, rec.fl + cj, nf,
                               g, kg, c);
      walk_counted<P, false, U>(acc, iv, rec.bgeo + cj * kb, nullptr, nb,
                                g, 0, c);
    }
  }

  reduce_store<P::kOut, W, kTranspose>(acc, lane, active, out,
                                       static_cast<int64_t>(t),
                                       static_cast<int64_t>(kg));
}

// the launcher of pass P's pack: pack_kernel<P> into geo, side and bgeo,
// or for a pass with the counted interface count_pack_kernel into geo,
// count, bgeo and bcount
template <class P>
cudaError_t launch_pack(const float* fl, const float* bd, void* geo,
                        void* side, void* bgeo, int* count, int* bcount,
                        int k, int kb, int64_t g, const Consts& c,
                        cudaStream_t stream) {
  const int slots = k + (P::kBoundary ? kb : 0);
  if (g == 0 || slots == 0) return cudaSuccess;
  if (slots > 65535) return cudaErrorInvalidValue;  // gridDim.y
  const dim3 blocks(static_cast<unsigned>((g + kThreads - 1) / kThreads),
                    static_cast<unsigned>(slots));
  if constexpr (counted<P>::value) {
    count_pack_kernel<<<blocks, kThreads, 0, stream>>>(
        fl, bd, static_cast<float4*>(geo), count, static_cast<float4*>(bgeo),
        bcount, k, kb, g, c);
  } else {
    pack_kernel<P><<<blocks, kThreads, 0, stream>>>(
        fl, bd, static_cast<float4*>(geo),
        static_cast<typename P::J*>(side), static_cast<float4*>(bgeo), k,
        kb, g, c);
  }
  return cudaGetLastError();
}

// the launchers of counted_pass_kernel<P, W, kTranspose, U>; its 32-bit
// indices need the operand's P::kRows * K * G floats, Kb*G and the n * W
// threads under 2^31
template <int U>
struct CountedIn {
  template <class P, int W, bool kTranspose>
  struct L {
    static cudaError_t run(Counted rec, const int64_t* islots, float* out,
                           int n, int k, int kb, int gx, int gy, int gz,
                           const Consts& c, cudaStream_t stream) {
      if (n == 0) return cudaSuccess;
      const int64_t g = static_cast<int64_t>(gx) * gy * gz;
      constexpr int64_t kMax = int64_t{1} << 31;
      if (P::kRows * k * g >= kMax || kb * g >= kMax ||
          static_cast<int64_t>(n) * W >= kMax)
        return cudaErrorInvalidValue;
      counted_pass_kernel<P, W, kTranspose, U>
          <<<group_blocks<W>(n), kThreads, 0, stream>>>(
              rec, islots, out, n, k, kb, gx, gy, gz, c);
      return cudaGetLastError();
    }
  };
};

// --- the brick-tiled fluid-only kernel (exp/flat_pallas_proto.py:67) ---

// A pass with its boundary loop compiled out: the prototype's bodies are
// fluid-only halves of passes that have a boundary term.
template <class P>
struct FluidOnly : P {
  static constexpr bool kBoundary = false;
};

constexpr int kFlatThreads = 512;
constexpr int64_t kMaxShared = 232448;  // a Hopper block's dynamic shared max

// Layout as column_pass_kernel; fl holds exactly the `rows` rows the
// functor reads. One block per brick (bx, by, bz) of the GHOSTED grid, the
// bricks in x-major order; the last brick on an axis may run past the grid.
// Shared memory holds rows x K slots x the brick's (bx+2)(by+2)(bz+2) halo
// cells, in fl's row/slot/cell order with cell stride 1, and then each halo
// cell's occupancy (its leading real slots). Halo cells outside the grid
// stage as empty; ghost-ring cells are staged like any other. One thread per
// (slot, brick cell), looping; the offsets and slots run in
// column_pass_kernel's order, sums stay in registers and are stored once, so
// two launches are bitwise equal. Ghost cells and empty slots store 0.
template <class P>
__global__ void __launch_bounds__(kFlatThreads)
    flat_pass_kernel(const float* __restrict__ fl, float* __restrict__ out,
                     int rows, int k, int gx, int gy, int gz, int bx, int by,
                     int bz, Consts c) {
  static_assert(!P::kBoundary, "the tiled kernel is fluid-only");
  extern __shared__ float sm[];
  const int hy = by + 2, hz = bz + 2;
  const int nh = (bx + 2) * hy * hz;
  const int64_t kh = static_cast<int64_t>(k) * nh;  // shared row stride
  int* occ = reinterpret_cast<int*>(sm + rows * kh);
  const int64_t g = static_cast<int64_t>(gx) * gy * gz;
  const int64_t kg = k * g;
  const int nby = (gy + by - 1) / by, nbz = (gz + bz - 1) / bz;
  const int x0 = static_cast<int>(blockIdx.x) / (nby * nbz) * bx;
  const int y0 = (static_cast<int>(blockIdx.x) / nbz) % nby * by;
  const int z0 = static_cast<int>(blockIdx.x) % nbz * bz;

  // stage: thread -> (halo cell h, lane); each lane walks every lanes-th
  // (row, slot) of its cell. Neighbouring threads take neighbouring halo
  // cells, which are consecutive in fl along z, so the loads coalesce in
  // z-runs. nh <= blockDim.x (launch_flat checks it).
  {
    const int lanes = blockDim.x / nh;
    const int h = threadIdx.x % nh, lane = threadIdx.x / nh;
    const int x = x0 - 1 + h / (hy * hz);
    const int y = y0 - 1 + (h / hz) % hy;
    const int z = z0 - 1 + h % hz;
    const bool inside =
        x >= 0 && x < gx && y >= 0 && y < gy && z >= 0 && z < gz;
    const int64_t cell =
        inside ? (static_cast<int64_t>(x) * gy + y) * gz + z : 0;
    const float pad = 2.f * c.pos_guard;  // POS_PAD
    if (lane < lanes) {
      for (int rs = lane; rs < rows * k; rs += lanes)  // rs = row * k + slot
        sm[rs * nh + h] = inside ? fl[rs * g + cell] : (rs < k ? pad : 0.f);
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < nh; h += blockDim.x) {
    int n = 0;
    while (n < k && sm[n * nh + h] < c.pos_guard) ++n;  // ranks fill from 0
    occ[h] = n;
  }
  __syncthreads();

  const int nb = bx * by * bz;
  for (int t = threadIdx.x; t < k * nb; t += blockDim.x) {
    const int s = t / nb, ci = t % nb;
    const int lx = ci / (by * bz), ly = (ci / bz) % by, lz = ci % bz;
    const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
    if (x >= gx || y >= gy || z >= gz) continue;  // past the grid's edge
    const int hi = ((lx + 1) * hy + ly + 1) * hz + lz + 1;
    const bool interior =
        x > 0 && x < gx - 1 && y > 0 && y < gy - 1 && z > 0 && z < gz - 1;

    float acc[P::kOut];
#pragma unroll
    for (int n = 0; n < P::kOut; ++n) acc[n] = 0.f;

    if (interior && s < occ[hi]) {
      const int64_t ti = static_cast<int64_t>(s) * nh + hi;
      const typename P::I iv = P::load_i(sm, ti, kh, c);
      for (int o = 0; o < 27; ++o) {
        const int hj =
            hi + (o / 9 - 1) * hy * hz + ((o % 9) / 3 - 1) * hz + (o % 3 - 1);
        const int nj = occ[hj];
        for (int sj = 0; sj < nj; ++sj) {
          const int64_t tj = static_cast<int64_t>(sj) * nh + hj;
          pair_terms<P, true>(acc, iv, sm, tj, kh, sm[tj], c);
        }
      }
    }
    const int64_t cell = (static_cast<int64_t>(x) * gy + y) * gz + z;
#pragma unroll
    for (int n = 0; n < P::kOut; ++n) out[n * kg + s * g + cell] = acc[n];
  }
}

// rows: the rows P reads. The brick comes from the caller
// (ops/column_pass_cuda.py:flat_brick); one that does not fit is refused.
template <class P>
cudaError_t launch_flat(int rows, const float* fl, float* out, int k, int gx,
                        int gy, int gz, int bx, int by, int bz,
                        const Consts& c, cudaStream_t stream) {
  if (k <= 0 || bx <= 0 || by <= 0 || bz <= 0) return cudaErrorInvalidValue;
  const int64_t nh = static_cast<int64_t>(bx + 2) * (by + 2) * (bz + 2);
  const int64_t bytes = (rows * static_cast<int64_t>(k) + 1) * nh * 4;
  if (nh > kFlatThreads || bytes > kMaxShared) return cudaErrorInvalidValue;
  const int64_t blocks = static_cast<int64_t>((gx + bx - 1) / bx) *
                         ((gy + by - 1) / by) * ((gz + bz - 1) / bz);
  cudaError_t err = cudaFuncSetAttribute(
      flat_pass_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  flat_pass_kernel<P><<<static_cast<unsigned>(blocks), kFlatThreads,
                        static_cast<size_t>(bytes), stream>>>(
      fl, out, rows, k, gx, gy, gz, bx, by, bz, c);
  return cudaGetLastError();
}

// tiled: the brick kernel; else column_pass_kernel on the same functor
template <class P>
cudaError_t launch_fluid(bool tiled, int rows, const float* fl, float* out,
                         int k, int gx, int gy, int gz, int bx, int by, int bz,
                         const Consts& c, cudaStream_t stream) {
  if (tiled)
    return launch_flat<FluidOnly<P>>(rows, fl, out, k, gx, gy, gz, bx, by, bz,
                                     c, stream);
  return launch<FluidOnly<P>>(fl, nullptr, out, k, 0, gx, gy, gz, c, stream);
}

bool read_consts(const float* consts, int n_consts, Consts* c) {
  if (n_consts < 0 ||
      static_cast<size_t>(n_consts) * sizeof(float) != sizeof(Consts))
    return false;
  std::memcpy(c, consts, sizeof(Consts));
  return true;
}

}  // namespace

// Pass ids match ops/column_pass_cuda.py:PASS_IDS. Returns a cudaError_t
// (0 on success); an unknown pass id or constant count is
// cudaErrorInvalidValue.
extern "C" int column_pass_launch(int pass_id, const float* fl,
                                  const float* bd, float* out, int k, int kb,
                                  int gx, int gy, int gz, const float* consts,
                                  int n_consts, int device, void* stream) {
  Consts c;
  if (!read_consts(consts, n_consts, &c)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pass_id) {
    case 0:
      return launch<DensityPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 1:
      return launch<DensityColorgradViscPass>(fl, bd, out, k, kb, gx, gy, gz,
                                              c, s);
    case 2:
      return launch<SurfacePressurePass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 3:
      return launch<DensityAlphaColorgradPass>(fl, bd, out, k, kb, gx, gy, gz,
                                               c, s);
    case 4:
      return launch<DivergencePass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 5:
      return launch<StiffnessAccelPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 6:
      return launch<ViscosityPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 7:
      return launch<SurfacePass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 8:
      return launch<DensityAlphaPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 9:
      return launch<DensityViscPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 10:
      return launch<PressureForcePass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 11:
      return launch<PbdLambdaPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 12:
      return launch<XsphColorgradPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 13:
      return launch<XsphPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 14:
      return launch<ColorGradientPass>(fl, bd, out, k, kb, gx, gy, gz, c, s);
    case 15:
      return launch<DensityColorgradPass>(fl, bd, out, k, kb, gx, gy, gz, c,
                                          s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The particle-list kernel on pass ids 0 (density), 1
// (density_colorgrad_visc), 2 (surface_pressure), 3
// (density_alpha_colorgrad), 4 (divergence), 5 (stiffness_accel), 6
// (viscosity, fluid only), 7 (surface, fluid only), 8 (density_alpha), 9
// (density_visc), 10 (pressure_force), 11 (pbd_lambda), 12
// (xsph_colorgrad) and 13 (xsph, fluid only) of column_pass_launch, W =
// lanes in {8, 16, 32}, reduction 0 (the xor
// butterfly) or 1 (the transpose reduction, only where the pass's sums
// padded to a power of two fit W: not density_alpha_colorgrad at W 8),
// over the n particles of islots (int64, a slot in [0, K*G) or the trash
// value K*G). A fluid-only pass takes bd = nullptr and kb = 0. out must be
// zeroed by the caller: only listed slots are written. Returns a
// cudaError_t; any other pass id, width or reduction is
// cudaErrorInvalidValue.
extern "C" int particle_pass_launch(int pass_id, int lanes, int reduction,
                                    const float* fl, const float* bd,
                                    const int64_t* islots, float* out, int n,
                                    int k, int kb, int gx, int gy, int gz,
                                    const float* consts, int n_consts,
                                    int device, void* stream) {
  Consts c;
  if (!read_consts(consts, n_consts, &c) || n < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto pass) {
    return launch_lanes<Particles, decltype(pass)>(
        lanes, reduction, fl, bd, islots, out, n, k, kb, gx, gy, gz, c, s);
  };
  switch (pass_id) {
    case 0:
      return run(DensityPass{});
    case 1:
      return run(DensityColorgradViscPass{});
    case 2:
      return run(SurfacePressurePass{});
    case 3:
      return run(DensityAlphaColorgradPass{});
    case 4:
      return run(DivergencePass{});
    case 5:
      return run(StiffnessAccelPass{});
    case 6:
      return run(ViscosityPass{});
    case 7:
      return run(SurfacePass{});
    case 8:
      return run(DensityAlphaPass{});
    case 9:
      return run(DensityViscPass{});
    case 10:
      return run(PressureForcePass{});
    case 11:
      return run(PbdLambdaPass{});
    case 12:
      return run(XsphColorgradPass{});
    case 13:
      return run(XsphPass{});
    default:
      return cudaErrorInvalidValue;
  }
}

// The cell-packed records of pass ids 2 (surface_pressure: geo and side
// (float2) from fl = [pos3, mass, rho, p, cg3], bgeo from bd), 6
// (viscosity: side (float4) from fl = [pos3, mass, vel3]; bd and bgeo
// null, kb 0), 7 (surface: geo and side (float) from fl = [pos3, mass,
// cg3]; bd and bgeo null, kb 0) and 12 (xsph_colorgrad: side (float4)
// from fl = [pos3, mass, vel3], bgeo from bd) of column_pass_launch, each
// record at c*K + s (boundary c*Kb + s) of buffers the caller allocates;
// only the records a walk reads are written (pack_kernel; count and bcount
// null). Pass ids 5 (stiffness_accel), 8 (density_alpha), 10
// (pressure_force) and 11 (pbd_lambda) take one position pack, the same
// for all four (count_pack_kernel): geo and bgeo of
// the real slots of rows 0-3 of fl and bd, and int32 count and bcount per
// cell (side null); the caller zeroes bcount where Kb is 0. Returns a
// cudaError_t; any other pass id, or K + Kb over 65535, is
// cudaErrorInvalidValue.
extern "C" int pack_records_launch(int pass_id, const float* fl,
                                   const float* bd, void* geo, void* side,
                                   void* bgeo, int* count, int* bcount,
                                   int k, int kb, int gx, int gy, int gz,
                                   const float* consts, int n_consts,
                                   int device, void* stream) {
  Consts c;
  if (!read_consts(consts, n_consts, &c)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t g = static_cast<int64_t>(gx) * gy * gz;
  switch (pass_id) {
    case 2:
      return launch_pack<SurfacePressurePass>(fl, bd, geo, side, bgeo,
                                              nullptr, nullptr, k, kb, g, c,
                                              s);
    case 5:
      return launch_pack<StiffnessAccelPass>(fl, bd, geo, nullptr, bgeo,
                                             count, bcount, k, kb, g, c, s);
    case 6:
      return launch_pack<ViscosityPass>(fl, nullptr, geo, side, nullptr,
                                        nullptr, nullptr, k, 0, g, c, s);
    case 7:
      return launch_pack<SurfacePass>(fl, nullptr, geo, side, nullptr,
                                      nullptr, nullptr, k, 0, g, c, s);
    case 8:
      return launch_pack<DensityAlphaPass>(fl, bd, geo, nullptr, bgeo, count,
                                           bcount, k, kb, g, c, s);
    case 10:
      return launch_pack<PressureForcePass>(fl, bd, geo, nullptr, bgeo,
                                            count, bcount, k, kb, g, c, s);
    case 11:
      return launch_pack<PbdLambdaPass>(fl, bd, geo, nullptr, bgeo, count,
                                        bcount, k, kb, g, c, s);
    case 12:
      return launch_pack<XsphColorgradPass>(fl, bd, geo, side, bgeo, nullptr,
                                            nullptr, k, kb, g, c, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The record kernel on pass ids 2 (surface_pressure), 6 (viscosity), 7
// (surface) and 12 (xsph_colorgrad) over pack_records_launch's records
// (count, bcount and fl null), U = unroll in {1, 2}, and the counted walk
// (counted_pass_kernel) on pass ids 5 (stiffness_accel, whose i side and
// s_j come from the operand fl = [pos3, mass, s]), 8 (density_alpha, fl =
// [pos3, mass]), 10 (pressure_force, whose i side and rho_j, p_j come from
// fl = [pos3, mass, rho, p]) and 11 (pbd_lambda, fl = [pos3, mass]), whose
// row 0 says which i slots hold a particle, over their position pack (geo,
// count, bgeo, bcount; side null), U in {1, 2, 4}; W = lanes in {8, 16,
// 32}, reduction 0 or 1 as particle_pass_launch, over the n particles of
// islots (plane slots as particle_pass_launch's). out must be zeroed by
// the caller. Returns a cudaError_t; any other pass id, width, reduction
// or unroll is cudaErrorInvalidValue.
extern "C" int record_pass_launch(int pass_id, int lanes, int reduction,
                                  int unroll, const void* geo,
                                  const void* side, const void* bgeo,
                                  const int* count, const int* bcount,
                                  const float* fl, const int64_t* islots,
                                  float* out, int n, int k, int kb, int gx,
                                  int gy, int gz, const float* consts,
                                  int n_consts, int device, void* stream) {
  Consts c;
  if (!read_consts(consts, n_consts, &c) || n < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto pass) -> cudaError_t {
    using P = decltype(pass);
    if constexpr (counted<P>::value) {
      const Counted rec{static_cast<const float4*>(geo), count,
                        static_cast<const float4*>(bgeo), bcount, fl};
      switch (unroll) {
        case 1:
          return launch_lanes<CountedIn<1>::L, P>(
              lanes, reduction, rec, islots, out, n, k, kb, gx, gy, gz, c, s);
        case 2:
          return launch_lanes<CountedIn<2>::L, P>(
              lanes, reduction, rec, islots, out, n, k, kb, gx, gy, gz, c, s);
        case 4:
          return launch_lanes<CountedIn<4>::L, P>(
              lanes, reduction, rec, islots, out, n, k, kb, gx, gy, gz, c, s);
        default:
          return cudaErrorInvalidValue;
      }
    } else {
      const Records<P> rec{static_cast<const float4*>(geo),
                           static_cast<const typename P::J*>(side),
                           static_cast<const float4*>(bgeo)};
      const int kbp = P::kBoundary ? kb : 0;
      switch (unroll) {
        case 1:
          return launch_lanes<RecordsIn<1>::L, P>(
              lanes, reduction, rec, islots, out, n, k, kbp, gx, gy, gz, c,
              s);
        case 2:
          return launch_lanes<RecordsIn<2>::L, P>(
              lanes, reduction, rec, islots, out, n, k, kbp, gx, gy, gz, c,
              s);
        default:
          return cudaErrorInvalidValue;
      }
    }
  };
  switch (pass_id) {
    case 2:
      return run(SurfacePressurePass{});
    case 5:
      return run(StiffnessAccelPass{});
    case 6:
      return run(ViscosityPass{});
    case 7:
      return run(SurfacePass{});
    case 8:
      return run(DensityAlphaPass{});
    case 10:
      return run(PressureForcePass{});
    case 11:
      return run(PbdLambdaPass{});
    case 12:
      return run(XsphColorgradPass{});
    default:
      return cudaErrorInvalidValue;
  }
}

// The prototype's bodies, ids as ops/column_pass_cuda.py:FLAT_IDS: 0
// density (fl = [pos3, mass]), 1 sa = stiffness_accel (fl = [pos3, mass,
// s]), 2 dcv = density_colorgrad_visc (fl = [pos3, mass, vel3]), each
// fluid-only. tiled != 0: the brick kernel with brick (bx, by, bz); else the
// untiled column_pass_kernel (the brick is ignored). Returns a cudaError_t.
extern "C" int flat_pass_launch(int body_id, int tiled, const float* fl,
                                float* out, int k, int gx, int gy, int gz,
                                int bx, int by, int bz, const float* consts,
                                int n_consts, int device, void* stream) {
  Consts c;
  if (!read_consts(consts, n_consts, &c)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool t = tiled != 0;
  switch (body_id) {
    case 0:
      return launch_fluid<DensityPass>(t, 4, fl, out, k, gx, gy, gz, bx, by,
                                       bz, c, s);
    case 1:
      return launch_fluid<StiffnessAccelPass>(t, 5, fl, out, k, gx, gy, gz,
                                              bx, by, bz, c, s);
    case 2:
      return launch_fluid<DensityColorgradViscPass>(t, 7, fl, out, k, gx, gy,
                                                    gz, bx, by, bz, c, s);
    default:
      return cudaErrorInvalidValue;
  }
}
