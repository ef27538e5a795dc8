// Neighbor-pass kernel for Hopper (sm_90a): one SPH pair-sum traversal of
// the lane-major flat cell grid.
//
// Replaces cpp_fluid_particles_tpu/ops/pallas_passes.py:107 `column_pass`
// (the Pallas kernel that evaluates a pass body over (CZ, K_i, 27K_j) pair
// blocks per (x, y) cell column). It computes what that kernel computes with
// `_std_body` (pallas_passes.py:780): the one-sided 27-cell fluid pair sum
// plus the boundary term, for three pass instances (template functors
// below): density, density_colorgrad_visc and surface_pressure.
//
// Layout (ops/dense.py): fl (Fi, K, G) and bd (Fb=4, Kb, G), float32,
// contiguous, G = GX*GY*GZ the flattened ghosted cell axis (x-major). Slot k
// of cell c holds the particle of rank k; ranks fill slots contiguously
// from 0 and empty slots hold POS_PAD positions. Output (n_out, K, G).
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
// j cell is re-read by the 27 cells around it. A shared-memory halo tile
// (the plan of exp/flat_pallas_proto.py) is the next step for this kernel.
//
// Support is tested BEFORE the kernel polynomials are evaluated: against a
// POS_PAD slot r ~ 1.7e6 and the Akinci piece overflows float32 to inf,
// which a zero mass would turn into NaN. The float constants are computed
// on the host in double, as the Python does, and passed in as float.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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

// --- pass functors. Row r of a grid with slot stride kg is at r*kg + t. ---

// rho = sum m_j W (pallas_passes.py:874); fl = bd = [pos3, mass].
struct DensityPass {
  static constexpr int kOut = 1;
  struct I {
    float x, y, z;
  };
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return {fl[t], fl[kg + t], fl[2 * kg + t]};
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
  struct I {
    float x, y, z, vx, vy, vz;
  };
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts&) {
    return {fl[t],          fl[kg + t],     fl[2 * kg + t],
            fl[4 * kg + t], fl[5 * kg + t], fl[6 * kg + t]};
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
struct SurfacePressurePass {
  static constexpr int kOut = 6;
  struct I {
    float x, y, z, c2, gate, p_rho2;
  };
  __device__ static float p_rho2(const float* f, int64_t t, int64_t kg,
                               const Consts& c) {
    const float rho = f[4 * kg + t];
    return f[5 * kg + t] / fmaxf(c.eps, rho * rho);
  }
  __device__ static float cg2(const float* f, int64_t t, int64_t kg) {
    const float gx = f[6 * kg + t], gy = f[7 * kg + t], gz = f[8 * kg + t];
    return gx * gx + gy * gy + gz * gz;
  }
  __device__ static I load_i(const float* fl, int64_t t, int64_t kg,
                             const Consts& c) {
    const float c2 = cg2(fl, t, kg);
    const float n = sqrtf(c2);
    return {fl[t], fl[kg + t], fl[2 * kg + t], c2, n / fmaxf(c.eps, n),
            p_rho2(fl, t, kg, c)};
  }
  __device__ static void fluid(float* acc, const I& i, const float* fl,
                               int64_t tj, int64_t kg, float dx, float dy,
                               float dz, float r, const Consts& c) {
    const float mj = fl[3 * kg + tj];
    const float cw = grad_w_cubic_coef(r, c);
    const float st = c.st_coef * (i.c2 + cg2(fl, tj, kg)) *
                     grad_w_surface_coef(r, c);
    const float ms = mj * (st + c.air_coef * i.gate * cw);
    const float mp = mj * ((i.p_rho2 + p_rho2(fl, tj, kg, c)) * cw);
    acc[0] += ms * dx;
    acc[1] += ms * dy;
    acc[2] += ms * dz;
    acc[3] -= mp * dx;
    acc[4] -= mp * dy;
    acc[5] -= mp * dz;
  }
  __device__ static void bdry(float* acc, const I& i, const float* bd,
                              int64_t tj, int64_t kbg, float dx, float dy,
                              float dz, float r, const Consts& c) {
    const float coefb = -bd[3 * kbg + tj] * i.p_rho2 * grad_w_cubic_coef(r, c);
    acc[3] += coefb * dx;
    acc[4] += coefb * dy;
    acc[5] += coefb * dz;
  }
};

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
      for (int s = 0; s < k; ++s) {
        const int64_t tj = s * g + cj;
        const float xj = fl[tj];
        if (!(xj < c.pos_guard)) break;  // ranks fill slots from 0
        const float dx = iv.x - xj;
        const float dy = iv.y - fl[kg + tj];
        const float dz = iv.z - fl[2 * kg + tj];
        const float r = sqrtf(dx * dx + dy * dy + dz * dz);
        if (in_support(r, c)) P::fluid(acc, iv, fl, tj, kg, dx, dy, dz, r, c);
      }
      for (int s = 0; s < kb; ++s) {
        const int64_t tj = s * g + cj;
        const float xj = bd[tj];
        if (!(xj < c.pos_guard)) break;
        const float dx = iv.x - xj;
        const float dy = iv.y - bd[kbg + tj];
        const float dz = iv.z - bd[2 * kbg + tj];
        const float r = sqrtf(dx * dx + dy * dy + dz * dz);
        if (in_support(r, c)) P::bdry(acc, iv, bd, tj, kbg, dx, dy, dz, r, c);
      }
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

}  // namespace

// Pass ids match ops/column_pass_cuda.py:PASS_IDS. Returns a cudaError_t
// (0 on success); an unknown pass id or constant count is
// cudaErrorInvalidValue.
extern "C" int column_pass_launch(int pass_id, const float* fl,
                                  const float* bd, float* out, int k, int kb,
                                  int gx, int gy, int gz, const float* consts,
                                  int n_consts, int device, void* stream) {
  if (n_consts < 0 ||
      static_cast<size_t>(n_consts) * sizeof(float) != sizeof(Consts))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
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
    default:
      return cudaErrorInvalidValue;
  }
}
