// Slice-to-volume registration cost of the port, for Hopper (sm_90a), with
// a plain C interface loaded through ctypes
// (fetalreconstruction_tpu_torch/_kernels.py).
//
// -------------------------------------------------------------------------
// frt_reg_ncc_cost
//   Replaces no TPU kernel: the JAX package leaves the cost to XLA, which
//   fuses it.  Eager PyTorch runs it as ~570 launches a call
//   (register/slice2vol.make_cost_fn's torch path: per through-plane
//   offset, the rigid map and raster, the trilinear gather from the bf16
//   shingle table, reg_blur's two passes and _ncc's sums), each a few
//   microseconds of device work behind ~20 us of host time.  This pair
//   computes the same function in two launches:
//     cost[n] = sum_o NCC(target[n], blur(generate(vol, M_n, o)))
//   with M_n = w2i @ T(params[n]) @ ofs[n], over the offsets o in order.
//
//   Launch 1, reg_cost_strips: a block per (unit, offset, strip of rows).
//   The prologue forms the unit's 3 x 4 map; the block then generates its
//   strip's rows and r halo rows on each side (clipped to the slice) into
//   shared memory: the trilinear corners read from the volume (bf16 or
//   float32; zero outside), weighted in corner_weights' corner and product
//   order, < 0 -> -1.  reg_blur follows in shared memory, x then y: -1
//   stays -1, neighbours clamped to >= 0, clamp-to-edge at the slice's
//   border (the halo rows are generated again by the neighbouring strip,
//   never exchanged).  Every float32 step rounds as the torch path's
//   separate ops do (no FMA contraction), so the blurred slice is the
//   torch path's bit for bit wherever the map M_n agrees.  The block then
//   writes its strip's moments in float64: over valid source pixels the
//   count and the sum (the source mean); over the pixels where target >=
//   0, source >= 0 and the level's sub-mask holds, the count and the sums
//   of t', s, t's, s^2 and t'^2, with t' = t - target_mean in float32.
//   Launch 2, reg_cost_finish: a thread per unit adds its strips' moments
//   in strip order, forms each offset's NCC as _ncc defines it (norm > 0
//   else 0) and adds the offsets in order in float32.
//
//   Deterministic: a fixed pixel-to-thread map, a fixed shuffle tree and
//   fixed orders across warps and strips; no atomics.
//
//   Bound on this card: operations, about 100 float32 operations a pixel
//   and offset (raster, weights, 8 corner products, the blur's taps, the
//   moments), against bytes that are read once (the targets) or stay in
//   L2 (the volume, 9.6 MB in bf16 at 169^3).  What the design does about
//   it: nothing of the generated or blurred slice leaves shared memory, and
//   a strip's height follows from H, W and r so that the strip and its
//   halo fit the block's shared memory (kStripBytes, more only where a
//   halo alone exceeds it): a 40^2 patch is one strip, with several blocks
//   resident on an SM; a 180^2 slice eight strips of 23 rows.
// -------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMoments = 8;   // cnt_v, sum_v, n_ok, t', s, t's, s^2, t'^2
constexpr int kMaxOfs = 8;    // through-plane offsets
constexpr int kMaxR = 32;     // blur radius round(4 sigma), sigma <= 8 px
constexpr int kStripBytes = 40 * 1024;     // a strip's two row buffers
constexpr int kMaxSmem = 232448;           // 227 KB, after the opt-in

struct CostArgs {
  int n_ofs;
  float zval[kMaxOfs];      // 2 x offset: the raster's z
  int r;                    // blur radius, 0 for no blur
  float taps[kMaxR + 1];    // k[r], k[r + 1], ..., k[2r]
};

__device__ __forceinline__ float corner(const uint16_t* vol, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(vol + i)) << 16);
}

__device__ __forceinline__ float corner(const float* vol, int64_t i) {
  return __ldg(vol + i);
}

// The trilinear sample of the volume at (x, y, z), as
// psf_fast.shingle_gather reads it from the registration table, then
// generate_slices_psf's < 0 -> -1.
template <typename V>
__device__ float sample(const V* __restrict__ vol, int zs, int ys, int xs,
                        float x, float y, float z) {
  const float u = floorf(x), v = floorf(y), w = floorf(z);
  if (!(u >= -1.0f && u < static_cast<float>(xs) && v >= -1.0f &&
        v < static_cast<float>(ys) && w >= -1.0f &&
        w < static_cast<float>(zs)))
    return 0.0f;
  const float du = __fsub_rn(x, u), dv = __fsub_rn(y, v),
              dw = __fsub_rn(z, w);
  const float fx[2] = {__fsub_rn(1.0f, du), du};
  const float fy[2] = {__fsub_rn(1.0f, dv), dv};
  const float fz[2] = {__fsub_rn(1.0f, dw), dw};
  const int iu = static_cast<int>(u), iv = static_cast<int>(v),
            iw = static_cast<int>(w);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cw = c >> 2, cv = (c >> 1) & 1, cu = c & 1;
    const float wt = __fmul_rn(__fmul_rn(fx[cu], fy[cv]), fz[cw]);
    const int zz = iw + cw, yy = iv + cv, xx = iu + cu;
    float val = 0.0f;
    if (zz >= 0 && zz < zs && yy >= 0 && yy < ys && xx >= 0 && xx < xs)
      val = corner(vol, (static_cast<int64_t>(zz) * ys + yy) * xs + xx);
    acc = __fadd_rn(acc, __fmul_rn(val, wt));
  }
  return acc < 0.0f ? -1.0f : acc;
}

// One pass of reg_blur at a pixel of value c whose neighbour at distance k
// along the pass is nb(k) (clamped to >= 0 here): taps k[r .. 2r].
template <typename F>
__device__ __forceinline__ float blur_at(float c, const float* taps, int r,
                                         F nb) {
  float acc = __fmul_rn(c, taps[0]);
  for (int k = 1; k <= r; ++k) {
    const float p = fmaxf(nb(k), 0.0f), m = fmaxf(nb(-k), 0.0f);
    acc = __fadd_rn(acc, __fmul_rn(taps[k], __fadd_rn(p, m)));
  }
  return c == -1.0f ? -1.0f : acc;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
reg_cost_strips(const V* __restrict__ vol, int zs, int ys, int xs,
                const float* __restrict__ w2i,
                const float* __restrict__ params,
                const float* __restrict__ ofs, const float* __restrict__ tgt,
                const float* __restrict__ tmean, int H, int W, int sub,
                int strip_h, int n_strips, CostArgs a,
                double* __restrict__ part) {
  extern __shared__ float rows_buf[];  // generated rows, then x-blurred
  __shared__ float m[12];
  __shared__ float taps[kMaxR + 1];
  __shared__ double red[kWarps][kMoments];
  const int strip = blockIdx.x % n_strips;
  const int o = (blockIdx.x / n_strips) % a.n_ofs;
  const int unit = blockIdx.x / (n_strips * a.n_ofs);
  const int y0 = strip * strip_h, y1 = min(H, y0 + strip_h);
  const int g0 = max(0, y0 - a.r), g1 = min(H, y1 + a.r);
  const int n_gen = (g1 - g0) * W;
  float* gen = rows_buf;
  float* bx = rows_buf + n_gen;
  const int r = a.r;
  if (threadIdx.x <= r) taps[threadIdx.x] = a.taps[threadIdx.x];

  if (threadIdx.x == 0) {
    // T(params) as core.geometry.rigid_matrix_torch builds it
    const float* p = params + static_cast<int64_t>(unit) * 6;
    const float d2r = static_cast<float>(3.14159265358979323846 / 180.0);
    const float rx = __fmul_rn(p[3], d2r), ry = __fmul_rn(p[4], d2r),
                rz = __fmul_rn(p[5], d2r);
    const float cx = cosf(rx), cy = cosf(ry), cz = cosf(rz);
    const float sx = sinf(rx), sy = sinf(ry), sz = sinf(rz);
    const float sxsy = __fmul_rn(sx, sy), cxsy = __fmul_rn(cx, sy);
    const float t[4][4] = {
        {__fmul_rn(cy, cz), __fmul_rn(cy, sz), -sy, p[0]},
        {__fsub_rn(__fmul_rn(sxsy, cz), __fmul_rn(cx, sz)),
         __fadd_rn(__fmul_rn(sxsy, sz), __fmul_rn(cx, cz)),
         __fmul_rn(sx, cy), p[1]},
        {__fadd_rn(__fmul_rn(cxsy, cz), __fmul_rn(sx, sz)),
         __fsub_rn(__fmul_rn(cxsy, sz), __fmul_rn(sx, cz)),
         __fmul_rn(cx, cy), p[2]},
        {0.0f, 0.0f, 0.0f, 1.0f}};
    const float* f = ofs + static_cast<int64_t>(unit) * 16;
    for (int i = 0; i < 3; ++i) {
      float wt[4];
      for (int k = 0; k < 4; ++k) {
        float s = 0.0f;
        for (int j = 0; j < 4; ++j) s = fmaf(w2i[i * 4 + j], t[j][k], s);
        wt[k] = s;
      }
      for (int l = 0; l < 4; ++l) {
        float s = 0.0f;
        for (int k = 0; k < 4; ++k) s = fmaf(wt[k], f[k * 4 + l], s);
        m[i * 4 + l] = s;
      }
    }
  }
  __syncthreads();

  // the raster of slice_points: ((m0 x + m1 y) + m2 z) + m3 per axis
  const float zv = a.zval[o];
  const float mz[3] = {__fmul_rn(m[2], zv), __fmul_rn(m[6], zv),
                       __fmul_rn(m[10], zv)};
  for (int i = threadIdx.x; i < n_gen; i += kThreads) {
    const float fx = static_cast<float>(i % W);
    const float fy = static_cast<float>(g0 + i / W);
    float q[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[c] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[4 * c], fx),
                                           __fmul_rn(m[4 * c + 1], fy)),
                                 mz[c]),
                       m[4 * c + 3]);
    gen[i] = sample(vol, zs, ys, xs, q[0], q[1], q[2]);
  }
  __syncthreads();

  const float* src = gen;  // the rows the y pass reads
  if (r > 0) {
    for (int i = threadIdx.x; i < n_gen; i += kThreads) {
      const int x = i % W;
      const float* row = gen + (i - x);
      bx[i] = blur_at(row[x], taps, r, [&](int k) {
        return row[min(max(x + k, 0), W - 1)];
      });
    }
    __syncthreads();
    src = bx;
  }

  double acc[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) acc[k] = 0.0;
  const float tm = tmean[unit];
  const float* trow = tgt + static_cast<int64_t>(unit) * H * W;
  for (int i = threadIdx.x; i < (y1 - y0) * W; i += kThreads) {
    const int x = i % W, y = y0 + i / W;
    const float c = src[(y - g0) * W + x];
    const float s = r > 0 ? blur_at(c, taps, r, [&](int k) {
      return src[(min(max(y + k, 0), H - 1) - g0) * W + x];
    }) : c;
    if (s > -1.0f) {
      acc[0] += 1.0;
      acc[1] += s;
    }
    const float t = trow[y * W + x];
    if (t >= 0.0f && s >= 0.0f && (y * W + x) % sub == 0) {
      const double tp = __fsub_rn(t, tm), sd = s;
      acc[2] += 1.0;
      acc[3] += tp;
      acc[4] += sd;
      acc[5] += tp * sd;
      acc[6] += sd * sd;
      acc[7] += tp * tp;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kMoments; ++k) {
    const double v = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kMoments) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    part[static_cast<int64_t>(blockIdx.x) * kMoments + threadIdx.x] = v;
  }
}

__global__ void reg_cost_finish(const double* __restrict__ part, int n,
                                int n_ofs, int n_strips,
                                float* __restrict__ out) {
  const int unit = blockIdx.x * blockDim.x + threadIdx.x;
  if (unit >= n) return;
  float sim = 0.0f;
  for (int o = 0; o < n_ofs; ++o) {
    double mo[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    const double* p =
        part + (static_cast<int64_t>(unit) * n_ofs + o) * n_strips * kMoments;
    for (int s = 0; s < n_strips; ++s)
      for (int k = 0; k < kMoments; ++k) mo[k] += p[s * kMoments + k];
    // _ncc: a = t', b = s - mean over the ok pixels, mean over valid s
    const double mean = mo[0] > 0.0 ? mo[1] / mo[0] : 0.0;
    const double sab = mo[5] - mean * mo[3];
    const double saa = mo[7];
    const double sbb = mo[6] - 2.0 * mean * mo[4] + mo[2] * mean * mean;
    const double norm = saa * sbb;
    const double ncc = norm > 0.0 ? sab / sqrt(fmax(norm, 1e-30)) : 0.0;
    sim = __fadd_rn(sim, static_cast<float>(ncc));
  }
  out[unit] = sim;
}

// Rows of a strip: the most that keep the strip and its 2r halo rows in
// kStripBytes (two float rows of W each), at least one; then evened out
// over the strips that H needs.
int strip_rows(int H, int W, int r) {
  const int fit = kStripBytes / (2 * static_cast<int>(sizeof(float)) * W);
  const int hs = std::max(fit - 2 * r, 1);
  if (hs >= H) return H;
  const int n = (H + hs - 1) / hs;
  return (H + n - 1) / n;
}

template <typename V>
cudaError_t launch(const void* vol, int zs, int ys, int xs, const void* w2i,
                   const void* params, const void* ofs, const void* tgt,
                   const void* tmean, int n, int H, int W, int sub,
                   const CostArgs& a, void* part, void* out,
                   cudaStream_t stream) {
  const int hs = strip_rows(H, W, a.r);
  const int n_strips = (H + hs - 1) / hs;
  const size_t smem =
      2 * sizeof(float) * static_cast<size_t>(std::min(H, hs + 2 * a.r)) * W;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reg_cost_strips<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = static_cast<int64_t>(n) * a.n_ofs * n_strips;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  reg_cost_strips<V><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const V*>(vol), zs, ys, xs, static_cast<const float*>(w2i),
      static_cast<const float*>(params), static_cast<const float*>(ofs),
      static_cast<const float*>(tgt), static_cast<const float*>(tmean), H, W,
      sub, hs, n_strips, a, static_cast<double*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reg_cost_finish<<<(n + 127) / 128, 128, 0, stream>>>(
      static_cast<const double*>(part), n, a.n_ofs, n_strips,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strips of a (H, W) slice at blur radius r: the caller sizes the moments
// buffer of frt_reg_ncc_cost from it.  A plain host function.
int frt_reg_cost_strips(int H, int W, int r) {
  if (H < 1 || W < 1 || r < 0) return 0;
  const int hs = strip_rows(H, W, r);
  return (H + hs - 1) / hs;
}

// vol (zs, ys, xs) bf16 (vol_bf16 != 0) or f32; w2i (4, 4) f32; params
// (n, 6) f32; ofs (n, 4, 4) f32; tgt (n, H, W) f32; tmean (n,) f32;
// sub = level + 1 (the sub-mask keeps y * W + x divisible by it); taps
// (r + 1,) host f32, k[r .. 2r] of the blur (r = 0: no blur); offsets
// (n_ofs,) host i32; part (n, n_ofs, frt_reg_cost_strips(H, W, r), 8)
// f64 scratch; out (n,) f32.  All contiguous, on one device.
int frt_reg_ncc_cost(const void* vol, int vol_bf16, int zs, int ys, int xs,
                     const void* w2i, const void* params, const void* ofs,
                     const void* tgt, const void* tmean, int n, int H, int W,
                     int sub, const void* taps, int r, const void* offsets,
                     int n_ofs, void* part, void* out, void* stream) {
  if (n_ofs < 1 || n_ofs > kMaxOfs || r < 0 || r > kMaxR || sub < 1 ||
      H < 1 || W < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  CostArgs a;
  a.n_ofs = n_ofs;
  for (int o = 0; o < n_ofs; ++o)
    a.zval[o] = 2.0f * static_cast<float>(static_cast<const int*>(offsets)[o]);
  a.r = r;
  for (int k = 0; k <= r; ++k) a.taps[k] = static_cast<const float*>(taps)[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vol_bf16 ? launch<uint16_t>(vol, zs, ys, xs, w2i, params, ofs, tgt,
                                  tmean, n, H, W, sub, a, part, out, s)
               : launch<float>(vol, zs, ys, xs, w2i, params, ofs, tgt, tmean,
                               n, H, W, sub, a, part, out, s);
  return static_cast<int>(err);
}

}  // extern "C"
