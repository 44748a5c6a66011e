// Transpose (scatter) half of the fast PSF engine: the two kernels of
// psf_fast.fast_scatter2, for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (fetalreconstruction_tpu_torch/_kernels.py).
//
// Accumulator layout (both kernels): the LOGICAL parity-blocked accumulator
// of psf_fast._splat2_blocked, (S*8*Bz*By*Bx, 16) f32, row
//   (((s*8 + par)*Bz + bz)*By + by)*Bx + bx
// and value ((cw*2 + cv)*2 + cu)*2 + pay within the row, with
// B* = (dim + 3) / 2.  Flat offsets are int64: rows * 16 nears 2^31 at the
// 0.75 mm 8-stack size.
//
// -------------------------------------------------------------------------
// B1  frt_splat2_rows
//   Replaces fetalreconstruction_tpu/ops/pallas_scatter.py: _make_kernel
//   (launched by pallas_splat2_packed), the sorted-stream accumulate.
//   Computes, for every TOUCHED accumulator row t (the scatter plan's
//   CSR: rows[t], pixel run row_ptr[t] .. row_ptr[t+1] in sorted order),
//     out[rows[t], 2c + 0] = sum_k w[k, c] * pay_a[pix[k]]
//     out[rows[t], 2c + 1] = sum_k w[k, c] * pay_b[pix[k]]
//   One thread per touched row, output-stationary: no atomics, and the run
//   is summed in the plan's (stable, pixel-ascending) order with
//   round-to-nearest multiply and add kept apart (no FMA contraction), so
//   the result is bitwise deterministic and equal to a sequential
//   index_add in that order.
//   Bound on this card: memory.  Per pixel it reads its index (4 B), its 8
//   corner weights (32 B) and two gathered payloads (8 B, random access);
//   per touched row it writes one 64 B row.  No arithmetic intensity to
//   speak of (16 multiply-adds per 44 B).  The design reads weights as two
//   16 B vector loads and writes each row as four 16 B stores; untouched
//   rows are never visited (the wrapper zero-fills the output).  Coalescing
//   the payload gather (sorting slots by pixel within a block) is later
//   work.
//
// B2  frt_unblock2
//   Replaces fetalreconstruction_tpu/ops/pallas_scatter.py:
//   _make_unblock_kernel (launched by pallas_unblock) together with the
//   XLA sum of its 8 parity partials.  Computes the dense per-stack volumes
//     out[s, pay, z, y, x] = sum_{par=0..7} acc[row(s, par, z+sz, y+sy,
//                                                   x+sx), value(pay)]
//   (psf_fast._unblock2's math), one thread per (s, z, y, x) voxel writing
//   both payloads, the 8 parity terms added in order par = 0..7 exactly as
//   _unblock2 does, so it is bitwise equal to the plain version.
//   Bound on this card: memory.  Per voxel it writes 8 B and reads 8
//   scattered 8 B pairs; neighbouring x voxels of one parity share a 64 B
//   accumulator row, so a warp's reads of one parity fall in ~16 rows.
//   The whole accumulator (~1.1 GB at the 160^3 4-stack size) is read
//   about once.  The TPU design's one-hot interleave matmuls and
//   plane-padded layout existed only for the TPU's (8, 128) tiling and are
//   not carried over.
// -------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void splat2_rows_kernel(const int32_t* __restrict__ pix,
                                   const float* __restrict__ wts,
                                   const int64_t* __restrict__ rows,
                                   const int64_t* __restrict__ row_ptr,
                                   int64_t n_touched,
                                   const float* __restrict__ pay_a,
                                   const float* __restrict__ pay_b,
                                   float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_touched) return;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
  const int64_t k1 = row_ptr[t + 1];
  for (int64_t k = row_ptr[t]; k < k1; ++k) {
    const int64_t p = pix[k];
    const float a = pay_a[p];
    const float b = pay_b[p];
    const float4* w4 = reinterpret_cast<const float4*>(wts + k * 8);
    const float4 lo = w4[0];
    const float4 hi = w4[1];
    const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[2 * c] = __fadd_rn(acc[2 * c], __fmul_rn(w[c], a));
      acc[2 * c + 1] = __fadd_rn(acc[2 * c + 1], __fmul_rn(w[c], b));
    }
  }
  float4* o = reinterpret_cast<float4*>(out + rows[t] * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]);
}

__global__ void unblock2_kernel(const float* __restrict__ acc,
                                float* __restrict__ out, int n_stacks,
                                int zs, int ys, int xs) {
  const int64_t nvox = (int64_t)zs * ys * xs;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n_stacks * nvox) return;
  const int64_t s = i / nvox;
  const int64_t v = i - s * nvox;
  const int x = (int)(v % xs);
  const int y = (int)((v / xs) % ys);
  const int z = (int)(v / ((int64_t)xs * ys));
  const int64_t Bz = (zs + 3) / 2, By = (ys + 3) / 2, Bx = (xs + 3) / 2;
  float oa = 0.0f, ob = 0.0f;
#pragma unroll
  for (int par = 0; par < 8; ++par) {
    const int iz = z + ((par >> 2) & 1);
    const int iy = y + ((par >> 1) & 1);
    const int ix = x + (par & 1);
    const int64_t row =
        (((s * 8 + par) * Bz + (iz >> 1)) * By + (iy >> 1)) * Bx + (ix >> 1);
    const int val = (((iz & 1) * 2 + (iy & 1)) * 2 + (ix & 1)) * 2;
    const float2 ab = *reinterpret_cast<const float2*>(acc + row * 16 + val);
    oa = __fadd_rn(oa, ab.x);
    ob = __fadd_rn(ob, ab.y);
  }
  out[(s * 2) * nvox + v] = oa;
  out[(s * 2 + 1) * nvox + v] = ob;
}

constexpr int kThreads = 256;

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* frt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pix (M,) i32, wts (M, 8) f32, rows (T,) i64, row_ptr (T+1,) i64,
// pay_a / pay_b (n_pixels,) f32, out (n_rows, 16) f32 pre-zeroed.
int frt_splat2_rows(const void* pix, const void* wts, const void* rows,
                    const void* row_ptr, int64_t n_touched,
                    const void* pay_a, const void* pay_b, void* out,
                    void* stream) {
  if (n_touched > 0) {
    splat2_rows_kernel<<<blocks_for(n_touched), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(pix), static_cast<const float*>(wts),
        static_cast<const int64_t*>(rows),
        static_cast<const int64_t*>(row_ptr), n_touched,
        static_cast<const float*>(pay_a), static_cast<const float*>(pay_b),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// acc (S*8*Bz*By*Bx, 16) f32, out (S, 2, zs, ys, xs) f32.
int frt_unblock2(const void* acc, void* out, int n_stacks, int zs, int ys,
                 int xs, void* stream) {
  const int64_t n = (int64_t)n_stacks * zs * ys * xs;
  if (n > 0) {
    unblock2_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(acc), static_cast<float*>(out), n_stacks,
        zs, ys, xs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
