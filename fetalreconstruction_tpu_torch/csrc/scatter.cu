// Transpose (scatter) half of the fast PSF engine: the kernel of
// psf_fast.fast_scatter2, for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (fetalreconstruction_tpu_torch/_kernels.py).
//
// -------------------------------------------------------------------------
// frt_splat2_dense
//   Replaces fetalreconstruction_tpu/ops/pallas_scatter.py: _make_kernel
//   (launched by pallas_splat2_packed, the sorted-stream accumulate into
//   the parity-blocked accumulator) AND _make_unblock_kernel (launched by
//   pallas_unblock, which un-blocks that accumulator into dense volumes),
//   together with the XLA sum of the un-block's 8 parity partials.
//   Computes the dense per-stack volumes straight from the plan:
//     out[s, 0, z, y, x] = sum_par sum_{k in run(cell(s, par, z, y, x))}
//                          w[k, corner] * pay_a[pix[k]]
//   (and pay_b into out[s, 1]), where, on each axis, the floor is the one
//   of {v - 1, v} whose parity is par's bit on that axis and the corner is
//   v - floor.  The plan (ops/scatter.build_scatter_plan) is a CSR over
//   the floor cells, (S, zs+1, ys+1, xs+1) of them, cell
//     ((s*(zs+1) + w+1)*(ys+1) + v+1)*(xs+1) + u+1
//   with each run's slots in ascending pixel order.
//
//   Order of the sums: each run summed per corner and payload in plan
//   order from 0, round-to-nearest multiply and add kept apart (no FMA
//   contraction); per voxel the 8 run totals added in par order from 0, as
//   the un-block did.  A parity row (s, par, bz, by, bx) of the TPU's
//   accumulator holds exactly the pixels of floor cell 2b - par on each
//   axis, in the same order, so this is the arithmetic of the former row
//   splat followed by the former un-block, bit for bit, and deterministic:
//   no atomics.
//
//   Design: a block owns a kTX x kTY x kTZ tile of one stack's voxels.
//   Phase A, one thread per floor cell of the tile (the tile + 1 on each
//   axis), sums the cell's run into 8 corner totals x 2 payloads kept in
//   shared memory: the TPU kept its accumulator block in VMEM, and here a
//   tile's share of it never leaves the SM.  Phase B, one thread per voxel
//   (x fastest within a warp, so the output stores coalesce; every voxel
//   written, so the wrapper allocates with torch.empty), adds the totals
//   of its 8 cells.  A cell on the tile's upper faces is summed by the
//   neighbouring tiles too (1.45 x the cells at 32 x 4 x 4).
//
//   Bound on this card: bytes.  Each slot's index (4 B), its 8 corner
//   weights (32 B) and its 2 payloads (8 B) are read, the cell pointer
//   (4 B a cell) is read and the dense volumes (8 B a voxel) written:
//   about 0.32 GB at the 160^3 4-stack size, against 2.5 GB for the
//   accumulator pair it replaces (1.09 GB zero-filled, written and read
//   back).  No accumulator exists; what is left above the bound is
//   latency: a cell's run is a chain of dependent loads (pointer, pixel,
//   payloads), which phase A walks one cell after another.  Designs
//   measured and dropped: one thread per voxel walking its 8 runs in
//   device memory, with and without the tile's slots staged in shared
//   memory (slower: 8 walks of each run instead of one).
// -------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block's tile: kTX x kTY x kTZ voxels of one stack; its threads
// kTX x kTY x kWZ, each kTZ / kWZ voxels along z in phase B.
constexpr int kTX = 32, kTY = 4, kTZ = 4, kWZ = 2;
constexpr int kThreads = kTX * kTY * kWZ;
constexpr int kCX = kTX + 1, kCY = kTY + 1, kCZ = kTZ + 1;
constexpr int kCells = kCX * kCY * kCZ;  // floor cells of a tile
constexpr int kSmem = 8 * kCells * sizeof(float2);  // 52,800 B

__global__ void __launch_bounds__(kThreads)
splat2_dense_kernel(const int32_t* __restrict__ pix,
                    const float* __restrict__ wts,
                    const int32_t* __restrict__ cell_ptr,
                    const float* __restrict__ pay_a,
                    const float* __restrict__ pay_b,
                    float* __restrict__ out, int zs, int ys, int xs,
                    int tiles_z) {
  extern __shared__ float2 tot[];  // [corner][cell]: (a, b) run totals
  const int s = blockIdx.z / tiles_z;
  const int z0 = (blockIdx.z - s * tiles_z) * kTZ;
  const int y0 = blockIdx.y * kTY;
  const int x0 = blockIdx.x * kTX;
  const int64_t cxs = xs + 1, cys = ys + 1, czs = zs + 1;
  const int tid = threadIdx.x + kTX * (threadIdx.y + kTY * threadIdx.z);
  // phase A: cells past the grid's last cell are left at 0 (no voxel of
  // the grid reads them)
  for (int i = tid; i < kCells; i += kThreads) {
    const int lx = i % kCX;
    const int ly = (i / kCX) % kCY;
    const int lz = i / (kCX * kCY);
    const int64_t cz = z0 + lz, cy = y0 + ly, cx = x0 + lx;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
    if (cz <= zs && cy <= ys && cx <= xs) {
      const int64_t c = ((s * czs + cz) * cys + cy) * cxs + cx;
      const int k1 = cell_ptr[c + 1];
      for (int k = cell_ptr[c]; k < k1; ++k) {
        const int p = pix[k];
        const float a = pay_a[p];
        const float b = pay_b[p];
        const float4* w4 =
            reinterpret_cast<const float4*>(wts + (int64_t)k * 8);
        const float4 lo = w4[0];
        const float4 hi = w4[1];
        const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          acc[2 * q] = __fadd_rn(acc[2 * q], __fmul_rn(w[q], a));
          acc[2 * q + 1] = __fadd_rn(acc[2 * q + 1], __fmul_rn(w[q], b));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      tot[q * kCells + i] = make_float2(acc[2 * q], acc[2 * q + 1]);
  }
  __syncthreads();
  // phase B
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= xs || y >= ys) return;
  const int64_t nvox = (int64_t)zs * ys * xs;
  for (int tz = threadIdx.z; tz < kTZ && z0 + tz < zs; tz += kWZ) {
    const int z = z0 + tz;
    float oa = 0.0f, ob = 0.0f;
#pragma unroll
    for (int par = 0; par < 8; ++par) {
      // corner on each axis: 0 where v has par's parity (floor v), else 1
      // (floor v - 1); the floor's cell is v + 1 - corner
      const int cw = (z ^ (par >> 2)) & 1;
      const int cv = (y ^ (par >> 1)) & 1;
      const int cu = (x ^ par) & 1;
      const int i = ((tz + 1 - cw) * kCY + threadIdx.y + 1 - cv) * kCX
                    + threadIdx.x + 1 - cu;
      const float2 t = tot[((cw * 2 + cv) * 2 + cu) * kCells + i];
      oa = __fadd_rn(oa, t.x);
      ob = __fadd_rn(ob, t.y);
    }
    const int64_t v = ((int64_t)z * ys + y) * xs + x;
    out[(int64_t)(s * 2) * nvox + v] = oa;
    out[(int64_t)(s * 2 + 1) * nvox + v] = ob;
  }
}

}  // namespace

extern "C" {

const char* frt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pix (M,) i32, wts (M, 8) f32, cell_ptr (S*(zs+1)*(ys+1)*(xs+1) + 1,)
// i32, pay_a / pay_b (n_pixels,) f32, out (S, 2, zs, ys, xs) f32 (every
// element written).
int frt_splat2_dense(const void* pix, const void* wts, const void* cell_ptr,
                     const void* pay_a, const void* pay_b, void* out,
                     int n_stacks, int zs, int ys, int xs, void* stream) {
  const int tiles_z = (zs + kTZ - 1) / kTZ;
  if ((int64_t)n_stacks * zs * ys * xs > 0) {
    // above 48 KB of shared memory only after this opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        splat2_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((xs + kTX - 1) / kTX, (ys + kTY - 1) / kTY,
                    n_stacks * tiles_z);
    splat2_dense_kernel<<<grid, dim3(kTX, kTY, kWZ), kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(pix), static_cast<const float*>(wts),
        static_cast<const int32_t*>(cell_ptr),
        static_cast<const float*>(pay_a), static_cast<const float*>(pay_b),
        static_cast<float*>(out), zs, ys, xs, tiles_z);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
