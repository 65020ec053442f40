// Halo row-block decoder tail for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of the JAX package's kernels/halo_conv.py:
//   * halo_tail        <- `_halo_kernel` (launched by `_halo_tail_impl`): one
//                         grid step per image and row block, its slab copied
//                         at a dynamic row offset;
//   * halo_tail_static <- `_halo_static_kernel` (launched by
//                         `_halo_tail_static_impl`): one grid step per image,
//                         a static, unrolled loop over the row blocks.
// Both compute the interior rows EDGE .. H-EDGE-1 (EDGE = 4) of the decoder
// tail conv8 -> relu -> conv9 -> relu -> conv10, in row blocks of bh rows
// ((H - 8) % bh == 0). The wrapper (kernels/halo_conv.py) adds the 4 top and
// 4 bottom rows from reflect-padded strips.
//
// What is computed. Output row r needs input rows r-3 .. r+3 through the
// three layers, and for r in [4, H-5] every one of them is a real row: the
// convs are VALID in H (block i reads input rows 4 + i*bh - 3 .. 4 + i*bh +
// bh + 2; layer 8 gives bh+4 rows, layer 9 bh+2, layer 10 bh), reflect-padded
// in W at every layer (layer 9's pad reflects layer 8's output). Exact
// products summed in fp32, the fp32 bias added before the one rounding to
// the input type, relu after layers 8 and 9: `_tail_block`'s arithmetic,
// which is `_conv3x3`'s. The tile body is conv_stack.cu's (conv_tile.cuh)
// in its VALID_H mode, where only the columns reflect, so each interior
// pixel is summed in the same order as in the fused tail and equals its
// rows bit for bit.
//
// Layouts: x (B, C, H, W) fp32 or bf16; biases fp32; weights as the fused
// tail takes them (bf16: the packed blocks of `pack_tc_weights`; fp32:
// (C_in, 3, 3, C_out) tap-major copies). Out: the interior (B, O10, H-8, W)
// in the input type.
//
// What bounds it on this card. Per 128^2 image the interior is 120 x 128
// pixels of 2 x 9 x (64*64 + 64*64 + 64*2) FLOP, 2,300 MFLOP against 2 MB in
// and 60 KB out, so the products bound it, at the tensor cores' bf16 rate
// for bf16 operands and the CUDA cores' fp32 rate for fp32.
// What the design does about it. The TPU kernel's slab, (bh+6) x W x C, is
// 590 KB in bf16 at bh = 30, more than the 227 KB of shared memory a block
// may use. So a block owns `rows` output rows (the largest divisor of bh up
// to 16: 15 at bh = 30 or 60) by a column tile of `cols` (the widest of 16,
// 8, 4 that fits: 16 at C = 64), with a 3-pixel halo, and computes each
// intermediate layer over the halo the next one still needs (1.42 times
// the interior's work at 15 x 16). In bf16 the tile runs on the tensor
// cores (`tc_tail_tile`, conv_tile.cuh: the 15 x 16 tile's conv8 and conv9
// are 4 runs of 112 pixels each, one a warpgroup); in fp32 on the CUDA
// cores (`tail_tile`), fixed by the input type.
//   * halo_tail: one block per image x row block x sub-block x column tile
//     (fp32), or one block an SM walking them (bf16); each tile's first
//     row comes from its index at run time.
//   * halo_tail_static<BH>: one block per image x column tile, looping over
//     the image's row blocks and over each block's BH/rows sub-blocks, with
//     BH and rows compile-time constants (BH in {8, 16, 24, 30, 60}), so
//     each slab offset is EDGE + i*BH + s*rows with constant strides; the
//     number of row blocks, (H - 8) / BH, is a run-time bound. The loops
//     are not unrolled: each unrolled sub-block would repeat the whole
//     inlined tile body, and the build would take minutes.
//     The TPU kernel holds the whole image in VMEM (2 MB); here the image is
//     not resident in shared memory: the block walks its column strip down
//     the image, and the halo rows that consecutive sub-blocks share are
//     read again from device memory, through the 50 MB L2, as are each
//     layer's weights.
//
// Each entry point launches one kernel on the caller's stream, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include "conv_tile.cuh"

namespace {

constexpr int EDGE = 4;  // top and bottom rows left to the wrapper's strips
constexpr int MAX_ROWS = 16;

// The largest divisor of bh that is at most MAX_ROWS.
__host__ __device__ constexpr int block_rows(int bh) {
  int r = bh < MAX_ROWS ? bh : MAX_ROWS;
  while (bh % r != 0) --r;
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
halo_kernel(const T* __restrict__ x, int C, int H, int W, int bh, int rows, int cols,
            int tiles_x, const float* k8, const float* b8, int O8, const float* k9,
            const float* b9, int O9, const float* k10, const float* b10, int O10,
            T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int subs = bh / rows, n_blocks = (H - 2 * EDGE) / bh;
  int id = blockIdx.x;
  const int tx = id % tiles_x;
  id /= tiles_x;
  const int s = id % subs;
  id /= subs;
  const int i = id % n_blocks;
  const int b = id / n_blocks;
  // The first output row of this block; its slab starts 3 rows above.
  const int y0 = EDGE + i * bh + s * rows;
  const int h_out = H - 2 * EDGE;
  tail_tile<T, true>(x + (size_t)b * C * H * W, C, H, W, y0, tx * cols, rows, cols, k8, b8, O8,
                     k9, b9, O9, k10, b10, O10, out + (size_t)b * O10 * h_out * W, EDGE, h_out,
                     smem);
}

template <typename T, int BH>
__global__ void __launch_bounds__(THREADS)
halo_static_kernel(const T* __restrict__ x, int C, int H, int W, int cols, int tiles_x,
                   const float* k8, const float* b8, int O8, const float* k9, const float* b9,
                   int O9, const float* k10, const float* b10, int O10, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ROWS = block_rows(BH);
  const int tx = blockIdx.x % tiles_x;
  const int b = blockIdx.x / tiles_x;
  const int n_blocks = (H - 2 * EDGE) / BH;
  const int h_out = H - 2 * EDGE;
  const T* xb = x + (size_t)b * C * H * W;
  T* ob = out + (size_t)b * O10 * h_out * W;
  for (int i = 0; i < n_blocks; ++i) {
#pragma unroll 1
    for (int s = 0; s < BH / ROWS; ++s) {
      // The previous sub-block's last layer must be done reading B (which
      // shares its buffer with the next input tile) before the next load.
      __syncthreads();
      tail_tile<T, true>(xb, C, H, W, EDGE + i * BH + s * ROWS, tx * cols, ROWS, cols, k8, b8,
                         O8, k9, b9, O9, k10, b10, O10, ob, EDGE, h_out, smem);
    }
  }
}

// The same two kernels on the tensor cores (bf16). halo_tc_kernel: one
// block an SM walks the (image, row block, sub-block, column tile) tiles.
__global__ void __launch_bounds__(TC_THREADS, 1)
halo_tc_kernel(const __nv_bfloat16* __restrict__ x, int C, int H, int W, int bh, int rows,
               int cols, int tiles_x, int n_tiles, const __nv_bfloat16* w8, const float* b8,
               int O8, const __nv_bfloat16* w9, const float* b9, int O9,
               const __nv_bfloat16* w10, const float* b10, int O10,
               __nv_bfloat16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tc_smem(smem_raw);
  const int h_out = H - 2 * EDGE;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    asm volatile("" : "+r"(bh), "+r"(rows));  // as in tc_tail_tile: recomputed, not held
    const int subs = bh / rows, n_blocks = (H - 2 * EDGE) / bh;
    int id = t;
    const int tx = id % tiles_x;
    id /= tiles_x;
    const int s = id % subs;
    id /= subs;
    const int i = id % n_blocks;
    const int b = id / n_blocks;
    tc_tail_tile<true>(x + (size_t)b * C * H * W, C, H, W, EDGE + i * bh + s * rows, tx * cols,
                       rows, cols, w8, b8, O8, w9, b9, O9, w10, b10, O10,
                       out + (size_t)b * O10 * h_out * W, EDGE, h_out, smem,
                       t == (int)blockIdx.x, t + (int)gridDim.x >= n_tiles);
  }
}

template <int BH>
__global__ void __launch_bounds__(TC_THREADS, 1)
halo_static_tc_kernel(const __nv_bfloat16* __restrict__ x, int C, int H, int W, int cols,
                      int tiles_x, const __nv_bfloat16* w8, const float* b8, int O8,
                      const __nv_bfloat16* w9, const float* b9, int O9,
                      const __nv_bfloat16* w10, const float* b10, int O10,
                      __nv_bfloat16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int ROWS = block_rows(BH);
  unsigned char* smem = tc_smem(smem_raw);
  const int tx = blockIdx.x % tiles_x;
  const int b = blockIdx.x / tiles_x;
  const int n_blocks = (H - 2 * EDGE) / BH;
  const int h_out = H - 2 * EDGE;
  const __nv_bfloat16* xb = x + (size_t)b * C * H * W;
  __nv_bfloat16* ob = out + (size_t)b * O10 * h_out * W;
  // Row block i, sub-block s of the strip: its first row is EDGE + i*BH +
  // s*ROWS = EDGE + u*ROWS for the u-th sub-block overall.
  const int n_sub = n_blocks * (BH / ROWS);
#pragma unroll 1
  for (int u = 0; u < n_sub; ++u) {
    tc_tail_tile<true>(xb, C, H, W, EDGE + u * ROWS, tx * cols, ROWS, cols, w8, b8, O8, w9, b9,
                       O9, w10, b10, O10, ob, EDGE, h_out, smem, u == 0, u == n_sub - 1);
  }
}

bool bad_args(int B, int C, int H, int W, int bh, int O8, int O9, int O10) {
  return B < 1 || C < 1 || O8 < 1 || O9 < 1 || O10 < 1 || W < 2 || bh < 1 ||
         H < 2 * EDGE + 2 || (H - 2 * EDGE) % bh != 0;
}

// The widest column tile of 16, 8, 4 whose shared memory fits; 0 if none.
template <typename T>
int pick_cols(int rows, int C, int O8, int O9, int O10, size_t* bytes) {
  const int limit = max_smem();
  const int tiles[] = {16, 8, 4};
  for (int t : tiles) {
    *bytes = tail_smem<T>(rows, t, C, O8, O9, O10);
    if (*bytes <= (size_t)limit) return t;
  }
  return 0;
}

// The widest column tile of 16, 8, 4 whose tensor-core plan fits; 0 if none.
int pick_cols_tc(int rows, int C, int O8, int O9, int O10, size_t* bytes) {
  const int limit = max_smem();
  const int tiles[] = {16, 8, 4};
  for (int t : tiles) {
    *bytes = tc_tail_plan(rows, t, C, O8, O9, O10).bytes;
    if (*bytes <= (size_t)limit) return t;
  }
  return 0;
}

using bf = __nv_bfloat16;

int launch_halo_tc(const void* x, int B, int C, int H, int W, int bh, const void* w8,
                   const float* b8, int O8, const void* w9, const float* b9, int O9,
                   const void* w10, const float* b10, int O10, void* out, cudaStream_t stream) {
  if (bad_args(B, C, H, W, bh, O8, O9, O10)) return (int)cudaErrorInvalidValue;
  const int rows = block_rows(bh);
  size_t bytes = 0;
  const int cols = pick_cols_tc(rows, C, O8, O9, O10, &bytes);
  if (cols == 0) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + cols - 1) / cols;
  const long long blocks = (long long)B * ((H - 2 * EDGE) / rows) * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(halo_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(blocks < sm_count() ? blocks : sm_count());
  halo_tc_kernel<<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf*>(x), C, H, W, bh, rows, cols, tiles_x, (int)blocks,
      static_cast<const bf*>(w8), b8, O8, static_cast<const bf*>(w9), b9, O9,
      static_cast<const bf*>(w10), b10, O10, static_cast<bf*>(out));
  return (int)cudaGetLastError();
}

template <int BH>
int launch_static_tc(const void* x, int B, int C, int H, int W, const void* w8, const float* b8,
                     int O8, const void* w9, const float* b9, int O9, const void* w10,
                     const float* b10, int O10, void* out, cudaStream_t stream) {
  size_t bytes = 0;
  const int cols = pick_cols_tc(block_rows(BH), C, O8, O9, O10, &bytes);
  if (cols == 0) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + cols - 1) / cols;
  const long long blocks = (long long)B * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(halo_static_tc_kernel<BH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  halo_static_tc_kernel<BH><<<(unsigned)blocks, TC_THREADS, bytes, stream>>>(
      static_cast<const bf*>(x), C, H, W, cols, tiles_x, static_cast<const bf*>(w8), b8, O8,
      static_cast<const bf*>(w9), b9, O9, static_cast<const bf*>(w10), b10, O10,
      static_cast<bf*>(out));
  return (int)cudaGetLastError();
}

int launch_halo_static_tc(const void* x, int B, int C, int H, int W, int bh, const void* w8,
                          const float* b8, int O8, const void* w9, const float* b9, int O9,
                          const void* w10, const float* b10, int O10, void* out,
                          cudaStream_t stream) {
  if (bad_args(B, C, H, W, bh, O8, O9, O10)) return (int)cudaErrorInvalidValue;
  switch (bh) {
    case 8: return launch_static_tc<8>(x, B, C, H, W, w8, b8, O8, w9, b9, O9, w10, b10, O10, out, stream);
    case 16: return launch_static_tc<16>(x, B, C, H, W, w8, b8, O8, w9, b9, O9, w10, b10, O10, out, stream);
    case 24: return launch_static_tc<24>(x, B, C, H, W, w8, b8, O8, w9, b9, O9, w10, b10, O10, out, stream);
    case 30: return launch_static_tc<30>(x, B, C, H, W, w8, b8, O8, w9, b9, O9, w10, b10, O10, out, stream);
    case 60: return launch_static_tc<60>(x, B, C, H, W, w8, b8, O8, w9, b9, O9, w10, b10, O10, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_halo(const void* x, int B, int C, int H, int W, int bh, const float* k8,
                const float* b8, int O8, const float* k9, const float* b9, int O9,
                const float* k10, const float* b10, int O10, void* out, cudaStream_t stream) {
  if (bad_args(B, C, H, W, bh, O8, O9, O10)) return (int)cudaErrorInvalidValue;
  const int rows = block_rows(bh);
  size_t bytes = 0;
  const int cols = pick_cols<T>(rows, C, O8, O9, O10, &bytes);
  if (cols == 0) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + cols - 1) / cols;
  const long long blocks = (long long)B * ((H - 2 * EDGE) / rows) * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(halo_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  halo_kernel<T><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), C, H, W, bh, rows, cols, tiles_x, k8, b8, O8, k9, b9, O9, k10,
      b10, O10, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T, int BH>
int launch_static(const void* x, int B, int C, int H, int W, const float* k8, const float* b8,
                  int O8, const float* k9, const float* b9, int O9, const float* k10,
                  const float* b10, int O10, void* out, cudaStream_t stream) {
  size_t bytes = 0;
  const int cols = pick_cols<T>(block_rows(BH), C, O8, O9, O10, &bytes);
  if (cols == 0) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + cols - 1) / cols;
  const long long blocks = (long long)B * tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(halo_static_kernel<T, BH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  halo_static_kernel<T, BH><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), C, H, W, cols, tiles_x, k8, b8, O8, k9, b9, O9, k10, b10, O10,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_halo_static(const void* x, int B, int C, int H, int W, int bh, const float* k8,
                       const float* b8, int O8, const float* k9, const float* b9, int O9,
                       const float* k10, const float* b10, int O10, void* out,
                       cudaStream_t stream) {
  if (bad_args(B, C, H, W, bh, O8, O9, O10)) return (int)cudaErrorInvalidValue;
  switch (bh) {
    case 8: return launch_static<T, 8>(x, B, C, H, W, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, stream);
    case 16: return launch_static<T, 16>(x, B, C, H, W, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, stream);
    case 24: return launch_static<T, 24>(x, B, C, H, W, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, stream);
    case 30: return launch_static<T, 30>(x, B, C, H, W, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, stream);
    case 60: return launch_static<T, 60>(x, B, C, H, W, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT; weights fp32 tap-major (C_in, 3, 3, C_out)
// copies), 1 = bfloat16 (tensor cores; weights the packed bf16 blocks of
// `pack_tc_weights`). x and out in that type, biases fp32. Out: the
// interior rows, (B, O10, H - 8, W).
int halo_tail(int dtype, const void* x, int B, int C, int H, int W, int bh, const void* k8,
              const float* b8, int O8, const void* k9, const float* b9, int O9,
              const void* k10, const float* b10, int O10, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_halo<float>(x, B, C, H, W, bh, static_cast<const float*>(k8), b8, O8,
                              static_cast<const float*>(k9), b9, O9,
                              static_cast<const float*>(k10), b10, O10, out, s);
  }
  if (dtype == 1) {
    return launch_halo_tc(x, B, C, H, W, bh, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// As halo_tail, for bh in {8, 16, 24, 30, 60} (the instantiated block heights).
int halo_tail_static(int dtype, const void* x, int B, int C, int H, int W, int bh,
                     const void* k8, const float* b8, int O8, const void* k9, const float* b9,
                     int O9, const void* k10, const float* b10, int O10, void* out,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_halo_static<float>(x, B, C, H, W, bh, static_cast<const float*>(k8), b8, O8,
                                     static_cast<const float*>(k9), b9, O9,
                                     static_cast<const float*>(k10), b10, O10, out, s);
  }
  if (dtype == 1) {
    return launch_halo_static_tc(x, B, C, H, W, bh, k8, b8, O8, k9, b9, O9, k10, b10, O10, out,
                                 s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
