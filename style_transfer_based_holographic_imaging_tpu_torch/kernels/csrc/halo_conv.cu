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
// in W at every layer (layer 9's pad reflects layer 8's output). Products in
// fp32, summed in fp32, the fp32 bias added before the one rounding to the
// input type, relu after layers 8 and 9: `_tail_block`'s arithmetic, which is
// `_conv3x3`'s, so the interior equals the fused tail's (conv_stack.cu) on
// the same rows. The layer body is conv_stack.cu's, shared through
// conv_tile.cuh in its VALID_H mode, where only the columns reflect.
//
// Layouts: x (B, C, H, W) fp32 or bf16; weights as fp32 (C_in, 3, 3, C_out)
// tap-major copies of the OIHW kernels in the input type; biases fp32. Out:
// the interior (B, O10, H-8, W) in the input type.
//
// What bounds it on this card. Per 128^2 image the interior is 120 x 128
// pixels of 2 x 9 x (64*64 + 64*64 + 64*2) FLOP, 2,300 MFLOP against 2 MB in
// and 60 KB out, so the arithmetic bounds it, at the tensor cores' bf16 rate
// for bf16 operands. Like the fused tail, this design runs the products on
// the CUDA cores in fp32 and stays well above that bound.
// What the design does about it. The TPU kernel's slab, (bh+6) x W x C, is
// 590 KB in bf16 at bh = 30, more than the 227 KB of shared memory a block
// may use. So a block owns `rows` output rows (the largest divisor of bh up
// to 16: 15 at bh = 30 or 60) by a column tile of `cols` (16 in bf16, 8 in
// fp32 at C = 64; the widest of 16, 8, 4 that fits), with a 3-pixel halo,
// and computes each intermediate layer over the halo the next one still
// needs (1.4 times the interior's work at 15 x 16).
//   * halo_tail: one block per image x row block x sub-block x column tile;
//     each block computes its slab's first row from blockIdx at run time
//     and loads it with plain global loads. TMA and wgmma are later work.
//   * halo_tail_static<BH>: one block per image x column tile, looping over
//     the image's row blocks and over each block's BH/rows sub-blocks, with
//     BH and rows compile-time constants (BH in {8, 16, 24, 30, 60}), so
//     each slab offset is EDGE + i*BH + s*rows with constant strides; the
//     number of row blocks, (H - 8) / BH, is a run-time bound. The loops
//     are not unrolled: each unrolled sub-block repeats the whole inlined
//     tile body, and unrolling made this source's build take 105 s. With
//     bh and rows run-time arguments instead, the kernel took 3 % longer in
//     bf16 and 9 % in fp32, for 40 % of this source's nvcc time
//     (PERF.md).
//     The TPU kernel holds the whole image in VMEM (2 MB); here the image is
//     not resident in shared memory: the block walks its column strip down
//     the image, and the halo rows that consecutive sub-blocks share are
//     read again from device memory, through the 50 MB L2.
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

// dtype: 0 = float32, 1 = bfloat16 (x and out). Weights are fp32 tap-major
// (C_in, 3, 3, C_out) copies, biases fp32. Out: the interior rows, (B, O10,
// H - 8, W).
int halo_tail(int dtype, const void* x, int B, int C, int H, int W, int bh, const float* k8,
              const float* b8, int O8, const float* k9, const float* b9, int O9,
              const float* k10, const float* b10, int O10, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_halo<float>(x, B, C, H, W, bh, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, s);
  }
  if (dtype == 1) {
    return launch_halo<__nv_bfloat16>(x, B, C, H, W, bh, k8, b8, O8, k9, b9, O9, k10, b10, O10,
                                      out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// As halo_tail, for bh in {8, 16, 24, 30, 60} (the instantiated block heights).
int halo_tail_static(int dtype, const void* x, int B, int C, int H, int W, int bh,
                     const float* k8, const float* b8, int O8, const float* k9, const float* b9,
                     int O9, const float* k10, const float* b10, int O10, void* out,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_halo_static<float>(x, B, C, H, W, bh, k8, b8, O8, k9, b9, O9, k10, b10, O10,
                                     out, s);
  }
  if (dtype == 1) {
    return launch_halo_static<__nv_bfloat16>(x, B, C, H, W, bh, k8, b8, O8, k9, b9, O9, k10, b10,
                                             O10, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
