// Fused reflect-padded 3x3 conv stacks for Hopper (sm_90a), CUDA C++.
//
// Replaces two Pallas TPU kernels of the JAX package's kernels/conv_stack.py:
//   * conv_head <- `_head_kernel` (launched by `_fused_encoder_head_impl`):
//                  conv1_1 -> relu -> conv1_2 -> relu -> 2x2/2 max pool;
//   * conv_tail <- `_tail_kernel` (launched by `_fused_conv_tail_impl`):
//                  conv8 -> relu -> conv9 -> relu -> conv10 (no relu).
// Both are the int8 serving path's full-resolution ends (models/quant.py with
// the fused stacks on), where the JAX package runs them in bf16.
//
// What is computed, per layer, as `_conv3x3` does: ReflectionPad2d(1) of the
// layer's input (layer 2 reflects layer 1's output, not the stack's input),
// a 3x3 convolution whose products are exact (bf16 x bf16 or fp32 x fp32)
// and summed in fp32, the fp32 bias added before the cast, the relu, and the
// result rounded to the input type. With one input channel the head sums
// the taps in the TPU kernel's order (broadcast branch, conv_stack.py:69-75).
//
// Layouts (the port is NCHW): x (B, C, H, W) fp32 or bf16; biases fp32.
// Weights in bf16: the tail's three layers and the head's conv1_2 take the
// packed blocks (9, N, C16) bf16 of kernels/conv_stack.py `pack_tc_weights`
// (tap-major, N the output channels padded to 64, 64, 8 and 64, C16 the
// input channels padded to 16); the head's conv1_1, and every layer in
// fp32, takes an fp32 (C_in, 3, 3, C_out) "tap-major" copy of the OIHW
// kernel (the values are exactly the input type's). Out: head
// (B, O2, H/2, W/2), tail (B, O10, H, W), in the input type.
//
// What bounds it on this card. Per 128^2 image the head does 1,227 MFLOP
// against 32 KB in and 512 KB out, the tail 2,454 MFLOP against 2 MB in and
// 64 KB out: hundreds to thousands of FLOP per byte, so the products bound
// both, at the tensor cores' bf16 rate (989 TFLOP/s) for bf16 operands and
// the CUDA cores' fp32 rate (67 TFLOP/s) for fp32.
// What the design does about it: nothing between the layers goes to device
// memory, as on the TPU, but instead of one whole image per grid step a
// block owns one output tile of one image and many tiles run in parallel.
// The block loads its input tile with the halo its layers need (tail: 3
// pixels, head: 2) into shared memory and computes each intermediate layer
// over the halo it still needs, reflect pad included (conv_tile.cuh).
//   * The tail in bf16 runs on the tensor cores (`tc_tail_tile`, the
//     design in conv_tile.cuh): conv8 and conv9 as D = W . X with both
//     operands in shared memory, one wgmma m64n112k16 per tap and 16 input
//     channels over runs of 112 pixels of the channels-last input, conv10
//     (O = 2) as m64n8k16 with the pixels in registers. 4 warpgroups,
//     213 KB of shared memory at C = 64, one block an SM walking
//     the tiles; each tile's conv10 overlaps the staging of the next
//     tile's conv8 weights.
//   * The head in bf16 (`tc_head_tile`): conv1_2 carries 98.5 % of the
//     work and is the tail's conv9 (64 -> 64 at 128^2), so it runs the same
//     `tc_conv_ss` products, on a 16 x 32 pre-pool tile: 16 rows of 34
//     buffer columns are 4 runs of 136 pixels (wgmma m64n136k16), one a
//     warpgroup, 1.06 times the output's work. conv1_1 (one or three input
//     channels: 9 or 27 MACs an output) runs on the CUDA cores into the
//     channels-last buffer, in the JAX kernel's tap order, each pad
//     position on its own reflected window. conv1_2's weights are staged
//     once per block; after the products the block meets at a barrier and
//     the epilogue writes the rounded output over conv1_1's, which the
//     pool reads in 2x2 quads and stores 16 bytes at a time. One block an
//     SM walks the tiles; with one input channel the next tile's input is
//     loaded into registers during the pool. (24 x 16 in runs of 112 and
//     16 x 16 in runs of 72 were measured slower: PERF.md.)
//   * The tail and the head in fp32 run the SIMT body: each thread owns 4
//     pixels x 16 output channels (64 fp32 accumulators). fp32 stays there
//     because the tensor cores have no exact fp32 product.
// The input type picks the body, bf16 -> tensor cores and fp32 -> SIMT,
// with one exception: the tensor-core bodies stage a layer's whole weights
// in shared memory, which past one 64-channel block a layer (9 x 128 x 128
// bf16 = 295 KB at 65..128 channels) outgrows the card's 227 KB. Such bf16
// stacks, wider than every release, run the SIMT body in bf16;
// `conv_head_tc` and `conv_tail_tc` tell the host which body takes a shape.
//
// Each entry point launches one kernel on the caller's stream, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include "conv_tile.cuh"

namespace {

template <typename T>
size_t head_smem(int tile, int C, int O1, int O2) {
  const int om = O1 > O2 ? O1 : O2;
  const size_t na = 2 * tile + 2, nx = 2 * tile + 4;
  return (size_t)CK * 9 * om * 4 + ((O1 * na * na * sizeof(T) + 15) / 16) * 16 +
         C * nx * nx * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const T* __restrict__ x, int C, int H, int W, int tile, int tiles_x, int tiles_y,
            const float* k8, const float* b8, int O8, const float* k9, const float* b9, int O9,
            const float* k10, const float* b10, int O10, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = tiles_x * tiles_y;
  const int b = blockIdx.x / n_tiles;
  const int ty0 = (blockIdx.x % n_tiles) / tiles_x * tile;
  const int tx0 = (blockIdx.x % n_tiles) % tiles_x * tile;
  tail_tile<T, false>(x + (size_t)b * C * H * W, C, H, W, ty0, tx0, tile, tile, k8, b8, O8, k9,
                      b9, O9, k10, b10, O10, out + (size_t)b * O10 * H * W, 0, H, smem);
}

// One block an SM walks the tiles (image-major, row-major within an image).
__global__ void __launch_bounds__(TC_THREADS, 1)
tail_tc_kernel(const __nv_bfloat16* __restrict__ x, int C, int H, int W, int tile, int tiles_x,
               int tiles_y, int n_tiles, const __nv_bfloat16* w8, const float* b8, int O8,
               const __nv_bfloat16* w9, const float* b9, int O9, const __nv_bfloat16* w10,
               const float* b10, int O10, __nv_bfloat16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tc_smem(smem_raw);
  const int per_image = tiles_x * tiles_y;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / per_image;
    const int ty0 = (t % per_image) / tiles_x * tile;
    const int tx0 = (t % per_image) % tiles_x * tile;
    tc_tail_tile<false>(x + (size_t)b * C * H * W, C, H, W, ty0, tx0, tile, tile, w8, b8, O8, w9,
                        b9, O9, w10, b10, O10, out + (size_t)b * O10 * H * W, 0, H, smem,
                        t == (int)blockIdx.x, t + (int)gridDim.x >= n_tiles);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_kernel(const T* __restrict__ x, int C, int H, int W, int tile, int tiles_x, int tiles_y,
            const float* k1, const float* b1, int O1, const float* k2, const float* b2, int O2,
            T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = tiles_x * tiles_y;
  const int b = blockIdx.x / n_tiles;
  const int py0 = (blockIdx.x % n_tiles) / tiles_x * tile;  // pooled coordinates
  const int px0 = (blockIdx.x % n_tiles) % tiles_x * tile;
  // The last tile may overhang the image: clip its conv region (H, W even).
  const int nr = 2 * min(tile, H / 2 - py0), nc = 2 * min(tile, W / 2 - px0);
  const int om = max(O1, O2);
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* pa = smem + (size_t)CK * 9 * om * 4;
  const size_t na = 2 * tile + 2;
  T* px = reinterpret_cast<T*>(pa + ((O1 * na * na * sizeof(T) + 15) / 16) * 16);

  const int y0 = 2 * py0, x0 = 2 * px0;
  const Tile<T> tx{px, y0 - 2, x0 - 2, 2 * tile + 4, 2 * tile + 4};
  const Tile<T> ta{reinterpret_cast<T*>(pa), y0 - 1, x0 - 1, 2 * tile + 2, 2 * tile + 2};
  const Tile<T> to{nullptr, y0, x0, nr, nc};

  load_tile(x + (size_t)b * C * H * W, C, H, W, tx);
  __syncthreads();
  conv<T, TO_SMEM>(tx, C, k1, b1, O1, true, ws, ta, nullptr, H, W);
  __syncthreads();
  conv<T, TO_POOL>(ta, O1, k2, b2, O2, true, ws, to, out + (size_t)b * O2 * (H / 2) * (W / 2),
                   H, W);
}

// One block an SM walks the head's tiles (image-major, row-major within an
// image).
template <int ROWS, int COLS, int PIX>
__global__ void __launch_bounds__(TC_THREADS, 1)
head_tc_kernel(const __nv_bfloat16* __restrict__ x, int C, int H, int W, int tiles_x, int tiles_y,
               int n_tiles, const float* w1, const float* b1, int O1, const __nv_bfloat16* w2,
               const float* b2, int O2, __nv_bfloat16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tc_smem(smem_raw);
  const int per_image = tiles_x * tiles_y;
  auto image = [&](int t) { return x + (size_t)(t / per_image) * C * H * W; };
  auto row = [&](int t) { return (t % per_image) / tiles_x * ROWS; };
  auto col = [&](int t) { return (t % per_image) % tiles_x * COLS; };
  auto fetch = [&](int t, uint32_t(&v)[HEAD_FETCH]) {
    if (t < n_tiles) head_fetch<ROWS + 4, COLS + 4>(image(t), H, W, row(t), col(t), v);
  };
  uint32_t pre[HEAD_FETCH] = {};
  if (C == 1) fetch(blockIdx.x, pre);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    tc_head_tile<ROWS, COLS, PIX>(
        image(t), C, H, W, row(t), col(t), w1, b1, O1, w2, b2, O2,
        out + (size_t)(t / per_image) * O2 * (H / 2) * (W / 2), smem, t == (int)blockIdx.x, pre,
        [&](uint32_t(&v)[HEAD_FETCH]) { fetch(t + (int)gridDim.x, v); });
  }
}

template <typename T>
int launch_tail(const void* x, int B, int C, int H, int W, const float* k8, const float* b8,
                int O8, const float* k9, const float* b9, int O9, const float* k10,
                const float* b10, int O10, void* out, cudaStream_t stream) {
  if (B < 1 || C < 1 || O8 < 1 || O9 < 1 || O10 < 1 || H < 2 || W < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int limit = max_smem();
  int tile = 0;
  size_t bytes = 0;
  const int tiles[] = {16, 8, 4};
  for (int t : tiles) {
    bytes = tail_smem<T>(t, t, C, O8, O9, O10);
    if (bytes <= (size_t)limit) { tile = t; break; }
  }
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + tile - 1) / tile, tiles_y = (H + tile - 1) / tile;
  const long long blocks = (long long)tiles_x * tiles_y * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  tail_kernel<T><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), C, H, W, tile, tiles_x, tiles_y, k8, b8, O8, k9, b9, O9, k10,
      b10, O10, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// The tensor-core tail's square tile: the largest of 16, 8, 4 whose shared
// memory fits, 0 where none does (its weights alone outgrow the card's
// shared memory past 64 channels a layer).
int tc_tail_tile_size(int C, int O8, int O9, int O10) {
  const int tiles[] = {16, 8, 4};
  for (int t : tiles) {
    if (tc_tail_plan(t, t, C, O8, O9, O10).bytes <= (size_t)max_smem()) return t;
  }
  return 0;
}

int launch_tail_tc(const void* x, int B, int C, int H, int W, const void* w8, const float* b8,
                   int O8, const void* w9, const float* b9, int O9, const void* w10,
                   const float* b10, int O10, void* out, cudaStream_t stream) {
  if (B < 1 || C < 1 || O8 < 1 || O9 < 1 || O10 < 1 || H < 2 || W < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int tile = tc_tail_tile_size(C, O8, O9, O10);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = tc_tail_plan(tile, tile, C, O8, O9, O10).bytes;
  const int tiles_x = (W + tile - 1) / tile, tiles_y = (H + tile - 1) / tile;
  const long long blocks = (long long)tiles_x * tiles_y * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tail_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const int grid = (int)(blocks < sm_count() ? blocks : sm_count());
  tail_tc_kernel<<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf*>(x), C, H, W, tile, tiles_x, tiles_y, (int)blocks,
      static_cast<const bf*>(w8), b8, O8, static_cast<const bf*>(w9), b9, O9,
      static_cast<const bf*>(w10), b10, O10, static_cast<bf*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_head(const void* x, int B, int C, int H, int W, const float* k1, const float* b1,
                int O1, const float* k2, const float* b2, int O2, void* out,
                cudaStream_t stream) {
  if (B < 1 || C < 1 || O1 < 1 || O2 < 1 || H < 2 || W < 2 || H % 2 || W % 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int limit = max_smem();
  int tile = 0;
  size_t bytes = 0;
  const int tiles[] = {8, 4, 2};
  for (int t : tiles) {
    bytes = head_smem<T>(t, C, O1, O2);
    if (bytes <= (size_t)limit) { tile = t; break; }
  }
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W / 2 + tile - 1) / tile, tiles_y = (H / 2 + tile - 1) / tile;
  const long long blocks = (long long)tiles_x * tiles_y * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  head_kernel<T><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), C, H, W, tile, tiles_x, tiles_y, k1, b1, O1, k2, b2, O2,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// The bf16 head on the tensor cores, on its 16 x 32 pre-pool tile.
constexpr int HEAD_ROWS = 16, HEAD_COLS = 32, HEAD_PIX = 136;

// Whether the tensor-core head takes these channels: one 64-channel block a
// layer (every release's width) and its shared memory within the card's.
bool head_tc_takes(int C, int O1, int O2) {
  return O1 <= TC_M && O2 <= TC_M &&
         tc_head_plan(HEAD_ROWS, HEAD_COLS, HEAD_PIX, C, O1).bytes <= (size_t)max_smem();
}

int launch_head_tc(const void* x, int B, int C, int H, int W, const float* w1, const float* b1,
                   int O1, const void* w2, const float* b2, int O2, void* out,
                   cudaStream_t stream) {
  if (B < 1 || C < 1 || O1 < 1 || O2 < 1 || H < 4 || W < 4 || H % 2 || W % 2 ||
      !head_tc_takes(C, O1, O2)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = tc_head_plan(HEAD_ROWS, HEAD_COLS, HEAD_PIX, C, O1).bytes;
  const int tiles_x = (W + HEAD_COLS - 1) / HEAD_COLS, tiles_y = (H + HEAD_ROWS - 1) / HEAD_ROWS;
  const long long blocks = (long long)tiles_x * tiles_y * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = head_tc_kernel<HEAD_ROWS, HEAD_COLS, HEAD_PIX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const int grid = (int)(blocks < sm_count() ? blocks : sm_count());
  kernel<<<grid, TC_THREADS, bytes, stream>>>(static_cast<const bf*>(x), C, H, W, tiles_x, tiles_y,
                                              (int)blocks, w1, b1, O1, static_cast<const bf*>(w2),
                                              b2, O2, static_cast<bf*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// body: 0 = float32 on the SIMT body, 2 = bfloat16 on the SIMT body (weights
// fp32 tap-major (C_in, 3, 3, C_out) copies), 1 = bfloat16 on the tensor
// cores (weights the packed bf16 blocks of `pack_tc_weights`; the shapes
// `conv_tail_tc` takes). x and out in that type, biases fp32.
int conv_tail(int body, const void* x, int B, int C, int H, int W, const void* k8,
              const float* b8, int O8, const void* k9, const float* b9, int O9,
              const void* k10, const float* b10, int O10, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f8 = static_cast<const float*>(k8), *f9 = static_cast<const float*>(k9),
              *f10 = static_cast<const float*>(k10);
  if (body == 0) {
    return launch_tail<float>(x, B, C, H, W, f8, b8, O8, f9, b9, O9, f10, b10, O10, out, s);
  }
  if (body == 1) {
    return launch_tail_tc(x, B, C, H, W, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, s);
  }
  if (body == 2) {
    return launch_tail<__nv_bfloat16>(x, B, C, H, W, f8, b8, O8, f9, b9, O9, f10, b10, O10, out,
                                      s);
  }
  return (int)cudaErrorInvalidValue;
}

// 1 where the bf16 tail runs on the tensor cores (its weights and a tile fit
// the current card's shared memory: up to 64 channels a layer), else 0.
int conv_tail_tc(int C, int O8, int O9, int O10) {
  return tc_tail_tile_size(C, O8, O9, O10) > 0;
}

// body: 0 = float32 on the SIMT body, 2 = bfloat16 on the SIMT body (both
// kernels fp32 tap-major copies), 1 = bfloat16 with conv1_2 on the tensor
// cores (k1 the fp32 tap-major copy, k2 the packed bf16 blocks of
// `pack_tc_weights`; the shapes `conv_head_tc` takes). x and out in that
// type, biases fp32.
int conv_head(int body, const void* x, int B, int C, int H, int W, const void* k1,
              const float* b1, int O1, const void* k2, const float* b2, int O2, void* out,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *f1 = static_cast<const float*>(k1), *f2 = static_cast<const float*>(k2);
  if (body == 0) return launch_head<float>(x, B, C, H, W, f1, b1, O1, f2, b2, O2, out, s);
  if (body == 1) return launch_head_tc(x, B, C, H, W, f1, b1, O1, k2, b2, O2, out, s);
  if (body == 2) {
    return launch_head<__nv_bfloat16>(x, B, C, H, W, f1, b1, O1, f2, b2, O2, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// 1 where the bf16 head runs on the tensor cores, else 0.
int conv_head_tc(int C, int O1, int O2) { return head_tc_takes(C, O1, O2); }

}  // extern "C"
