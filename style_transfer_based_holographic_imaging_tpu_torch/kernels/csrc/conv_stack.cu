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
// a 3x3 convolution whose products are taken in fp32 (exact for bf16
// operands) and summed in fp32, the fp32 bias added before the cast, the
// relu, and the result rounded to the input type. With one input channel
// the taps are summed in the TPU kernel's order (broadcast branch,
// conv_stack.py:69-75), so the sum is the same fp32 sequence.
//
// Layouts (the port is NCHW): x (B, C, H, W) fp32 or bf16; the weights of
// each layer as fp32 (C_in, 3, 3, C_out) "tap-major" copies of the OIHW
// kernels in the input type (the wrapper builds them; the values are exactly
// the input type's); biases fp32. Out: head (B, O2, H/2, W/2), tail
// (B, O10, H, W), in the input type.
//
// What bounds it on this card. Per 128^2 image the head does 1,227 MFLOP
// against 1 x 32 KB in and 512 KB out, the tail 2,454 MFLOP against 2 MB
// in and 64 KB out: hundreds to thousands of FLOP per byte, so the
// arithmetic bounds both, at the tensor cores' bf16 rate (989 TFLOP/s) for
// bf16 operands. This design runs the products on the CUDA cores in fp32
// (67 TFLOP/s), so it is well above that bound.
// What the design does about it: nothing between the layers goes to device
// memory, as on the TPU, but instead of one whole image per grid step a
// block owns one output tile of one image (tail: 16x16 in bf16, 8x8 in fp32;
// head: 8x8 pooled pixels) and many tiles run in parallel. The block loads
// its input tile with a 3-pixel halo (head: 2) into shared memory and
// computes each intermediate layer over the halo it still needs, so tiles
// recompute a ring of their neighbours' pixels (1.4x the tail's work at
// 16x16). Positions outside the image are the reflect pad: a virtual
// position -1 or H holds the layer's value at real position 1 or H-2,
// computed for it, so every window read is a plain 3x3 window of the
// buffer. Each thread owns 4 pixels and 16 output channels (64 fp32
// accumulators): per input channel and tap it reads 4 activations and 16
// weights (four warp-uniform 128-bit shared-memory broadcasts) for 64 FMAs.
// The weights are staged 16 input channels at a time. Tensor cores (wgmma
// on bf16 tiles), TMA loads and persistent blocks are later work. The layer
// body and the tail's tile live in conv_tile.cuh, which halo_conv.cu shares.
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). Weights are fp32 tap-major
// (C_in, 3, 3, C_out) copies, biases fp32.
int conv_tail(int dtype, const void* x, int B, int C, int H, int W, const float* k8,
              const float* b8, int O8, const float* k9, const float* b9, int O9,
              const float* k10, const float* b10, int O10, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_tail<float>(x, B, C, H, W, k8, b8, O8, k9, b9, O9, k10, b10, O10, out, s);
  }
  if (dtype == 1) {
    return launch_tail<__nv_bfloat16>(x, B, C, H, W, k8, b8, O8, k9, b9, O9, k10, b10, O10,
                                      out, s);
  }
  return (int)cudaErrorInvalidValue;
}

int conv_head(int dtype, const void* x, int B, int C, int H, int W, const float* k1,
              const float* b1, int O1, const float* k2, const float* b2, int O2, void* out,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_head<float>(x, B, C, H, W, k1, b1, O1, k2, b2, O2, out, s);
  if (dtype == 1) {
    return launch_head<__nv_bfloat16>(x, B, C, H, W, k1, b1, O1, k2, b2, O2, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
