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
// on bf16 tiles), TMA loads and persistent blocks are later work.
//
// Each entry point launches one kernel on the caller's stream, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int PX = 4;   // output pixels per work item
constexpr int CK = 16;  // input channels whose weights are staged at once
constexpr int MAX_SMEM_DEFAULT = 232448;

enum Mode { TO_SMEM = 0, TO_GLOBAL = 1, TO_POOL = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Real index of a virtual index in [-1, n] under ReflectionPad2d(1).
__device__ __forceinline__ int reflect1(int v, int n) {
  return v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
}

// A buffer in shared memory: channel planes of nr x nc values covering the
// virtual rows y0 .. y0+nr-1 and columns x0 .. x0+nc-1 of one image.
template <typename T>
struct Tile {
  T* p;
  int y0, x0, nr, nc;
};

// One conv layer of the block's tile: `in` (C channels) -> `out` (O channels).
// TO_SMEM: the output region is `out`'s; virtual positions -1 .. H (W) are
// computed (the reflect pad of the next layer), the rest are never read.
// TO_GLOBAL: positions of `out`'s region inside the image go to `g` (the
// image's (O, H, W) output). TO_POOL: `out`'s region is read in 2x2 quads
// whose max goes to `g` (the image's (O, H/2, W/2) output).
template <typename T, int OT, int MODE>
__device__ void conv_layer(const Tile<T>& in, int C, const float* __restrict__ wt,
                           const float* __restrict__ bias, int O, bool relu, float* ws,
                           const Tile<T>& out, T* __restrict__ g, int H, int W) {
  const int npix = out.nr * out.nc;
  const int groups = MODE == TO_POOL ? (out.nr / 2) * (out.nc / 2) : (npix + PX - 1) / PX;
  const int n_items = groups * (O / OT);
  const int rounds = (n_items + THREADS - 1) / THREADS;
  const int vlo = MODE == TO_SMEM ? -1 : 0;
  const int vhi_r = MODE == TO_SMEM ? H : H - 1;
  const int vhi_c = MODE == TO_SMEM ? W : W - 1;
  const int in_plane = in.nr * in.nc;

  for (int round = 0; round < rounds; ++round) {
    const int item = round * THREADS + threadIdx.x;
    const bool active = item < n_items;
    const int grp = active ? item % groups : 0;
    const int o0 = active ? (item / groups) * OT : 0;

    int base[PX], rr[PX], cc_[PX];
    bool valid[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      int r, c;
      bool inside;
      if (MODE == TO_POOL) {
        const int qn = out.nc / 2;
        r = 2 * (grp / qn) + i / 2;
        c = 2 * (grp % qn) + i % 2;
        inside = true;
      } else {
        const int p = grp + i * groups;
        r = p / out.nc;
        c = p % out.nc;
        inside = p < npix;
      }
      const int vr = out.y0 + r, vc = out.x0 + c;
      valid[i] = active && inside && vr >= vlo && vr <= vhi_r && vc >= vlo && vc <= vhi_c;
      rr[i] = r;
      cc_[i] = c;
      base[i] = valid[i]
          ? (reflect1(vr, H) - 1 - in.y0) * in.nc + (reflect1(vc, W) - 1 - in.x0)
          : 0;
    }

    float acc[PX][OT];
#pragma unroll
    for (int i = 0; i < PX; ++i)
#pragma unroll
      for (int t = 0; t < OT; ++t) acc[i][t] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CK) {
      const int cn = min(CK, C - c0);
      __syncthreads();
      const float* src = wt + (size_t)c0 * 9 * O;
      for (int j = threadIdx.x; j < cn * 9 * O; j += THREADS) ws[j] = src[j];
      __syncthreads();
      if (!active) continue;
      for (int k = 0; k < cn; ++k) {
        const T* ic = in.p + (size_t)(c0 + k) * in_plane;
        const float* wc = ws + k * 9 * O + o0;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            float xv[PX];
#pragma unroll
            for (int i = 0; i < PX; ++i) xv[i] = to_f(ic[base[i] + kh * in.nc + kw]);
            const float* wp = wc + (kh * 3 + kw) * O;
            if constexpr (OT % 4 == 0) {
#pragma unroll
              for (int q = 0; q < OT / 4; ++q) {
                const float4 w4 = reinterpret_cast<const float4*>(wp)[q];
#pragma unroll
                for (int i = 0; i < PX; ++i) {
                  acc[i][4 * q + 0] = fmaf(xv[i], w4.x, acc[i][4 * q + 0]);
                  acc[i][4 * q + 1] = fmaf(xv[i], w4.y, acc[i][4 * q + 1]);
                  acc[i][4 * q + 2] = fmaf(xv[i], w4.z, acc[i][4 * q + 2]);
                  acc[i][4 * q + 3] = fmaf(xv[i], w4.w, acc[i][4 * q + 3]);
                }
              }
            } else {
#pragma unroll
              for (int t = 0; t < OT; ++t) {
                const float wv = wp[t];
#pragma unroll
                for (int i = 0; i < PX; ++i) acc[i][t] = fmaf(xv[i], wv, acc[i][t]);
              }
            }
          }
        }
      }
    }

    if (!active) continue;
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      const int o = o0 + t;
      const float bo = bias[o];
      if (MODE == TO_POOL) {
        if (!valid[0]) continue;
        float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          float y = acc[i][t] + bo;
          if (relu) y = fmaxf(y, 0.f);
          m = fmaxf(m, to_f(from_f<T>(y)));
        }
        const int pr = (out.y0 + rr[0]) / 2, pc = (out.x0 + cc_[0]) / 2;
        g[((size_t)o * (H / 2) + pr) * (W / 2) + pc] = from_f<T>(m);
        continue;
      }
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        if (!valid[i]) continue;
        float y = acc[i][t] + bo;
        if (relu) y = fmaxf(y, 0.f);
        if (MODE == TO_SMEM) {
          out.p[((size_t)o * out.nr + rr[i]) * out.nc + cc_[i]] = from_f<T>(y);
        } else {
          g[((size_t)o * H + out.y0 + rr[i]) * W + out.x0 + cc_[i]] = from_f<T>(y);
        }
      }
    }
  }
}

// The layer with the widest output-channel tile that divides O.
template <typename T, int MODE>
__device__ void conv(const Tile<T>& in, int C, const float* wt, const float* bias, int O,
                     bool relu, float* ws, const Tile<T>& out, T* g, int H, int W) {
  if (O % 16 == 0) {
    conv_layer<T, 16, MODE>(in, C, wt, bias, O, relu, ws, out, g, H, W);
  } else if (O % 8 == 0) {
    conv_layer<T, 8, MODE>(in, C, wt, bias, O, relu, ws, out, g, H, W);
  } else if (O % 2 == 0) {
    conv_layer<T, 2, MODE>(in, C, wt, bias, O, relu, ws, out, g, H, W);
  } else {
    conv_layer<T, 1, MODE>(in, C, wt, bias, O, relu, ws, out, g, H, W);
  }
}

// Load the image's input tile: virtual positions -1 .. H (W) take the
// reflected real value; the rest of the buffer is never read.
template <typename T>
__device__ void load_tile(const T* __restrict__ xb, int C, int H, int W, const Tile<T>& t) {
  const int plane = t.nr * t.nc;
  for (int i = threadIdx.x; i < C * plane; i += THREADS) {
    const int c = i / plane;
    const int r = (i % plane) / t.nc;
    const int s = i % t.nc;
    const int vr = t.y0 + r, vc = t.x0 + s;
    if (vr >= -1 && vr <= H && vc >= -1 && vc <= W) {
      t.p[i] = xb[((size_t)c * H + reflect1(vr, H)) * W + reflect1(vc, W)];
    }
  }
}

// Shared memory: [weights: CK x 9 x O_max fp32][A][X, later B], in bytes.
template <typename T>
size_t tail_smem(int tile, int C, int O8, int O9, int O10) {
  const int om = O8 > O9 ? (O8 > O10 ? O8 : O10) : (O9 > O10 ? O9 : O10);
  const size_t nx = tile + 6, na = tile + 4, nb = tile + 2;
  const size_t x_bytes = C * nx * nx * sizeof(T), b_bytes = O9 * nb * nb * sizeof(T);
  return (size_t)CK * 9 * om * 4 + ((O8 * na * na * sizeof(T) + 15) / 16) * 16 +
         (x_bytes > b_bytes ? x_bytes : b_bytes);
}

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
  const int om = max(O8, max(O9, O10));
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* pa = smem + (size_t)CK * 9 * om * 4;
  const size_t na = tile + 4;
  T* px = reinterpret_cast<T*>(pa + ((O8 * na * na * sizeof(T) + 15) / 16) * 16);

  const Tile<T> tx{px, ty0 - 3, tx0 - 3, tile + 6, tile + 6};
  const Tile<T> ta{reinterpret_cast<T*>(pa), ty0 - 2, tx0 - 2, tile + 4, tile + 4};
  const Tile<T> tb{px, ty0 - 1, tx0 - 1, tile + 2, tile + 2};
  const Tile<T> to{nullptr, ty0, tx0, tile, tile};

  load_tile(x + (size_t)b * C * H * W, C, H, W, tx);
  __syncthreads();
  conv<T, TO_SMEM>(tx, C, k8, b8, O8, true, ws, ta, nullptr, H, W);
  __syncthreads();
  conv<T, TO_SMEM>(ta, O8, k9, b9, O9, true, ws, tb, nullptr, H, W);
  __syncthreads();
  conv<T, TO_GLOBAL>(tb, O9, k10, b10, O10, false, ws, to, out + (size_t)b * O10 * H * W, H, W);
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

int max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return MAX_SMEM_DEFAULT;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return MAX_SMEM_DEFAULT;
  }
  return v;
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
    bytes = tail_smem<T>(t, C, O8, O9, O10);
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
