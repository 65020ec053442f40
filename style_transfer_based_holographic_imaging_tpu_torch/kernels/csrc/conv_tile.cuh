// The tiled 3x3 conv layer body shared by conv_stack.cu and halo_conv.cu.
//
// A block computes one output tile of one image through a chain of 3x3 conv
// layers held in shared memory. Each layer's products are taken in fp32
// (exact for bf16 operands) and summed in fp32, the fp32 bias is added
// before the one rounding to the input type, then the relu: the arithmetic
// of `_conv3x3` in the JAX package's kernels/conv_stack.py.
//
// Thread mapping: each thread owns 4 output pixels and OT (up to 16) output
// channels, i.e. 64 fp32 accumulators; per input channel and tap it reads 4
// activations and OT weights (warp-uniform 128-bit shared-memory
// broadcasts). The weights are staged CK = 16 input channels at a time.
//
// Reflect padding: a buffer covers virtual positions of the image, and a
// virtual position -1 or n holds the layer's value at real position 1 or
// n-2 (ReflectionPad2d(1) of that layer's input), computed for it, so every
// window read is a plain 3x3 window of the buffer. In the VALID_H mode the
// rows of every buffer are real rows of the image (the caller keeps the
// output tile at least 3 rows from the top and bottom edges), so only the
// columns reflect: the row-block tail of halo_conv.cu.
//
// Each source that includes this header is compiled into a library of its
// own (one translation unit), hence the unnamed namespace.

#pragma once

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
// TO_GLOBAL: positions of `out`'s region inside the image go to `g`, the
// image's (O, g_h, W) output whose first row is image row g_y0. TO_POOL:
// `out`'s region is read in 2x2 quads whose max goes to `g` (the image's
// (O, H/2, W/2) output). VALID_H: rows are real, only columns reflect.
template <typename T, int OT, int MODE, bool VALID_H>
__device__ void conv_layer(const Tile<T>& in, int C, const float* __restrict__ wt,
                           const float* __restrict__ bias, int O, bool relu, float* ws,
                           const Tile<T>& out, T* __restrict__ g, int H, int W, int g_y0,
                           int g_h) {
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
      const bool row_ok = VALID_H || (vr >= vlo && vr <= vhi_r);
      valid[i] = active && inside && row_ok && vc >= vlo && vc <= vhi_c;
      rr[i] = r;
      cc_[i] = c;
      const int wr = VALID_H ? vr : reflect1(vr, H);
      base[i] = valid[i] ? (wr - 1 - in.y0) * in.nc + (reflect1(vc, W) - 1 - in.x0) : 0;
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
          g[((size_t)o * g_h + out.y0 - g_y0 + rr[i]) * W + out.x0 + cc_[i]] = from_f<T>(y);
        }
      }
    }
  }
}

// The layer with the widest output-channel tile that divides O.
template <typename T, int MODE, bool VALID_H = false>
__device__ void conv(const Tile<T>& in, int C, const float* wt, const float* bias, int O,
                     bool relu, float* ws, const Tile<T>& out, T* g, int H, int W,
                     int g_y0 = 0, int g_h = 0) {
  if (O % 16 == 0) {
    conv_layer<T, 16, MODE, VALID_H>(in, C, wt, bias, O, relu, ws, out, g, H, W, g_y0, g_h);
  } else if (O % 8 == 0) {
    conv_layer<T, 8, MODE, VALID_H>(in, C, wt, bias, O, relu, ws, out, g, H, W, g_y0, g_h);
  } else if (O % 2 == 0) {
    conv_layer<T, 2, MODE, VALID_H>(in, C, wt, bias, O, relu, ws, out, g, H, W, g_y0, g_h);
  } else {
    conv_layer<T, 1, MODE, VALID_H>(in, C, wt, bias, O, relu, ws, out, g, H, W, g_y0, g_h);
  }
}

// Load the image's input tile: virtual positions -1 .. H (W) take the
// reflected real value; the rest of the buffer is never read. VALID_H: the
// tile's rows are real rows, loaded as they are.
template <typename T, bool VALID_H = false>
__device__ void load_tile(const T* __restrict__ xb, int C, int H, int W, const Tile<T>& t) {
  const int plane = t.nr * t.nc;
  for (int i = threadIdx.x; i < C * plane; i += THREADS) {
    const int c = i / plane;
    const int r = (i % plane) / t.nc;
    const int s = i % t.nc;
    const int vr = t.y0 + r, vc = t.x0 + s;
    const bool row_ok = VALID_H || (vr >= -1 && vr <= H);
    if (row_ok && vc >= -1 && vc <= W) {
      const int sr = VALID_H ? vr : reflect1(vr, H);
      t.p[i] = xb[((size_t)c * H + sr) * W + reflect1(vc, W)];
    }
  }
}

// Bytes of the tail's buffer A (layer 8's output), rounded up to 16.
template <typename T>
__host__ __device__ size_t a_bytes(int rows, int cols, int O8) {
  return (((size_t)O8 * (rows + 4) * (cols + 4) * sizeof(T) + 15) / 16) * 16;
}

// Shared memory of the three-layer tail on an output tile of rows x cols:
// [weights: CK x 9 x O_max fp32][A: layer 8's output][X: the input, later
// B: layer 9's output], in bytes.
template <typename T>
size_t tail_smem(int rows, int cols, int C, int O8, int O9, int O10) {
  const int om = O8 > O9 ? (O8 > O10 ? O8 : O10) : (O9 > O10 ? O9 : O10);
  const size_t x_bytes = (size_t)C * (rows + 6) * (cols + 6) * sizeof(T);
  const size_t b_bytes = (size_t)O9 * (rows + 2) * (cols + 2) * sizeof(T);
  return (size_t)CK * 9 * om * 4 + a_bytes<T>(rows, cols, O8) +
         (x_bytes > b_bytes ? x_bytes : b_bytes);
}

// The tail conv8 -> relu -> conv9 -> relu -> conv10 on one output tile of
// rows x cols at image position (y0, x0): loads the input tile with a
// 3-pixel halo, computes layer 8 over the 2-pixel halo and layer 9 over the
// 1-pixel halo that the next layer still needs, and writes the tile's
// positions inside the image to `g` (rows g_y0 .. g_y0+g_h-1 of the image's
// output). `xb` is the image's (C, H, W) input. Ends with the block's last
// write to shared memory done, not synchronised.
template <typename T, bool VALID_H>
__device__ void tail_tile(const T* __restrict__ xb, int C, int H, int W, int y0, int x0,
                          int rows, int cols, const float* k8, const float* b8, int O8,
                          const float* k9, const float* b9, int O9, const float* k10,
                          const float* b10, int O10, T* __restrict__ g, int g_y0, int g_h,
                          unsigned char* smem) {
  const int om = max(O8, max(O9, O10));
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* pa = smem + (size_t)CK * 9 * om * 4;
  T* px = reinterpret_cast<T*>(pa + a_bytes<T>(rows, cols, O8));

  const Tile<T> tx{px, y0 - 3, x0 - 3, rows + 6, cols + 6};
  const Tile<T> ta{reinterpret_cast<T*>(pa), y0 - 2, x0 - 2, rows + 4, cols + 4};
  const Tile<T> tb{px, y0 - 1, x0 - 1, rows + 2, cols + 2};
  const Tile<T> to{nullptr, y0, x0, rows, cols};

  load_tile<T, VALID_H>(xb, C, H, W, tx);
  __syncthreads();
  conv<T, TO_SMEM, VALID_H>(tx, C, k8, b8, O8, true, ws, ta, nullptr, H, W);
  __syncthreads();
  conv<T, TO_SMEM, VALID_H>(ta, O8, k9, b9, O9, true, ws, tb, nullptr, H, W);
  __syncthreads();
  conv<T, TO_GLOBAL, VALID_H>(tb, O9, k10, b10, O10, false, ws, to, g, H, W, g_y0, g_h);
}

int max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return MAX_SMEM_DEFAULT;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return MAX_SMEM_DEFAULT;
  }
  return v;
}

}  // namespace
