// Border ring of a reflect-padded 3x3 convolution for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel kernels/reflect_border.py `_make_kernel`
// (launched by `_border_lines_pallas_impl`) of the JAX package.
//
// What is computed. ReflectConv's `cuda` backend runs a SAME (zero-padded)
// convolution and then overwrites the one-pixel border ring, whose SAME
// windows saw zeros instead of reflections. The ring depends on the four
// edge lines of each side only: for output row 0 the reflected window is
// [row 1, row 0, row 1], so the taps fold to ksym = k[0] + k[2] against the
// near line (row 1) and kmid = k[1] against the edge line (row 0); row H-1
// mirrors it with rows H-2 / H-1. Columns contract the kernel's transpose.
// Along the line the window is reflect-padded too. The taps are folded in
// fp32 before the multiply (as reflect_border.py:69-74 and :100-102 do: a
// bf16 kernel summed in bf16 would round the folded weight), products are
// summed in fp32 and the result is rounded once to the input type.
//
// Layouts (the port is NCHW): x (B, C, H, W), k (O, C, 3, 3) OIHW, both
// fp32 or both bf16; rows (B, O, 2, W) are output rows 0 and H-1, cols
// (B, O, H, 2) are output columns 0 and W-1 over all rows (row-reflected at
// the ends, so the corners equal the rows' values). H and W >= 2, any parity.
//
// What bounds it on this card. Per image the ring does 12 C O (H + W) FLOP
// against 8 edge lines of input and 2 O (H + W) outputs: at the decoder's
// 128^2 64->64 layer, 25.2 MFLOP and 393 KB, about 64 FLOP per byte. The
// products are fp32 (CUDA cores, 67 TFLOP/s), so at that layer the
// operations bound it (0.38 us an image) ahead of the bytes (0.12 us).
// What the design does about it: one block per (image, ring line, 64-long
// segment, 32 output channels). It stages 32 input channels of the near and
// edge lines (reflect-padded along the line) and the folded fp32 taps in
// shared memory, so every line value is reused by 32 outputs and every
// folded tap by 64 positions; each thread keeps 8 output channels of one
// position in registers, and the tap reads are warp-uniform broadcasts.
// Columns read x with stride W (the near and edge columns share a sector).
//
// The entry point launches one kernel on the caller's stream, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int LT = 64;                    // ring positions per block
constexpr int OB = 32;                    // output channels per block
constexpr int OT = 8;                     // output channels per thread
constexpr int CK = 32;                    // input channels staged per step
constexpr int THREADS = LT * (OB / OT);   // 256
constexpr int MAX_GRID_Z = 65535;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Real index of a virtual index in [-1, n] under ReflectionPad(1).
__device__ __forceinline__ int reflect1(int v, int n) {
  return v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
}

// blockIdx.x: segment of the line; blockIdx.y: block of output channels;
// blockIdx.z: image * 4 + line, line 0 = row 0, 1 = row H-1, 2 = col 0,
// 3 = col W-1.
template <typename T>
__global__ void __launch_bounds__(THREADS)
border_kernel(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ rows,
              T* __restrict__ cols, int C, int H, int W, int O) {
  __shared__ float s_near[CK][LT + 2];
  __shared__ float s_edge[CK][LT + 2];
  __shared__ __align__(16) float s_wsym[CK][3][OB];
  __shared__ __align__(16) float s_wmid[CK][3][OB];

  const int line = blockIdx.z & 3;
  const int b = blockIdx.z >> 2;
  const bool is_row = line < 2;
  const int side = line & 1;
  const int L = is_row ? W : H;
  const int l0 = blockIdx.x * LT;
  if (l0 >= L) return;  // the grid spans max(H, W); uniform per block
  const int o0 = blockIdx.y * OB;
  const int tid = threadIdx.x;
  const int pos = tid % LT;
  const int og = tid / LT;  // warp-uniform
  const int across = is_row ? H : W;
  const int edge_i = side ? across - 1 : 0;
  const int near_i = side ? across - 2 : 1;
  const size_t plane = (size_t)H * W;
  const T* xb = x + (size_t)b * C * plane;

  float acc[OT];
#pragma unroll
  for (int t = 0; t < OT; ++t) acc[t] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();
    for (int i = tid; i < CK * (LT + 2); i += THREADS) {
      const int cc = i / (LT + 2);
      const int j = i % (LT + 2);
      const int c = c0 + cc;
      const int v = l0 - 1 + j;
      float ne = 0.f, ed = 0.f;
      if (c < C && v >= -1 && v <= L) {
        const int p = reflect1(v, L);
        const T* xc = xb + (size_t)c * plane;
        if (is_row) {
          ne = to_f(xc[(size_t)near_i * W + p]);
          ed = to_f(xc[(size_t)edge_i * W + p]);
        } else {
          ne = to_f(xc[(size_t)p * W + near_i]);
          ed = to_f(xc[(size_t)p * W + edge_i]);
        }
      }
      s_near[cc][j] = ne;
      s_edge[cc][j] = ed;
    }
    for (int i = tid; i < CK * 3 * OB; i += THREADS) {
      const int oo = i % OB;
      const int j = (i / OB) % 3;
      const int cc = i / (3 * OB);
      const int c = c0 + cc;
      const int o = o0 + oo;
      float ws = 0.f, wm = 0.f;
      if (c < C && o < O) {
        const T* kk = k + ((size_t)o * C + c) * 9;
        if (is_row) {  // window along W: taps k[kh][j], kh folded
          ws = to_f(kk[j]) + to_f(kk[6 + j]);
          wm = to_f(kk[3 + j]);
        } else {       // window along H: taps k[j][kw], kw folded
          ws = to_f(kk[3 * j]) + to_f(kk[3 * j + 2]);
          wm = to_f(kk[3 * j + 1]);
        }
      }
      s_wsym[cc][j][oo] = ws;
      s_wmid[cc][j][oo] = wm;
    }
    __syncthreads();
    const int cn = min(CK, C - c0);
    for (int cc = 0; cc < cn; ++cc) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float ne = s_near[cc][pos + j];
        const float ed = s_edge[cc][pos + j];
        const float4* ws4 = reinterpret_cast<const float4*>(&s_wsym[cc][j][og * OT]);
        const float4* wm4 = reinterpret_cast<const float4*>(&s_wmid[cc][j][og * OT]);
#pragma unroll
        for (int q = 0; q < OT / 4; ++q) {
          const float4 s = ws4[q];
          const float4 m = wm4[q];
          acc[4 * q + 0] = fmaf(ed, m.x, fmaf(ne, s.x, acc[4 * q + 0]));
          acc[4 * q + 1] = fmaf(ed, m.y, fmaf(ne, s.y, acc[4 * q + 1]));
          acc[4 * q + 2] = fmaf(ed, m.z, fmaf(ne, s.z, acc[4 * q + 2]));
          acc[4 * q + 3] = fmaf(ed, m.w, fmaf(ne, s.w, acc[4 * q + 3]));
        }
      }
    }
  }

  const int l = l0 + pos;
  if (l >= L) return;
#pragma unroll
  for (int t = 0; t < OT; ++t) {
    const int o = o0 + og * OT + t;
    if (o >= O) break;
    if (is_row) {
      store(rows + (((size_t)b * O + o) * 2 + side) * W + l, acc[t]);
    } else {
      store(cols + (((size_t)b * O + o) * H + l) * 2 + side, acc[t]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* k, void* rows, void* cols, int B, int C, int H, int W,
           int O, cudaStream_t stream) {
  if (B < 1 || C < 1 || O < 1 || H < 2 || W < 2 || B > MAX_GRID_Z / 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int lmax = H > W ? H : W;
  const dim3 grid((lmax + LT - 1) / LT, (O + OB - 1) / OB, 4 * B);
  border_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(rows),
      static_cast<T*>(cols), C, H, W, O);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, k, rows and cols alike).
int border_lines(int dtype, const void* x, const void* k, void* rows, void* cols, int B, int C,
                 int H, int W, int O, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k, rows, cols, B, C, H, W, O, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, k, rows, cols, B, C, H, W, O, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
