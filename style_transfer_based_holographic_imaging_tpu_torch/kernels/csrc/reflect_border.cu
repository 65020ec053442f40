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
// fp32 before the multiply (as reflect_border.py:69-74 and :100-107 do: a
// bf16 kernel summed in bf16 would round the folded weight), products are
// fp32 x fp32 in both input types, summed in fp32, and the result is
// rounded once to the input type.
//
// Layouts (the port is NCHW): x (B, C, H, W), k (O, C, 3, 3) OIHW, both
// fp32 or both bf16; rows (B, O, 2, W) are output rows 0 and H-1, cols
// (B, O, H, 2) are output columns 0 and W-1 over all rows (row-reflected at
// the ends, so the corners equal the rows' values). H and W >= 2, any parity.
//
// What bounds it on this card. The ring of one layer is 24 C O (H + W)
// FLOP an image against 8 edge lines of input and 2 O (H + W) outputs: at
// the decoder's 128^2 64->64 layer 25.2 MFLOP against 393 KB an image (in
// fp32), at its 16^2 512->256 layer 101 MFLOP against 328 KB. The products
// are fp32 (CUDA cores, 67 TFLOP/s), so the operations bound it.
// What the design does about it: the ring is one fp32 GEMM per line
// orientation, D[o, n] = sum_k T[k, o] L[k, n], with
//   * K = 6 C: (near line, edge line) x 3 taps along the line x C;
//   * N = every ring position of every image and line, flattened: rows
//     n = (b, side, p) over B x 2 x W, columns n = (b, p, side) over
//     B x 2 x H, so that each output channel's positions are consecutive
//     in `rows` and `cols` alike;
//   * M = O.
// `ring_taps_kernel` folds the taps once per call into T (2, 6, C, O64) fp32,
// K-major (O64 = O padded to 64 with zeros), as the JAX kernel folds them.
// A block of `ring_gemm` owns 64 output channels x 128 ring positions,
// which may span several lines and images, so no position idles on a
// 16-long line. It stages K in chunks of 8 channels (48 rows), double-
// buffered: T's rows by cp.async, the line values through registers
// (loaded before the chunk ahead is computed, so their latency hides
// behind it), each value scattered into the rows of the taps that read it
// with each line's own reflection at its ends (a line that ends inside the
// block reflects there). Each thread keeps a 4 x 8 register tile
// (4 channels x 2 runs of 4 positions) of fp32 sums and reads per k one
// float4 of T (a broadcast) and two float4 of L. Rows read x coalesced
// along W; columns read the pairs (0, 1) and (W-2, W-1) of each image row,
// one load each where W is even. Blocks of rows and of columns alternate
// in the grid, so the columns' scattered reads meet the rows' products on
// each SM.
//
// Entry points launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() (0 on success).

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;           // output channels a block
constexpr int BN = 128;          // ring positions a block
constexpr int KC = 8;            // input channels a K chunk
constexpr int BK = 6 * KC;       // K rows a chunk: (near, edge) x 3 taps x KC
constexpr int THREADS = 256;     // 16 x 16 threads of 4 channels x 8 positions
constexpr size_t SMEM_BYTES = 2 * (size_t)BK * (BM + BN) * 4;  // two chunks of T and L

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// T[orient][s][j][c][o], s 0 = the near line (ksym), 1 = the edge line
// (kmid), j the tap along the line; rows (orient 0) fold over kh, columns
// over kw. One thread an (o, c) pair, o fastest.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ring_taps_kernel(const T* __restrict__ k, float* __restrict__ taps, int C, int O, int O64) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= O64 * C) return;
  const int o = i % O64, c = i / O64;
  float kk[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) kk[t] = o < O ? to_f(k[((size_t)o * C + c) * 9 + t]) : 0.f;
  const size_t plane = (size_t)C * O64;
  float* dst = taps + (size_t)c * O64 + o;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dst[(0 * 3 + j) * plane] = kk[j] + kk[6 + j];          // rows, near: k[0][j] + k[2][j]
    dst[(1 * 3 + j) * plane] = kk[3 + j];                  // rows, edge: k[1][j]
    dst[(6 + j) * plane] = kk[3 * j] + kk[3 * j + 2];      // columns, near: k[j][0] + k[j][2]
    dst[(9 + j) * plane] = kk[3 * j + 1];                  // columns, edge: k[j][1]
  }
}

// Where a ring position's line values are: for position n of an
// orientation, the element offsets of its near and edge line at channel 0
// and its index p along the line. `ok` is false outside 0 .. 2 B L - 1.
struct Pos {
  size_t near, edge;
  int p, side;
  bool ok;
};

__device__ __forceinline__ Pos locate(int n, bool is_row, int B, int C, int H, int W) {
  Pos r;
  const int L = is_row ? W : H;
  r.ok = n >= 0 && n < 2 * B * L;
  if (!r.ok) n = 0;
  const int b = n / (2 * L), m = n % (2 * L);
  const int side = is_row ? m / L : m % 2;
  r.side = side;
  r.p = is_row ? m % L : m / 2;
  const size_t img = (size_t)b * C * H * W;
  if (is_row) {
    r.near = img + (size_t)(side ? H - 2 : 1) * W + r.p;
    r.edge = img + (size_t)(side ? H - 1 : 0) * W + r.p;
  } else {
    r.near = img + (size_t)r.p * W + (side ? W - 2 : 1);
    r.edge = img + (size_t)r.p * W + (side ? W - 1 : 0);
  }
  return r;
}

// Scatter line value v (line s, chunk channel cc) of the position at
// column i of the block (outside [0, BN) for the halo), index p on a line
// of length L, positions d apart, into the rows of the taps that read it:
// tap 1 of itself, tap 0 of the next position and tap 2 of the previous
// one on its line, and where the line ends reflect, tap 0 of p = 0 (from
// p = 1) and tap 2 of p = L-1 (from p = L-2).
__device__ __forceinline__ void scatter(float* Ls, float v, int s, int cc, int i, int p, int L,
                                        int d) {
  float* row0 = Ls + ((s * 3 + 0) * KC + cc) * BN;
  float* row1 = Ls + ((s * 3 + 1) * KC + cc) * BN;
  float* row2 = Ls + ((s * 3 + 2) * KC + cc) * BN;
  if (i >= 0 && i < BN) row1[i] = v;
  const int fwd = i + d, back = i - d;
  if (fwd >= 0 && fwd < BN) {
    if (p < L - 1) row0[fwd] = v;
    if (p == L - 2) row2[fwd] = v;
  }
  if (back >= 0 && back < BN) {
    if (p > 0) row2[back] = v;
    if (p == 1) row0[back] = v;
  }
}

// Two neighbouring values of x, 2 sizeof(T)-aligned.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}

// One block: output channels o0 .. o0+63 at ring positions n0 .. n0+127 of
// one orientation.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ring_gemm_kernel(const T* __restrict__ x, const float* __restrict__ taps, T* __restrict__ rows,
                 T* __restrict__ cols, int B, int C, int H, int W, int O, int O64, int nb_rows,
                 int nb_cols) {
  extern __shared__ __align__(16) float smem[];
  const int mblocks = O64 / BM;
  const int mb = blockIdx.x % mblocks, nb = blockIdx.x / mblocks;
  // Rows and columns alternate while both have blocks left; the rest are
  // the longer orientation's.
  const int both = 2 * min(nb_rows, nb_cols);
  const bool is_row = nb < both ? nb % 2 == 0 : nb_rows > nb_cols;
  const int L = is_row ? W : H, d = is_row ? 1 : 2;
  const int n0 = (nb < both ? nb / 2 : nb - both / 2) * BN;
  const int o0 = mb * BM;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)H * W;  // x's channel stride
  const float* tk = taps + (size_t)(is_row ? 0 : 6) * C * O64 + o0;

  // This thread's line values: position n0 + tid % BN, KC of its 2 x KC
  // (line, channel) values a chunk, and for tid < 4 KC d one value of the
  // halo, d positions on either side. Rows: line tid / BN, every channel.
  // Columns, where W is even (an aligned pair): channels 4 (tid / BN) ..
  // +3 of both lines, whose columns (0, 1) or (W-2, W-1) are one load.
  const bool pairs = !is_row && W % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const int s_main = tid / BN;
  const Pos pm = locate(n0 + tid % BN, is_row, B, C, H, W);
  const int h = tid / (2 * KC), s_halo = tid / KC % 2, cc_halo = tid % KC;
  const bool has_halo = tid < 4 * KC * d;
  const int nh = h < d ? n0 - d + h : n0 + BN + (h - d);
  const Pos ph = locate(has_halo ? nh : -1, is_row, B, C, H, W);
  const T* xm = x + (pairs ? (pm.near < pm.edge ? pm.near : pm.edge) : (s_main ? pm.edge : pm.near));
  const T* xh = x + (s_halo ? ph.edge : ph.near);

  // Chunk buffers: T of buffer u at smem + u * BK * BM, L after both Ts.
  auto t_buf = [&](int u) { return smem + u * BK * BM; };
  auto l_buf = [&](int u) { return smem + 2 * BK * BM + u * BK * BN; };

  auto load_taps = [&](int c0, float* dst) {
    for (int i = tid; i < BK * BM / 4; i += THREADS) {
      const int r = i / (BM / 4), q = i % (BM / 4);  // r = (s * 3 + j) * KC + cc
      const int sj = r / KC, c = c0 + r % KC;
      const bool ok = c < C;
      const float* src = tk + ((size_t)sj * C + (ok ? c : 0)) * O64 + 4 * q;
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * BM + 4 * q)), src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float vm[KC], vh = 0.f;  // pairs: vm[2u] near, vm[2u + 1] edge of channel KC / 2 s_main + u
  auto load_lines = [&](int c0) {
    if (pairs) {
#pragma unroll
      for (int u = 0; u < KC / 2; ++u) {
        const int c = c0 + KC / 2 * s_main + u;
        const float2 v = pm.ok && c < C ? load2(xm + (size_t)c * plane) : make_float2(0.f, 0.f);
        vm[2 * u] = pm.side ? v.x : v.y;  // columns (0 edge, 1 near) or (W-2 near, W-1 edge)
        vm[2 * u + 1] = pm.side ? v.y : v.x;
      }
    } else {
#pragma unroll
      for (int cc = 0; cc < KC; ++cc) {
        vm[cc] = pm.ok && c0 + cc < C ? to_f(xm[(size_t)(c0 + cc) * plane]) : 0.f;
      }
    }
    if (has_halo) vh = ph.ok && c0 + cc_halo < C ? to_f(xh[(size_t)(c0 + cc_halo) * plane]) : 0.f;
  };
  auto store_lines = [&](float* dst) {
    if (pm.ok) {
#pragma unroll
      for (int cc = 0; cc < KC; ++cc) {
        if (pairs) {
          scatter(dst, vm[cc], cc % 2, KC / 2 * s_main + cc / 2, tid % BN, pm.p, L, d);
        } else {
          scatter(dst, vm[cc], s_main, cc, tid % BN, pm.p, L, d);
        }
      }
    }
    if (has_halo && ph.ok) scatter(dst, vh, s_halo, cc_halo, nh - n0, ph.p, L, d);
  };

  const int tm = tid / 16, tn = tid % 16;  // channels 4 tm .., positions 4 tn .. and 64 + 4 tn ..
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  const int chunks = (C + KC - 1) / KC;
  load_taps(0, t_buf(0));
  load_lines(0);
  store_lines(l_buf(0));
  for (int ch = 0; ch < chunks; ++ch) {
    const int cur = ch & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk ch staged; every thread is done with chunk ch - 1's buffers
    const bool next = ch + 1 < chunks;
    if (next) {
      load_taps((ch + 1) * KC, t_buf(cur ^ 1));
      load_lines((ch + 1) * KC);
    }
    const float* tcur = t_buf(cur) + 4 * tm;
    const float* lcur = l_buf(cur) + 4 * tn;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(tcur + k * BM);
      const float4 b0 = *reinterpret_cast<const float4*>(lcur + k * BN);
      const float4 b1 = *reinterpret_cast<const float4*>(lcur + k * BN + 64);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    if (next) store_lines(l_buf(cur ^ 1));
  }

  // Output channel o at position n lies at (b, o, n % 2L) of rows or cols:
  // a thread's runs of 4 positions are 16 (or 8) consecutive bytes of one
  // channel where 2L is a multiple of 4 (a run then stays in one image).
  T* out = is_row ? rows : cols;
  const int total = 2 * B * L;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n0 + 64 * half + 4 * tn;
    if (n >= total) continue;
    const bool whole = (2 * L) % 4 == 0 && n + 3 < total;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = o0 + 4 * tm + u;
      if (o >= O) break;
      if (whole) {
        T* dst = out + ((size_t)(n / (2 * L)) * O + o) * 2 * L + n % (2 * L);
        store4(dst, acc[u][4 * half], acc[u][4 * half + 1], acc[u][4 * half + 2],
               acc[u][4 * half + 3]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (n + v >= total) break;
          store(out + ((size_t)((n + v) / (2 * L)) * O + o) * 2 * L + (n + v) % (2 * L),
                acc[u][4 * half + v]);
        }
      }
    }
  }
}

// Ring positions are counted in 32-bit ints: 2 B max(H, W) + 2 BN < 2^31.
int check(int B, int C, int H, int W, int O) {
  if (B < 1 || C < 1 || O < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  if (2LL * B * (H > W ? H : W) + 2 * BN > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch_taps(const void* k, float* taps, int C, int O, cudaStream_t stream) {
  const int O64 = round_up(O, BM);
  const long long n = (long long)O64 * C;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ring_taps_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(k), taps, C, O, O64);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* k, float* taps, void* rows, void* cols, int B, int C, int H,
           int W, int O, cudaStream_t stream) {
  int err = check(B, C, H, W, O);
  if (err) return err;
  err = launch_taps<T>(k, taps, C, O, stream);
  if (err) return err;
  const int O64 = round_up(O, BM);
  const long long nb_rows = (2LL * B * W + BN - 1) / BN, nb_cols = (2LL * B * H + BN - 1) / BN;
  const long long blocks = (nb_rows + nb_cols) * (O64 / BM);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ring_gemm_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  ring_gemm_kernel<T><<<(unsigned)blocks, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), taps, static_cast<T*>(rows), static_cast<T*>(cols), B, C, H, W, O,
      O64, (int)nb_rows, (int)nb_cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, k, rows and cols alike). `taps` is
// fp32 scratch of 2 x 6 x C x round_up(O, 64) values, which the call writes
// and then reads.
int border_lines(int dtype, const void* x, const void* k, float* taps, void* rows, void* cols,
                 int B, int C, int H, int W, int O, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k, taps, rows, cols, B, C, H, W, O, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, k, taps, rows, cols, B, C, H, W, O, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
