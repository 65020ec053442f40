// The tiled 3x3 conv layer bodies shared by conv_stack.cu and halo_conv.cu.
//
// A block computes one output tile of one image through a chain of 3x3 conv
// layers held in shared memory: each layer reflect-pads its own input, takes
// bf16 x bf16 (or fp32 x fp32) products summed in fp32, adds the fp32 bias
// before the one rounding to the input type, then the relu: the arithmetic
// of `_conv3x3` in the JAX package's kernels/conv_stack.py. Both bodies
// sum each output in the same order wherever its tile lies, so the halo
// kernels' rows equal the fused tail's bit for bit.
//
// Two bodies, chosen by the input type and by nothing else:
//   * bf16: `tc_tail_tile`, on the tensor cores (wgmma, bf16 in, fp32
//     accumulators), 4 warpgroups a block, one block an SM walking tiles.
//     conv8 and conv9 (`tc_conv_ss`): D (output channels x pixels) = W . X,
//     one wgmma m64n112k16 per tap and 16 input channels, both operands in
//     shared memory: A the layer's weights (staged once per layer per tile
//     from blocks the host packs, (9, N, C) bf16), B a run of 112
//     consecutive pixels of the channels-last input buffer, shifted by the
//     tap's offset, so the 3x3 window is a start address and no register
//     holds an operand. Runs cross buffer rows (the two columns past each
//     output row are computed and dropped). The epilogue adds the bias,
//     applies the relu, rounds, and writes 8 channels of a pixel as one
//     16-byte chunk (`stmatrix .trans`). conv10 (`tc_conv_last`, O = 2):
//     M = 64 output pixels, N = 8 channels (wgmma's least N), m64n8k16 with
//     A from registers (`ldmatrix`, each lane naming its own pixel row).
//     The encoder head in bf16 (`tc_head_tile`) reuses `tc_conv_ss` for
//     conv1_2 (64 -> 64, the tail's conv9) with runs of 136 pixels on a
//     16 x 32 pre-pool tile, four runs, one a warpgroup; conv1_1 (one or
//     three input channels) runs on the CUDA cores straight into the
//     channels-last buffer, and a pass pools conv1_2's rounded output.
//   * fp32: `tail_tile` / `conv_layer`, on the CUDA cores (tensor cores have
//     no exact fp32 product): each thread owns 4 output pixels and OT (up to
//     16) output channels, 64 fp32 accumulators, and reads per input channel
//     and tap 4 activations and OT weights (warp-uniform 128-bit broadcasts)
//     from channel planes; the weights are staged CK = 16 input channels at
//     a time. The encoder head in fp32 runs this body too (TO_POOL).
//
// What bounds the bf16 tail on this card: the products, 2,454 MFLOP an
// image at 128^2 against 2 MB in. A 16 x 16 tile recomputes its
// neighbours' halo (1.41 times the tile's own work; 1.56 with the dropped
// columns and the runs' tails), and between the products it loads its
// input (62 KB, NCHW -> channels-last), stages conv9's weights and runs
// conv10, which the tensor cores wait on (PERF.md).
//
// Channels-last buffers (`Act`): in each block of 64 channels, pixel q is a
// 128-byte row whose 16-byte chunk j lies at chunk j ^ (q & 7), the
// 128-byte swizzle of wgmma's operands keyed on the row's address, so a
// run of pixels from any pixel is an operand, and the 8 pixels of one
// `ldmatrix` matrix meet no bank twice. Channels past a layer's width are
// zeros to the end of their block. A planar layout cannot feed the tensor
// cores: a one-pixel shift of the window would move an operand row by two
// bytes.
//
// Reflect padding: a buffer covers virtual positions of the image, and a
// virtual position -1 or n holds the layer's value at real position 1 or
// n-2 (ReflectionPad2d(1) of that layer's input), so every window read is
// a plain 3x3 window of the buffer. The SIMT body computes each pad
// position from its source's window; the tensor-core body copies the
// source pixel after the layer (`fix_pads`). In the VALID_H mode the rows
// of every buffer are real rows of the image (the caller keeps the output
// tile at least 3 rows from the top and bottom edges), so only the columns
// reflect: the row-block tail of halo_conv.cu.
//
// Each source that includes this header is compiled into a library of its
// own (one translation unit), hence the unnamed namespace.

#pragma once

#include <cstdint>

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

// ===========================================================================
// The bf16 body on the tensor cores.
// ===========================================================================

constexpr int TC_WARPGROUPS = 4;  // each takes every fourth product tile of a layer
constexpr int TC_THREADS = 128 * TC_WARPGROUPS;
constexpr int TC_PIX = 112;     // pixels a product of conv8 / conv9 (wgmma m64n112k16)
constexpr int TC_M = 64;        // output channels a product of conv8 / conv9
constexpr int TC_N_LAST = 8;    // conv10's N (m64n8k16, wgmma's least N)
constexpr int TC_ALIGN = 1024;  // 128-byte-swizzled tiles repeat every 1024 bytes

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline size_t align_up(size_t v) {
  return (v + TC_ALIGN - 1) / TC_ALIGN * TC_ALIGN;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A channels-last activation buffer: virtual rows y0 .. y0+nr-1 and columns
// x0 .. x0+nc-1 of one image, cp channels (a multiple of 16, zero past the
// layer's width) in blocks of 64 channels `blk` bytes apart. In a block,
// pixel q is a 128-byte row whose 16-byte chunk j lies at chunk j ^ (q & 7):
// the 128-byte swizzle of wgmma's operands, keyed on the row as the
// hardware keys it on the address, so a run of pixels from any start is an
// operand, and the 8 pixels of an `ldmatrix` matrix meet no bank twice.
struct Act {
  uint32_t s;  // shared-memory address
  int y0, x0, nr, nc, cp, blk;
};

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Byte offset of chunk j (channels 8j .. 8j+7) of pixel q.
__device__ __forceinline__ int chunk_off(const Act& a, int q, int j) {
  return (j >> 3) * a.blk + q * 128 + (((j & 7) ^ (q & 7)) << 4);
}

// Pixels a buffer of nr x nc must hold when a `tc_conv_ss` layer reads it
// for an output region of (nr - 2) rows: the products run over whole rows
// of the input buffer in runs of pix, and each tap reads up to 2 rows + 2
// pixels past its run's first pixel.
__host__ __device__ inline int tc_reach(int nr, int nc, int pix = TC_PIX) {
  const int n = round_up((nr - 2) * nc, pix) + 2 * nc + 2;
  return round_up(n > nr * nc ? n : nr * nc, 8);
}

// Load the image's bf16 input tile, NCHW -> channels-last: virtual
// positions -1 .. H (W) take the reflected real value, the rest and the
// channels past C (to the end of their 64-channel block) are zeros.
// VALID_H: the tile's rows are real rows. Each thread gathers LOAD_UNROLL
// chunks (8 channels of one pixel each) before it stores them, so 8 x
// LOAD_UNROLL of its global loads are in flight; neighbouring threads read
// neighbouring pixels of a channel row.
constexpr int LOAD_UNROLL = 2;

template <bool VALID_H>
__device__ void tc_load_tile(const __nv_bfloat16* __restrict__ xb, int C, int H, int W,
                             const Act& t) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
  const int npix = t.nr * t.nc, total = (t.cp + 63) / 64 * 8 * npix;
  const size_t plane = (size_t)H * W;
  for (int i0 = threadIdx.x; i0 < total; i0 += TC_THREADS * LOAD_UNROLL) {
    uint32_t w[LOAD_UNROLL][4];
#pragma unroll
    for (int u = 0; u < LOAD_UNROLL; ++u) {
      const int i = i0 + u * TC_THREADS;
      const int j = i / npix, q = i % npix;
      const int vr = t.y0 + q / t.nc, vc = t.x0 + q % t.nc;
      const bool ok = i < total && (VALID_H || (vr >= -1 && vr <= H)) && vc >= -1 && vc <= W;
#pragma unroll
      for (int e = 0; e < 4; ++e) w[u][e] = 0u;
      if (ok && j * 8 < C) {
        const int sr = VALID_H ? vr : reflect1(vr, H);
        const unsigned short* src = xs + (size_t)sr * W + reflect1(vc, W) + (size_t)j * 8 * plane;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t v = j * 8 + e < C ? (uint32_t)__ldg(src + e * plane) : 0u;
          w[u][e / 2] |= v << (16 * (e % 2));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LOAD_UNROLL; ++u) {
      const int i = i0 + u * TC_THREADS;
      if (i < total) {
        st_shared_v4(t.s + chunk_off(t, i % npix, i / npix),
                     make_uint4(w[u][0], w[u][1], w[u][2], w[u][3]));
      }
    }
  }
}

// Bytes of a layer's staged weights: 9 taps x K blocks of 64 channels (cp
// rounded up: the products take 64 channels at a time) x np rows of 128
// bytes.
__host__ __device__ constexpr size_t tc_weight_bytes(int cp, int np) {
  return (size_t)9 * (round_up(cp, 64) / 64) * np * 128;
}

// Stage a layer's packed weights (9, np, cp) bf16 (K-major per tap, from
// the host) as a K-major wgmma operand (conv8's and conv9's A, conv10's
// B): [tap][K block of 64 channels][np rows][128 bytes], the 128-byte
// swizzle, chunk c of row n at c ^ (n & 7). Chunks past cp are not
// written: the products read them against zero activations, so they need
// only be finite (`tc_tail_tile` zeroes the regions once). The copies are
// cp.async, all in flight at once: `tc_weights_wait` waits for them.
__device__ void tc_stage_weights(const __nv_bfloat16* __restrict__ wk, int cp, int np,
                                 uint32_t base) {
  const uint4* src = reinterpret_cast<const uint4*>(wk);
  const int c8n = cp / 8, nkb = round_up(cp, 64) / 64;
  for (int i = threadIdx.x; i < 9 * np * c8n; i += TC_THREADS) {
    const int c8 = i % c8n, n = (i / c8n) % np, tap = i / (c8n * np);
    const int off = ((tap * nkb + c8 / 8) * np + n) * 128 + (((c8 % 8) ^ (n & 7)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + off), "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's weight copies are in shared memory and ordered before the
// tensor cores' reads, which go through the async proxy. A block barrier
// must follow before any warp's products.
__device__ __forceinline__ void tc_weights_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major operand: rows of 128 bytes
// with the 128-byte swizzle (layout type 1), 8-row groups 1024 bytes apart.
// The address field is the low 14 bits in 16-byte units: a step of 32
// bytes along the rows adds 2 to the descriptor. The card applies the
// swizzle to the address bits of each row, so a run of pixels from any
// pixel of a 1024-byte-aligned buffer is an operand with a base offset of
// 0 (stating the start's row phase there instead gives wrong products,
// measured on the H100).
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N fp32, registers) += A (64 x 16) . B (16 x N), both bf16 K-major
// in shared memory; one instance for each run length of the bodies.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<112>(float (&d)[56], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55}, "
      "%56, %57, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<136>(float (&d)[68], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67}, "
      "%68, %69, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 8 fp32, registers) += A (64 x 16 bf16, registers) . B (16 x 8
// bf16, K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from the mma fragment layout (register i: row
// lane/4, columns 2(lane%4) + {0,1} of matrix i), each stored transposed:
// lane 8i + k gives the address of column k of matrix i, 16 bytes.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// conv8, conv9 or conv1_2 on the tensor cores: `in` (in.cp channels) ->
// `out`, the region one pixel inside `in` on every side. D (output channels
// x pixels) = W (the weights, A) . X (the pixels, B): a product tile is 64
// output channels by PIX consecutive pixels q of `in`'s buffer, whose output
// is at out's (q / in.nc, q % in.nc); for each tap the B operand is the
// same run shifted by the tap's offset, (tap / 3) * in.nc + tap % 3, so
// the 3x3 window is a start address. Runs cross buffer rows; the two
// columns of each row past out's width, and the run's tail past the
// region, are computed and dropped (their lanes store to `trash`, 16
// bytes). The fp32 bias, the relu, one rounding, then `stmatrix .trans`
// writes 8 channels of a pixel as one 16-byte chunk. Every position of the
// region gets its plain 3x3 window's value: `fix_pads` then gives the
// reflect pad its value. The channels from O to out.cp are zeros (zero
// weights and bias). `ws`: the staged weights, np rows; `bias`
// in shared memory, np values. With SYNC the block meets at a barrier
// between its products and its epilogues, so `out` may overlay `in` (the
// caller keeps the jobs to one round: runs x np / 64 <= TC_WARPGROUPS).
// NC > 0 states in.nc at compile time (the epilogue divides by it).
template <int PIX, bool SYNC = false, int NC = 0>
__device__ void tc_conv_ss(const Act& in, uint32_t ws, int np, const float* bias, bool relu,
                           const Act& out, uint32_t trash) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int warp = t / 32, lane = t % 32;
  const int in_nc = NC > 0 ? NC : in.nc;
  const int runs = (out.nr * in_nc + PIX - 1) / PIX, mtiles = np / TC_M;
  const int nkb = (in.cp + 63) / 64;
  const uint32_t in_base = in.s, w_base = ws, out_base = out.s;

  // The same trip count in every warpgroup (ptxas serializes wgmma in a
  // loop whose count differs between threads): a warpgroup past the last
  // job repeats it and stores nothing.
  const int jobs = runs * mtiles;
#pragma unroll 1
  for (int it = 0; it < (jobs + TC_WARPGROUPS - 1) / TC_WARPGROUPS; ++it) {
    const int job = min(it * TC_WARPGROUPS + wg, jobs - 1);
    const bool active = it * TC_WARPGROUPS + wg < jobs;
    const int q0 = job % runs * PIX, m0 = job / runs * TC_M;
    float acc[PIX / 2];
#pragma unroll
    for (int i = 0; i < PIX / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t b0 = in_base + (q0 + (tap / 3) * in.nc + tap % 3) * 128;
      const uint32_t a0 = w_base + (tap * nkb * np + m0) * 128;
      int kb = 0;
      do {  // 64 channels a block (one block up to 64 channels)
        const uint64_t da = desc128(a0 + kb * np * 128), db = desc128(b0 + kb * in.blk);
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // 16 channels a step: 32 bytes, 2 in the address field
          wgmma_ss<PIX>(acc, da + 2 * k, db + 2 * k);
        }
      } while (++kb < nkb);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if constexpr (SYNC) __syncthreads();

    // Accumulator layout of m64nNk16: warp w holds rows (output channels)
    // 16w + lane/4 (+8); register 4j + {0,1} columns (pixels) 8j +
    // 2(lane%4) + {0,1}, 4j + {2,3} the same columns 8 rows down. Pixel
    // group j and j+1 (8 pixels each) by channel halves: four matrices a
    // stmatrix, chunk m0/8 + 2w (+1) of each pixel. With PIX / 8 odd the
    // last stmatrix has no group j+1: its lanes store to `trash`.
    const int o = m0 + warp * 16 + lane / 4;
    const float bias0 = bias[o], bias1 = bias[o + 8];
    const int mi = lane / 8, chunk = (m0 + warp * 16) / 8 + (mi & 1);
#pragma unroll
    for (int j = 0; j < PIX / 8; j += 2) {
      uint32_t r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = j + (u >> 1), hh = u & 1;
        if (jj >= PIX / 8) {
          r[u] = 0u;
          continue;
        }
        float y0 = acc[4 * jj + 2 * hh] + (hh ? bias1 : bias0);
        float y1 = acc[4 * jj + 2 * hh + 1] + (hh ? bias1 : bias0);
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        r[u] = pack_bf16x2(y0, y1);
      }
      const int jq = j + (mi >> 1);
      const int q = q0 + 8 * jq + lane % 8;
      const int rr = q / in_nc, cc = q % in_nc;
      const uint32_t addr = active && jq < PIX / 8 && rr < out.nr && cc < out.nc
                                ? out_base + chunk_off(out, rr * out.nc + cc, chunk)
                                : trash;
      stmatrix_x4_trans(addr, r[0], r[1], r[2], r[3]);
    }
  }
}

// The reflect pad of a layer's output buffer: each position -1 or n of a
// reflected axis (rows unless VALID_H, and columns) inside `out`'s region
// takes the pixel at its source, 1 or n-2 (both axes reflected at a
// corner). The block's barrier must separate it from the layer's stores
// and from the next layer's reads; tiles away from the image's border have
// no pad and skip it.
template <bool VALID_H>
__device__ void fix_pads(const Act& out, int H, int W) {
  const bool rows = !VALID_H && (out.y0 <= -1 || out.y0 + out.nr > H);
  const bool cols = out.x0 <= -1 || out.x0 + out.nc > W;
  if (!rows && !cols) return;
  const int npix = out.nr * out.nc, c8 = out.cp / 8;
  for (int i = threadIdx.x; i < npix * c8; i += TC_THREADS) {
    const int q = i % npix, j = i / npix;
    const int vr = out.y0 + q / out.nc, vc = out.x0 + q % out.nc;
    const bool pad_r = !VALID_H && (vr == -1 || vr == H);
    const bool pad_c = vc == -1 || vc == W;
    if (!(pad_r || pad_c)) continue;
    if ((!VALID_H && (vr < -1 || vr > H)) || vc < -1 || vc > W) continue;
    const int sr = pad_r ? reflect1(vr, H) : vr, sc = pad_c ? reflect1(vc, W) : vc;
    const int src = (sr - out.y0) * out.nc + (sc - out.x0);
    st_shared_v4(out.s + chunk_off(out, q, j), ld_shared_v4(out.s + chunk_off(out, src, j)));
  }
  __syncthreads();
}

// conv10 on the tensor cores: `in` -> the image's output `g` (O channels,
// (O, g_h, W) whose first row is image row g_y0), out's region one pixel
// inside `in`. O is small (2), so here M is 64 output pixels (row-major
// over out's region) and N = TC_N_LAST output channels: A comes from
// registers, loaded by ldmatrix, each lane naming its own pixel row (the
// window's shift is per-lane address arithmetic), B is the weights (np
// rows, N at a time). Positions outside the image are not
// written.
template <bool VALID_H>
__device__ void tc_conv_last(const Act& in, uint32_t ws, int np, const float* bias, int O,
                             const Act& out, __nv_bfloat16* __restrict__ g, int H, int W,
                             int g_y0, int g_h) {
  constexpr int N = TC_N_LAST;
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int warp = t / 32, lane = t % 32;
  const int npix = out.nr * out.nc, mtiles = (npix + 63) / 64;
  const int nkb = (in.cp + 63) / 64;
  const uint32_t in_base = in.s, w_base = ws;
  auto inside = [&](int m, int& vr, int& vc) {
    vr = out.y0 + m / out.nc;
    vc = out.x0 + m % out.nc;
    return (VALID_H || (vr >= 0 && vr < H)) && vc >= 0 && vc < W;
  };

  const int jobs = mtiles * (np / N);
#pragma unroll 1
  for (int it = 0; it < (jobs + TC_WARPGROUPS - 1) / TC_WARPGROUPS; ++it) {  // as tc_conv_ss
    const int job = min(it * TC_WARPGROUPS + wg, jobs - 1);
    const bool active = it * TC_WARPGROUPS + wg < jobs;
    const int mt = job % mtiles, n0 = job / mtiles * N;
    // This lane's row of A: ldmatrix matrix lane/8 takes rows 0-7, 8-15,
    // 0-7, 8-15 of the warp's 16 and K halves 0, 0, 1, 1.
    const int m = mt * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int half = lane >> 4;
    int pb = 0, vr, vc;
    if (m < npix && inside(m, vr, vc)) pb = (m / out.nc) * in.nc + m % out.nc;
    __syncwarp();  // ldmatrix and wgmma are .aligned: the warp goes on together
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    // K in commit groups of one tap and one 64-channel block (4 steps of
    // 16), each retired before the next group's ldmatrix reuses its
    // registers: a second register set of A would overlap them, but
    // costs the registers that four warpgroups do not have.
    const int groups = 9 * nkb;
    auto load_group = [&](uint32_t(&a)[4][4], int gi) {
      const int tap = gi / nkb, kb = gi % nkb;
      const int q = pb + (tap / 3) * in.nc + tap % 3;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ldmatrix_x4(a[u], in_base + chunk_off(in, q, 8 * kb + 2 * u + half));
      }
    };
    auto mma_group = [&](const uint32_t(&a)[4][4], int gi) {
      const int tap = gi / nkb, kb = gi % nkb;
      const uint64_t db = desc128(w_base + ((tap * nkb + kb) * np + n0) * 128);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) wgmma_rs_n8(acc, a[u], db + 2 * u);
      wgmma_commit();
    };
    uint32_t a[4][4];
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) {
      load_group(a, gi);
      mma_group(a, gi);
      wgmma_wait<0>();
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Accumulator rows 16w + lane/4 (+8) are pixels, columns 2(lane%4) +
    // {0,1} output channels.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int mo = mt * 64 + warp * 16 + lane / 4 + 8 * hh;
      if (!active || mo >= npix || !inside(mo, vr, vc)) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 2 * (lane % 4) + e;
        if (n < O) {
          const float y = acc[2 * hh + e] + bias[n];
          g[((size_t)n * g_h + vr - g_y0) * W + vc] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

// The tensor-core tail's shared memory on an output tile of rows x cols:
// [conv8's, then conv9's weights][conv10's weights][the biases, zero-padded
// to np][16 bytes of trash][A: conv8's output][X: the input, later B:
// conv9's output], the
// weight and activation regions at multiples of TC_ALIGN, plus TC_ALIGN
// bytes of slack to align the base.
struct TcTail {
  int cp0, cp8, cp9, np8, np9, np10;
  int blk_x, blk_a, blk_b;  // bytes of a 64-channel block of X, A, B
  int w10_off, bias_off, trash_off, a_off, x_off;  // bytes from the aligned base
  size_t bytes;
};

__host__ __device__ inline TcTail tc_tail_plan(int rows, int cols, int C, int O8, int O9,
                                               int O10) {
  TcTail p;
  p.cp0 = round_up(C, 16);
  p.cp8 = round_up(O8, 16);
  p.cp9 = round_up(O9, 16);
  p.np8 = round_up(O8, TC_M);
  p.np9 = round_up(O9, TC_M);
  p.np10 = round_up(O10, TC_N_LAST);
  p.blk_x = tc_reach(rows + 6, cols + 6) * 128;
  p.blk_a = tc_reach(rows + 4, cols + 4) * 128;
  p.blk_b = round_up((rows + 2) * (cols + 2), 8) * 128;
  const size_t w8 = tc_weight_bytes(p.cp0, p.np8), w9 = tc_weight_bytes(p.cp8, p.np9);
  const size_t x = (size_t)p.blk_x * ((p.cp0 + 63) / 64);
  const size_t b = (size_t)p.blk_b * ((p.cp9 + 63) / 64);
  p.w10_off = (int)align_up(w8 > w9 ? w8 : w9);
  p.bias_off = p.w10_off + (int)tc_weight_bytes(p.cp9, p.np10);
  p.trash_off = p.bias_off + (p.np8 + p.np9 + p.np10) * 4;
  p.a_off = (int)align_up(p.trash_off + 16);
  p.x_off = p.a_off + (int)align_up((size_t)p.blk_a * ((p.cp8 + 63) / 64));
  p.bytes = p.x_off + (x > b ? x : b) + TC_ALIGN;
  return p;
}

// The dynamic shared memory's first TC_ALIGN-aligned byte.
__device__ __forceinline__ unsigned char* tc_smem(unsigned char* raw) {
  return raw + ((TC_ALIGN - (smem_u32(raw) & (TC_ALIGN - 1))) & (TC_ALIGN - 1));
}

// tail_tile on the tensor cores, bf16: w8, w9, w10 are the packed weight
// blocks (9, np, cp) of the host (kernels/conv_stack.py `pack_tc_weights`),
// `smem` TC_ALIGN-aligned with tc_tail_plan's bytes. A block runs its tiles
// through this one after another, all with the same weights: the `first`
// stages conv10's weights and the biases for all of them, and each tile but
// the `last` stages the next one's conv8 weights while its conv10 runs.
// Ends with the block's last write to shared memory done, not synchronised.
template <bool VALID_H>
__device__ void tc_tail_tile(const __nv_bfloat16* __restrict__ xb, int C, int H, int W, int y0,
                             int x0, int rows, int cols, const __nv_bfloat16* w8,
                             const float* b8, int O8, const __nv_bfloat16* w9, const float* b9,
                             int O9, const __nv_bfloat16* w10, const float* b10, int O10,
                             __nv_bfloat16* __restrict__ g, int g_y0, int g_h,
                             unsigned char* smem, bool first, bool last) {
  // The plan is the same for every tile of a block; hidden from the
  // compiler's hoisting, it is recomputed here instead of held in
  // registers across the products, where it would spill.
  asm volatile("" : "+r"(rows), "+r"(cols), "+r"(C));
  const TcTail p = tc_tail_plan(rows, cols, C, O8, O9, O10);
  const uint32_t ws = smem_u32(smem), ws10 = ws + p.w10_off;
  float* bs = reinterpret_cast<float*>(smem + p.bias_off);
  const Act tx{ws + p.x_off, y0 - 3, x0 - 3, rows + 6, cols + 6, p.cp0, p.blk_x};
  const Act ta{ws + p.a_off, y0 - 2, x0 - 2, rows + 4, cols + 4, p.cp8, p.blk_a};
  const Act tb{ws + p.x_off, y0 - 1, x0 - 1, rows + 2, cols + 2, p.cp9, p.blk_b};
  const Act to{0u, y0, x0, rows, cols, 0, 0};

  if (first) {  // in flight while the input tile loads
    for (int i = threadIdx.x; i < p.bias_off / 16; i += TC_THREADS) {
      st_shared_v4(ws + 16 * i, make_uint4(0u, 0u, 0u, 0u));
    }
    __syncthreads();
    tc_stage_weights(w8, p.cp0, p.np8, ws);
    tc_stage_weights(w10, p.cp9, p.np10, ws10);
    for (int i = threadIdx.x; i < p.np8 + p.np9 + p.np10; i += TC_THREADS) {
      const int j9 = i - p.np8, j10 = j9 - p.np9;
      bs[i] = i < p.np8 ? (i < O8 ? b8[i] : 0.f)
                        : (j9 < p.np9 ? (j9 < O9 ? b9[j9] : 0.f) : (j10 < O10 ? b10[j10] : 0.f));
    }
  } else {
    __syncthreads();  // the previous tile's conv10 is done reading B (X's bytes)
  }
  tc_load_tile<VALID_H>(xb, C, H, W, tx);
  tc_weights_wait();
  __syncthreads();
  const uint32_t trash = ws + p.trash_off;
  tc_conv_ss<TC_PIX>(tx, ws, p.np8, bs, true, ta, trash);
  __syncthreads();
  fix_pads<VALID_H>(ta, H, W);
  tc_stage_weights(w9, p.cp8, p.np9, ws);
  tc_weights_wait();
  __syncthreads();
  tc_conv_ss<TC_PIX>(ta, ws, p.np9, bs + p.np8, true, tb, trash);
  __syncthreads();
  fix_pads<VALID_H>(tb, H, W);
  if (!last) tc_stage_weights(w8, p.cp0, p.np8, ws);  // the next tile's; waited on there
  tc_conv_last<VALID_H>(tb, ws10, p.np10, bs + p.np8 + p.np9, O10, to, g, H, W, g_y0, g_h);
}

// ===========================================================================
// The encoder head's bf16 body: conv1_1 on the CUDA cores, conv1_2 on the
// tensor cores, the 2x2 pool from shared memory.
// ===========================================================================

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// The tensor-core head's shared memory on a pre-pool output tile of rows x
// cols, conv1_2 in runs of pix pixels: [conv1_2's weights][conv1_1's
// weights, fp32 (C, 9, 64)][the biases, 64 + 64][16 bytes of trash][the
// input tile, fp32 planes (C, rows + 4, cols + 4)][A: conv1_1's output over
// the 1-pixel halo, then conv1_2's rounded output (the pool's input) over
// it], A at a multiple of TC_ALIGN, plus TC_ALIGN bytes of slack to align
// the base. Channels are padded to one 64-channel block: O1, O2 <= 64.
struct TcHead {
  int cp1;    // conv1_1's output channels padded to 16: conv1_2's K
  int blk_a;  // bytes of A's 64-channel block
  int w1_off, bias_off, trash_off, x_off, a_off;  // bytes from the aligned base
  size_t bytes;
};

__host__ __device__ inline TcHead tc_head_plan(int rows, int cols, int pix, int C, int O1) {
  TcHead p;
  p.cp1 = round_up(O1, 16);
  p.blk_a = tc_reach(rows + 2, cols + 2, pix) * 128;
  p.w1_off = (int)tc_weight_bytes(p.cp1, TC_M);
  p.bias_off = p.w1_off + C * 9 * TC_M * 4;
  p.trash_off = p.bias_off + 2 * TC_M * 4;
  p.x_off = p.trash_off + 16;
  p.a_off = (int)align_up(p.x_off + (size_t)C * (rows + 4) * (cols + 4) * 4);
  p.bytes = p.a_off + (size_t)p.blk_a + TC_ALIGN;
  return p;
}

// The input of a head tile, NR x NC positions a channel from virtual row
// y0 - 2 and column x0 - 2: positions -1 .. H (W) take the reflected real
// value, the rest zeros (read by no kept output). `head_fetch` gathers one
// channel into registers, the bf16 bits of elements threadIdx.x + u *
// TC_THREADS, so that the next tile's input is in flight during this
// tile's pool; `head_put` writes them to the fp32 planes `xs`.
constexpr int HEAD_FETCH = 2;  // input values a thread holds for the next tile

template <int NR, int NC>
__device__ __forceinline__ void head_fetch(const __nv_bfloat16* __restrict__ xb, int H, int W,
                                           int y0, int x0, uint32_t (&v)[HEAD_FETCH]) {
  static_assert(NR * NC <= HEAD_FETCH * TC_THREADS, "one channel in HEAD_FETCH values a thread");
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
#pragma unroll
  for (int u = 0; u < HEAD_FETCH; ++u) {
    const int i = threadIdx.x + u * TC_THREADS;
    const int vr = y0 - 2 + i / NC, vc = x0 - 2 + i % NC;
    v[u] = i < NR * NC && vr >= -1 && vr <= H && vc >= -1 && vc <= W
               ? (uint32_t)__ldg(xs + (size_t)reflect1(vr, H) * W + reflect1(vc, W))
               : 0u;
  }
}

template <int NR, int NC>
__device__ __forceinline__ void head_put(const uint32_t (&v)[HEAD_FETCH], float* __restrict__ xs) {
#pragma unroll
  for (int u = 0; u < HEAD_FETCH; ++u) {
    const int i = threadIdx.x + u * TC_THREADS;
    if (i < NR * NC) xs[i] = __uint_as_float(v[u] << 16);
  }
}

// The same for C channels at once, loaded and stored in one pass (the head
// with the stem unfolded, C > 1).
template <int NR, int NC>
__device__ void head_load_input(const __nv_bfloat16* __restrict__ xb, int C, int H, int W, int y0,
                                int x0, float* __restrict__ xs) {
  for (int i = threadIdx.x; i < C * NR * NC; i += TC_THREADS) {
    const int c = i / (NR * NC), r = i % (NR * NC) / NC, s = i % NC;
    const int vr = y0 - 2 + r, vc = x0 - 2 + s;
    float v = 0.f;
    if (vr >= -1 && vr <= H && vc >= -1 && vc <= W) {
      v = __bfloat162float(xb[((size_t)c * H + reflect1(vr, H)) * W + reflect1(vc, W)]);
    }
    xs[i] = v;
  }
}

// conv1_1 on the CUDA cores: the input planes `xs` ((NR + 2) x (NC + 2)
// from virtual (a.y0 - 1, a.x0 - 1)) -> `a` (NR x NC), every position of
// its region and all 64 channels of its block (zero weights and bias past
// O1). A position at virtual -1 or H (W) takes its own reflected window,
// its source's, so `a` needs no fix_pads; positions outside the padded
// image are zeros, read only by products whose outputs are dropped. Per
// input channel the 9 taps in (kh, kw) order, one fmaf each, then the
// bias, the relu, one rounding. With C = 1 that is the JAX kernel's
// broadcast branch (a bf16 x bf16 product is exact in fp32, so each fmaf
// rounds where its multiply-then-add rounds). Each warp keeps one chunk of
// 8 channels; an item is two vertically neighbouring positions, so each
// tap's two 16-byte weight broadcasts serve 16 FMAs; neighbouring lanes
// take neighbouring columns, so the 16-byte stores meet no bank twice.
template <int NR, int NC>
__device__ void head_conv1(const float* __restrict__ xs, int C, const float* __restrict__ w1,
                           const float* __restrict__ b1, const Act& a, int H, int W) {
  static_assert(NR % 2 == 0, "positions in vertical pairs");
  constexpr int XC = NC + 2, PLANE = (NR + 2) * XC, ITEMS = NR / 2 * NC;
  constexpr int LANES = TC_THREADS / 8;  // threads a chunk
  const int j = threadIdx.x / 32 % 8;
  const int l = threadIdx.x / 256 * 32 + threadIdx.x % 32;
  float bj[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bj[e] = b1[8 * j + e];
  for (int it = l; it < ITEMS; it += LANES) {
    const int r0 = it / NC * 2, s = it % NC;
    const int vc = a.x0 + s;
    bool ok[2];
    const float* xp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int vr = a.y0 + r0 + h;
      ok[h] = vc >= -1 && vc <= W && vr >= -1 && vr <= H;
      xp[h] = xs + (ok[h] ? (reflect1(vr, H) - a.y0) * XC + reflect1(vc, W) - a.x0 : 0);
    }
    float acc[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
    const float* wp = w1 + 8 * j;
    for (int c = 0; c < C; ++c, wp += 9 * TC_M) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4 wa = reinterpret_cast<const float4*>(wp + tap * TC_M)[0];
        const float4 wb = reinterpret_cast<const float4*>(wp + tap * TC_M)[1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float xv = xp[h][c * PLANE + (tap / 3) * XC + tap % 3];
          acc[h][0] = fmaf(xv, wa.x, acc[h][0]);
          acc[h][1] = fmaf(xv, wa.y, acc[h][1]);
          acc[h][2] = fmaf(xv, wa.z, acc[h][2]);
          acc[h][3] = fmaf(xv, wa.w, acc[h][3]);
          acc[h][4] = fmaf(xv, wb.x, acc[h][4]);
          acc[h][5] = fmaf(xv, wb.y, acc[h][5]);
          acc[h][6] = fmaf(xv, wb.z, acc[h][6]);
          acc[h][7] = fmaf(xv, wb.w, acc[h][7]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = ok[h] ? pack_bf16x2(fmaxf(acc[h][2 * e] + bj[2 * e], 0.f),
                                   fmaxf(acc[h][2 * e + 1] + bj[2 * e + 1], 0.f))
                     : 0u;
      }
      st_shared_v4(a.s + chunk_off(a, (r0 + h) * NC + s, j), make_uint4(v[0], v[1], v[2], v[3]));
    }
  }
}

// The 2x2/2 max pool of conv1_2's rounded output `o` (ROWS x COLS, 64
// channels) into the image's (O2, H/2, W/2) output `g`: the max of rounded
// values, which is the rounded max. An item is one pooled row, 8 pooled
// columns and two channels: it reads the pair's 4 bytes of the 32 pixels
// and writes 16 bytes to each channel's row, element by element at a
// ragged or unaligned end; the two items of a row's 16 pooled columns are
// neighbouring lanes, so each store instruction writes whole 32-byte
// sectors. Pooled positions outside the image are not written.
template <int ROWS, int COLS>
__device__ void head_pool(const Act& o, int O2, int H, int W, __nv_bfloat16* __restrict__ g) {
  constexpr int GROUPS = COLS / 16;
  const int hp = H / 2, wp = W / 2, py0 = o.y0 / 2, px0 = o.x0 / 2;
  const int pairs = (O2 + 1) / 2;
  unsigned short* gs = reinterpret_cast<unsigned short*>(g);
  for (int i = threadIdx.x; i < ROWS / 2 * GROUPS * pairs; i += TC_THREADS) {
    const int gi = i % GROUPS, e = i / GROUPS % pairs, pr = i / GROUPS / pairs;
    const int pc0 = px0 + 8 * gi;
    if (py0 + pr >= hp || pc0 >= wp) continue;
    uint32_t m[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = 2 * pr * COLS + 2 * (8 * gi + u);
      const uint32_t off = (e % 4) * 4;
      const uint32_t top = max_bf16x2(ld_shared_u32(o.s + chunk_off(o, q, e / 4) + off),
                                      ld_shared_u32(o.s + chunk_off(o, q + 1, e / 4) + off));
      const uint32_t bot = max_bf16x2(ld_shared_u32(o.s + chunk_off(o, q + COLS, e / 4) + off),
                                      ld_shared_u32(o.s + chunk_off(o, q + COLS + 1, e / 4) + off));
      m[u] = max_bf16x2(top, bot);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = 2 * e + h;
      if (ch >= O2) break;
      unsigned short* dst = gs + ((size_t)ch * hp + py0 + pr) * wp + pc0;
      if (pc0 + 8 <= wp && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = h ? (m[2 * k] >> 16) | (m[2 * k + 1] & 0xffff0000u)
                   : (m[2 * k] & 0xffffu) | (m[2 * k + 1] << 16);
        }
        asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "r"(w[0]), "r"(w[1]),
                     "r"(w[2]), "r"(w[3])
                     : "memory");
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (pc0 + u < wp) dst[u] = (unsigned short)(h ? m[u] >> 16 : m[u] & 0xffffu);
        }
      }
    }
  }
}

// conv1_1 -> relu -> conv1_2 -> relu -> 2x2 pool of one image, bf16, on the
// pre-pool output tile of ROWS x COLS at (y0, x0), H and W even: `w1` is
// conv1_1's fp32 tap-major (C, 3, 3, O1) copy, `w2` conv1_2's packed
// blocks (9, 64, cp1) of `pack_tc_weights`, `g` the image's
// (O2, H/2, W/2) output, `smem` TC_ALIGN-aligned with tc_head_plan's
// bytes. The tile: its input planes with a 2-pixel halo; conv1_1 over the
// 1-pixel halo into A; conv1_2 as one round of `tc_conv_ss` (a run of PIX
// pixels a warpgroup), whose epilogue overwrites A after a barrier; the
// pool. A block runs its tiles through this one after another: the
// `first` stages both layers' weights and the biases for all of them.
// With C = 1 the tile's input arrives in `pre` (`head_fetch`), and
// `fetch_next(pre)` fetches the next tile's after the products, in flight
// during the pool (it works out where that tile lies only then, so nothing
// of it is held in registers across the products).
template <int ROWS, int COLS, int PIX, typename FetchNext>
__device__ void tc_head_tile(const __nv_bfloat16* __restrict__ xb, int C, int H, int W, int y0,
                             int x0, const float* w1, const float* b1, int O1,
                             const __nv_bfloat16* w2, const float* b2, int O2,
                             __nv_bfloat16* __restrict__ g, unsigned char* smem, bool first,
                             uint32_t (&pre)[HEAD_FETCH], FetchNext fetch_next) {
  static_assert(ROWS % 2 == 0 && COLS % 16 == 0, "the pool takes whole quads, 8 columns a store");
  static_assert(ROWS * (COLS + 2) <= TC_WARPGROUPS * PIX, "conv1_2 in one round of products");
  asm volatile("" : "+r"(C), "+r"(O1));  // as in tc_tail_tile: recomputed, not held
  const TcHead p = tc_head_plan(ROWS, COLS, PIX, C, O1);
  const uint32_t ws = smem_u32(smem);
  float* w1s = reinterpret_cast<float*>(smem + p.w1_off);
  float* bs = reinterpret_cast<float*>(smem + p.bias_off);
  float* xs = reinterpret_cast<float*>(smem + p.x_off);
  const Act ta{ws + p.a_off, y0 - 1, x0 - 1, ROWS + 2, COLS + 2, p.cp1, p.blk_a};
  const Act to{ws + p.a_off, y0, x0, ROWS, COLS, TC_M, ROWS * COLS * 128};

  if (first) {  // the weights stay for all of the block's tiles
    for (int i = threadIdx.x; i < p.w1_off / 16; i += TC_THREADS) {
      st_shared_v4(ws + 16 * i, make_uint4(0u, 0u, 0u, 0u));
    }
    __syncthreads();
    tc_stage_weights(w2, p.cp1, TC_M, ws);
    for (int i = threadIdx.x; i < C * 9 * TC_M; i += TC_THREADS) {
      const int o = i % TC_M;
      w1s[i] = o < O1 ? w1[i / TC_M * O1 + o] : 0.f;
    }
    for (int i = threadIdx.x; i < 2 * TC_M; i += TC_THREADS) {
      const int o = i % TC_M;
      bs[i] = i < TC_M ? (o < O1 ? b1[o] : 0.f) : (o < O2 ? b2[o] : 0.f);
    }
  }
  __syncthreads();  // the previous tile's pool is done reading A
  if (C == 1) {
    head_put<ROWS + 4, COLS + 4>(pre, xs);
  } else {
    head_load_input<ROWS + 4, COLS + 4>(xb, C, H, W, y0, x0, xs);
  }
  __syncthreads();
  head_conv1<ROWS + 2, COLS + 2>(xs, C, w1s, bs, ta, H, W);
  tc_weights_wait();  // conv1_2's weights (first tile) and A's stores, before the products read
  __syncthreads();
  tc_conv_ss<PIX, true, COLS + 2>(ta, ws, TC_M, bs + TC_M, true, to, ws + p.trash_off);
  if (C == 1) fetch_next(pre);
  __syncthreads();
  head_pool<ROWS, COLS>(to, O2, H, W, g);
}

// Streaming multiprocessors of the current device: the persistent grids'
// size (one block an SM).
int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return v;
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
