// Fused angular-spectrum propagator for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * asm_const   <- kernels/asm_pallas.py `_make_kernel_const` (launched by
//                    `_propagate_pallas_const_impl`): one host-scalar distance,
//                    the transfer function H (global phasor folded in) is an
//                    input plane built once on the host.
//   * asm_dynamic <- kernels/asm_pallas.py `_make_kernel` (launched by
//                    `_propagate_pallas_impl`): one distance per image; the
//                    transfer phase d*kz_rel and its cos/sin are computed here,
//                    and the global phasor exp(i d 2pi/lambda) is applied to
//                    the output.
//
// What is computed, per image x (h, w) complex as fp32 re/im planes:
//   S = A . x . B     replicate-pad (h,w)->(fh,fw) folded into thin DFT factors
//   T = S * H         transfer function (fused into stage 2's epilogue)
//   U = C . T . D     ifft2 + centre crop folded into thin factors
// with A (fh,h), B (w,fw), C (h,fh), D (fw,w) complex, shared by all images.
// At 128 -> 256 that is 25.2 M complex MACs an image (about 201 MFLOP of
// real products) against 256 KB of input and output.
//
// What bounds it on this card: the arithmetic. 201 MFLOP for 256 KB of I/O is
// ~770 FLOP per byte, far above the H100's ridge in every mode. `high` does
// three bf16 products per product (603 MFLOP an image) and `bf16` one, which
// the tensor cores run at 989 TFLOP/s dense: 0.61 us and 0.20 us an image.
// `highest` is fp32 on the CUDA cores (67 TFLOP/s): 3 us an image.
//
// Precision modes (the JAX package's `set_dft_precision` names):
//   highest  fp32 FMA on the fp32 operands: `cgemm_kernel`, SIMT tiles.
//   high     the bf16 hi/lo three-product split of `_make_dot`:
//            a*b ~ ahi*bhi + ahi*blo + alo*bhi (lo*lo dropped), hi = bf16(a),
//            lo = bf16(a - hi), products summed in fp32: `tc_gemm_kernel`.
//   bf16     one product of bf16-rounded operands, fp32 sums: the same kernel.
//
// The tensor-core design (`high`, `bf16`):
//   * Each stage's complex product is ONE real GEMM with re and im stacked
//     along K: a factor on the left is the block [Ar -Ai; Ai Ar] times
//     [Xr; Xi]; a factor on the right is [Xr Xi] times a block whose output
//     columns interleave re and im, so each thread's accumulator pair
//     (columns 2n, 2n+1) is one complex value and the epilogue can apply H
//     or the phasor. The host builds the block factors and their bf16 hi/lo
//     planes once per (h, w) (`asm_cuda._block_factor_tensors`): the kernel
//     never splits a factor.
//   * `wgmma.mma_async` m64n128k16 bf16 -> fp32: a 128x128 output tile per
//     block, two consumer warpgroups of 64 rows. In `high` each 16-deep K
//     step issues the three passes (A_hi,B_hi), (A_hi,B_lo), (A_lo,B_hi)
//     into the same accumulators; nothing is duplicated in memory.
//   * Operands are K-major in device memory and reach shared memory by TMA
//     (3-D tensor maps: K, rows, image) into 64-byte-swizzled 128x32 tiles,
//     a ring of 3 stages (`high`: four tiles a stage, 32 KB) or 4 (`bf16`:
//     two tiles, 16 KB), each with an mbarrier that the TMA completes. Thread
//     0 refills the stage whose products `wgmma.wait_group 1` has retired.
//     At about 97 KB a block, two blocks share an SM, so one block's
//     epilogue and prologue overlap the other's products.
//     TMA fills boxes past the tensor's edge with zeros, so every even h, w
//     in [16, 256] runs, M = 16 or 48 included. The tensor maps are encoded
//     on the host with libcuda's `cuTensorMapEncodeTiled`, whose address
//     the CUDA runtime hands out (no -lcuda at link time).
//   * Each stage's epilogue writes the next stage's operand, K-major, as its
//     bf16 hi and lo planes (`bf16`: hi only): stage 1 the row-stacked S1 as
//     [S1r | S1i]; stage 2 applies H in fp32 before anything is rounded (the
//     plane for asm_const, sincosf(d kz) for asm_dynamic) and writes T
//     transposed as [Tr | Ti] along K; stage 3 writes [U1r | U1i]; stage 4
//     writes fp32 y (times the phasor for asm_dynamic). The block stages its
//     tile in shared memory in the destination's row order and writes whole
//     rows with 16-byte stores. A split pass before stage 1 writes x
//     transposed as its hi/lo planes.
//   * Five launches a call (split + four stages); the intermediates go
//     through device memory and L2: at B = 256 that is about 300 MB written
//     once and read back. Fusing stages, a persistent grid and clusters are
//     later work.
//
// The numbers: each operand is rounded exactly as `asm_propagate`'s plain
// version rounds it (`asm_cuda._plain`); only the order of the fp32 sums
// differs (one accumulator for the three passes and for re/im).
//
// Each entry point launches its kernels on the caller's stream, allocates
// nothing, and returns the first non-zero cudaError_t (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Prec { PREC_HIGHEST = 0, PREC_HIGH = 1, PREC_BF16 = 2 };
constexpr int MAX_GRID_Z = 65535;

// ===========================================================================
// `highest`: fp32 SIMT tiles.
// ===========================================================================

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // depth of one shared-memory slice
constexpr int TM = 4;         // output rows per thread (strided by 16)
constexpr int TN = 4;         // output columns per thread (strided by 16)
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)

enum Epi { EPI_NONE = 0, EPI_PLANE = 1, EPI_KZ = 2, EPI_PHASOR = 3 };

// Batched complex GEMM  C[z] = op(A[z] . B[z])  on fp32 re/im planes,
// row-major. A is M x K (row stride lda, batch stride sa; 0 = shared by the
// batch), B is K x N (ldb, sb), C is M x N (row stride N, batch stride sc).
// Each block computes a 64x64 tile from 16-deep shared-memory slices, a 4x4
// complex micro-tile per thread. The epilogue multiplies the product
// elementwise by
//   EPI_PLANE:  (e0 + i e1)[m, n]                 (the constant H)
//   EPI_KZ:     exp(i dist[z] e0[m, n])           (the per-image H)
//   EPI_PHASOR: exp(i dist[z] gcoef)              (the global phasor)
template <int EPI>
__global__ void __launch_bounds__(THREADS)
cgemm_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im, long long sa, int lda,
             const float* __restrict__ b_re, const float* __restrict__ b_im, long long sb, int ldb,
             float* __restrict__ c_re, float* __restrict__ c_im, long long sc,
             int M, int N, int K,
             const float* __restrict__ e0, const float* __restrict__ e1,
             const float* __restrict__ dist, float gcoef) {
  // A slices are stored k-major (transposed) so a thread's 4 rows are one
  // broadcast read; +4 floats of padding spread the transposing stores.
  __shared__ float as_r[BK][BM + 4];
  __shared__ float as_i[BK][BM + 4];
  __shared__ float bs_r[BK][BN];
  __shared__ float bs_i[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15: column lane
  const int ty = tid / (BN / TN);  // 0..15: row lane
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long z = blockIdx.z;

  const float* pa_r = a_re + z * sa;
  const float* pa_i = a_im + z * sa;
  const float* pb_r = b_re + z * sb;
  const float* pb_i = b_im + z * sb;

  float acc_r[TM][TN];
  float acc_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_r[i][j] = 0.f;
      acc_i[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slice: BM x BK = 1024 elements a plane, 4 per thread, K-contiguous.
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK;
      const int k = e % BK;
      const int gm = m0 + r;
      const int gk = k0 + k;
      float vr = 0.f, vi = 0.f;
      if (gm < M && gk < K) {
        const long long off = (long long)gm * lda + gk;
        vr = pa_r[off];
        vi = pa_i[off];
      }
      as_r[k][r] = vr;
      as_i[k][r] = vi;
    }
    // B slice: BK x BN = 1024 elements a plane, 4 per thread, N-contiguous.
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int k = e / BN;
      const int c = e % BN;
      const int gk = k0 + k;
      const int gn = n0 + c;
      float vr = 0.f, vi = 0.f;
      if (gk < K && gn < N) {
        const long long off = (long long)gk * ldb + gn;
        vr = pb_r[off];
        vi = pb_i[off];
      }
      bs_r[k][c] = vr;
      bs_i[k][c] = vi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ar[i] = as_r[kk][ty + 16 * i];
        ai[i] = as_i[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = bs_r[kk][tx + 16 * j];
        bi[j] = bs_i[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_r[i][j] = fmaf(ar[i], br[j], acc_r[i][j]);
          acc_r[i][j] = fmaf(-ai[i], bi[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(ar[i], bi[j], acc_i[i][j]);
          acc_i[i][j] = fmaf(ai[i], br[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float d = 0.f;
  if constexpr (EPI == EPI_KZ || EPI == EPI_PHASOR) {
    d = dist[z];
  }
  float gc = 1.f, gs = 0.f;
  if constexpr (EPI == EPI_PHASOR) {
    sincosf(d * gcoef, &gs, &gc);
  }

  float* out_r = c_re + z * sc;
  float* out_i = c_im + z * sc;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) {
        const long long off = (long long)m * N + n;
        float vr = acc_r[i][j];
        float vi = acc_i[i][j];
        if constexpr (EPI == EPI_PLANE) {
          const float hr = e0[off];
          const float hi = e1[off];
          const float tr = vr * hr - vi * hi;
          const float ti = vr * hi + vi * hr;
          vr = tr;
          vi = ti;
        } else if constexpr (EPI == EPI_KZ) {
          float s, c;
          sincosf(d * e0[off], &s, &c);
          const float tr = vr * c - vi * s;
          const float ti = vr * s + vi * c;
          vr = tr;
          vi = ti;
        } else if constexpr (EPI == EPI_PHASOR) {
          const float tr = vr * gc - vi * gs;
          const float ti = vr * gs + vi * gc;
          vr = tr;
          vi = ti;
        }
        out_r[off] = vr;
        out_i[off] = vi;
      }
    }
  }
}

// One batched GEMM launch, the batch split into chunks the grid's z can hold.
template <int EPI>
cudaError_t launch_cgemm(const float* a_re, const float* a_im, long long sa, int lda,
                         const float* b_re, const float* b_im, long long sb, int ldb,
                         float* c_re, float* c_im, int M, int N, int K, int batch,
                         const float* e0, const float* e1, const float* dist, float gcoef,
                         cudaStream_t stream) {
  const long long sc = (long long)M * N;
  for (int z0 = 0; z0 < batch; z0 += MAX_GRID_Z) {
    const int nz = (batch - z0 < MAX_GRID_Z) ? (batch - z0) : MAX_GRID_Z;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nz);
    cgemm_kernel<EPI><<<grid, THREADS, 0, stream>>>(
        a_re + z0 * sa, a_im + z0 * sa, sa, lda,
        b_re + z0 * sb, b_im + z0 * sb, sb, ldb,
        c_re + z0 * sc, c_im + z0 * sc, sc, M, N, K,
        e0, e1, dist == nullptr ? nullptr : dist + z0, gcoef);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The four stages of one propagate in fp32. EPI2 is stage 2's epilogue (the
// transfer function), EPI4 stage 4's (the global phasor, or none).
template <int EPI2, int EPI4>
cudaError_t propagate_fp32(const float* xre, const float* xim, int batch, int h, int w,
                           int fh, int fw, const float* const* f,
                           const float* e0, const float* e1, const float* dist, float gcoef,
                           float* const* scratch, float* yre, float* yim, cudaStream_t stream) {
  const float *are = f[0], *aim = f[1], *bre = f[2], *bim = f[3];
  const float *cre = f[4], *cim = f[5], *dre = f[6], *dim = f[7];
  float *s1re = scratch[0], *s1im = scratch[1], *tre = scratch[2], *tim = scratch[3];
  float *u1re = scratch[4], *u1im = scratch[5];
  cudaError_t err;
  // Stage 1: S1 (fh, w) = A (fh, h) . x (h, w).
  err = launch_cgemm<EPI_NONE>(are, aim, 0, h, xre, xim, (long long)h * w, w,
                               s1re, s1im, fh, w, h, batch,
                               nullptr, nullptr, nullptr, 0.f, stream);
  if (err != cudaSuccess) return err;
  // Stage 2: T (fh, fw) = (S1 (fh, w) . B (w, fw)) * H.
  err = launch_cgemm<EPI2>(s1re, s1im, (long long)fh * w, w, bre, bim, 0, fw,
                           tre, tim, fh, fw, w, batch, e0, e1, dist, gcoef, stream);
  if (err != cudaSuccess) return err;
  // Stage 3: U1 (h, fw) = C (h, fh) . T (fh, fw).
  err = launch_cgemm<EPI_NONE>(cre, cim, 0, fh, tre, tim, (long long)fh * fw, fw,
                               u1re, u1im, h, fw, fh, batch,
                               nullptr, nullptr, nullptr, 0.f, stream);
  if (err != cudaSuccess) return err;
  // Stage 4: y (h, w) = (U1 (h, fw) . D (fw, w)) [* global phasor].
  return launch_cgemm<EPI4>(u1re, u1im, (long long)h * fw, fw, dre, dim, 0, w,
                            yre, yim, h, w, fw, batch, nullptr, nullptr, dist, gcoef,
                            stream);
}

// ===========================================================================
// `high` and `bf16`: bf16 wgmma, TMA-fed ring.
// ===========================================================================

constexpr int TC_BM = 128;       // output rows per block (two warpgroups of 64)
constexpr int TC_BN = 128;       // output columns per block (wgmma N)
constexpr int TC_BK = 32;        // K per tile: 32 bf16 = one 64-byte swizzle row
constexpr int TC_THREADS = 256;  // two consumer warpgroups; thread 0 also feeds TMA
constexpr int TILE_BYTES = TC_BM * TC_BK * 2;  // 8 KB; a B tile is the same size

// Stage epilogues: where the accumulator tile goes.
enum TcEpi {
  TE_LEFT = 0,      // rows [0, M/2) re, [M/2, M) im -> next A operand [re | im] along K
  TE_PLANE_T = 1,   // (re, im) column pairs times H (planes) -> next B operand, transposed
  TE_KZ_T = 2,      // (re, im) column pairs times exp(i d kz) -> the same
  TE_Y = 3,         // (re, im) column pairs -> fp32 y planes
  TE_PHASOR_Y = 4,  // (re, im) column pairs times exp(i d gcoef) -> fp32 y planes
};

struct TcOut {
  __nv_bfloat16* hi;  // the next operand's hi plane (K-major)
  __nv_bfloat16* lo;  // its lo plane (`high` only)
  long long bstride;  // elements between images
  int pitch;          // elements between rows (a multiple of 8: 16 bytes)
  const float* e0;    // H re (TE_PLANE_T) or kz_rel (TE_KZ_T), (M, N/2)
  const float* e1;    // H im (TE_PLANE_T)
  const float* dist;  // per-image distance (TE_KZ_T, TE_PHASOR_Y)
  float gcoef;        // 2 pi / lambda (TE_PHASOR_Y)
  float* yre;         // output planes (TE_Y, TE_PHASOR_Y), (M, N/2) an image
  float* yim;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with the 64-byte swizzle
// (layout type 2): rows of 64 bytes, 8-row groups 512 bytes apart (SBO), LBO
// unused (16).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
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

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, fp32, in registers) += A (64 x 16) . B (16 x 128), both bf16
// K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The ring: tiles a stage (A_hi, B_hi[, A_lo, B_lo]) and stages.
template <bool HIGH>
struct Ring {
  static constexpr int NT = HIGH ? 4 : 2;
  static constexpr int STAGES = HIGH ? 3 : 4;
  static constexpr int STAGE_BYTES = NT * TILE_BYTES;
};

// The epilogue stages the block's output tile in shared memory (the ring's
// bytes, free once the products are done) in the destination's row order,
// then copies whole rows with 16-byte stores: the transposed and the
// re/im-split layouts would otherwise be 2- and 4-byte scattered stores.
constexpr int SP = TC_BM + 8;  // bf16 staging row: 128 values + 16 bytes (banks)
constexpr int YP = TC_BN / 2 + 4;  // fp32 staging row: 64 values + 16 bytes
// The staged tile's bytes: two planes of 128 rows (bf16 hi/lo, or fp32 y re/im).
constexpr int STAGING_BYTES = 2 * TC_BM * SP * 2;
static_assert(STAGING_BYTES == 2 * TC_BM * YP * 4, "both staging layouts take the same bytes");

// Dynamic shared memory of the kernel: the ring or the staged tile (they
// share bytes), 1 KB of alignment slack, the ring's mbarriers.
template <bool HIGH>
__host__ __device__ constexpr int tc_smem_bytes() {
  constexpr int ring = Ring<HIGH>::STAGES * Ring<HIGH>::STAGE_BYTES;
  return (ring > STAGING_BYTES ? ring : STAGING_BYTES) + 1024 + 8 * Ring<HIGH>::STAGES;
}

// hi = bf16(v), lo = bf16(v - hi), as the plain version splits.
__device__ __forceinline__ void split2(float v0, float v1, __nv_bfloat162& h, __nv_bfloat162& l) {
  h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ void split1(float v, __nv_bfloat16& h, __nv_bfloat16& l) {
  h = __float2bfloat16_rn(v);
  l = __float2bfloat16_rn(v - __bfloat162float(h));
}

// Copy `len` (<= the staged row's length) values of a staged row to global
// memory: 16-byte stores where the destination is aligned, else one value
// at a time. `chunk` is this thread's 16-byte piece of the row.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* g, const T* s, int len, int chunk) {
  constexpr int CH = 16 / sizeof(T);
  const int e0 = chunk * CH;
  if (e0 >= len) return;
  if (e0 + CH <= len && (reinterpret_cast<uintptr_t>(g + e0) & 15) == 0) {
    *reinterpret_cast<uint4*>(g + e0) = *reinterpret_cast<const uint4*>(s + e0);
  } else {
    for (int e = e0; e < e0 + CH && e < len; ++e) g[e] = s[e];
  }
}

// Stage the accumulator pair at tile-local row rl, column cl (even) of the
// stage's M x N output, image z.
template <bool HIGH, int EPI>
__device__ __forceinline__ void stage_pair(unsigned char* sm, const TcOut& o, int M, int N,
                                           long long z, int r, int c, int rl, int cl, float v0,
                                           float v1) {
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(sm);
  if constexpr (EPI == TE_LEFT) {
    // rows of the tile as they are; plane hi, then lo
    __nv_bfloat162 h, l;
    split2(v0, v1, h, l);
    *reinterpret_cast<__nv_bfloat162*>(sh + rl * SP + cl) = h;
    if (HIGH) *reinterpret_cast<__nv_bfloat162*>(sh + (TC_BM + rl) * SP + cl) = l;
  } else if constexpr (EPI == TE_PLANE_T || EPI == TE_KZ_T) {
    // staged rows: (plane, re/im, column n of T), each along the tile's rows
    const int nl = cl / 2;
    float hr = 0.f, hi = 0.f;
    if (r < M && c < N) {
      const long long idx = (long long)r * (N / 2) + c / 2;
      if constexpr (EPI == TE_PLANE_T) {
        hr = o.e0[idx];
        hi = o.e1[idx];
      } else {
        sincosf(o.dist[z] * o.e0[idx], &hi, &hr);
      }
    }
    const float tr = v0 * hr - v1 * hi;
    const float ti = v0 * hi + v1 * hr;
    __nv_bfloat16 h, l;
    split1(tr, h, l);
    sh[nl * SP + rl] = h;
    if (HIGH) sh[(TC_BN + nl) * SP + rl] = l;
    split1(ti, h, l);
    sh[(TC_BN / 2 + nl) * SP + rl] = h;
    if (HIGH) sh[(TC_BN + TC_BN / 2 + nl) * SP + rl] = l;
  } else {
    // fp32 y: rows of the tile, yre then yim
    float* sf = reinterpret_cast<float*>(sm);
    float yr = v0, yi = v1;
    if constexpr (EPI == TE_PHASOR_Y) {
      float gs, gc;
      sincosf(o.dist[z] * o.gcoef, &gs, &gc);
      yr = v0 * gc - v1 * gs;
      yi = v0 * gs + v1 * gc;
    }
    sf[rl * YP + cl / 2] = yr;
    sf[(TC_BM + rl) * YP + cl / 2] = yi;
  }
}

// Write the staged tile (rows m0.., columns n0.. of the M x N output) to
// the destination, all threads of the block together.
template <bool HIGH, int EPI>
__device__ __forceinline__ void store_tile(const unsigned char* sm, const TcOut& o, int M, int N,
                                           long long z, int m0, int n0, int tid) {
  typedef __nv_bfloat16 bf;
  const bf* sh = reinterpret_cast<const bf*>(sm);
  constexpr int CHUNKS = 16;  // 16-byte pieces of a staged row: 128 bf16 or 64 fp32
  if constexpr (EPI == TE_LEFT) {
    const int half = M / 2;
    const int len = min(TC_BN, N - n0);
    constexpr int ROWS = (HIGH ? 2 : 1) * TC_BM;
    for (int i = tid; i < ROWS * CHUNKS; i += TC_THREADS) {
      const int q = i / CHUNKS, plane = q / TC_BM, rl = q % TC_BM;
      const int r = m0 + rl;
      if (r >= M) continue;
      const bool im = r >= half;
      const long long off = z * o.bstride + (long long)(im ? r - half : r) * o.pitch + (im ? N : 0) + n0;
      copy_chunk<bf>((plane ? o.lo : o.hi) + off, sh + q * SP, len, i % CHUNKS);
    }
  } else if constexpr (EPI == TE_PLANE_T || EPI == TE_KZ_T) {
    const int len = min(TC_BM, M - m0);
    constexpr int ROWS = (HIGH ? 2 : 1) * TC_BN;  // (plane, re/im, n) rows
    for (int i = tid; i < ROWS * CHUNKS; i += TC_THREADS) {
      const int q = i / CHUNKS, plane = q / TC_BN, part = (q / (TC_BN / 2)) % 2;
      const int n = n0 / 2 + q % (TC_BN / 2);
      if (n >= N / 2) continue;
      const long long off = z * o.bstride + (long long)n * o.pitch + (part ? M : 0) + m0;
      copy_chunk<bf>((plane ? o.lo : o.hi) + off, sh + q * SP, len, i % CHUNKS);
    }
  } else {
    const float* sf = reinterpret_cast<const float*>(sm);
    const int w = N / 2;
    const int len = min(TC_BN / 2, w - n0 / 2);
    for (int i = tid; i < 2 * TC_BM * CHUNKS; i += TC_THREADS) {
      const int q = i / CHUNKS, part = q / TC_BM, rl = q % TC_BM;
      const int r = m0 + rl;
      if (r >= M) continue;
      const long long off = z * (long long)M * w + (long long)r * w + n0 / 2;
      copy_chunk<float>((part ? o.yim : o.yre) + off, sf + q * YP, len, i % CHUNKS);
    }
  }
}

// Batched real GEMM  D[z] (M x N) = A[z] (M x K) . B[z]^T, A and B both
// stored K-major (rows of K), bf16 hi (and lo) planes behind 3-D tensor maps
// (K, rows, image; a factor shared by the batch has one image). Grid:
// (N / 128, M / 128, images); z0 is the first image of this launch.
template <bool HIGH, int EPI>
__global__ void __launch_bounds__(TC_THREADS, 2)
tc_gemm_kernel(const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
               const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
               int M, int N, int K, int a_batched, int b_batched, int z0, TcOut out) {
  constexpr int STAGES = Ring<HIGH>::STAGES;
  constexpr int STAGE_BYTES = Ring<HIGH>::STAGE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles want 512-byte alignment
  const uint32_t bar0 = base + tc_smem_bytes<HIGH>() - 1024 - 8 * STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  const int z = z0 + blockIdx.z;
  const int za = a_batched ? z : 0;
  const int zb = b_batched ? z : 0;
  const int nk = (K + TC_BK - 1) / TC_BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int kt) {
    const int s = kt % STAGES;
    const uint32_t st = base + s * STAGE_BYTES;
    const uint32_t bar = bar0 + 8 * s;
    const int k = kt * TC_BK;
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load_3d(st, &a_hi, k, m0, za, bar);
    tma_load_3d(st + TILE_BYTES, &b_hi, k, n0, zb, bar);
    if constexpr (HIGH) {
      tma_load_3d(st + 2 * TILE_BYTES, &a_lo, k, m0, za, bar);
      tma_load_3d(st + 3 * TILE_BYTES, &b_lo, k, n0, zb, bar);
    }
  };
  if (tid == 0) {
    for (int kt = 0; kt < STAGES && kt < nk; ++kt) issue(kt);
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(bar0 + 8 * s, (kt / STAGES) & 1);
    __syncwarp();  // wgmma is .aligned: the warp leaves the wait together
    const uint32_t st = base + s * STAGE_BYTES;
    const uint32_t ah = st + wg * 64 * TC_BK * 2;  // this warpgroup's 64 rows of A
    const uint32_t bh = st + TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t step = 32 * kk;  // 16 bf16 along the swizzled row
      wgmma_m64n128k16(acc, smem_desc(ah + step), smem_desc(bh + step));
      if constexpr (HIGH) {
        const uint32_t al = ah + 2 * TILE_BYTES;
        const uint32_t bl = bh + 2 * TILE_BYTES;
        wgmma_m64n128k16(acc, smem_desc(ah + step), smem_desc(bl + step));
        wgmma_m64n128k16(acc, smem_desc(al + step), smem_desc(bh + step));
      }
    }
    wgmma_commit();
    // The products of tile kt-1 are done in this warpgroup; after the
    // barrier, in both: its stage can be refilled.
    wgmma_wait<1>();
    __syncthreads();
    if (tid == 0 && kt >= 1 && kt - 1 + STAGES < nk) issue(kt - 1 + STAGES);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16w + lane/4 (+8); register 4j + {0,1} columns 8j + 2(lane%4) + {0,1},
  // 4j + {2,3} the same columns 8 rows down.
  unsigned char* sm = smem_raw + (base - raw);
  __syncthreads();  // both warpgroups' products have read the ring
  const int t = tid % 128;
  const int rl0 = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int cl0 = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = rl0 + 8 * hh;
      const int cl = cl0 + 8 * j;
      stage_pair<HIGH, EPI>(sm, out, M, N, z, m0 + rl, n0 + cl, rl, cl, acc[4 * j + 2 * hh],
                            acc[4 * j + 2 * hh + 1]);
    }
  }
  __syncthreads();
  store_tile<HIGH, EPI>(sm, out, M, N, z, m0, n0, tid);
}

// x (h, w) re/im fp32 -> X^T (w, 2h) hi[/lo] bf16, row n = [xr[:, n] | xi[:, n]],
// through a 32 x 32 shared-memory tile so reads and writes are both coalesced.
template <bool HIGH>
__global__ void __launch_bounds__(256)
split_transpose_kernel(const float* __restrict__ xre, const float* __restrict__ xim, int h, int w,
                       int z0, __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo,
                       int pitch, long long bstride) {
  __shared__ float tile[32][33];
  const long long z = z0 + blockIdx.z;
  const int k0 = blockIdx.y * 32;  // along 2h
  const int n0 = blockIdx.x * 32;  // along w
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long img = z * h * w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 8 * i;
    const int n = n0 + tx;
    float v = 0.f;
    if (k < 2 * h && n < w) v = k < h ? xre[img + (long long)k * w + n] : xim[img + (long long)(k - h) * w + n];
    tile[ty + 8 * i][tx] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 8 * i;
    const int k = k0 + tx;
    if (n < w && k < 2 * h) {
      const float v = tile[tx][ty + 8 * i];
      const long long off = z * bstride + (long long)n * pitch + k;
      const __nv_bfloat16 vh = __float2bfloat16_rn(v);
      hi[off] = vh;
      if (HIGH) lo[off] = __float2bfloat16_rn(v - __bfloat162float(vh));
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, its address from the CUDA runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A K-major bf16 operand: `rows` rows of `k` values, `pitch` apart (a
// multiple of 8), `images` images `bstride` apart; boxes of 64 x 128 x 1.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int k, int rows, int images, int pitch,
                     long long bstride) {
  const EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)rows, (cuuint64_t)images};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 2, (cuuint64_t)bstride * 2};
  const cuuint32_t box[3] = {TC_BK, TC_BM, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A K-major operand's planes: hi, lo, its geometry.
struct Operand {
  const void* hi;
  const void* lo;
  int k, rows, images, pitch;
  long long bstride;
};

template <bool HIGH, int EPI>
cudaError_t launch_tc(const Operand& a, const Operand& b, int M, int N, int K, int batch,
                      const TcOut& out, cudaStream_t stream) {
  const int smem = tc_smem_bytes<HIGH>();
  CUtensorMap ah, al, bh, bl;
  cudaError_t err;
  if ((err = make_map(&ah, a.hi, a.k, a.rows, a.images, a.pitch, a.bstride)) != cudaSuccess) return err;
  if ((err = make_map(&bh, b.hi, b.k, b.rows, b.images, b.pitch, b.bstride)) != cudaSuccess) return err;
  al = ah;
  bl = bh;
  if (HIGH) {
    if ((err = make_map(&al, a.lo, a.k, a.rows, a.images, a.pitch, a.bstride)) != cudaSuccess) return err;
    if ((err = make_map(&bl, b.lo, b.k, b.rows, b.images, b.pitch, b.bstride)) != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(tc_gemm_kernel<HIGH, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // Two blocks an SM: one's epilogue and prologue overlap the other's products.
  err = cudaFuncSetAttribute(tc_gemm_kernel<HIGH, EPI>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  for (int z0 = 0; z0 < batch; z0 += MAX_GRID_Z) {
    const int nz = (batch - z0 < MAX_GRID_Z) ? (batch - z0) : MAX_GRID_Z;
    const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, nz);
    tc_gemm_kernel<HIGH, EPI><<<grid, TC_THREADS, smem, stream>>>(
        ah, al, bh, bl, M, N, K, a.images > 1, b.images > 1, z0, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

inline int pad8(int n) { return (n + 7) / 8 * 8; }

// The split pass and the four stages of one propagate on the tensor cores.
// f: the block factors' bf16 planes F1 hi, lo, G2 hi, lo, F3 hi, lo, G4 hi,
// lo. scratch: S1 hi, lo, T hi, lo, U1 hi, lo (X^T lives in U1's planes
// until stage 3 writes U1).
template <bool HIGH, int EPI2, int EPI4>
cudaError_t propagate_tc(const float* xre, const float* xim, int batch, int h, int w, int fh,
                         int fw, const void* const* f, const float* e0, const float* e1,
                         const float* dist, float gcoef, void* const* scratch, float* yre,
                         float* yim, cudaStream_t stream) {
  typedef __nv_bfloat16 bf;
  const int px = pad8(2 * h), ps = pad8(2 * w), pt = pad8(2 * fh), pu = pad8(2 * fw);
  const Operand xt = {scratch[4], scratch[5], 2 * h, w, batch, px, (long long)w * px};
  const Operand s1 = {scratch[0], scratch[1], 2 * w, fh, batch, ps, (long long)fh * ps};
  const Operand tt = {scratch[2], scratch[3], 2 * fh, fw, batch, pt, (long long)fw * pt};
  const Operand u1 = {scratch[4], scratch[5], 2 * fw, h, batch, pu, (long long)h * pu};
  const Operand f1 = {f[0], f[1], 2 * h, 2 * fh, 1, px, (long long)2 * fh * px};
  const Operand g2 = {f[2], f[3], 2 * w, 2 * fw, 1, ps, (long long)2 * fw * ps};
  const Operand f3 = {f[4], f[5], 2 * fh, 2 * h, 1, pt, (long long)2 * h * pt};
  const Operand g4 = {f[6], f[7], 2 * fw, 2 * w, 1, pu, (long long)2 * w * pu};
  auto to = [&](const Operand& o) {
    TcOut t = {};
    t.hi = static_cast<bf*>(const_cast<void*>(o.hi));
    t.lo = static_cast<bf*>(const_cast<void*>(o.lo));
    t.bstride = o.bstride;
    t.pitch = o.pitch;
    t.e0 = e0;
    t.e1 = e1;
    t.dist = dist;
    t.gcoef = gcoef;
    t.yre = yre;
    t.yim = yim;
    return t;
  };
  cudaError_t err;
  for (int z0 = 0; z0 < batch; z0 += MAX_GRID_Z) {
    const int nz = (batch - z0 < MAX_GRID_Z) ? (batch - z0) : MAX_GRID_Z;
    const dim3 grid((w + 31) / 32, (2 * h + 31) / 32, nz);
    split_transpose_kernel<HIGH><<<grid, dim3(32, 8), 0, stream>>>(
        xre, xim, h, w, z0, static_cast<bf*>(scratch[4]), static_cast<bf*>(scratch[5]), px, xt.bstride);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // Stage 1: [S1r; S1i] (2fh, w) = [Ar -Ai; Ai Ar] . [xr; xi]  -> S1 = [S1r | S1i].
  err = launch_tc<HIGH, TE_LEFT>(f1, xt, 2 * fh, w, 2 * h, batch, to(s1), stream);
  if (err != cudaSuccess) return err;
  // Stage 2: (S1r + i S1i) . B, re/im columns interleaved, times H -> T^T = [Tr | Ti] along K.
  err = launch_tc<HIGH, EPI2>(s1, g2, fh, 2 * fw, 2 * w, batch, to(tt), stream);
  if (err != cudaSuccess) return err;
  // Stage 3: [U1r; U1i] (2h, fw) = [Cr -Ci; Ci Cr] . [Tr; Ti]  -> U1 = [U1r | U1i].
  err = launch_tc<HIGH, TE_LEFT>(f3, tt, 2 * h, fw, 2 * fh, batch, to(u1), stream);
  if (err != cudaSuccess) return err;
  // Stage 4: (U1r + i U1i) . D, re/im columns interleaved [times the phasor] -> y.
  return launch_tc<HIGH, EPI4>(u1, g4, h, 2 * w, 2 * fw, batch, to(u1), stream);
}

}  // namespace

extern "C" {

// Constant distance: H = hre + i him (fh, fw), global phasor folded in.
// `highest`: f0..f7 are the fp32 re/im planes of A, B, C, D, and the six
// scratch buffers fp32 S1, T, U1 re/im. `high`/`bf16`: f0..f7 are the bf16
// hi/lo planes of the stacked block factors F1, G2, F3, G4
// (`asm_cuda._block_factor_tensors`), and the scratch buffers hold the bf16
// hi/lo operand planes (each at least as large as both layouts need).
int asm_const(int precision, const float* xre, const float* xim, int batch, int h, int w,
              int fh, int fw,
              const void* f0, const void* f1, const void* f2, const void* f3,
              const void* f4, const void* f5, const void* f6, const void* f7,
              const float* hre, const float* him,
              void* s1re, void* s1im, void* tre, void* tim, void* u1re, void* u1im,
              float* yre, float* yim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* f[8] = {f0, f1, f2, f3, f4, f5, f6, f7};
  void* scratch[6] = {s1re, s1im, tre, tim, u1re, u1im};
  cudaError_t err;
  switch (precision) {
    case PREC_HIGHEST:
      err = propagate_fp32<EPI_PLANE, EPI_NONE>(
          xre, xim, batch, h, w, fh, fw, reinterpret_cast<const float* const*>(f), hre, him,
          nullptr, 0.f, reinterpret_cast<float* const*>(scratch), yre, yim, st);
      break;
    case PREC_HIGH:
      err = propagate_tc<true, TE_PLANE_T, TE_Y>(xre, xim, batch, h, w, fh, fw, f, hre, him,
                                                 nullptr, 0.f, scratch, yre, yim, st);
      break;
    case PREC_BF16:
      err = propagate_tc<false, TE_PLANE_T, TE_Y>(xre, xim, batch, h, w, fh, fw, f, hre, him,
                                                  nullptr, 0.f, scratch, yre, yim, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Per-image distance dist (batch,), kz_rel (fh, fw); gcoef = fp32(2 pi / lambda).
// The factor and scratch pointers as for asm_const.
int asm_dynamic(int precision, const float* xre, const float* xim, int batch, int h, int w,
                int fh, int fw,
                const void* f0, const void* f1, const void* f2, const void* f3,
                const void* f4, const void* f5, const void* f6, const void* f7,
                const float* kz, const float* dist, float gcoef,
                void* s1re, void* s1im, void* tre, void* tim, void* u1re, void* u1im,
                float* yre, float* yim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* f[8] = {f0, f1, f2, f3, f4, f5, f6, f7};
  void* scratch[6] = {s1re, s1im, tre, tim, u1re, u1im};
  cudaError_t err;
  switch (precision) {
    case PREC_HIGHEST:
      err = propagate_fp32<EPI_KZ, EPI_PHASOR>(
          xre, xim, batch, h, w, fh, fw, reinterpret_cast<const float* const*>(f), kz, nullptr,
          dist, gcoef, reinterpret_cast<float* const*>(scratch), yre, yim, st);
      break;
    case PREC_HIGH:
      err = propagate_tc<true, TE_KZ_T, TE_PHASOR_Y>(xre, xim, batch, h, w, fh, fw, f, kz,
                                                     nullptr, dist, gcoef, scratch, yre, yim, st);
      break;
    case PREC_BF16:
      err = propagate_tc<false, TE_KZ_T, TE_PHASOR_Y>(xre, xim, batch, h, w, fh, fw, f, kz,
                                                      nullptr, dist, gcoef, scratch, yre, yim, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
