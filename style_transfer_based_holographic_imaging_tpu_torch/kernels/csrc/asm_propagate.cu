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
// At 128 -> 256 that is 25.2 M complex MACs an image (about 201 MFLOP fp32)
// against 256 KB of input and output.
//
// What bounds it on this card: the arithmetic. 201 MFLOP for 256 KB of I/O is
// ~770 FLOP per byte, far above the H100's ridge in every mode. In `highest`
// mode the operands are fp32 (67 TFLOP/s on the CUDA cores): ~3 us an image.
// In `high` and `bf16` modes they are bf16 with fp32 accumulation, which the
// tensor cores run at 989 TFLOP/s dense: three products an image bound `high`
// at ~0.6 us an image and one bounds `bf16` at ~0.2 us. This design runs the
// bf16 products on the CUDA cores, so it is far from those two bounds.
// What the design does about it: each of the four products is a batched
// complex GEMM tiled through shared memory (64x64 output tile, 16-deep K
// slices, a 4x4 complex micro-tile per thread, fp32 accumulation), so every
// operand loaded from device memory is reused 64 times from shared memory and
// 4 times from registers. The factor that all images share is broadcast over
// the batch (batch stride 0). The intermediates S/T and the half products go
// through global scratch that the wrapper allocates: T is 512 KB an image,
// more than the 227 KB of shared memory a block can hold. Tensor cores
// (wgmma) for the bf16 modes, keeping intermediates on chip and a single
// launch are later work.
//
// Precision modes (the JAX package's `set_dft_precision` names), a template
// parameter:
//   PREC_HIGHEST  fp32 FMA on the fp32 operands.
//   PREC_HIGH     the bf16 hi/lo three-product split of `_make_dot`:
//                 a*b ~ ahi*bhi + ahi*blo + alo*bhi, operands rounded with
//                 __float2bfloat16_rn, products accumulated in fp32.
//   PREC_BF16     one product of bf16-rounded operands, fp32 accumulation.
//
// Each entry point launches four kernels on the caller's stream, allocates
// nothing, and returns the first non-zero cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // depth of one shared-memory slice
constexpr int TM = 4;         // output rows per thread (strided by 16)
constexpr int TN = 4;         // output columns per thread (strided by 16)
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int MAX_GRID_Z = 65535;

enum Prec { PREC_HIGHEST = 0, PREC_HIGH = 1, PREC_BF16 = 2 };
enum Epi { EPI_NONE = 0, EPI_PLANE = 1, EPI_KZ = 2, EPI_PHASOR = 3 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Complex multiply-accumulate of the micro-tile, in the precision mode.
template <int PREC>
__device__ __forceinline__ void mac_tile(float (&acc_r)[TM][TN], float (&acc_i)[TM][TN],
                                         const float (&ar)[TM], const float (&ai)[TM],
                                         const float (&br)[TN], const float (&bi)[TN]) {
  if constexpr (PREC == PREC_HIGH) {
    float arh[TM], arl[TM], aih[TM], ail[TM], brh[TN], brl[TN], bih[TN], bil[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      arh[i] = bf16_round(ar[i]);
      arl[i] = bf16_round(ar[i] - arh[i]);
      aih[i] = bf16_round(ai[i]);
      ail[i] = bf16_round(ai[i] - aih[i]);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      brh[j] = bf16_round(br[j]);
      brl[j] = bf16_round(br[j] - brh[j]);
      bih[j] = bf16_round(bi[j]);
      bil[j] = bf16_round(bi[j] - bih[j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float rr = arh[i] * brh[j] + arh[i] * brl[j] + arl[i] * brh[j];
        float ii = aih[i] * bih[j] + aih[i] * bil[j] + ail[i] * bih[j];
        float ri = arh[i] * bih[j] + arh[i] * bil[j] + arl[i] * bih[j];
        float ir = aih[i] * brh[j] + aih[i] * brl[j] + ail[i] * brh[j];
        acc_r[i][j] += rr - ii;
        acc_i[i][j] += ri + ir;
      }
    }
  } else {
    float xr[TM], xi[TM], yr[TN], yi[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      xr[i] = (PREC == PREC_BF16) ? bf16_round(ar[i]) : ar[i];
      xi[i] = (PREC == PREC_BF16) ? bf16_round(ai[i]) : ai[i];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      yr[j] = (PREC == PREC_BF16) ? bf16_round(br[j]) : br[j];
      yi[j] = (PREC == PREC_BF16) ? bf16_round(bi[j]) : bi[j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc_r[i][j] = fmaf(xr[i], yr[j], acc_r[i][j]);
        acc_r[i][j] = fmaf(-xi[i], yi[j], acc_r[i][j]);
        acc_i[i][j] = fmaf(xr[i], yi[j], acc_i[i][j]);
        acc_i[i][j] = fmaf(xi[i], yr[j], acc_i[i][j]);
      }
    }
  }
}

// Batched complex GEMM  C[z] = op(A[z] . B[z])  on re/im planes, row-major.
// A is M x K (row stride lda, batch stride sa; 0 = shared by the batch),
// B is K x N (ldb, sb), C is M x N (row stride N, batch stride sc).
// The epilogue multiplies the product elementwise by
//   EPI_PLANE:  (e0 + i e1)[m, n]                 (the constant H)
//   EPI_KZ:     exp(i dist[z] e0[m, n])           (the per-image H)
//   EPI_PHASOR: exp(i dist[z] gcoef)              (the global phasor)
template <int PREC, int EPI>
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
      mac_tile<PREC>(acc_r, acc_i, ar, ai, br, bi);
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
template <int PREC, int EPI>
cudaError_t launch_cgemm(const float* a_re, const float* a_im, long long sa, int lda,
                         const float* b_re, const float* b_im, long long sb, int ldb,
                         float* c_re, float* c_im, int M, int N, int K, int batch,
                         const float* e0, const float* e1, const float* dist, float gcoef,
                         cudaStream_t stream) {
  const long long sc = (long long)M * N;
  for (int z0 = 0; z0 < batch; z0 += MAX_GRID_Z) {
    const int nz = (batch - z0 < MAX_GRID_Z) ? (batch - z0) : MAX_GRID_Z;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nz);
    cgemm_kernel<PREC, EPI><<<grid, THREADS, 0, stream>>>(
        a_re + z0 * sa, a_im + z0 * sa, sa, lda,
        b_re + z0 * sb, b_im + z0 * sb, sb, ldb,
        c_re + z0 * sc, c_im + z0 * sc, sc, M, N, K,
        e0, e1, dist == nullptr ? nullptr : dist + z0, gcoef);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The four stages of one propagate. EPI2 is stage 2's epilogue (the transfer
// function), EPI4 stage 4's (the global phasor, or none).
template <int PREC, int EPI2, int EPI4>
cudaError_t propagate_stages(const float* xre, const float* xim, int batch, int h, int w,
                             int fh, int fw,
                             const float* are, const float* aim, const float* bre,
                             const float* bim, const float* cre, const float* cim,
                             const float* dre, const float* dim,
                             const float* e0, const float* e1, const float* dist, float gcoef,
                             float* s1re, float* s1im, float* tre, float* tim,
                             float* u1re, float* u1im, float* yre, float* yim,
                             cudaStream_t stream) {
  cudaError_t err;
  // Stage 1: S1 (fh, w) = A (fh, h) . x (h, w).
  err = launch_cgemm<PREC, EPI_NONE>(are, aim, 0, h, xre, xim, (long long)h * w, w,
                                     s1re, s1im, fh, w, h, batch,
                                     nullptr, nullptr, nullptr, 0.f, stream);
  if (err != cudaSuccess) return err;
  // Stage 2: T (fh, fw) = (S1 (fh, w) . B (w, fw)) * H.
  err = launch_cgemm<PREC, EPI2>(s1re, s1im, (long long)fh * w, w, bre, bim, 0, fw,
                                 tre, tim, fh, fw, w, batch, e0, e1, dist, gcoef, stream);
  if (err != cudaSuccess) return err;
  // Stage 3: U1 (h, fw) = C (h, fh) . T (fh, fw).
  err = launch_cgemm<PREC, EPI_NONE>(cre, cim, 0, fh, tre, tim, (long long)fh * fw, fw,
                                     u1re, u1im, h, fw, fh, batch,
                                     nullptr, nullptr, nullptr, 0.f, stream);
  if (err != cudaSuccess) return err;
  // Stage 4: y (h, w) = (U1 (h, fw) . D (fw, w)) [* global phasor].
  return launch_cgemm<PREC, EPI4>(u1re, u1im, (long long)h * fw, fw, dre, dim, 0, w,
                                  yre, yim, h, w, fw, batch, nullptr, nullptr, dist, gcoef,
                                  stream);
}

}  // namespace

extern "C" {

// Constant distance: H = hre + i him (fh, fw), global phasor folded in.
int asm_const(int precision, const float* xre, const float* xim, int batch, int h, int w,
              int fh, int fw,
              const float* are, const float* aim, const float* bre, const float* bim,
              const float* cre, const float* cim, const float* dre, const float* dim,
              const float* hre, const float* him,
              float* s1re, float* s1im, float* tre, float* tim, float* u1re, float* u1im,
              float* yre, float* yim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (precision) {
    case PREC_HIGHEST:
      err = propagate_stages<PREC_HIGHEST, EPI_PLANE, EPI_NONE>(
          xre, xim, batch, h, w, fh, fw, are, aim, bre, bim, cre, cim, dre, dim, hre, him,
          nullptr, 0.f, s1re, s1im, tre, tim, u1re, u1im, yre, yim, st);
      break;
    case PREC_HIGH:
      err = propagate_stages<PREC_HIGH, EPI_PLANE, EPI_NONE>(
          xre, xim, batch, h, w, fh, fw, are, aim, bre, bim, cre, cim, dre, dim, hre, him,
          nullptr, 0.f, s1re, s1im, tre, tim, u1re, u1im, yre, yim, st);
      break;
    case PREC_BF16:
      err = propagate_stages<PREC_BF16, EPI_PLANE, EPI_NONE>(
          xre, xim, batch, h, w, fh, fw, are, aim, bre, bim, cre, cim, dre, dim, hre, him,
          nullptr, 0.f, s1re, s1im, tre, tim, u1re, u1im, yre, yim, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Per-image distance dist (batch,), kz_rel (fh, fw); gcoef = fp32(2 pi / lambda).
int asm_dynamic(int precision, const float* xre, const float* xim, int batch, int h, int w,
                int fh, int fw,
                const float* are, const float* aim, const float* bre, const float* bim,
                const float* cre, const float* cim, const float* dre, const float* dim,
                const float* kz, const float* dist, float gcoef,
                float* s1re, float* s1im, float* tre, float* tim, float* u1re, float* u1im,
                float* yre, float* yim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (precision) {
    case PREC_HIGHEST:
      err = propagate_stages<PREC_HIGHEST, EPI_KZ, EPI_PHASOR>(
          xre, xim, batch, h, w, fh, fw, are, aim, bre, bim, cre, cim, dre, dim, kz, nullptr,
          dist, gcoef, s1re, s1im, tre, tim, u1re, u1im, yre, yim, st);
      break;
    case PREC_HIGH:
      err = propagate_stages<PREC_HIGH, EPI_KZ, EPI_PHASOR>(
          xre, xim, batch, h, w, fh, fw, are, aim, bre, bim, cre, cim, dre, dim, kz, nullptr,
          dist, gcoef, s1re, s1im, tre, tim, u1re, u1im, yre, yim, st);
      break;
    case PREC_BF16:
      err = propagate_stages<PREC_BF16, EPI_KZ, EPI_PHASOR>(
          xre, xim, batch, h, w, fh, fw, are, aim, bre, bim, cre, cim, dre, dim, kz, nullptr,
          dist, gcoef, s1re, s1im, tre, tim, u1re, u1im, yre, yim, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
