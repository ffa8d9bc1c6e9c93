// Causal flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: ray_tpu/ops/attention.py::_flash_fwd_kernel (launched by
// _flash_attention_fwd_impl through pl.pallas_call). Same function: q is
// pre-scaled by scale*log2(e) in f32 and rounded back to bf16 (as the TPU
// kernel does at attention.py:69), scores run through an online softmax in
// base 2 (exp2), interior k-tiles run unmasked and the diagonal tile is
// masked with -1e30, O is written in bf16 and the per-row log-sum-exp in
// base-2 units as f32 [B, H, S].
//
// What bounds it on an H100: at the shapes serving prefill gives it (B=1,
// H=12, D=64, S=32..2048) the work is small. At S=1024 it is about 1.6
// GFLOP against 6.3 MB of q/k/v/o: 1.6 us at 989 TFLOP/s, 1.9 us at
// 3.35 TB/s. So it is memory- and launch-bound, and at short S a launch of
// a few microseconds dominates.
//
// What the design does about it: each CTA owns one (b, h, 64-row q tile),
// keeps its Q fragments in registers, and streams 64-row K/V tiles through
// a two-stage cp.async ring in shared memory, so q/k/v are read from HBM
// about once per q tile and the S x S scores never leave registers. The
// k-loop stops at the diagonal; only the diagonal tile pays for the mask.
// Q tiles are issued heaviest first (the last q tile walks the most k
// tiles). Products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate). wgmma, TMA and warp specialisation are later work.
//
// Layout: q, k, v, o are [B, H, S, 64] with any batch/head/seq strides (in
// elements) and a unit stride on the last dim; rows must be 16-byte
// aligned. Ragged S is masked here: rows past S load as zeros and are never
// stored, so no divisibility is required.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBlockM = 64;    // q rows per CTA (16 per warp)
constexpr int kBlockN = 64;    // k/v rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;    // smem row pitch: 144 B, conflict-free fragment loads
constexpr float kNegInf = -1e30f;

static_assert(kBlockM == kBlockN, "tiles below the diagonal tile are interior only when square");

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  int H;
  int S;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float qscale;  // softmax scale * log2(e)
};

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> bf16x2 with `lo` in the low half (the lower column index).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM * kLd];
  __shared__ __align__(16) __nv_bfloat16 sK[2][kBlockN * kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kBlockN * kLd];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const __nv_bfloat16* qg = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = a.k + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vg = a.v + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* og = a.o + b * a.o_sb + h * a.o_sh;

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kBlockN;
    for (int c = tid; c < kBlockN * kD / 8; c += kThreads) {
      const int r = c / (kD / 8);
      const int col = (c % (kD / 8)) * 8;
      const int row = k0 + r;
      const bool valid = row < a.S;
      const long long srow = valid ? row : 0;
      cp_async16(&sK[stage][r * kLd + col], kg + srow * a.k_ss + col, valid);
      cp_async16(&sV[stage][r * kLd + col], vg + srow * a.v_ss + col, valid);
    }
  };

  load_kv(0, 0);
  cp_async_commit();

  // Q tile, pre-scaled by scale*log2(e) in f32 and rounded to bf16.
  for (int c = tid; c < kBlockM * kD / 8; c += kThreads) {
    const int r = c / (kD / 8);
    const int col = (c % (kD / 8)) * 8;
    const long long row = q0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.S) raw = *reinterpret_cast<const uint4*>(qg + row * a.q_ss + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint4 packed;
    uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pw[i] = pack_f32(__bfloat162float(e[2 * i]) * a.qscale,
                       __bfloat162float(e[2 * i + 1]) * a.qscale);
    }
    *reinterpret_cast<uint4*>(&sQ[r * kLd + col]) = packed;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    qf[kk][0] = ld32(&sQ[r0 * kLd + c0]);
    qf[kk][1] = ld32(&sQ[(r0 + 8) * kLd + c0]);
    qf[kk][2] = ld32(&sQ[r0 * kLd + c0 + 8]);
    qf[kk][3] = ld32(&sQ[(r0 + 8) * kLd + c0 + 8]);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
  const int row_a = q0 + r0;
  const int row_b = row_a + 8;

  const int n_tiles = qt + 1;  // tiles [0, qt) are interior, tile qt is the diagonal
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(st ^ 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s = q_scaled @ k^T, base-2 logits, 16 x 64 per warp.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = &sK[st][(nt * 8 + g) * kLd];
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        mma_bf16_16816(s[nt], qf[kk], ld32(kr + kk * 16 + 2 * t), ld32(kr + kk * 16 + 2 * t + 8));
      }
    }
    if (j == qt) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const int col = j * kBlockN + nt * 8 + 2 * t;
        if (col > row_a) s[nt][0] = kNegInf;
        if (col + 1 > row_a) s[nt][1] = kNegInf;
        if (col > row_b) s[nt][2] = kNegInf;
        if (col + 1 > row_b) s[nt][3] = kNegInf;
      }
    }

    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
      mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
    }
    const float alpha0 = exp2f(m_i[0] - mx[0]);
    const float alpha1 = exp2f(m_i[1] - mx[1]);
    m_i[0] = mx[0];
    m_i[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx[0]);
      s[nt][1] = exp2f(s[nt][1] - mx[0]);
      s[nt][2] = exp2f(s[nt][2] - mx[1]);
      s[nt][3] = exp2f(s[nt][3] - mx[1]);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l_i[0] = l_i[0] * alpha0 + rs0;
    l_i[1] = l_i[1] * alpha1 + rs1;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += p @ v: the score accumulators are the A fragments of P (bf16).
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const __nv_bfloat16* vr = &sV[st][(kk * 16 + 2 * t) * kLd];
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const int c = dt * 8 + g;
        mma_bf16_16816(acc[dt], pa, pack_bf16(vr[c], vr[kLd + c]),
                       pack_bf16(vr[8 * kLd + c], vr[9 * kLd + c]));
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
  }
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (row_a < a.S) {
      *reinterpret_cast<__nv_bfloat162*>(og + row_a * a.o_ss + c) =
          __floats2bfloat162_rn(acc[dt][0] / l_i[0], acc[dt][1] / l_i[0]);
    }
    if (row_b < a.S) {
      *reinterpret_cast<__nv_bfloat162*>(og + row_b * a.o_ss + c) =
          __floats2bfloat162_rn(acc[dt][2] / l_i[1], acc[dt][3] / l_i[1]);
    }
  }
  if (t == 0) {
    float* lg = a.lse + (static_cast<long long>(b) * a.H + h) * a.S;
    if (row_a < a.S) lg[row_a] = m_i[0] + log2f(l_i[0]);
    if (row_b < a.S) lg[row_b] = m_i[1] + log2f(l_i[1]);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). lse is a
// contiguous f32 [B, H, S]; strides are in elements.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int S, int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                   long long o_sb, long long o_sh, long long o_ss, float qscale, void* stream) {
  if (D != kD || B < 1 || H < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.S = S;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.qscale = qscale;
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
