// Causal flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: ray_tpu/ops/attention.py::_flash_fwd_kernel (launched by
// _flash_attention_fwd_impl through pl.pallas_call). Same function: q is
// pre-scaled by scale*log2(e) in f32 and rounded back to bf16 (as the TPU
// kernel does at attention.py:69), scores run through an online softmax in
// base 2 (exp2), tiles below the diagonal run unmasked and the tiles that
// cross it are masked with -1e30, O is written in bf16 and the per-row
// log-sum-exp in base-2 units as f32 [B, H, S].
//
// What bounds it on an H100: two products over the S(S+1)/2 causal pairs
// against q/k/v/O read or written once. At the training shape (B=8, H=12,
// S=1024, D=64) that is 12.9 GFLOP (13 us at 989 TFLOP/s) against 50 MB
// (15 us at 3.35 TB/s); the 50 M exponentials need about as long again on
// the SFUs (16 a clock per SM). At serving's B=1 the grid is small and a
// launch of a few microseconds dominates. Per-warp mma.sync from register
// fragments, tiles loaded thread by thread and the whole block stalled on
// each tile ran at a small fraction of either bound.
//
// What the design does about it (warp specialisation, TMA, wgmma):
// - One CTA per (b, h, 64-row q tile), heaviest q tiles issued first: one
//   consumer warpgroup and one producer warp, three CTAs to an SM, so that
//   one CTA's exponentials run while another's products do. (Measured on
//   the card: 128-row q tiles with two consumer warpgroups a CTA, which a
//   ping-pong between them would need, were slower at every shape, and
//   overlapping a warpgroup's own softmax with its P V product made ptxas
//   insert waits and was slower too; PERF.md.)
// - The producer warp issues every load as a TMA copy of 64-row boxes into
//   128-byte-swizzled shared-memory tiles: the Q tile once, then 128-row K
//   and V tiles into a two-stage ring. Each stage has a full barrier for K,
//   one for V (an mbarrier counting the copy's bytes) and an empty barrier
//   that the consumer warps arrive on when they are done with it. Rows past
//   S arrive as zeros (the tensor map's dims end at S), so a strided head
//   view never reads another batch's rows.
// - The consumers scale Q in place to Qs = bf16(q * qscale) once. S = Qs K^T
//   is a wgmma with both operands K-major in shared memory; the online
//   softmax runs on the f32 accumulator in registers (exp2 on the SFU);
//   O += P V is a wgmma with P from registers (the S accumulator packed
//   pairwise to bf16 is already the A fragment) and V read MN-major. Only
//   tiles that cross the diagonal (which covers the ragged edge: a column
//   past S lies past every valid row) pay for the mask.
// - O is written through shared memory (the Q tile, swizzled) by a TMA
//   store that drops rows past S; the LSE by plain stores, since a row of a
//   ragged S need not start 16-byte aligned.
//
// Layout: q, k, v, o are [B, H, S, 64] with any batch/head/seq strides (in
// elements, multiples of 8) and a unit stride on the last dim; rows must be
// 16-byte aligned. Any S >= 1 runs.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;         // head dim
constexpr int kBlockM = 64;    // q rows per CTA: one consumer warpgroup
constexpr int kBlockN = 128;   // k/v rows per tile
constexpr int kStages = 2;
constexpr int kThreads = 128 + 32;  // the consumer warpgroup, then the producer warp
constexpr int kCtasPerSm = 3;       // at most 136 registers a thread
constexpr float kNegInf = -1e30f;

// Shared memory, from a 1024-byte-aligned base.
constexpr int kKVBytes = kBlockN * kRowBytes;
constexpr int kOffK = kBlockM * kRowBytes;  // the Q tile comes first
constexpr int kOffV = kOffK + kStages * kKVBytes;
constexpr int kOffBar = kOffV + kStages * kKVBytes;
constexpr int kSmem = kOffBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack

struct FwdParams {
  CUtensorMap tq, tk, tv, to;
  float* lse;
  int H;
  int S;
  float qscale;  // softmax scale * log2(e)
};

// Mask the scores of the K/V tile starting at column k0 where they lie past
// the diagonal (only a tile that crosses it), then one online-softmax step:
// sc becomes exp2(sc - m_new), m and the partial row sums l are updated.
// Returns the factors (rows r0, r0 + 8) the O accumulator must be rescaled by.
__device__ __forceinline__ float2 softmax_step(float (&sc)[kBlockN / 2], float (&m)[2],
                                               float (&l)[2], int k0, int q0, int row_a,
                                               int row_b, int t) {
  if (k0 + kBlockN - 1 > q0) {  // some column of this tile lies past some row of ours
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      const int col = k0 + 8 * n + 2 * t;
      if (col > row_a) sc[4 * n] = kNegInf;
      if (col + 1 > row_a) sc[4 * n + 1] = kNegInf;
      if (col > row_b) sc[4 * n + 2] = kNegInf;
      if (col + 1 > row_b) sc[4 * n + 3] = kNegInf;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
    mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
  }
  const float2 alpha = make_float2(fast_exp2(m[0] - mx[0]), fast_exp2(m[1] - mx[1]));
  m[0] = mx[0];
  m[1] = mx[1];
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    sc[4 * n] = fast_exp2(sc[4 * n] - mx[0]);
    sc[4 * n + 1] = fast_exp2(sc[4 * n + 1] - mx[0]);
    sc[4 * n + 2] = fast_exp2(sc[4 * n + 2] - mx[1]);
    sc[4 * n + 3] = fast_exp2(sc[4 * n + 3] - mx[1]);
    rs0 += sc[4 * n] + sc[4 * n + 1];
    rs1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
  l[0] = l[0] * alpha.x + rs0;
  l[1] = l[1] * alpha.y + rs1;
  return alpha;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles need 1024-byte alignment
  uint8_t* const sq = smem_raw + (base - raw);  // the Q tile, then Qs, then O
  const uint32_t bar_q = base + kOffBar;
  auto bar_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto bar_e = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };
  auto sk = [&](int s) { return base + kOffK + s * kKVBytes; };
  auto sv = [&](int s) { return base + kOffV + s * kKVBytes; };

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockM;
  // K/V tiles up to the one holding this q tile's last row (and S's last row).
  const int n_tiles = min((q0 + kBlockM + kBlockN - 1) / kBlockN, (p.S + kBlockN - 1) / kBlockN);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 4);  // every consumer warp arrives once
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // The producer warp: one thread issues every TMA load.
    if (threadIdx.x == 128) {
      prefetch_tensormap(&p.tq);
      prefetch_tensormap(&p.tk);
      prefetch_tensormap(&p.tv);
      mbar_arrive_expect_tx(bar_q, kBlockM * kRowBytes);
      tma_load_rows(base, &p.tq, bar_q, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(bar_e(s), (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(bar_k(s), kKVBytes);
        for (int r = 0; r < kBlockN; r += kBoxRows) {
          tma_load_rows(sk(s) + r * kRowBytes, &p.tk, bar_k(s), j * kBlockN + r, h, b);
        }
        mbar_arrive_expect_tx(bar_v(s), kKVBytes);
        for (int r = 0; r < kBlockN; r += kBoxRows) {
          tma_load_rows(sv(s) + r * kRowBytes, &p.tv, bar_v(s), j * kBlockN + r, h, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.
  const int tw = threadIdx.x;
  const int lane = tw % 32;
  const int t = lane % 4;
  const int r0 = 16 * (tw / 32) + lane / 4;  // this thread's rows r0 and r0 + 8 of the tile
  const int row_a = q0 + r0;
  const int row_b = row_a + 8;

  // Qs = bf16(q qscale) in place, read by every S product from shared memory.
  mbar_wait(bar_q, 0);
  scale_tile(sq, sq, p.qscale, tw);
  fence_proxy_async();
  named_bar_sync(1, 128);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t par = (j / kStages) & 1;

    // S = Qs K^T: [64 x kBlockN] base-2 logits.
    float sc[kBlockN / 2];
    mbar_wait(bar_k(s), par);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n128(sc, desc_sw128(base + 32 * kk), desc_sw128(sk(s) + 32 * kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    const float2 alpha = softmax_step(sc, m, l, j * kBlockN, q0, row_a, row_b, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[4 * n] *= alpha.x;
      o[4 * n + 1] *= alpha.x;
      o[4 * n + 2] *= alpha.y;
      o[4 * n + 3] *= alpha.y;
    }

    // O += P V: P (bf16) from registers, V MN-major from shared memory.
    uint32_t pf[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) acc_to_a_frag(pf[kk], sc, kk);
    mbar_wait(bar_v(s), par);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_rs_n64<1>(o, pf[kk], desc_sw128(sv(s) + 2048 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(bar_e(s));  // this warp is done with the stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (t == 0) {
    float* lg = p.lse + (static_cast<long long>(b) * p.H + h) * p.S;
    if (row_a < p.S) lg[row_a] = m[0] + log2f(l[0]);
    if (row_b < p.S) lg[row_b] = m[1] + log2f(l[1]);
  }
  // O through the Q tile in shared memory, then one TMA store.
  named_bar_sync(1, 128);  // every warp's last S product has read Qs
  store_acc_tile(sq, o, 1.f / l[0], 1.f / l[1], r0, t);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (tw == 0) {
    tma_store_rows(&p.to, base, q0, h, b);
    tma_store_wait();
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// kTensorMapError + i if the driver refuses the i-th tensor map (q, k, v,
// o). lse is a contiguous f32 [B, H, S]; strides are in elements.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int S, int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                   long long o_sb, long long o_sh, long long o_ss, float qscale, void* stream) {
  if (D != kD || B < 1 || H < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  // Set the kernel's shared-memory limit first: that runtime call also makes
  // the device's context current on this thread, which the driver's
  // tensor-map encoder needs (an autograd worker thread may not have it yet).
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdParams p;
  const void* ptrs[4] = {q, k, v, o};
  CUtensorMap* maps[4] = {&p.tq, &p.tk, &p.tv, &p.to};
  const long long strides[4][3] = {
      {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}};
  for (int i = 0; i < 4; ++i) {
    const CUresult r =
        make_rows_map(maps[i], ptrs[i], B, H, S, strides[i][0], strides[i][1], strides[i][2]);
    if (r != CUDA_SUCCESS) return tensor_map_error(i, r);
  }
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.S = S;
  p.qscale = qscale;
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tiles every launch uses: out[0] q rows per CTA, out[1] k rows per tile.
void flash_fwd_tile_rows(int* out) {
  out[0] = kBlockM;
  out[1] = kBlockN;
}

const char* flash_fwd_error_string(int code) {
  static const char* const kOperands[] = {"q", "k", "v", "o"};
  return error_string(code, kOperands);
}

}  // extern "C"
