// Causal flash-attention backward for Hopper (sm_90a), bf16 in, f32 sums.
//
// Replaces: ray_tpu/ops/attention.py::_flash_bwd_fused_kernel (launched by
// _flash_attention_bwd_impl through pl.pallas_call), with the delta
// reduction that _flash_attention_bwd_impl computes beside it. Same
// function and the same rounding points:
//   delta = rowsum(dO * O) in f32,
//   qs    = bf16(q * scale * log2(e)),   s = qs . k^T in f32 (base 2),
//   p     = exp2(s - lse) (lse in base 2 from the forward), masked to 0,
//   dV   += bf16(p)^T . dO,
//   dP    = dO . V^T,   dS = bf16(p * (dP - delta)),
//   dK   += dS^T . q,   dQ += dS . k,
// and dK, dQ are multiplied by `scale` in f32 when they are written.
//
// The TPU kernel walks the k blocks in order on one core and carries dQ in
// a VMEM scratch from one grid step to the next. CUDA blocks run in
// parallel, so nothing may carry over between them. Here the work is split
// in two passes that own disjoint outputs, which makes the result
// deterministic (no atomics, no zero-initialised f32 buffer; reruns are
// bit-equal):
//   (a) flash_bwd_dq_kernel: one CTA per (b, h, 64-row q tile), walking the
//       64-row k tiles up to the diagonal. It also computes delta for its
//       rows (from the O and dO tiles it holds) and writes it out;
//   (b) flash_bwd_dkdv_kernel: one CTA per (b, h, 64-row k tile), walking
//       the 64-row q tiles from the diagonal to the last, with the delta
//       that (a) wrote.
// s and p are computed in both passes: seven products where a fused sweep
// would do five, and reruns stay bit-equal without ordering any additions.
//
// What bounds it on an H100: at the training shape (B=8, H=12, S=1024,
// D=64) the five products over the S(S+1)/2 causal pairs are 32 GFLOP (33
// us at 989 TFLOP/s) against about 100 MB of inputs and outputs (30 us at
// 3.35 TB/s): operations-bound on paper. The tensor cores reach that rate
// only through wgmma, fed from shared memory without stalling the threads
// that do the exponentials.
//
// What the design does about it (warp specialisation, TMA, wgmma). Each
// CTA has one consumer warpgroup and one producer warp; two CTAs share an
// SM, so that one's exponentials run while the other's products do. The
// producer issues TMA copies of 64-row boxes into 128-byte-swizzled
// shared-memory tiles: the CTA's own rows once, then the streamed tiles
// into a two-stage ring with a full and an empty mbarrier per stage. Rows
// past S arrive as zeros. Every product is a wgmma with f32 accumulators
// in registers:
//   (a) scales its Q tile in place to Qs and streams K and V: S = Qs K^T and
//       dP = dO V^T with both operands K-major in shared memory, then
//       dQ += dS K with dS as register A fragments and K read MN-major;
//   (b) holds K and V in shared memory and streams q, dO (and lse, delta,
//       which the producer's lanes copy with plain loads: a row of a ragged
//       S need not start 16-byte aligned). Per q tile (FA3's transposed
//       form): S^T = K Qs^T and dP^T = V dO^T (Qs: the consumers scale the
//       q tile into a tile of their own), then P^T and dS^T in registers,
//       then dV += P^T dO and dK += dS^T q, issued together, with P^T and
//       dS^T as register A fragments and dO and the unscaled q read
//       MN-major. (Issuing dV while dS^T was still being computed made
//       ptxas serialise the products for want of registers, and was slower.)
// dQ, dK and dV go through shared memory to TMA stores that drop rows past
// S. Only tiles that cross the diagonal, or hold rows past a ragged S, pay
// for the mask.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, H, S, 64] with any batch, head
// and row strides (in elements, multiples of 8) and a unit stride on the
// last dim; rows must be 16-byte aligned. lse and delta are contiguous f32
// [B, H, S]. Any S >= 1 runs.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;     // head dim
constexpr int kTile = 64;  // rows of every q or k tile: one consumer warpgroup's
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kStages = 2;
constexpr int kThreads = 128 + 32;  // the consumer warpgroup, then the producer warp
constexpr int kCtasPerSm = 2;       // at most 204 registers a thread

struct BwdParams {
  CUtensorMap tq, tk, tv, to, tdo, tdq, tdk, tdv;
  const float* lse;
  float* delta;
  int H, S;
  float qscale;  // softmax scale * log2(e)
  float scale;   // softmax scale
};

// ---- (a) dQ and delta: one CTA per (b, h, 64 q rows) ----

namespace dq_pass {
constexpr int kOffQ = 0;
constexpr int kOffDo = kOffQ + kTileBytes;
constexpr int kOffO = kOffDo + kTileBytes;
constexpr int kOffK = kOffO + kTileBytes;               // [kStages] k tiles
constexpr int kOffV = kOffK + kStages * kTileBytes;     // [kStages] v tiles
constexpr int kOffBar = kOffV + kStages * kTileBytes;
constexpr int kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
}  // namespace dq_pass

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  using namespace dq_pass;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bar_rows = base + kOffBar;
  auto bar_f = [&](int s) { return bar_rows + 8 * (1 + s); };
  auto bar_e = [&](int s) { return bar_rows + 8 * (1 + kStages + s); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q tiles (the last) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kTile;
  const int n_tiles = qt + 1;  // k tiles up to the diagonal one

  if (threadIdx.x == 0) {
    mbar_init(bar_rows, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 4);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // The producer warp: one thread issues every TMA load.
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(bar_rows, 3 * kTileBytes);
      tma_load_rows(base + kOffQ, &p.tq, bar_rows, q0, h, b);
      tma_load_rows(base + kOffDo, &p.tdo, bar_rows, q0, h, b);
      tma_load_rows(base + kOffO, &p.to, bar_rows, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(bar_e(s), (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(bar_f(s), 2 * kTileBytes);
        tma_load_rows(base + kOffK + s * kTileBytes, &p.tk, bar_f(s), j * kTile, h, b);
        tma_load_rows(base + kOffV + s * kTileBytes, &p.tv, bar_f(s), j * kTile, h, b);
      }
    }
    return;
  }

  const int tw = threadIdx.x;
  const int lane = tw % 32;
  const int t = lane % 4;
  const int r0 = 16 * (tw / 32) + lane / 4;  // this thread's q rows r0 and r0 + 8 of the tile
  const int row_a = q0 + r0;
  const int row_b = row_a + 8;
  const uint32_t sq = base + kOffQ;
  const uint32_t sdo = base + kOffDo;
  const long long bh_row = (static_cast<long long>(b) * p.H + h) * p.S;
  const float lse_a = row_a < p.S ? p.lse[bh_row + row_a] : 0.f;
  const float lse_b = row_b < p.S ? p.lse[bh_row + row_b] : 0.f;

  mbar_wait(bar_rows, 0);
  // delta = rowsum(dO * O) in f32: the 4 threads of a row group take 16
  // columns each, in a fixed order, so reruns are bit-equal.
  float delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float sum = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t off = swz(r, 16 * t + 8 * half);
      const uint4 dv = *reinterpret_cast<const uint4*>(sbase + kOffDo + off);
      const uint4 ov = *reinterpret_cast<const uint4*>(sbase + kOffO + off);
      const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        sum += __uint_as_float(dw[w] << 16) * __uint_as_float(ow[w] << 16);
        sum += __uint_as_float(dw[w] & 0xffff0000u) * __uint_as_float(ow[w] & 0xffff0000u);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[i] = sum;
  }
  if (t == 0) {
    if (row_a < p.S) p.delta[bh_row + row_a] = delta[0];
    if (row_b < p.S) p.delta[bh_row + row_b] = delta[1];
  }
  // Qs = bf16(q qscale) in place over the Q tile.
  scale_tile(sbase + kOffQ, sbase + kOffQ, p.qscale, tw);
  fence_proxy_async();
  named_bar_sync(1, 128);

  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t par = (j / kStages) & 1;
    const uint32_t sk = base + kOffK + s * kTileBytes;
    const uint32_t sv = base + kOffV + s * kTileBytes;
    mbar_wait(bar_f(s), par);
    __syncwarp();

    // S = Qs K^T and dP = dO V^T: [64 q rows x 64 keys] each.
    float sp[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n64(sp, desc_sw128(sq + 32 * kk), desc_sw128(sk + 32 * kk), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n64(dp, desc_sw128(sdo + 32 * kk), desc_sw128(sv + 32 * kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sp);

    // P = exp2(S - lse), zero past the diagonal (which covers keys past S).
    const int k0 = j * kTile;
    const bool masked = j == qt;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sp[4 * n] = fast_exp2(sp[4 * n] - lse_a);
      sp[4 * n + 1] = fast_exp2(sp[4 * n + 1] - lse_a);
      sp[4 * n + 2] = fast_exp2(sp[4 * n + 2] - lse_b);
      sp[4 * n + 3] = fast_exp2(sp[4 * n + 3] - lse_b);
      if (masked) {
        const int col = k0 + 8 * n + 2 * t;
        if (col > row_a) sp[4 * n] = 0.f;
        if (col + 1 > row_a) sp[4 * n + 1] = 0.f;
        if (col > row_b) sp[4 * n + 2] = 0.f;
        if (col + 1 > row_b) sp[4 * n + 3] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P * (dP - delta), then dQ += bf16(dS) K, K read MN-major.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      dp[4 * n] = sp[4 * n] * (dp[4 * n] - delta[0]);
      dp[4 * n + 1] = sp[4 * n + 1] * (dp[4 * n + 1] - delta[0]);
      dp[4 * n + 2] = sp[4 * n + 2] * (dp[4 * n + 2] - delta[1]);
      dp[4 * n + 3] = sp[4 * n + 3] * (dp[4 * n + 3] - delta[1]);
    }
    uint32_t dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a_frag(dsf[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64<1>(dq_acc, dsf[kk], desc_sw128(sk + 2048 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    if (lane == 0) mbar_arrive(bar_e(s));  // this warp is done with the stage
  }

  // dQ (times scale) through the Q tile, then one TMA store.
  named_bar_sync(1, 128);
  store_acc_tile(sbase + kOffQ, dq_acc, p.scale, p.scale, r0, t);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (tw == 0) {
    tma_store_rows(&p.tdq, sq, q0, h, b);
    tma_store_wait();
  }
}

// ---- (b) dK/dV: one CTA per (b, h, 64 k rows) ----

namespace dkdv_pass {
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kTileBytes;
constexpr int kOffQ = kOffV + kTileBytes;                 // [kStages] q tiles
constexpr int kOffDo = kOffQ + kStages * kTileBytes;      // [kStages] dO tiles
constexpr int kOffQs = kOffDo + kStages * kTileBytes;     // [2] scaled q tiles
constexpr int kOffLse = kOffQs + 2 * kTileBytes;          // [kStages][64] f32
constexpr int kOffDelta = kOffLse + kStages * kTile * 4;  // [kStages][64] f32
constexpr int kOffBar = kOffDelta + kStages * kTile * 4;
constexpr int kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
}  // namespace dkdv_pass

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    flash_bwd_dkdv_kernel(const __grid_constant__ BwdParams p) {
  using namespace dkdv_pass;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bar_kv = base + kOffBar;
  auto bar_f = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto bar_e = [&](int s) { return bar_kv + 8 * (1 + kStages + s); };
  float* const s_lse = reinterpret_cast<float*>(sbase + kOffLse);
  float* const s_delta = reinterpret_cast<float*>(sbase + kOffDelta);

  const int kt = blockIdx.x;  // heaviest k tiles (the first) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kTile;
  const int n_q = (p.S + kTile - 1) / kTile;  // q tiles kt .. n_q - 1 reach these keys

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 32);  // the producer warp's lanes, after their lse/delta copies
      mbar_init(bar_e(s), 4);   // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // The producer warp: lane 0 issues the TMA loads, every lane copies lse/delta.
    const int lane = threadIdx.x % 32;
    const long long bh_row = (static_cast<long long>(b) * p.H + h) * p.S;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * kTileBytes);
      tma_load_rows(base + kOffK, &p.tk, bar_kv, k0, h, b);
      tma_load_rows(base + kOffV, &p.tv, bar_kv, k0, h, b);
    }
    for (int it = 0; kt + it < n_q; ++it) {
      const int s = it % kStages;
      const int q0 = (kt + it) * kTile;
      if (it >= kStages) mbar_wait(bar_e(s), (it / kStages - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(bar_f(s), 2 * kTileBytes);
        tma_load_rows(base + kOffQ + s * kTileBytes, &p.tq, bar_f(s), q0, h, b);
        tma_load_rows(base + kOffDo + s * kTileBytes, &p.tdo, bar_f(s), q0, h, b);
      }
      for (int r = lane; r < kTile; r += 32) {
        const bool valid = q0 + r < p.S;
        s_lse[s * kTile + r] = valid ? p.lse[bh_row + q0 + r] : 0.f;
        s_delta[s * kTile + r] = valid ? p.delta[bh_row + q0 + r] : 0.f;
      }
      mbar_arrive(bar_f(s));
    }
    return;
  }

  const int tw = threadIdx.x;
  const int lane = tw % 32;
  const int t = lane % 4;
  const int r0 = 16 * (tw / 32) + lane / 4;  // this thread's key rows r0 and r0 + 8 of the tile
  const int key_a = k0 + r0;
  const int key_b = key_a + 8;
  const uint32_t sk = base + kOffK;
  const uint32_t sv = base + kOffV;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int it = 0; kt + it < n_q; ++it) {
    const int s = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int q0 = (kt + it) * kTile;
    const uint32_t sq = base + kOffQ + s * kTileBytes;
    const uint32_t sdo = base + kOffDo + s * kTileBytes;
    // Double-buffered: a warp may still read the previous tile's Qs.
    const uint32_t sqs = base + kOffQs + (it & 1) * kTileBytes;
    const float* lse = s_lse + s * kTile;
    const float* delta = s_delta + s * kTile;
    mbar_wait(bar_f(s), par);

    scale_tile(sbase + (sqs - base), sbase + (sq - base), p.qscale, tw);  // Qs = bf16(q qscale)
    fence_proxy_async();
    named_bar_sync(1, 128);

    // S^T = K Qs^T and dP^T = V dO^T: [64 keys x 64 q rows] each.
    float pt[32], dst[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n64(pt, desc_sw128(sk + 32 * kk), desc_sw128(sqs + 32 * kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n64(dst, desc_sw128(sv + 32 * kk), desc_sw128(sdo + 32 * kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pt);
    fence_regs(dst);

    // P^T = exp2(S^T - lse[q]), zero where q < key or q >= S; then
    // dS^T = P^T * (dP^T - delta[q]) in place of dP^T.
    const bool masked = it == 0 || q0 + kTile > p.S;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + c);
      pt[4 * n] = fast_exp2(pt[4 * n] - l2.x);
      pt[4 * n + 1] = fast_exp2(pt[4 * n + 1] - l2.y);
      pt[4 * n + 2] = fast_exp2(pt[4 * n + 2] - l2.x);
      pt[4 * n + 3] = fast_exp2(pt[4 * n + 3] - l2.y);
      if (masked) {
        const int qa = q0 + c;
        const int qb = qa + 1;
        if (qa < key_a || qa >= p.S) pt[4 * n] = 0.f;
        if (qb < key_a || qb >= p.S) pt[4 * n + 1] = 0.f;
        if (qa < key_b || qa >= p.S) pt[4 * n + 2] = 0.f;
        if (qb < key_b || qb >= p.S) pt[4 * n + 3] = 0.f;
      }
      dst[4 * n] = pt[4 * n] * (dst[4 * n] - d2.x);
      dst[4 * n + 1] = pt[4 * n + 1] * (dst[4 * n + 1] - d2.y);
      dst[4 * n + 2] = pt[4 * n + 2] * (dst[4 * n + 2] - d2.x);
      dst[4 * n + 3] = pt[4 * n + 3] * (dst[4 * n + 3] - d2.y);
    }

    // dV += bf16(P^T) dO and dK += bf16(dS^T) q, dO and q read MN-major.
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a_frag(pf[kk], pt, kk);
      acc_to_a_frag(dsf[kk], dst, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64<1>(dv, pf[kk], desc_sw128(sdo + 2048 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64<1>(dk, dsf[kk], desc_sw128(sq + 2048 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(bar_e(s));  // this warp is done with the stage
  }

  // dK (times scale) and dV through the K and V tiles, then TMA stores.
  named_bar_sync(1, 128);
  store_acc_tile(sbase + kOffK, dk, p.scale, p.scale, r0, t);
  store_acc_tile(sbase + kOffV, dv, 1.f, 1.f, r0, t);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (tw == 0) {
    tma_store_rows(&p.tdk, sk, k0, h, b);
    tma_store_rows(&p.tdv, sv, k0, h, b);
    tma_store_wait();
  }
}

}  // namespace

extern "C" {

// Launch the two passes on `stream`, in order; returns the first nonzero
// cudaGetLastError() (0 on success), or kTensorMapError + i if the driver
// refuses the i-th tensor map (q, k, v, o, dO, dq, dk, dv). lse is the
// forward's contiguous f32 [B, H, S]; delta is contiguous f32 [B, H, S]
// scratch that this call fills. Strides are in elements.
int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H,
                   int S, int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                   long long o_sb, long long o_sh, long long o_ss, long long do_sb,
                   long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
                   long long dq_ss, long long dk_sb, long long dk_sh, long long dk_ss,
                   long long dv_sb, long long dv_sh, long long dv_ss, float scale,
                   float qscale, void* stream) {
  if (D != kD || B < 1 || H < 1 || S < 1 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Set the kernels' shared-memory limits first: that runtime call also makes
  // the device's context current on this thread, which the driver's
  // tensor-map encoder needs (an autograd worker thread may not have it yet).
  const cudaFuncAttribute smem_limit = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel, smem_limit, dq_pass::kSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel, smem_limit, dkdv_pass::kSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdParams p;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  CUtensorMap* maps[8] = {&p.tq, &p.tk, &p.tv, &p.to, &p.tdo, &p.tdq, &p.tdk, &p.tdv};
  const long long strides[8][3] = {{q_sb, q_sh, q_ss},    {k_sb, k_sh, k_ss},
                                   {v_sb, v_sh, v_ss},    {o_sb, o_sh, o_ss},
                                   {do_sb, do_sh, do_ss}, {dq_sb, dq_sh, dq_ss},
                                   {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss}};
  for (int i = 0; i < 8; ++i) {
    const CUresult r =
        make_rows_map(maps[i], ptrs[i], B, H, S, strides[i][0], strides[i][1], strides[i][2]);
    if (r != CUDA_SUCCESS) return tensor_map_error(i, r);
  }
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.H = H;
  p.S = S;
  p.qscale = qscale;
  p.scale = scale;

  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_bwd_dq_kernel<<<grid, kThreads, dq_pass::kSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<grid, kThreads, dkdv_pass::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tiles every launch uses: out[0], out[1] are the dK/dV pass's k rows
// per CTA and q rows per tile; out[2], out[3] the dQ pass's q rows per CTA
// and k rows per tile.
void flash_bwd_tile_rows(int* out) {
  out[0] = out[1] = out[2] = out[3] = kTile;
}

const char* flash_bwd_error_string(int code) {
  static const char* const kOperands[] = {"q", "k", "v", "o", "dO", "dq", "dk", "dv"};
  return error_string(code, kOperands);
}

}  // extern "C"
