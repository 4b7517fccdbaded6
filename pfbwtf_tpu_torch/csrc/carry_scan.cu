// K5: the carry scan, the running maxima and minima of J3, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package takes J3's running maxima
// and minima from lax.cummax and lax.cummin, XLA primitives
// (pfbwtf_tpu/ops/suffix.py, bwt_jax.py, fused.py, fused_stream.py); the
// port took them from aten's torch.cummax and
// torch.cummin, whose kernel gives a 1-D tensor's one row to one thread
// block, so each scan ran serially on 1 of the card's 132 SMs: about
// 170 ms a call on the 10^8 lanes of a doubling round.
//
// Two entries (wrapper ops/cuda/carry_scan.py, plain versions and the
// dispatch by device in ops/carry.py):
//   pfbwt_carry_scan  y = the inclusive running max or min of x, int64,
//                     forward or in reverse.
//   pfbwt_posrank     one dict doubling round's positional ranks from its
//                     sorted keys cks and its permutation order:
//                     rank[order[i]] = the last j <= i that heads a group
//                     (j = 0, or cks[j] != cks[j - 1]); the number of
//                     heads is added to a device counter.
//
// What bounds it on an H100: bytes.  A carry scan reads 8 B and writes
// 8 B a lane: 16 B, 0.48 ms at 3.35 TB/s for 10^8 lanes.  posrank reads
// cks and order and writes rank, 24 B a lane, the writes scattered by
// order.  The operations (a compare and a select a lane, five shuffle
// steps for 64 lanes) are far below the bytes.
//
// What the design does about it: one pass with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA, 2016), so every lane is read once and written once.
// A block takes one tile of 4,096 lanes, its id drawn from an atomic
// counter: every earlier tile is then held by a block already running,
// so the look-back always makes progress.  Each warp reads its 512 lanes
// as 16-byte vectors, 32 vectors side by side a step (coalesced), keeps
// them in registers, scans each step with warp shuffles and carries the
// step's total to the next.  The block combines its 8 warps' totals,
// publishes the tile's aggregate and only then looks back: warp 0 reads
// 32 predecessors' status words a step and stops at the nearest tile
// that has published its inclusive prefix.  A status word is stored with
// release semantics after its value and loaded with acquire semantics
// before it.  A reverse scan walks the tiles from the end and each tile
// from its top with the same aligned 16-byte loads, so it needs no
// flipped copies.  Tiles are laid on 16-byte boundaries: a tensor that
// starts 8 bytes off one has one lane before it in the first tile, never
// read.  One tile or less is one block.
//
// The wrapper zeroes the state words: [0] the head counter, [1] the tile
// counter, then ntiles status words, ntiles aggregates and ntiles
// inclusive prefixes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;                      // 16-byte vectors a lane
constexpr int kWarpVecs = 32 * kSteps;         // 256 vectors, 512 lanes
constexpr int kTileVecs = kWarps * kWarpVecs;  // 2,048 vectors
constexpr long long kTile = 2 * kTileVecs;     // 4,096 lanes

constexpr long long kInvalid = 0, kAggregate = 1, kPrefix = 2;

enum Op { kMax = 0, kMin = 1 };

template <int kOp>
__device__ __forceinline__ long long identity() {
  return kOp == kMax ? LLONG_MIN : LLONG_MAX;
}

template <int kOp>
__device__ __forceinline__ long long combine(long long a, long long b) {
  return kOp == kMax ? (a > b ? a : b) : (a < b ? a : b);
}

__device__ __forceinline__ long long load_acquire(const long long* p) {
  long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ long long load_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(long long* p, long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :
               : "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void store_release(long long* p, long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;"
               :
               : "l"(p), "l"(v)
               : "memory");
}

struct State {
  unsigned long long* heads;
  unsigned long long* counter;
  long long* status;
  long long* aggregate;
  long long* inclusive;
  long long ntiles;
};

// The value first, then its status word, released after it.
__device__ __forceinline__ void publish(long long* values, long long* status,
                                        long long t, long long v,
                                        long long s) {
  store_relaxed(values + t, v);
  store_release(status + t, s);
}

// The exclusive prefix of tile t > 0, by warp 0: each lane takes one of 32
// predecessors a step, waits until it has a status, and the lanes up to
// the nearest inclusive prefix are combined.
template <int kOp>
__device__ long long look_back(const State& st, long long t, int lane) {
  long long prefix = identity<kOp>();
  for (long long j0 = t - 1;; j0 -= 32) {
    const long long j = j0 - lane;
    long long s = kPrefix;  // before tile 0: nothing to add
    long long v = identity<kOp>();
    if (j >= 0) {
      while ((s = load_acquire(st.status + j)) == kInvalid) __nanosleep(32);
      v = load_relaxed((s == kPrefix ? st.inclusive : st.aggregate) + j);
    }
    const unsigned done = __ballot_sync(0xffffffffu, s == kPrefix);
    const int stop = done ? __ffs(done) - 1 : 31;
    if (lane > stop) v = identity<kOp>();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      v = combine<kOp>(v, __shfl_xor_sync(0xffffffffu, v, d));
    }
    prefix = combine<kOp>(prefix, v);
    if (done) return prefix;
  }
}

// Lanes i0 and i0 + 1 of x (i0 even from the 16-byte boundary), each
// outside [0, n) read as fill.
__device__ __forceinline__ void load_pair(const long long* __restrict__ x,
                                          long long i0, long long n,
                                          long long fill, long long& a,
                                          long long& b) {
  if (i0 >= 0 && i0 + 1 < n) {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(x + i0));
    a = v.x;
    b = v.y;
  } else {
    a = i0 >= 0 && i0 < n ? __ldg(x + i0) : fill;
    b = i0 + 1 >= 0 && i0 + 1 < n ? __ldg(x + i0 + 1) : fill;
  }
}

// One tile a block.  kPos: x is cks, order the permutation, y the rank
// (scattered); else y[i] is the running value at i.
template <int kOp, bool kRev, bool kPos>
__global__ void __launch_bounds__(kThreads)
    carry_kernel(const long long* __restrict__ x, long long* __restrict__ y,
                 const long long* __restrict__ order, long long n, int h,
                 State st) {
  __shared__ long long s_tile;
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_prefix;
  __shared__ int s_heads[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(st.counter, 1ull));
  }
  __syncthreads();
  const long long t = s_tile;
  // the lane of the tile's first vector: tiles lie on 16-byte boundaries
  const long long base = (kRev ? st.ntiles - 1 - t : t) * kTile - h;

  long long out[2 * kSteps];
  long long carry = identity<kOp>();
  int heads = 0;
  long long last = 0;  // kPos: the lane before this step's first
  if (kPos) {
    const long long i = base + 2LL * warp * kWarpVecs - 1;
    if (i >= 0 && i < n) last = __ldg(x + i);
  }
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int lv = warp * kWarpVecs + k * 32 + lane;
    const long long i0 = base + 2LL * (kRev ? kTileVecs - 1 - lv : lv);
    long long x0, x1;
    load_pair(x, i0, n, identity<kOp>(), x0, x1);
    long long a, b;  // the pair in scan order
    if (kPos) {
      long long p = __shfl_up_sync(0xffffffffu, x1, 1);
      if (lane == 0) p = last;
      last = __shfl_sync(0xffffffffu, x1, 31);
      const bool h0 = i0 >= 0 && i0 < n && (i0 == 0 || x0 != p);
      const bool h1 = i0 + 1 < n && (i0 + 1 == 0 || x1 != x0);
      heads += h0 + h1;
      a = h0 ? i0 : 0;
      b = h1 ? i0 + 1 : 0;
    } else {
      a = kRev ? x1 : x0;
      b = kRev ? x0 : x1;
    }
    const long long pair = combine<kOp>(a, b);
    long long s = pair;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s = combine<kOp>(s, u);
    }
    long long ex = __shfl_up_sync(0xffffffffu, s, 1);
    ex = combine<kOp>(carry, lane == 0 ? identity<kOp>() : ex);
    out[2 * k] = combine<kOp>(ex, a);
    out[2 * k + 1] = combine<kOp>(ex, pair);
    carry = combine<kOp>(carry, __shfl_sync(0xffffffffu, s, 31));
  }
  if (kPos) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      heads += __shfl_xor_sync(0xffffffffu, heads, d);
    }
  }
  if (lane == 0) {
    s_warp[warp] = carry;
    if (kPos) s_heads[warp] = heads;
  }
  __syncthreads();
  long long before = identity<kOp>();  // this warp's predecessors in the tile
  long long total = identity<kOp>();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = combine<kOp>(before, s_warp[w]);
    total = combine<kOp>(total, s_warp[w]);
  }
  if (warp == 0) {
    long long ex = identity<kOp>();
    if (t == 0) {
      if (lane == 0) publish(st.inclusive, st.status, 0, total, kPrefix);
    } else {
      if (lane == 0) publish(st.aggregate, st.status, t, total, kAggregate);
      ex = look_back<kOp>(st, t, lane);
      if (lane == 0) {
        publish(st.inclusive, st.status, t, combine<kOp>(ex, total), kPrefix);
      }
    }
    if (lane == 0) {
      s_prefix = ex;
      if (kPos) {
        int sum = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_heads[w];
        atomicAdd(st.heads, static_cast<unsigned long long>(sum));
      }
    }
  }
  __syncthreads();
  const long long pre = combine<kOp>(s_prefix, before);
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int lv = warp * kWarpVecs + k * 32 + lane;
    const long long i0 = base + 2LL * (kRev ? kTileVecs - 1 - lv : lv);
    const long long v0 = combine<kOp>(pre, out[kRev ? 2 * k + 1 : 2 * k]);
    const long long v1 = combine<kOp>(pre, out[kRev ? 2 * k : 2 * k + 1]);
    if (kPos) {
      long long o0, o1;
      load_pair(order, i0, n, 0, o0, o1);
      if (i0 >= 0 && i0 < n) y[o0] = v0;
      if (i0 + 1 >= 0 && i0 + 1 < n) y[o1] = v1;
    } else if (i0 >= 0 && i0 + 1 < n) {
      *reinterpret_cast<longlong2*>(y + i0) = make_longlong2(v0, v1);
    } else {
      if (i0 >= 0 && i0 < n) y[i0] = v0;
      if (i0 + 1 >= 0 && i0 + 1 < n) y[i0 + 1] = v1;
    }
  }
}

// The tiles of n lanes whose first lane lies h lanes past a 16-byte
// boundary.
long long tiles(long long n, int h) { return (n + h + kTile - 1) / kTile; }

State state_of(void* state, long long ntiles) {
  auto* w = static_cast<long long*>(state);
  return State{reinterpret_cast<unsigned long long*>(w),
               reinterpret_cast<unsigned long long*>(w + 1), w + 2,
               w + 2 + ntiles, w + 2 + 2 * ntiles, ntiles};
}

template <int kOp, bool kRev, bool kPos>
void launch(const long long* x, long long* y, const long long* order,
            long long n, int h, const State& st, cudaStream_t stream) {
  carry_kernel<kOp, kRev, kPos>
      <<<static_cast<unsigned>(st.ntiles), kThreads, 0, stream>>>(
          x, y, order, n, h, st);
}

}  // namespace

// The lanes of one tile; the wrapper sizes the state words from it.
extern "C" long long pfbwt_carry_tile() { return kTile; }

// x, y: n int64 lanes on the device, 8-byte aligned, at the same address
// modulo 16; op 0 max, 1 min; reverse 0 or 1; state: 2 + 3 * ntiles
// int64 words, zeroed, ntiles = ceil((n + h) / tile) with h = 1 where x
// lies 8 bytes past a 16-byte boundary, else 0.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or the error of a
// refused argument).
extern "C" int pfbwt_carry_scan(const void* x, void* y, long long n, int op,
                                int reverse, void* state, long long ntiles,
                                void* stream) {
  if (n <= 0) return 0;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  const int h = static_cast<int>(xa % 16 / 8);
  if (xa % 8 != 0 || ya % 16 != xa % 16 || (op != kMax && op != kMin) ||
      (reverse != 0 && reverse != 1) || ntiles != tiles(n, h) ||
      ntiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xp = static_cast<const long long*>(x);
  auto* yp = static_cast<long long*>(y);
  const State st = state_of(state, ntiles);
  const auto s = static_cast<cudaStream_t>(stream);
  if (op == kMax && !reverse) {
    launch<kMax, false, false>(xp, yp, nullptr, n, h, st, s);
  } else if (op == kMax) {
    launch<kMax, true, false>(xp, yp, nullptr, n, h, st, s);
  } else if (!reverse) {
    launch<kMin, false, false>(xp, yp, nullptr, n, h, st, s);
  } else {
    launch<kMin, true, false>(xp, yp, nullptr, n, h, st, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// cks, order: n int64 lanes on the device at the same address modulo 16,
// order a permutation of [0, n); rank: n int64 lanes, 8-byte aligned;
// state as for pfbwt_carry_scan, sized from cks, its word 0 the head
// count on return.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (or the error of a refused argument).
extern "C" int pfbwt_posrank(const void* cks, const void* order, void* rank,
                             long long n, void* state, long long ntiles,
                             void* stream) {
  if (n <= 0) return 0;
  const uintptr_t ca = reinterpret_cast<uintptr_t>(cks);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(order);
  const int h = static_cast<int>(ca % 16 / 8);
  if (ca % 8 != 0 || oa % 16 != ca % 16 ||
      reinterpret_cast<uintptr_t>(rank) % 8 != 0 || ntiles != tiles(n, h) ||
      ntiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch<kMax, false, true>(static_cast<const long long*>(cks),
                            static_cast<long long*>(rank),
                            static_cast<const long long*>(order), n, h,
                            state_of(state, ntiles),
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
