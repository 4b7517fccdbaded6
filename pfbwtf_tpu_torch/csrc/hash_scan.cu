// K1: the cut scan of the prefix-free parse, for Hopper (sm_90a).
//
// Replaces the TPU kernel pfbwtf_tpu/ops/pallas/hash_scan.py::_kernel
// (launched by _scan through pl.pallas_call at hash_scan.py:185; on the
// JAX main path it is reached from fused._parse_core via
// engine._cut_mask_device).
//
// What it computes, for every position i of the 2-bit code stream
// (A0 C1 G2 T3): the k-mer register of codes [i-w+1 .. i] with the newest
// code in bits [0:2) (codes before position 0 read as 0), the 64-bit Wang
// mix of that register (hash.hpp:12-21), and cut[i] = (i >= w) &&
// (hash % p == 0).  Output is one byte per position (0/1), written into a
// torch.bool tensor.  Every w <= 32 and every 1 <= p < 2**64 is taken.
//
// What bounds it on an H100: instruction issue, not memory.  The function
// reads one byte and writes one byte per position: 2 * 75,497,472 B for
// the main path's 64 MB input, 45 us at 3.35 TB/s.  The work is the
// k-mer's extraction, the Wang mix, a divisibility test by a
// multiplicative inverse and the flag: 32.16 32-bit instructions a
// position at w <= 16 (35.69 above), counted from this kernel's SASS
// less its loads, packing, stores, moves, set-up, addresses and control
// (scripts/k1_sass.py, "work").  At the card's issue rate of
// 132 SMs * 128 lanes * 1.98 GHz = 33.45 T/s that is 73 us for the main
// path (chip_smoke.k1_ops_per_position).  LOP3, SHF and IADD3, most of
// the Wang mix, issue to a pipe of half that width, so integer-only code
// can fall short of the issue rate.
//
// Design, each part cutting the instructions issued per position
// (scripts/k1_sass.py counts them from this kernel's SASS):
// - A thread owns kRun = 32 consecutive positions.  It loads the aligned
//   16-byte chunks that cover its codes and the 31 before them (5 vector
//   loads; neighbouring threads' overlap is served by L1), packs each
//   chunk into one 32-bit word, 2 bits a code with the oldest code
//   highest (an IMAD per 4 codes and 3 PRMT), and realigns the words to
//   its first position with a funnel shift.  The k-mer of each of its
//   positions is then a funnel shift of neighbouring words by a constant
//   amount and a mask (two of each for w > 16): the cost does not grow
//   with w, and the 32 positions are unrolled with no loop.
// - h % p == 0 for every p: p = 2^s * q with q odd, and h % p == 0 exactly
//   when rotr64(h * q^-1 mod 2^64, s) <= (2^64 - 1) / p (Hacker's Delight
//   10-17).  The wrapper computes q^-1, s and the limit once; per position
//   it is a 64-bit low product, two funnel shifts and a 64-bit compare
//   whose carry is added into a bit mask, which becomes bytes once per
//   four positions.
// - Two template flags, both fixed by the call's arguments, remove work
//   that does not apply: kWide (w > 16) keeps the k-mer's high word, and
//   kSwap (s >= 32) names the product's halves the other way round, so the
//   rotate needs no select.
// - Indices inside a block are 32-bit; only the block's base is 64-bit.
// - Loads and stores move 16 bytes a thread.  The input pointer may sit at
//   any byte (an offset view): the kernel reads from the 16-byte boundary
//   below it and shifts the packed words by that offset.  Chunks that
//   reach past either end of the input are read byte by byte, in bounds,
//   with the bytes outside it taken as 0; the first thread (positions
//   i < w never cut) and the ragged tail store byte by byte.
// - No shared memory and no barrier: the halo of a run is another
//   thread's codes, reloaded from L1.  A bulk asynchronous copy (TMA) into
//   shared memory would add an mbarrier wait and a block barrier per tile
//   to save loads that cost 0.16 instructions a position.
//
// Tensor cores and wgmma have no place here: the Wang mix is shifts, adds
// and xors with no multiply-accumulate structure, and the products per
// position are single 64-bit integer multiplies.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;                 // positions a thread owns
constexpr int kTile = kThreads * kRun;   // positions a block owns
constexpr int kHalo = 32;                // MAX_W: a position reads 31 codes back

__device__ __forceinline__ uint64_t wang64(uint64_t key) {
  key = (~key) + (key << 21);
  key = key ^ (key >> 24);
  key = (key + (key << 3)) + (key << 8);
  key = key ^ (key >> 14);
  key = (key + (key << 2)) + (key << 4);
  key = key ^ (key >> 28);
  key = key + (key << 31);
  return key;
}

// 16 codes, one a byte, into a word with 2 bits a code, the first code in
// bits [30:32).  x * (1 + 2^10 + 2^20 + 2^30) places bytes 0..3 of x as
// 2-bit fields at bits 30, 28, 26, 24 (no carries for codes <= 3).
__device__ __forceinline__ uint32_t pack16(uint32_t x, uint32_t y, uint32_t z,
                                           uint32_t v) {
  constexpr uint32_t kGather = 0x40100401u;
  const uint32_t lo = __byte_perm(v * kGather, z * kGather, 0x0073);
  const uint32_t hi = __byte_perm(y * kGather, x * kGather, 0x7300);
  return __byte_perm(lo, hi, 0x7610);
}

// The packed chunk of bytes [b, b + 16) from `src` (16-byte aligned, b a
// multiple of 16); bytes outside [lo, hi) are never read and count as 0.
__device__ __forceinline__ uint32_t load_chunk(const uint8_t* src, int b,
                                               int lo, int hi) {
  if (b >= lo && b + 16 <= hi) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(src + b));
    return pack16(q.x, q.y, q.z, q.w);
  }
  uint32_t word[4] = {0, 0, 0, 0};
  if (b + 16 > lo && b < hi) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (b + k >= lo && b + k < hi) {
        word[k >> 2] |= static_cast<uint32_t>(src[b + k]) << (8 * (k & 3));
      }
    }
  }
  return pack16(word[0], word[1], word[2], word[3]);
}

// 16 positions whose codes end words c (newest), b and a: the flags, one
// byte each, in 4 words.  kWide: w > 16, the k-mer has a high word.
// kSwap: s >= 32, and s arrives as s mod 32.
template <bool kWide, bool kSwap>
__device__ __forceinline__ uint4 scan16(uint32_t a, uint32_t b, uint32_t c,
                                        uint64_t mask, uint64_t qinv,
                                        uint32_t s, uint64_t limit) {
  const uint32_t mlo = static_cast<uint32_t>(mask);
  const uint32_t mhi = static_cast<uint32_t>(mask >> 32);
  const uint32_t llo = static_cast<uint32_t>(limit);
  const uint32_t lhi = static_cast<uint32_t>(limit >> 32);
  uint32_t acc = 0;  // bit k: the flag of position k of the 16
#pragma unroll
  for (int k = 15; k >= 0; --k) {
    const uint32_t r = 2 * (15 - k);
    const uint32_t klo = __funnelshift_r(c, b, r) & mlo;
    const uint32_t khi = kWide ? __funnelshift_r(b, a, r) & mhi : 0u;
    const uint64_t y =
        wang64((static_cast<uint64_t>(khi) << 32) | klo) * qinv;
    // rotr64(y, s) without a shift by 64: the halves swapped for s >= 32,
    // then a funnel shift by s mod 32
    const uint32_t u = static_cast<uint32_t>(kSwap ? y >> 32 : y);
    const uint32_t t = static_cast<uint32_t>(kSwap ? y : y >> 32);
    const uint32_t rlo = __funnelshift_r(u, t, s);
    const uint32_t rhi = __funnelshift_r(t, u, s);
    // acc = 2 * acc + (rot <= limit): limit - rot sets the carry flag
    // exactly when it does not borrow
    asm("{\n\t.reg .u32 d;\n\t"
        "sub.cc.u32 d, %1, %2;\n\t"
        "subc.cc.u32 d, %3, %4;\n\t"
        "addc.u32 %0, %0, %0;\n\t}"
        : "+r"(acc)
        : "r"(llo), "r"(rlo), "r"(lhi), "r"(rhi));
  }
  // x * (1 + 2^7 + 2^14 + 2^21) moves bit j of a nibble to bit 8j
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = (((acc >> (4 * j)) & 0xFu) * 0x00204081u) & 0x01010101u;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// codes: the input's 16-byte boundary at or below it, off bytes before
// position 0.  cut: 16-byte aligned.
template <bool kWide, bool kSwap>
__global__ void __launch_bounds__(kThreads)
cut_scan_kernel(const uint8_t* __restrict__ codes, uint32_t off,
                uint8_t* __restrict__ cut, long long n, int w, uint64_t mask,
                uint64_t qinv, uint32_t s, uint64_t limit) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = n - base;
  const int rem = left < kTile ? static_cast<int>(left) : kTile;
  const int t0 = threadIdx.x * kRun;
  if (t0 >= rem) return;
  // code bytes of the input relative to src, clipped to what a block reads
  const uint8_t* src = codes + base;
  const int lo = base == 0 ? static_cast<int>(off) : -2 * kHalo;
  const int hi = static_cast<int>(off) +
                 (left < kTile + kHalo ? static_cast<int>(left)
                                       : kTile + kHalo);
  uint32_t p[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    p[j] = load_chunk(src, t0 - kHalo + 16 * j, lo, hi);
  }
  // word j: the codes of positions [t0 - 32 + 16j, t0 - 16 + 16j)
  uint32_t wd[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wd[j] = __funnelshift_l(p[j + 1], p[j], 2 * off);
  }
  const uint4 f0 =
      scan16<kWide, kSwap>(wd[0], wd[1], wd[2], mask, qinv, s, limit);
  const uint4 f1 =
      scan16<kWide, kSwap>(wd[1], wd[2], wd[3], mask, qinv, s, limit);
  uint8_t* dst = cut + base + t0;
  // w <= kRun, so only the first thread holds positions i < w, which
  // never cut; it and the ragged tail store byte by byte
  if (t0 + kRun <= rem && base + t0 >= w) {
    reinterpret_cast<uint4*>(dst)[0] = f0;
    reinterpret_cast<uint4*>(dst)[1] = f1;
  } else {
    const uint32_t o[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (t0 + k < rem) {
        dst[k] = base + t0 + k >= w
                     ? static_cast<uint8_t>(o[k >> 2] >> (8 * (k & 3)))
                     : 0;
      }
    }
  }
}

template <bool kWide, bool kSwap>
void launch(long long n, cudaStream_t stream, const uint8_t* codes,
            uint32_t off, uint8_t* cut, int w, uint64_t mask, uint64_t qinv,
            uint32_t s, uint64_t limit) {
  const long long blocks = (n + kTile - 1) / kTile;
  cut_scan_kernel<kWide, kSwap><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(codes, off, cut, n, w, mask, qinv,
                                            s, limit);
}

}  // namespace

// codes: n uint8 codes (0..3) on the device, at any address; cut: n bytes
// on the device, 16-byte aligned.  p = 2^s * q with q odd, qinv = q^-1 mod
// 2^64, limit = (2^64 - 1) / p.  Launches on `stream` and does not
// synchronise; returns cudaGetLastError().
extern "C" int pfbwt_cut_scan(const void* codes, void* cut, long long n,
                              int w, unsigned long long qinv, int s,
                              unsigned long long limit, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || w > kHalo || s < 0 || s > 63 ||
      reinterpret_cast<uintptr_t>(cut) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t mask = w == 32 ? ~0ull : (1ull << (2 * w)) - 1;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(codes);
  const uint32_t off = static_cast<uint32_t>(addr % 16);
  const auto* src = reinterpret_cast<const uint8_t*>(addr - off);
  auto* dst = static_cast<uint8_t*>(cut);
  const auto st = static_cast<cudaStream_t>(stream);
  const uint32_t sm = static_cast<uint32_t>(s % 32);
  if (w > 16 && s >= 32) {
    launch<true, true>(n, st, src, off, dst, w, mask, qinv, sm, limit);
  } else if (w > 16) {
    launch<true, false>(n, st, src, off, dst, w, mask, qinv, sm, limit);
  } else if (s >= 32) {
    launch<false, true>(n, st, src, off, dst, w, mask, qinv, sm, limit);
  } else {
    launch<false, false>(n, st, src, off, dst, w, mask, qinv, sm, limit);
  }
  return static_cast<int>(cudaGetLastError());
}
