// K2, K3 and K4: the table gathers of the TPU gather probe, for Hopper
// (sm_90a).
//
// Replaces the three Pallas kernels of benchmarks/gather_probe.py, each
// with its own entry points:
//   K2  pfbwt_take_*        pallas_take (pallas_call at gather_probe.py:75,
//                           body _k_take :66): out[i] = table[idx[i]], every
//                           idx promised in [0, T) and not checked.
//   K3  pfbwt_take_along_*  pallas_tala (:108, body _k_tala :96):
//                           take_along_axis over the broadcast row; an idx
//                           in [-T, 0) wraps to idx + T, any other idx
//                           outside [0, T) gives INT32_MIN (jnp's fill).
//   K4  pfbwt_take_rows_*   pallas_rows (:145, body _k_rows :129): the same
//                           gather with idx clipped to [0, T - 1].
// The table, the indices and the output are int32.
//
// What bounds it on an H100: bytes.  The function reads each index once
// (4 B), writes each output once (4 B) and needs the table once: at the
// probe's shape (a 2^20-entry table, 2^24 indices) 138,412,032 B, 41.3 us
// at the H100 SXM's published 3.35 TB/s.  Its operations are one compare
// or two per lane.  But the lookups are random, so the memory level that
// holds the table sets the pace unless the table sits in shared memory.
// Two tiers, each with a _smem and an _l2 entry point; the wrapper picks
// one by the table's size against pfbwt_gather_smem_limit
// (ops/cuda/gather.py::gather_tier).  Times below: chip_smoke.py's sweep
// at 2^24 indices on an NVIDIA H100 80GB HBM3 at 700 W.
//
// - smem: the table fits one block's shared memory (4 T + 12 bytes within
//   the opt-in limit: 232,448 B there, up to 58,109 entries).  Each block
//   issues its first index loads, then stages the whole table into
//   dynamic shared memory with cooperative 16-byte loads (a scalar head
//   and tail for a table view that is off 16 bytes, stored 0-3 lanes into
//   the buffer so the body stays aligned), synchronises once, and walks
//   the index stream grid-stride as a persistent block.  Random 4-byte
//   lookups in shared memory cost a 3-4 way bank conflict on average, yet
//   outrun the index stream, so HBM bounds this tier: 0.72-0.80 of the
//   bytes bound batched.  Cooperative loads rather than a TMA bulk copy:
//   the first index loads overlap the staging either way, the staging
//   reads the table once a block where the stream reads 8 bytes a lane,
//   and the same code takes an offset table that a bulk copy (16-byte
//   aligned source, size a multiple of 16) would need a separate head and
//   tail for anyway.
// - l2: the table stays in device memory, read through the non-coherent
//   path with an L2::evict_last cache policy; the index stream is read
//   and the output written with streaming (evict-first) hints, so the
//   stream does not push table sectors out of the L2.  No stream or
//   device state is set (no access-policy window): a later caller
//   inherits nothing.  From 2^18 to 2^22 entries the time is flat
//   (0.137-0.151 ms batched): the L2's rate of random 32-byte sectors
//   sets it, not the table's size.
//
// Both tiers: each thread takes 16 lanes a step (four 16-byte index
// loads issued before any lookup, so 16 lookups are in flight), four
// 16-byte output stores; one full wave of blocks (SMs x resident blocks).
// A view that does not start on a 16-byte boundary (an offset view)
// peels a scalar head of up to three lanes; the wrapper allocates the
// output at the same address modulo 16, so both streams are aligned after
// the head.  The ragged tail (up to three lanes) is scalar.
//
// The launch path is as short as the host allows: each device's SM count
// and opt-in shared-memory limit are read once, each template instance's
// attributes are set once a device and its occupancy kept for the last
// table size, and the device is switched here, only where the caller's
// current device is another.

#include <atomic>
#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kVecs = 4;          // 16-byte index loads a thread a step
constexpr int kMaxDevices = 64;
constexpr int kSmemShift = 12;    // an offset table's shift: up to 3 lanes

enum Mode { kPromise = 0, kWrapFill = 1, kClip = 2 };
enum Tier { kSmem = 0, kL2 = 1 };

// The table as the smem tier reads it: a shared-memory copy.
struct SmemTable {
  const int32_t* p;
  __device__ __forceinline__ int32_t operator()(long long j) const {
    return p[j];
  }
};

// The table as the l2 tier reads it: device memory, non-coherent path,
// each load tagged with an L2::evict_last policy.
struct L2Table {
  const int32_t* p;
  uint64_t policy;
  __device__ __forceinline__ int32_t operator()(long long j) const {
    int32_t v;
    asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
        : "=r"(v)
        : "l"(p + j), "l"(policy));
    return v;
  }
};

template <int kMode, class Table>
__device__ __forceinline__ int32_t lookup(const Table& tab, long long t,
                                          int32_t i) {
  if (kMode == kPromise) {
    return tab(i);
  } else if (kMode == kWrapFill) {
    const long long j = i < 0 ? static_cast<long long>(i) + t : i;
    return (j >= 0 && j < t) ? tab(j) : INT_MIN;
  } else {
    const long long j = i < 0 ? 0 : (i >= t ? t - 1 : i);
    return tab(j);
  }
}

// q[k] = the 16-byte index vector v0 + k * stride, where it exists.
__device__ __forceinline__ void load_step(const int4* __restrict__ iv,
                                          long long nvec, long long v0,
                                          long long stride, int4 (&q)[kVecs]) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long v = v0 + k * stride;
    if (v < nvec) q[k] = __ldcs(iv + v);
  }
}

// Copies the t-entry table into dynamic shared memory, `a` lanes in (the
// table's address modulo 16, in lanes), so that the 16-byte body lands on
// 16-byte boundaries; returns the copy's first entry.  Ends with the
// block's one barrier.
__device__ __forceinline__ const int32_t* stage_table(
    const int32_t* __restrict__ table, long long t) {
  extern __shared__ int4 smem[];
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(table) % 16 / 4);
  int32_t* dst = reinterpret_cast<int32_t*>(smem) + a;
  const long long head = (4 - a) % 4 < t ? (4 - a) % 4 : t;
  if (threadIdx.x < head) dst[threadIdx.x] = __ldg(table + threadIdx.x);
  const long long nv = (t - head) / 4;
  const int4* __restrict__ src4 = reinterpret_cast<const int4*>(table + head);
  int4* dst4 = reinterpret_cast<int4*>(dst + head);  // a + head is 0 or 4
  constexpr int kUnroll = 8;
  long long k = threadIdx.x;
  for (; k + (kUnroll - 1) * kThreads < nv; k += kUnroll * kThreads) {
    int4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(src4 + k + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst4[k + u * kThreads] = r[u];
  }
  for (; k < nv; k += kThreads) dst4[k] = __ldg(src4 + k);
  const long long tail0 = head + 4 * nv;
  if (threadIdx.x < t - tail0) {
    dst[tail0 + threadIdx.x] = __ldg(table + tail0 + threadIdx.x);
  }
  __syncthreads();
  return dst;
}

// idx and out: n lanes, at the same address modulo 16; head (0..3) lanes
// come before the first 16-byte boundary of both.
template <int kMode, class Table>
__device__ __forceinline__ void gather_stream(
    const Table& tab, long long t, const int32_t* __restrict__ idx,
    int32_t* __restrict__ out, long long n, int head, long long nvec,
    long long tid, long long stride, int4 (&q)[kVecs]) {
  const int4* __restrict__ iv = reinterpret_cast<const int4*>(idx + head);
  int4* __restrict__ ov = reinterpret_cast<int4*>(out + head);
  for (long long v0 = tid; v0 < nvec; v0 += kVecs * stride) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (v0 + k * stride < nvec) {
        q[k].x = lookup<kMode>(tab, t, q[k].x);
        q[k].y = lookup<kMode>(tab, t, q[k].y);
        q[k].z = lookup<kMode>(tab, t, q[k].z);
        q[k].w = lookup<kMode>(tab, t, q[k].w);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long v = v0 + k * stride;
      if (v < nvec) __stcs(ov + v, q[k]);
    }
    load_step(iv, nvec, v0 + kVecs * stride, stride, q);
  }
  // the scalar head and the ragged tail, one lane a thread
  const long long tail0 = head + 4 * nvec;
  if (tid < head) {
    out[tid] = lookup<kMode>(tab, t, idx[tid]);
  } else if (tid < head + (n - tail0)) {
    const long long i = tail0 + (tid - head);
    out[i] = lookup<kMode>(tab, t, idx[i]);
  }
}

template <int kMode, int kTier>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ table, long long t,
              const int32_t* __restrict__ idx, int32_t* __restrict__ out,
              long long n, int head) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long nvec = (n - head) / 4;
  int4 q[kVecs];
  // the first step's indices are in flight before the table is touched
  load_step(reinterpret_cast<const int4*>(idx + head), nvec, tid, stride, q);
  if (kTier == kSmem) {
    const SmemTable tab{stage_table(table, t)};
    gather_stream<kMode>(tab, t, idx, out, n, head, nvec, tid, stride, q);
  } else {
    uint64_t policy;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
    const L2Table tab{table, policy};
    gather_stream<kMode>(tab, t, idx, out, n, head, nvec, tid, stride, q);
  }
}

struct Device {
  int sms = 0;
  int optin = 0;  // cudaDevAttrMaxSharedMemoryPerBlockOptin
  int rc = 0;
};

Device g_devices[kMaxDevices];
std::once_flag g_device_once[kMaxDevices];

// The device's attributes, read at its first use; nullptr for a device
// number out of range.
const Device* device(int dev) {
  if (dev < 0 || dev >= kMaxDevices) return nullptr;
  std::call_once(g_device_once[dev], [dev] {
    Device& d = g_devices[dev];
    int rc = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0) {
      rc = cudaDeviceGetAttribute(
          &d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    d.rc = rc;
  });
  return &g_devices[dev];
}

// Blocks of one instance resident on an SM with `smem` dynamic bytes,
// from the occupancy calculator; the last answer is kept per device, so a
// repeated table size costs one atomic load.
template <int kMode, int kTier>
int blocks_per_sm(int dev, int smem, int* per_sm) {
  static std::once_flag once[kMaxDevices];
  static int setup_rc[kMaxDevices];
  static std::atomic<unsigned long long> last[kMaxDevices];
  auto kernel = gather_kernel<kMode, kTier>;
  std::call_once(once[dev], [dev, kernel] {
    const Device& d = g_devices[dev];
    int rc = 0;
    if (kTier == kSmem) {
      rc = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                d.optin);
      if (rc == 0) {
        rc = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared);
      }
    }
    setup_rc[dev] = rc;
  });
  if (setup_rc[dev] != 0) return setup_rc[dev];
  const unsigned long long seen = last[dev].load(std::memory_order_relaxed);
  if (seen != 0 && static_cast<int>(seen >> 32) == smem) {
    *per_sm = static_cast<int>(seen & 0xffffffffu);
    return 0;
  }
  int b = 0;
  const int rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, kernel, kThreads, static_cast<size_t>(smem));
  if (rc != 0) return rc;
  if (b < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  last[dev].store((static_cast<unsigned long long>(smem) << 32) |
                      static_cast<unsigned>(b),
                  std::memory_order_relaxed);
  *per_sm = b;
  return 0;
}

// Makes `dev` the calling thread's current device while it lives, where
// another device is current; a device switch is the exception, so the
// common launch pays one cudaGetDevice.
class DeviceGuard {
 public:
  explicit DeviceGuard(int dev) {
    rc_ = static_cast<int>(cudaGetDevice(&prev_));
    if (rc_ == 0 && prev_ != dev) {
      rc_ = static_cast<int>(cudaSetDevice(dev));
      switched_ = rc_ == 0;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  int rc() const { return rc_; }

 private:
  int prev_ = 0;
  int rc_ = 0;
  bool switched_ = false;
};

template <int kMode, int kTier>
int launch(const void* table, long long t, const void* idx, void* out,
           long long n, int dev, void* stream) {
  if (n <= 0) return 0;
  const uintptr_t ta = reinterpret_cast<uintptr_t>(table);
  const uintptr_t ia = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (t < 1 || ta % 4 != 0 || ia % 4 != 0 || ia % 16 != oa % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Device* d = device(dev);
  if (d == nullptr) return static_cast<int>(cudaErrorInvalidDevice);
  if (d->rc != 0) return d->rc;
  const DeviceGuard guard(dev);
  if (guard.rc() != 0) return guard.rc();
  int smem = 0;
  if (kTier == kSmem) {
    const long long bytes = 4 * (t + static_cast<long long>(ta % 16 / 4));
    if (bytes > d->optin) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = static_cast<int>(bytes);
  }
  int per_sm = 0;
  const int rc = blocks_per_sm<kMode, kTier>(dev, smem, &per_sm);
  if (rc != 0) return rc;
  const int head = static_cast<int>(((16 - ia % 16) % 16) / 4);
  const int h = n < head ? static_cast<int>(n) : head;
  // one thread for each step of kVecs vectors (one block at least, which
  // also covers the head and tail lanes), at most one full wave
  const long long steps = ((n - h) / 4 + kVecs - 1) / kVecs;
  long long blocks = (steps + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(d->sms) * per_sm;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  gather_kernel<kMode, kTier><<<static_cast<unsigned>(blocks), kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), t, static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), n, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bytes of table that the smem tier takes on device `dev`: the
// opt-in shared memory a block may have (the kernels have no static
// shared memory), less the 12 bytes an offset table shifts by.  A
// negative value is a CUDA error code, negated.
extern "C" int pfbwt_gather_smem_limit(int dev) {
  const Device* d = device(dev);
  if (d == nullptr) return -static_cast<int>(cudaErrorInvalidDevice);
  if (d->rc != 0) return -d->rc;
  return d->optin - kSmemShift;
}

// table: t int32 entries on device `dev`; idx, out: n int32 lanes on the
// same device, at the same address modulo 16.  Each launches on `stream`
// (a stream of `dev`) with `dev` current, restores the caller's current
// device, does not synchronise, and returns cudaGetLastError() (or the
// error of a refused argument or set-up).  An _smem entry refuses a table
// larger than its limit.
extern "C" int pfbwt_take_smem(const void* table, long long t, const void* idx,
                               void* out, long long n, int dev, void* stream) {
  return launch<kPromise, kSmem>(table, t, idx, out, n, dev, stream);
}

extern "C" int pfbwt_take_l2(const void* table, long long t, const void* idx,
                             void* out, long long n, int dev, void* stream) {
  return launch<kPromise, kL2>(table, t, idx, out, n, dev, stream);
}

extern "C" int pfbwt_take_along_smem(const void* table, long long t,
                                     const void* idx, void* out, long long n,
                                     int dev, void* stream) {
  return launch<kWrapFill, kSmem>(table, t, idx, out, n, dev, stream);
}

extern "C" int pfbwt_take_along_l2(const void* table, long long t,
                                   const void* idx, void* out, long long n,
                                   int dev, void* stream) {
  return launch<kWrapFill, kL2>(table, t, idx, out, n, dev, stream);
}

extern "C" int pfbwt_take_rows_smem(const void* table, long long t,
                                    const void* idx, void* out, long long n,
                                    int dev, void* stream) {
  return launch<kClip, kSmem>(table, t, idx, out, n, dev, stream);
}

extern "C" int pfbwt_take_rows_l2(const void* table, long long t,
                                  const void* idx, void* out, long long n,
                                  int dev, void* stream) {
  return launch<kClip, kL2>(table, t, idx, out, n, dev, stream);
}
