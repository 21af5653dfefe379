// Hand-written Hopper kernels for the event core's round path.
//
// These replace the three Pallas kernels of the JAX package
// (shadow1_tpu/core/popk.py): the fused pop (_pop_kernel), the fused push
// (_push_kernel) and the fused outbox append (_obox_kernel). Each is
// bit-identical to its plain PyTorch version (core/events.py
// pop_until_plain / push_local_plain / push_back_plain, core/outbox.py
// outbox_append_plain), which chip_smoke.py checks on the card.
//
// Layout: every plane is i32 [C, H], slot-major and host-minor, payload
// [NP, C, H]. Design shared by all three: one thread per host and a loop
// over the slot axis. Neighbouring threads read neighbouring addresses, so
// every plane load of a warp is one coalesced 128-byte transaction, and
// since nothing crosses hosts there is no shared memory, no atomics and no
// second pass. The planes are updated in place, as the TPU kernels alias
// their inputs.
//
// What bounds them on an H100 (3.35 TB/s, bench shape C = 48, P = 24,
// H = 65,536, NP = 10; one [C, H] plane is 12.6 MB): bytes, never
// operations — each kernel does a few integer compares per byte it moves.
//
// * pop: the least it must read is the t32 plane (12.6 MB) plus the kind
//   and tie-break words of the slots whose t32 is below the bound, and it
//   writes a few words per popping host. The TPU kernel reads all 4 + NP
//   planes and extracts by a masked sum; this one keeps a running
//   lexicographic min of (t32, tb_hi, tb_lo) and its slot in registers,
//   reads kind, tb_hi and tb_lo only where t32 is below the bound, then
//   gathers kind and the NP payload words at that one slot and clears it.
//   The key is unique per host, so the argmin is the TPU kernel's one-hot
//   and the outputs are the same bits.
// * push: reads the kind plane only up to the first free slot (early exit)
//   and writes 6 + NP words per pushing host, (6 + NP) x H x 4 B = 4.2 MB
//   at most, against the TPU kernel's full read and write of 7 + NP planes.
// * obox: reads no plane at all; the slot is cnt[h]. It writes 5 + NP
//   words per appending host, at most (5 + NP) x H x 4 B = 3.9 MB.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNone = 0;                 // consts.K_NONE
constexpr int32_t kI32Max = 0x7fffffff;      // events.I32_MAX
constexpr int32_t kI32Free = 0x7fffffff;     // events.I32_FREE
constexpr int kNP = 10;                      // consts.NP
constexpr int kBlock = 256;

__global__ void pop_kernel(const int32_t* __restrict__ until32,
                           int32_t* __restrict__ t32,
                           const int32_t* __restrict__ tb_hi,
                           const int32_t* __restrict__ tb_lo,
                           int32_t* __restrict__ kind,
                           const int32_t* __restrict__ p,
                           int32_t* __restrict__ min_t,
                           int32_t* __restrict__ min_hi,
                           int32_t* __restrict__ min_lo,
                           int32_t* __restrict__ kind_out,
                           int32_t* __restrict__ p_out,
                           int C, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const int32_t u = *until32;
  // The masked min of the reference starts from (FREE, MAX, MAX): hosts
  // with no eligible slot report exactly those words.
  int32_t bt = kI32Free, bhi = kI32Max, blo = kI32Max;
  int slot = -1;
  for (int c = 0; c < C; ++c) {
    const int64_t i = (int64_t)c * H + h;
    const int32_t t = t32[i];
    if (t < u && kind[i] != kNone) {
      const int32_t hi = tb_hi[i];
      const int32_t lo = tb_lo[i];
      if (t < bt || (t == bt && (hi < bhi || (hi == bhi && lo < blo)))) {
        bt = t;
        bhi = hi;
        blo = lo;
        slot = c;
      }
    }
  }
  min_t[h] = bt;
  min_hi[h] = bhi;
  min_lo[h] = blo;
  if (slot < 0) {
    kind_out[h] = 0;
    for (int j = 0; j < kNP; ++j) p_out[(int64_t)j * H + h] = 0;
    return;
  }
  const int64_t s = (int64_t)slot * H + h;
  const int64_t plane = (int64_t)C * H;
  kind_out[h] = kind[s];
  for (int j = 0; j < kNP; ++j) p_out[(int64_t)j * H + h] = p[j * plane + s];
  t32[s] = kI32Free;
  kind[s] = kNone;
}

__global__ void push_kernel(const int32_t* __restrict__ mask,
                            const int32_t* __restrict__ thi_v,
                            const int32_t* __restrict__ tlo_v,
                            const int32_t* __restrict__ t32_v,
                            const int32_t* __restrict__ bhi_v,
                            const int32_t* __restrict__ blo_v,
                            const int32_t* __restrict__ kind_v,
                            const int32_t* __restrict__ p_v,
                            int32_t* __restrict__ thi,
                            int32_t* __restrict__ tlo,
                            int32_t* __restrict__ t32,
                            int32_t* __restrict__ bhi,
                            int32_t* __restrict__ blo,
                            int32_t* __restrict__ kind,
                            int32_t* __restrict__ p,
                            int32_t* __restrict__ over,
                            int C, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  if (mask[h] == 0) {
    over[h] = 0;
    return;
  }
  int slot = -1;
  for (int c = 0; c < C; ++c) {
    if (kind[(int64_t)c * H + h] == kNone) {
      slot = c;
      break;
    }
  }
  if (slot < 0) {
    over[h] = 1;
    return;
  }
  const int64_t s = (int64_t)slot * H + h;
  const int64_t plane = (int64_t)C * H;
  thi[s] = thi_v[h];
  tlo[s] = tlo_v[h];
  t32[s] = t32_v[h];
  bhi[s] = bhi_v[h];
  blo[s] = blo_v[h];
  kind[s] = kind_v[h];
  for (int j = 0; j < kNP; ++j) p[j * plane + s] = p_v[(int64_t)j * H + h];
  over[h] = 0;
}

__global__ void obox_kernel(const int32_t* __restrict__ cnt,
                            const int32_t* __restrict__ ok,
                            const int32_t* __restrict__ dst_v,
                            const int32_t* __restrict__ kind_v,
                            const int32_t* __restrict__ dhi_v,
                            const int32_t* __restrict__ dlo_v,
                            const int32_t* __restrict__ ctr_v,
                            const int32_t* __restrict__ p_v,
                            int32_t* __restrict__ dst,
                            int32_t* __restrict__ kind,
                            int32_t* __restrict__ dhi,
                            int32_t* __restrict__ dlo,
                            int32_t* __restrict__ ctr,
                            int32_t* __restrict__ p,
                            int P, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H || ok[h] == 0) return;
  const int32_t slot = cnt[h];
  if (slot < 0 || slot >= P) return;  // the reference's one-hot misses too
  const int64_t s = (int64_t)slot * H + h;
  const int64_t plane = (int64_t)P * H;
  dst[s] = dst_v[h];
  kind[s] = kind_v[h];
  dhi[s] = dhi_v[h];
  dlo[s] = dlo_v[h];
  ctr[s] = ctr_v[h];
  for (int j = 0; j < kNP; ++j) p[j * plane + s] = p_v[(int64_t)j * H + h];
}

inline int grid_for(int H) { return (H + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

int popk_np() { return kNP; }

int popk_pop(const int32_t* until32, int32_t* t32, const int32_t* tb_hi,
             const int32_t* tb_lo, int32_t* kind, const int32_t* p,
             int32_t* min_t, int32_t* min_hi, int32_t* min_lo,
             int32_t* kind_out, int32_t* p_out, int C, int H,
             cudaStream_t stream) {
  if (H > 0) {
    pop_kernel<<<grid_for(H), kBlock, 0, stream>>>(
        until32, t32, tb_hi, tb_lo, kind, p, min_t, min_hi, min_lo, kind_out,
        p_out, C, H);
  }
  return (int)cudaGetLastError();
}

int popk_push(const int32_t* mask, const int32_t* thi_v, const int32_t* tlo_v,
              const int32_t* t32_v, const int32_t* bhi_v,
              const int32_t* blo_v, const int32_t* kind_v,
              const int32_t* p_v, int32_t* thi, int32_t* tlo, int32_t* t32,
              int32_t* bhi, int32_t* blo, int32_t* kind, int32_t* p,
              int32_t* over, int C, int H, cudaStream_t stream) {
  if (H > 0) {
    push_kernel<<<grid_for(H), kBlock, 0, stream>>>(
        mask, thi_v, tlo_v, t32_v, bhi_v, blo_v, kind_v, p_v, thi, tlo, t32,
        bhi, blo, kind, p, over, C, H);
  }
  return (int)cudaGetLastError();
}

int popk_obox(const int32_t* cnt, const int32_t* ok, const int32_t* dst_v,
              const int32_t* kind_v, const int32_t* dhi_v,
              const int32_t* dlo_v, const int32_t* ctr_v, const int32_t* p_v,
              int32_t* dst, int32_t* kind, int32_t* dhi, int32_t* dlo,
              int32_t* ctr, int32_t* p, int P, int H, cudaStream_t stream) {
  if (H > 0) {
    obox_kernel<<<grid_for(H), kBlock, 0, stream>>>(
        cnt, ok, dst_v, kind_v, dhi_v, dlo_v, ctr_v, p_v, dst, kind, dhi, dlo,
        ctr, p, P, H);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
