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
// [NP, C, H]. The planes are updated in place, as the TPU kernels alias
// their inputs; every [H] result goes to an output the wrapper allocated.
//
// What bounds them on an H100 (3.35 TB/s, bench shape C = 48, P = 24,
// H = 65,536, NP = 10; one [C, H] plane is 12.6 MB): bytes or memory
// latency, never operations — each kernel does a few integer compares per
// byte it moves.
//
// Each kernel computes its whole public function in one launch: the pop
// kernel all of events.pop_until (the rebased bound u32, the argmin, the
// Popped rows with their i64 time and tie-break, the new n_elig), the push
// kernel all of push_local / push_back (both tie-break splits, the rebased
// key, the first free slot, the writes, overflow, the new n_elig and, for
// push_local, the new self_ctr), the obox kernel all of outbox_append.
//
// * pop: the least it must read is the t32 plane plus, at each slot below
//   u32 whose t32 is not past the host's least eligible one, the kind and
//   (where eligible) tie-break words, and the payload at the popped slot. One
//   thread per host issues the t32 loads of all its slots (kPopBatch of
//   them) before it compares any: a warp's load of one slot row is one
//   coalesced 128-byte line, and each SM keeps about 100 KB of them in
//   flight. It then examines the slots below u32 in increasing t32, one
//   per pass, reading that slot's kind, tie-break and payload words in one
//   round trip, until its remaining t32 exceed its best; on the bench path
//   that is one pass per popping host. Nothing crosses hosts, so there is
//   no barrier: a warp whose loads are back goes on while others wait.
//   (Splitting the slot axis over a block's warps, merging in shared
//   memory and then gathering the payload was slower on an H100: each of
//   its two dependent phases waited at a block barrier for the block's
//   slowest warp. PERF.md has the numbers.) What the
//   [C, H] layout makes impossible: the payload sits at a per-host slot,
//   so reading it costs one 32-byte sector per word and host, not 4
//   bytes. On a random bench-shape buffer the sectors that must move come
//   to about 46 MB, a floor near 14 us against a word bound of about
//   6.3 us; on the bench path the 13 sectors of each popping host come on
//   top of the t32 stream, after it.
// * push: a block of 8 warps owns a tile of 32 consecutive hosts, lane l
//   holding host l of it in every warp. Tiles where no host pushes exit at
//   once (on the PHOLD path a hop stays home with probability 1 / H, so
//   that is nearly every tile) after writing the pass-through [H] outputs,
//   whose inputs warp 0 read at its start. Otherwise warp g takes the slots
//   g, g + 8, ... and finds each pushing host's first free slot (kind ==
//   K_NONE) among them, kBatch slots' loads at a time; a shared-memory
//   minimum over the 8 groups gives each host its slot, and the 6 + NP
//   word stores go one (plane, host) pair per thread, so each warp stores
//   32 neighbouring hosts of one plane. A store at a per-host slot is
//   sector-granular too: 32 bytes move for every scattered 4-byte word, so
//   a random buffer's pushes cost up to 8x their word bound.
// * obox: the whole of outbox_append in one launch (ok = mask && cnt < P,
//   the new cnt and pkt_ctr rows, the tb_split of depart, the 5 + NP word
//   stores at slot cnt[h]). It reads no plane at all, so in the path what
//   bounds it is the chain of dependent device-memory round trips, and on
//   a random state the 32-byte sectors of its scattered stores. The first
//   port's kernel waited on three round trips (ok, then cnt, then the value
//   words, each behind a branch on the one before); this one waits on two.
//   One thread per host (neighbouring lanes on neighbouring hosts: each [H]
//   row load is one coalesced line per warp) loads mask, cnt and pkt_ctr
//   together and writes its [H] outputs; only a host whose packet lands
//   then loads its value words (dst, kind, depart, the NP payload words)
//   and makes its 5 + NP stores, so only the landing hosts' sectors of the
//   value rows move. Issuing every load before any test (one round trip)
//   was slower on the H100, in the path and in situ: it moves every host's
//   value words, 4.5 MB at bench shape, mostly the zero payload PHOLD
//   sends; so was loading the values of whole warps where any lane appends
//   (a warp vote). PERF.md has the three designs' times. The stores go
//   plane by plane, so a warp's 32 words of one plane leave in one
//   instruction, one 128-byte line where the hosts share cnt. On a random
//   state they bound it: a host's words sit at its own row cnt[h], so each
//   scattered 4-byte word costs a 32-byte sector, 8x its word bound when
//   no neighbours share a row. Neither TMA nor wgmma has a part here: the
//   loads are [H] rows and the stores go to per-host rows.
//
// Bit-exact hazards, each covered by tests/test_torch_cuda.py and the edge
// cases of chip_smoke.py:
// * tie-break low words >= 2**31: stored sign-flipped (lo ^ 0x80000000), so
//   signed i32 order is unsigned low-word order; tb_join undoes the flip;
// * time = I64_MAX: t32 saturates to I32_HORIZON;
// * pkt_ctr at and above 2**31 and 2**32: the outbox's ctr word is its low
//   32 bits, as .to(torch.int32) truncates; the new pkt_ctr wraps in uint64;
// * time < epoch (past due): t32 goes negative, down to I32_PASTDUE;
// * until <= epoch: u32 = 0, only past-due keys pop, and with none left
//   nothing pops (one bound for every host, until_step 0, the reference's
//   form);
// * a bound per host (until_step 1, a fleet whose lanes stop at different
//   max_rounds): u32 clamps at I32_PASTDUE instead of 0, so a bound of
//   epoch + I32_PASTDUE or below pops nothing, past-due keys included;
// * ties on t32 and on tb_hi: the lexicographic (t32, tb_hi, tb_lo) order
//   decides; the key is unique per host, so the argmin is the reference's
//   one-hot and the outputs are the same bits;
// * hosts with no eligible slot: the running minimum starts at
//   (I32_FREE, I32_MAX, I32_MAX), the reference's masked-min sentinels,
//   and the Popped row comes out masked (time, tb, kind, payload all 0).
// i64 subtractions and additions wrap as torch's do (done in uint64_t).
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
constexpr int32_t kHorizon = 0x7ffffffe;     // events.I32_HORIZON
constexpr int32_t kPastDue = -0x7ffffffe;    // events.I32_PASTDUE
constexpr int kNP = 10;                      // consts.NP
constexpr int kBlock = 256;                  // obox: threads (hosts) per block
constexpr int kThreads = 256;                // pop/push: threads per block
constexpr int kPopBatch = 48;                // pop: slots whose loads go together
constexpr int kGroups = kThreads / 32;       // push: slot groups (warps)
constexpr int kBatch = 6;                    // push: slots whose loads go together
constexpr int kTile = 32;                    // push: hosts per block

__device__ __forceinline__ int64_t wrap_sub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

__device__ __forceinline__ int64_t wrap_add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}

__device__ __forceinline__ int32_t clamp32(int64_t v, int32_t lo, int32_t hi) {
  return (int32_t)(v < lo ? lo : (v > hi ? hi : v));
}

// events.tb_split: hi = v >> 32, lo = low word with its sign bit flipped.
__device__ __forceinline__ int32_t split_hi(int64_t v) {
  return (int32_t)(v >> 32);
}

__device__ __forceinline__ int32_t split_lo(int64_t v) {
  return (int32_t)((uint32_t)v ^ 0x80000000u);
}

// events.tb_join.
__device__ __forceinline__ int64_t join(int32_t hi, int32_t lo) {
  return (int64_t)(((uint64_t)(uint32_t)hi << 32) |
                   (uint64_t)((uint32_t)lo ^ 0x80000000u));
}

// Lexicographic (t32, tb_hi, tb_lo) order, the slot last so that equal
// keys (which the reference never holds) still give one answer.
__device__ __forceinline__ bool key_less(int32_t t, int32_t hi, int32_t lo,
                                         int32_t slot, int32_t bt,
                                         int32_t bhi, int32_t blo,
                                         int32_t bslot) {
  if (t != bt) return t < bt;
  if (hi != bhi) return hi < bhi;
  if (lo != blo) return lo < blo;
  return (uint32_t)slot < (uint32_t)bslot;  // slot -1 (none) sorts last
}

// One thread per host: the t32 loads of kPopBatch slots first, then one
// pass per candidate slot in increasing t32 (see the note at the top).
__global__ void __launch_bounds__(kThreads, 2)
pop_kernel(const int64_t* __restrict__ until, const int64_t* __restrict__ epoch,
           int32_t* __restrict__ t32, const int32_t* __restrict__ tb_hi,
           const int32_t* __restrict__ tb_lo, int32_t* __restrict__ kind,
           const int32_t* __restrict__ p, const int32_t* __restrict__ n_elig,
           uint8_t* __restrict__ mask_out, int64_t* __restrict__ time_out,
           int64_t* __restrict__ tb_out, int32_t* __restrict__ kind_out,
           int32_t* __restrict__ p_out, int32_t* __restrict__ n_elig_out,
           int C, int H, int until_step) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const int32_t ne = n_elig[h];
  const int64_t ep = *epoch;
  // events.until32: clamp(until - epoch, 0 or I32_PASTDUE, I32_HORIZON).
  const int32_t u = clamp32(wrap_sub(until[(int64_t)h * until_step], ep),
                            until_step ? kPastDue : 0, kHorizon);
  const int64_t plane = (int64_t)C * H;
  // The best eligible slot so far, from the reference's sentinels, with its
  // kind and payload.
  int32_t bt = kI32Free, bhi = kI32Max, blo = kI32Max, bslot = -1;
  int32_t bkind = kNone, bp[kNP];
#pragma unroll
  for (int w = 0; w < kNP; ++w) bp[w] = 0;
  for (int c0 = 0; c0 < C; c0 += kPopBatch) {
    int32_t t[kPopBatch];
#pragma unroll
    for (int k = 0; k < kPopBatch; ++k) {
      t[k] = c0 + k < C ? t32[(int64_t)(c0 + k) * H + h] : kI32Free;
    }
    // Bit k: slot c0 + k has t32 < u32 and is not examined yet (kI32Free
    // >= u, so no slot past C).
    uint64_t rem = 0;
#pragma unroll
    for (int k = 0; k < kPopBatch; ++k) rem |= (uint64_t)(t[k] < u) << k;
    while (rem) {
      int32_t mt = kI32Free, mk = 0;
#pragma unroll
      for (int k = 0; k < kPopBatch; ++k) {
        if (((rem >> k) & 1u) && t[k] < mt) {
          mt = t[k];
          mk = k;
        }
      }
      if (mt > bt) break;  // every remaining slot sorts after the best
      rem &= ~(1ull << mk);
      const int32_t c = c0 + mk;
      const int64_t i = (int64_t)c * H + h;
      const int32_t kd = kind[i], hi = tb_hi[i], lo = tb_lo[i];
      int32_t pv[kNP];
#pragma unroll
      for (int w = 0; w < kNP; ++w) pv[w] = p[w * plane + i];
      if (kd != kNone && key_less(mt, hi, lo, c, bt, bhi, blo, bslot)) {
        bt = mt; bhi = hi; blo = lo; bslot = c; bkind = kd;
#pragma unroll
        for (int w = 0; w < kNP; ++w) bp[w] = pv[w];
      }
    }
  }
  // bt < u exactly when some slot was eligible (mask = min_t < u32).
  const bool pops = bt < u;
  mask_out[h] = pops;
  time_out[h] = pops ? wrap_add(ep, bt) : 0;
  tb_out[h] = pops ? join(bhi, blo) : 0;
  kind_out[h] = pops ? bkind : kNone;
  n_elig_out[h] = ne - (int32_t)pops;
#pragma unroll
  for (int w = 0; w < kNP; ++w) p_out[(int64_t)w * H + h] = pops ? bp[w] : 0;
  if (pops) {
    const int64_t s = (int64_t)bslot * H + h;
    t32[s] = kI32Free;
    kind[s] = kNone;
  }
}

// A block owns a tile of 32 hosts: lane l holds host l of it in every warp,
// and warp g takes slots g, g + kGroups, ...
__global__ void __launch_bounds__(kThreads)
push_kernel(const uint8_t* __restrict__ mask, const int64_t* __restrict__ time,
            const int64_t* __restrict__ tb, const int32_t* __restrict__ kind_v,
            const int32_t* __restrict__ p_v, const int64_t* __restrict__ epoch,
            const int32_t* __restrict__ u32, const int32_t* __restrict__ n_elig,
            int32_t* __restrict__ time_hi, int32_t* __restrict__ time_lo,
            int32_t* __restrict__ t32, int32_t* __restrict__ tb_hi,
            int32_t* __restrict__ tb_lo, int32_t* __restrict__ kind,
            int32_t* __restrict__ p, uint8_t* __restrict__ over_out,
            int32_t* __restrict__ n_elig_out, int64_t* __restrict__ ctr_out,
            int C, int H, int advance_ctr) {
  __shared__ int32_t s_free[kGroups][kTile];
  __shared__ int32_t s_slot[kTile];
  const int lane = threadIdx.x % 32;
  const int grp = threadIdx.x / 32;
  const int base = blockIdx.x * kTile;
  const int h0 = base + lane;
  const int hm = base + threadIdx.x;  // warp 0 finishes the tile's hosts
  const bool merger = threadIdx.x < kTile && hm < H;
  // Warp 0's [H] inputs, read now so that the loads overlap the mask's.
  const int32_t ne = merger ? n_elig[hm] : 0;
  const int64_t ctr = merger && advance_ctr ? tb[hm] : 0;
  const bool m = h0 < H && mask[h0] != 0;
  // Every warp of the block holds the same hosts, so every warp takes the
  // same branch and the whole block leaves together.
  if (!__any_sync(0xffffffffu, m)) {
    if (merger) {
      over_out[hm] = 0;
      n_elig_out[hm] = ne;
      if (advance_ctr) ctr_out[hm] = ctr;
    }
    return;
  }
  // First free slot of the lane's host among this group's slots (C =
  // none). Later batches hold larger slots, so the scan ends at the first
  // batch that finds one.
  int32_t first = C;
  if (m) {
    for (int c0 = grp; c0 < C && first == C; c0 += kGroups * kBatch) {
      int32_t kd[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 + k * kGroups;
        kd[k] = c < C ? kind[(int64_t)c * H + h0] : 1;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (kd[k] == kNone && first == C) first = c0 + k * kGroups;
      }
    }
  }
  s_free[grp][lane] = first;
  __syncthreads();
  if (merger) {
    const int l = threadIdx.x;
    int32_t slot = C;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) slot = min(slot, s_free[g][l]);
    const bool ok = m && slot < C;  // warp 0: h0 == hm
    s_slot[l] = ok ? slot : -1;
    // events._t32_of: clamp(time - epoch, I32_PASTDUE, I32_HORIZON).
    const int32_t t32v = clamp32(wrap_sub(time[hm], *epoch), kPastDue, kHorizon);
    over_out[hm] = m && !ok;
    n_elig_out[hm] = ne + (int32_t)(ok && t32v < *u32);
    if (advance_ctr) ctr_out[hm] = wrap_add(ctr, (int64_t)ok);
  }
  __syncthreads();
  // The 6 + NP word stores, one (plane, host) pair per thread: each warp
  // stores 32 neighbouring hosts of one plane.
  const int64_t plane = (int64_t)C * H;
  for (int q = threadIdx.x; q < (6 + kNP) * kTile; q += kThreads) {
    const int w = q / kTile, l = q % kTile, h = base + l;
    if (h >= H || s_slot[l] < 0) continue;
    const int64_t s = (int64_t)s_slot[l] * H + h;
    switch (w) {
      case 0: time_hi[s] = split_hi(time[h]); break;
      case 1: time_lo[s] = split_lo(time[h]); break;
      case 2: t32[s] = clamp32(wrap_sub(time[h], *epoch), kPastDue, kHorizon); break;
      case 3: tb_hi[s] = split_hi(tb[h]); break;
      case 4: tb_lo[s] = split_lo(tb[h]); break;
      case 5: kind[s] = kind_v[h]; break;
      default: p[(w - 6) * plane + s] = p_v[(int64_t)(w - 6) * H + h];
    }
  }
}

// One thread per host; dst, kind and depart are read at h * step (step 0:
// one value for every host). Two round trips: the [H] rows, then the value
// words of a host whose packet lands (see the note at the top). This is
// how ptxas schedules it in any case: it sinks a value load written before
// the test into the branch that uses it.
__global__ void __launch_bounds__(kBlock)
obox_kernel(const uint8_t* __restrict__ mask, const int32_t* __restrict__ cnt,
            const int64_t* __restrict__ pkt_ctr,
            const int32_t* __restrict__ dst_v, const int32_t* __restrict__ kind_v,
            const int64_t* __restrict__ depart, const int32_t* __restrict__ p_v,
            int32_t* __restrict__ dst, int32_t* __restrict__ kind,
            int32_t* __restrict__ dhi, int32_t* __restrict__ dlo,
            int32_t* __restrict__ ctr, int32_t* __restrict__ p,
            uint8_t* __restrict__ ok_out, int32_t* __restrict__ cnt_out,
            int64_t* __restrict__ pkt_ctr_out, int P, int H, int dst_step,
            int kind_step, int depart_step) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const bool m = mask[h] != 0;
  const int32_t c = cnt[h];
  const int64_t pc = pkt_ctr[h];
  const bool ok = m && c < P;
  ok_out[h] = ok;
  cnt_out[h] = c + (int32_t)ok;  // ok: c < P, so no overflow
  pkt_ctr_out[h] = wrap_add(pc, (int64_t)ok);
  if (!ok || c < 0) return;  // a negative cnt: the reference's one-hot misses
  // The 3 + NP value loads all go out before the first store (restrict).
  const int64_t s = (int64_t)c * H + h;
  const int64_t plane = (int64_t)P * H;
  const int64_t t = depart[(int64_t)h * depart_step];
  dst[s] = dst_v[(int64_t)h * dst_step];
  kind[s] = kind_v[(int64_t)h * kind_step];
  dhi[s] = split_hi(t);
  dlo[s] = split_lo(t);
  ctr[s] = (int32_t)(uint32_t)(uint64_t)pc;  // .to(torch.int32): the low word
#pragma unroll
  for (int w = 0; w < kNP; ++w) p[w * plane + s] = p_v[(int64_t)w * H + h];
}

}  // namespace

extern "C" {

int popk_np() { return kNP; }

int popk_pop(const int64_t* until, const int64_t* epoch, int32_t* t32,
             const int32_t* tb_hi, const int32_t* tb_lo, int32_t* kind,
             const int32_t* p, const int32_t* n_elig, uint8_t* mask_out,
             int64_t* time_out, int64_t* tb_out, int32_t* kind_out,
             int32_t* p_out, int32_t* n_elig_out, int C, int H,
             int until_step, cudaStream_t stream) {
  if (H > 0) {
    pop_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        until, epoch, t32, tb_hi, tb_lo, kind, p, n_elig, mask_out, time_out,
        tb_out, kind_out, p_out, n_elig_out, C, H, until_step);
  }
  return (int)cudaGetLastError();
}

int popk_push(const uint8_t* mask, const int64_t* time, const int64_t* tb,
              const int32_t* kind_v, const int32_t* p_v, const int64_t* epoch,
              const int32_t* u32, const int32_t* n_elig, int32_t* time_hi,
              int32_t* time_lo, int32_t* t32, int32_t* tb_hi, int32_t* tb_lo,
              int32_t* kind, int32_t* p, uint8_t* over_out,
              int32_t* n_elig_out, int64_t* ctr_out, int C, int H,
              int advance_ctr, cudaStream_t stream) {
  if (H > 0) {
    push_kernel<<<(H + kTile - 1) / kTile, kThreads, 0, stream>>>(
        mask, time, tb, kind_v, p_v, epoch, u32, n_elig, time_hi, time_lo, t32,
        tb_hi, tb_lo, kind, p, over_out, n_elig_out, ctr_out, C, H,
        advance_ctr);
  }
  return (int)cudaGetLastError();
}

int popk_obox(const uint8_t* mask, const int32_t* cnt, const int64_t* pkt_ctr,
              const int32_t* dst_v, const int32_t* kind_v,
              const int64_t* depart, const int32_t* p_v, int32_t* dst,
              int32_t* kind, int32_t* dhi, int32_t* dlo, int32_t* ctr,
              int32_t* p, uint8_t* ok_out, int32_t* cnt_out,
              int64_t* pkt_ctr_out, int P, int H, int dst_step,
              int kind_step, int depart_step, cudaStream_t stream) {
  if (H > 0) {
    obox_kernel<<<(H + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
        mask, cnt, pkt_ctr, dst_v, kind_v, depart, p_v, dst, kind, dhi, dlo,
        ctr, p, ok_out, cnt_out, pkt_ctr_out, P, H, dst_step, kind_step,
        depart_step);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
