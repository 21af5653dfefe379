// Hand-written Hopper kernels for the event core's round path, and for
// TCP's receive path (rx_ack, rx_data: see their section below).
//
// The first three replace the three Pallas kernels of the JAX package
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
#include <string.h>

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

// ---- TCP's receive path (tcp/tcp.py rx_ack_plain, rx_data_plain) ----------
//
// No TPU kernel: the JAX package runs tcp_rx as XLA's fused dense
// program. The port's plain version writes every field as a torch.where
// over the whole [S, H] plane (and the message-boundary retire over the
// [Q, S, H] one), about 30 such writes a packet, each moving the plane
// twice to change one value a host. These two kernels run the two
// per-socket blocks of tcp_rx with one thread per host: the thread reads
// its socket's column [ds, h] once, runs the block in registers in the
// source's program order (a later write wins; a read after a write sees
// it) and stores only the fields it changed, in place. What bounds them is
// the scattered column: a host's words sit at its own socket row, so each
// 4-byte word costs a 32-byte sector; only the hosts with a segment read
// any plane (the others write their zero [H] outputs and leave).
//
// The host-side rules they reproduce: a host outside ``mask`` (or sending a
// SYN to a listener) is not ``v``, so every mask and notification is 0 for
// it; ds >= S reads the clamped socket S - 1 but writes nothing (the
// reference's one-hot is empty), and its masks and notifications still
// follow what it read. Sequence arithmetic wraps in 32 bits and the RTT
// estimate in 64 (done unsigned); err >> 3 and >> 2 are arithmetic shifts,
// and (snd_nxt - snd_una) // 2 is a floor division, the same shift.

// consts.py: TCP states, segment flags, notification bits.
constexpr int32_t kTcpFree = 0, kSynSent = 2, kSynRcvd = 3, kEstablished = 4,
                  kFinWait1 = 5, kFinWait2 = 6, kCloseWait = 7, kLastAck = 8,
                  kClosing = 9;
constexpr int32_t kFSyn = 1, kFAck = 2, kFFin = 4;
constexpr int32_t kNEstablished = 1, kNAccepted = 2, kNMsg = 4, kNSpace = 8,
                  kNPeerFin = 16, kNClosed = 32, kNData = 128;
constexpr int32_t kCwndMax = 1 << 28;
// TCP_CONN_STATES and TCP_RCV_STATES as bit sets.
constexpr uint32_t kConnStates = (1u << kSynSent) | (1u << kSynRcvd) |
                                 (1u << kEstablished) | (1u << kFinWait1) |
                                 (1u << kFinWait2) | (1u << kCloseWait) |
                                 (1u << kLastAck) | (1u << kClosing);
constexpr uint32_t kRcvStates =
    (1u << kEstablished) | (1u << kFinWait1) | (1u << kFinWait2);

// The planes the two kernels read and write, in popk.RX_PLANES order: every
// one [S, H] but the [Q, S, H] message-boundary FIFO; bool planes as bytes.
struct TcpPlanes {
  int32_t *st, *peer_host, *peer_sock, *peer_wnd, *snd_una, *snd_nxt,
      *snd_max, *rcv_nxt, *app_end, *fin_pend, *cwnd, *ssthresh, *dupacks,
      *recover, *ts_seq, *srtt_hi, *srtt_lo, *rttvar_hi, *rttvar_lo, *rto_hi,
      *rto_lo, *rtx_t_hi, *rtx_t_lo, *ts_time_hi, *ts_time_lo;
  uint8_t *ts_act, *mq_valid;
  int32_t* mq_end;
};
constexpr int kTcpPlanes = 28;
constexpr int kMqBatch = 16;  // rx_ack: boundary slots whose loads go together
static_assert(sizeof(TcpPlanes) == kTcpPlanes * sizeof(void*),
              "TcpPlanes holds one pointer per plane");

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// tcp._state_in: bit s of the set, for s in [0, 31) (torch's shift of a
// larger or negative count reads 0).
__device__ __forceinline__ bool state_in(uint32_t set, int32_t s) {
  return (uint32_t)s < 31u && ((set >> s) & 1u);
}

// The segment's fields (tcp._segment) from the payload rows, [NP, H].
struct Segment {
  int32_t src, ss, ds, seq, ackno, length, wnd, mend, mmeta;
  bool syn, ack, fin;
};

__device__ __forceinline__ Segment segment(const int32_t* __restrict__ p,
                                           int64_t H, int h) {
  Segment g;
  g.src = p[h];
  const int32_t packed = p[H + h];
  g.seq = p[2 * H + h];
  g.ackno = p[3 * H + h];
  g.length = p[4 * H + h];
  g.wnd = p[5 * H + h];
  g.mend = p[6 * H + h];
  g.mmeta = p[7 * H + h];
  g.ss = packed & 0xFF;
  g.ds = (packed >> 8) & 0xFF;
  const int32_t flags = (packed >> 16) & 0xFF;
  g.syn = (flags & kFSyn) != 0;
  g.ack = (flags & kFAck) != 0;
  g.fin = (flags & kFFin) != 0;
  return g;
}

// rx_ack_plain: demux, ACK processing with the RTT sample and Reno, the
// message-boundary retire, the ACK-driven state transitions and the fast
// retransmit. Writes the six Notif rows (sock, flags, meta, meta2, dlen,
// space) and the masks v, est_ss, closed_by_ack, frx and flush (new_ack |
// frx), each [H].
__global__ void __launch_bounds__(kBlock)
rx_ack_kernel(TcpPlanes t, const uint8_t* __restrict__ mask,
              const uint8_t* __restrict__ to_listener,
              const int32_t* __restrict__ p, const int64_t* __restrict__ now_v,
              int32_t* __restrict__ n_sock, int32_t* __restrict__ n_flags,
              int32_t* __restrict__ n_meta, int32_t* __restrict__ n_meta2,
              int32_t* __restrict__ n_dlen, int32_t* __restrict__ n_space,
              uint8_t* __restrict__ out, int S, int Q, int H, int32_t mss,
              int32_t sndbuf, int32_t dupthresh, int64_t rto_min,
              int64_t rto_max) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const int64_t HH = H;
  int32_t sock = 0, flags = 0, space = 0;
  bool v = false, est_ss = false, closed = false, frx = false, flush = false;
  if (mask[h] && !to_listener[h]) {
    const Segment g = segment(p, HH, h);
    const int64_t now = now_v[h];
    const bool wr = g.ds < S;  // the one-hot holds the socket
    const int64_t i = (int64_t)min(g.ds, S - 1) * HH + h;
    // Every read first, so that the loads go out together.
    const int32_t st0 = t.st[i], peer_host = t.peer_host[i];
    const int32_t peer_sock0 = t.peer_sock[i];
    const int32_t snd_una0 = t.snd_una[i], snd_nxt0 = t.snd_nxt[i];
    const int32_t snd_max = t.snd_max[i], ts_seq = t.ts_seq[i];
    const int32_t app_end = t.app_end[i], fin_pend = t.fin_pend[i];
    const int32_t cwnd0 = t.cwnd[i], ssthresh0 = t.ssthresh[i];
    const int32_t dupacks0 = t.dupacks[i], recover0 = t.recover[i];
    const bool ts_act0 = t.ts_act[i] != 0;
    const int64_t ts_time = join(t.ts_time_hi[i], t.ts_time_lo[i]);
    const int64_t srtt0 = join(t.srtt_hi[i], t.srtt_lo[i]);
    const int64_t rttvar0 = join(t.rttvar_hi[i], t.rttvar_lo[i]);
    const int64_t rto0 = join(t.rto_hi[i], t.rto_lo[i]);
    int32_t st = st0, peer_sock = peer_sock0, snd_una = snd_una0;
    int32_t snd_nxt = snd_nxt0, cwnd = cwnd0, ssthresh = ssthresh0;
    int32_t dupacks = dupacks0, recover = recover0;
    bool ts_act = ts_act0;
    int64_t srtt = srtt0, rttvar = rttvar0, rto = rto0;

    // Demux: the peer must match; a SYN_SENT client learns the child's
    // socket from its SYN|ACK.
    const bool learn_peer = st0 == kSynSent && g.syn && g.ack;
    v = state_in(kConnStates, st0) && peer_host == g.src &&
        (peer_sock0 == g.ss || learn_peer);
    if (wr && v && learn_peer) peer_sock = g.ss;
    if (wr && v && g.ack) t.peer_wnd[i] = max(g.wnd, 1);

    // ACK processing, against snd_max.
    const bool a = v && g.ack;
    const bool new_ack = a && sub32(g.ackno, snd_una0) > 0 &&
                         sub32(g.ackno, snd_max) <= 0;
    const bool ts_ok = new_ack && ts_act0 && sub32(g.ackno, ts_seq) >= 0;
    int64_t rtt = wrap_sub(now, ts_time);
    if (rtt < 1) rtt = 1;
    const bool first = srtt0 == 0;
    const int64_t err = wrap_sub(rtt, srtt0);
    const int64_t abs_err = err < 0 ? wrap_sub(0, err) : err;
    const int64_t srtt_n = first ? rtt : wrap_add(srtt0, err >> 3);
    const int64_t rttvar_n =
        first ? rtt / 2 : wrap_add(rttvar0, wrap_sub(abs_err, rttvar0) >> 2);
    int64_t var4 = (int64_t)((uint64_t)rttvar_n * 4u);
    if (var4 < 1000000) var4 = 1000000;
    int64_t rto_n = wrap_add(srtt_n, var4);
    rto_n = rto_n < rto_min ? rto_min : rto_n;  // torch.clamp: min, then max
    rto_n = rto_n > rto_max ? rto_max : rto_n;
    if (wr && ts_ok) {
      srtt = srtt_n;
      rttvar = rttvar_n;
      rto = rto_n;
      ts_act = false;
    }
    // cwnd growth: slow start below ssthresh, else AIMD.
    const int32_t grow =
        cwnd0 < ssthresh0 ? mss : max((mss * mss) / max(cwnd0, 1), 1);
    if (wr && new_ack) {
      cwnd = min(add32(cwnd0, grow), kCwndMax);
      snd_una = g.ackno;
      if (sub32(g.ackno, snd_nxt0) > 0) snd_nxt = g.ackno;
      dupacks = 0;
      // Retire the message boundaries the peer has fully acked. The slots
      // sit a plane apart, a sector each: the loads of kMqBatch slots go
      // out together (a store between them would order every load after
      // it, one round trip a slot).
      const int64_t col = (int64_t)g.ds * HH + h, step = (int64_t)S * HH;
      for (int q0 = 0; q0 < Q; q0 += kMqBatch) {
        uint8_t valid[kMqBatch];
        int32_t end[kMqBatch];
#pragma unroll
        for (int k = 0; k < kMqBatch; ++k) {
          const int64_t s = col + (q0 + k) * step;
          valid[k] = q0 + k < Q ? t.mq_valid[s] : 0;
          end[k] = q0 + k < Q ? t.mq_end[s] : 0;
        }
#pragma unroll
        for (int k = 0; k < kMqBatch; ++k) {
          if (valid[k] && sub32(end[k], g.ackno) <= 0) {
            t.mq_valid[col + (q0 + k) * step] = 0;
          }
        }
      }
    }
    // Restart (or clear) the retransmit deadline, at the rto just set.
    const bool outstanding = sub32(snd_max, g.ackno) > 0;
    if (wr && new_ack) {
      const int64_t d = outstanding ? wrap_add(now, rto) : 0;
      t.rtx_t_hi[i] = split_hi(d);
      t.rtx_t_lo[i] = split_lo(d);
    }

    // State transitions driven by this ACK.
    const bool est_sr = new_ack && st0 == kSynRcvd;
    if (wr && est_sr) st = kEstablished;
    est_ss = a && g.syn && st0 == kSynSent && g.ackno == 1;
    if (wr && est_ss) {
      st = kEstablished;
      t.rcv_nxt[i] = 1;
    }
    const bool fin_acked =
        new_ack && fin_pend == 1 && g.ackno == add32(app_end, fin_pend);
    if (wr && fin_acked && st0 == kFinWait1) st = kFinWait2;
    closed = fin_acked && (st0 == kClosing || st0 == kLastAck);
    const bool sp =
        new_ack && (st0 == kEstablished || st0 == kCloseWait) && !closed;
    flags = (est_sr ? kNAccepted : 0) | (est_ss ? kNEstablished : 0) |
            (closed ? kNClosed : 0) | (sp ? kNSpace : 0);
    if (flags) sock = g.ds;
    if (sp) space = sub32(sndbuf, sub32(app_end, g.ackno));

    // Duplicate ACKs, and the fast retransmit at the threshold.
    const bool dup_a = a && !new_ack && g.ackno == snd_una0 && outstanding &&
                       g.length == 0 && !g.syn && !g.fin;
    const int32_t dp = add32(dupacks, 1);
    if (wr && dup_a) dupacks = dp;
    frx = dup_a && dp == dupthresh && sub32(snd_una0, recover0) >= 0;
    if (wr && frx) {
      const int32_t ssth = max(sub32(snd_nxt0, snd_una0) >> 1, 2 * mss);
      ssthresh = ssth;
      cwnd = ssth;
      recover = snd_nxt0;
      snd_nxt = snd_una0;
      ts_act = false;
    }
    flush = new_ack || frx;

    // Write back what changed.
    if (st != st0) t.st[i] = st;
    if (peer_sock != peer_sock0) t.peer_sock[i] = peer_sock;
    if (snd_una != snd_una0) t.snd_una[i] = snd_una;
    if (snd_nxt != snd_nxt0) t.snd_nxt[i] = snd_nxt;
    if (cwnd != cwnd0) t.cwnd[i] = cwnd;
    if (ssthresh != ssthresh0) t.ssthresh[i] = ssthresh;
    if (dupacks != dupacks0) t.dupacks[i] = dupacks;
    if (recover != recover0) t.recover[i] = recover;
    if (ts_act != ts_act0) t.ts_act[i] = ts_act;
    if (srtt != srtt0) {
      t.srtt_hi[i] = split_hi(srtt);
      t.srtt_lo[i] = split_lo(srtt);
    }
    if (rttvar != rttvar0) {
      t.rttvar_hi[i] = split_hi(rttvar);
      t.rttvar_lo[i] = split_lo(rttvar);
    }
    if (rto != rto0) {
      t.rto_hi[i] = split_hi(rto);
      t.rto_lo[i] = split_lo(rto);
    }
  }
  n_sock[h] = sock;
  n_flags[h] = flags;
  n_meta[h] = 0;
  n_meta2[h] = 0;
  n_dlen[h] = 0;
  n_space[h] = space;
  out[h] = v;
  out[HH + h] = est_ss;
  out[2 * HH + h] = closed;
  out[3 * HH + h] = frx;
  out[4 * HH + h] = flush;
}

// rx_data_plain: the in-order payload, the FIN (under its mask for every
// host, so no read decides whether it runs: its writes are all masked) and
// the free of a closed socket. Updates the Notif rows sock, flags, meta and
// dlen in place and writes the masks need_ack and out_of_order, [H].
__global__ void __launch_bounds__(kBlock)
rx_data_kernel(TcpPlanes t, const int32_t* __restrict__ p,
               const uint8_t* __restrict__ v_in,
               const uint8_t* __restrict__ est_ss_in,
               const uint8_t* __restrict__ closed_in,
               int32_t* __restrict__ n_sock, int32_t* __restrict__ n_flags,
               int32_t* __restrict__ n_meta, int32_t* __restrict__ n_dlen,
               uint8_t* __restrict__ out, int S, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const int64_t HH = H;
  bool need_ack = false, ooo = false;
  if (v_in[h]) {  // v holds mask, est_ss and closed_by_ack
    const Segment g = segment(p, HH, h);
    const bool wr = g.ds < S;
    const int64_t i = (int64_t)min(g.ds, S - 1) * HH + h;
    const int32_t st0 = t.st[i], rcv0 = t.rcv_nxt[i];
    int32_t st = st0, rcv = rcv0;
    // Payload, in order only (a Go-Back-N receiver).
    const bool has_data = state_in(kRcvStates, st0) && g.length > 0;
    const bool in_order = has_data && g.seq == rcv0;
    if (wr && in_order) rcv = add32(rcv0, g.length);
    // FIN: in order once the preceding data is consumed.
    const bool fin_here = g.fin && add32(g.seq, g.length) == rcv &&
                          state_in(kRcvStates, st0);
    if (wr && fin_here) rcv = add32(rcv, 1);
    const bool to_cw = fin_here && st0 == kEstablished;
    if (wr && to_cw) st = kCloseWait;
    if (wr && fin_here && st0 == kFinWait1) st = kClosing;
    const bool closed_by_fin = fin_here && st0 == kFinWait2;
    // Free a fully closed socket.
    if (wr && (closed_in[h] || closed_by_fin)) {
      st = kTcpFree;
      t.rtx_t_hi[i] = split_hi(0);
      t.rtx_t_lo[i] = split_lo(0);
    }
    if (st != st0) t.st[i] = st;
    if (rcv != rcv0) t.rcv_nxt[i] = rcv;
    const int32_t add = (in_order ? kNData : 0) |
                        (in_order && g.mend != 0 ? kNMsg : 0) |
                        (to_cw ? kNPeerFin : 0) | (closed_by_fin ? kNClosed : 0);
    if (add) {
      n_sock[h] = g.ds;
      n_flags[h] |= add;
    }
    if (in_order) n_dlen[h] = g.length;
    if (in_order && g.mend != 0) n_meta[h] = g.mmeta;
    need_ack = has_data || g.fin || est_ss_in[h];
    ooo = has_data && !in_order;
  }
  out[h] = need_ack;
  out[HH + h] = ooo;
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

// ``planes``: a host array of the kTcpPlanes device pointers, in
// popk.RX_PLANES order.
int popk_rx_ack(void* const* planes, const uint8_t* mask,
                const uint8_t* to_listener, const int32_t* p,
                const int64_t* now, int32_t* n_sock, int32_t* n_flags,
                int32_t* n_meta, int32_t* n_meta2, int32_t* n_dlen,
                int32_t* n_space, uint8_t* out, int S, int Q, int H, int mss,
                int sndbuf, int dupthresh, long long rto_min,
                long long rto_max, cudaStream_t stream) {
  TcpPlanes t;
  memcpy(&t, planes, sizeof t);
  if (H > 0) {
    rx_ack_kernel<<<(H + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
        t, mask, to_listener, p, now, n_sock, n_flags, n_meta, n_meta2,
        n_dlen, n_space, out, S, Q, H, mss, sndbuf, dupthresh, rto_min,
        rto_max);
  }
  return (int)cudaGetLastError();
}

int popk_rx_data(void* const* planes, const int32_t* p, const uint8_t* v,
                 const uint8_t* est_ss, const uint8_t* closed_by_ack,
                 int32_t* n_sock, int32_t* n_flags, int32_t* n_meta,
                 int32_t* n_dlen, uint8_t* out, int S, int H,
                 cudaStream_t stream) {
  TcpPlanes t;
  memcpy(&t, planes, sizeof t);
  if (H > 0) {
    rx_data_kernel<<<(H + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
        t, p, v, est_ss, closed_by_ack, n_sock, n_flags, n_meta, n_dlen, out,
        S, H);
  }
  return (int)cudaGetLastError();
}

int popk_tcp_planes() { return kTcpPlanes; }

}  // extern "C"
