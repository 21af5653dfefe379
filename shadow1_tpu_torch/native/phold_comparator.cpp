// Thread-per-core PHOLD comparator — the honest CPU baseline.
//
// The north-star target (BASELINE.json) is measured against a
// "thread-per-core CPU scheduler"; this is that scheduler, built the way
// the reference builds it (src/main/core/scheduler/scheduler-policy-host-
// steal.c: hosts partitioned across worker threads, conservative windows
// with barrier rounds, cross-thread event push through locked queues) —
// NOT the Python oracle, whose interpreter overhead would flatter the
// batched engine by orders of magnitude.
//
// Exact-parity contract: this program simulates the IDENTICAL experiment
// the batched engine and the Python oracle run — same splitmix64 counter RNG
// (the Q32 log2 table is loaded from a file dumped by Python so no libm
// rounding difference can creep in), same fixed-point exponential, same
// multiply-shift randint, same (time, tb) event order, same ev_cap /
// outbox_cap accounting (docs/SEMANTICS.md). Its event/packet counters
// must equal the other two engines' bit for bit (tests/test_native_
// comparator.py), which is what makes its wall-clock an honest baseline.
//
// Usage:
//   phold_comparator <table_file> <n_hosts> <seed> <n_windows> <window_ns>
//                    <mean_delay_ns> <init_events> <ev_cap> <outbox_cap>
//                    <n_threads>
// Prints one JSON line with counters and wall seconds.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- RNG ----
// Mirrors shadow1_tpu_torch/rng.py exactly (integer pipeline).
constexpr uint64_t C1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t C2 = 0x94D049BB133111EBull;
constexpr uint64_t P1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P3 = 0x165667B19E3779F9ull;
constexpr int LOG_BITS = 12;

uint64_t LOG_TBL[(1 << LOG_BITS) + 1];  // loaded from the Python dump
uint64_t LN2_Q32 = 0;                   // loaded (= round(ln 2 * 2^32))

inline uint64_t mix(uint64_t z) {
  z ^= z >> 30; z *= C1; z ^= z >> 27; z *= C2; z ^= z >> 31; return z;
}

inline uint64_t base_key(uint64_t seed) { return seed * P1 + C2; }

inline uint32_t rng_bits(uint64_t key, uint64_t purpose, uint64_t host,
                         uint64_t ctr) {
  uint64_t z = key + purpose * P1 + host * P2 + ctr * P3;
  return static_cast<uint32_t>(mix(mix(z)) >> 32);
}

inline uint64_t neg_log1m_q32(uint32_t b) {
  uint64_t x = (1ull << 32) - static_cast<uint64_t>(b);  // [1, 2^32]
  int k = 63 - __builtin_clzll(x);
  uint64_t m = x << (63 - k);
  uint64_t frac = (m << 1) >> 1;
  uint64_t idx = frac >> (63 - LOG_BITS);
  uint64_t rem = (frac >> (63 - LOG_BITS - 24)) & ((1ull << 24) - 1);
  uint64_t lo = LOG_TBL[idx], hi = LOG_TBL[idx + 1];
  uint64_t log2_frac = lo + (((hi - lo) * rem) >> 24);
  uint64_t log2_x = (static_cast<uint64_t>(k) << 32) + log2_frac;
  uint64_t e2 = (32ull << 32) - log2_x;
  return (e2 * (LN2_Q32 >> 5)) >> 27;
}

inline int64_t exponential_ns(uint32_t b, uint64_t mean_ns) {
  uint64_t e = neg_log1m_q32(b);
  if (mean_ns > (1ull << 38)) mean_ns = 1ull << 38;
  uint64_t d = mean_ns * (e >> 32) + ((mean_ns * ((e & 0xFFFFFFFFull) >> 7)) >> 25);
  return d < 1 ? 1 : static_cast<int64_t>(d);
}

inline int32_t randint(uint32_t b, uint64_t n) {
  return static_cast<int32_t>((static_cast<uint64_t>(b) * n) >> 32);
}

// ------------------------------------------------------------- engine ----
constexpr uint64_t R_PHOLD_DELAY = 1, R_PHOLD_DST = 2;
constexpr int64_t TB_PACKET_BASE = 1ll << 62;

struct Ev {
  int64_t time;
  int64_t tb;
  int32_t host;
  bool operator>(const Ev& o) const {
    if (time != o.time) return time > o.time;
    return tb > o.tb;
  }
};

struct Shard {
  std::priority_queue<Ev, std::vector<Ev>, std::greater<Ev>> heap;
  std::vector<Ev> mailbox;          // cross-thread deliveries (locked)
  std::mutex mbox_mu;
  // counters
  int64_t events = 0, pkts_sent = 0, pkts_delivered = 0;
  int64_t ev_overflow = 0, ob_overflow = 0;
  char pad[64];                     // no false sharing between shards
};

int main_run(int argc, char** argv) {
  if (argc != 11) {
    std::fprintf(stderr, "need 10 args\n");
    return 2;
  }
  const char* table_file = argv[1];
  const int64_t n_hosts = std::atoll(argv[2]);
  const uint64_t seed = std::strtoull(argv[3], nullptr, 10);
  const int64_t n_windows = std::atoll(argv[4]);
  const int64_t window_ns = std::atoll(argv[5]);
  const uint64_t mean_delay = std::strtoull(argv[6], nullptr, 10);
  const int init_events = std::atoi(argv[7]);
  const int64_t ev_cap = std::atoll(argv[8]);
  const int64_t ob_cap = std::atoll(argv[9]);
  const int n_threads = std::atoi(argv[10]);

  {  // Q32 log2 table + ln2 constant, dumped by shadow1_tpu_torch.native
    std::FILE* f = std::fopen(table_file, "rb");
    if (!f) { std::fprintf(stderr, "cannot open %s\n", table_file); return 2; }
    size_t want = (1 << LOG_BITS) + 1;
    if (std::fread(LOG_TBL, 8, want, f) != want ||
        std::fread(&LN2_Q32, 8, 1, f) != 1) {
      std::fprintf(stderr, "bad table file\n");
      std::fclose(f);
      return 2;
    }
    std::fclose(f);
  }

  const uint64_t key = base_key(seed);
  const int64_t lat = window_ns;  // single-vertex experiment: lat == window
  const int64_t end_time = n_windows * window_ns;

  // Per-host state (SoA, shared; each host touched by exactly one thread).
  std::vector<int64_t> self_ctr(n_hosts, 0), pkt_ctr(n_hosts, 0),
      draw_ctr(n_hosts, 0), pending(n_hosts, 0), ob_used(n_hosts, 0),
      ob_win(n_hosts, -1), hops(n_hosts, 0);

  std::vector<Shard> shards(n_threads);
  auto owner = [&](int64_t h) {
    return static_cast<int>(h * n_threads / n_hosts);
  };

  // Seed: init_events per host at t=0 (tb = self_ctr ordering, ev_cap'd).
  for (int64_t h = 0; h < n_hosts; ++h) {
    Shard& s = shards[owner(h)];
    for (int i = 0; i < init_events; ++i) {
      if (pending[h] >= ev_cap) { s.ev_overflow++; continue; }
      pending[h]++;
      s.heap.push({0, self_ctr[h]++, static_cast<int32_t>(h)});
    }
  }

  std::atomic<int> barrier_count{0};
  std::atomic<int64_t> barrier_gen{0};
  auto barrier = [&]() {
    int64_t gen = barrier_gen.load();
    if (barrier_count.fetch_add(1) == n_threads - 1) {
      barrier_count.store(0);
      barrier_gen.fetch_add(1);
    } else {
      while (barrier_gen.load() == gen) std::this_thread::yield();
    }
  };

  auto worker = [&](int t) {
    Shard& me = shards[t];
    for (int64_t w = 0; w < n_windows; ++w) {
      const int64_t win_end = (w + 1) * window_ns;
      while (!me.heap.empty() && me.heap.top().time < win_end) {
        Ev ev = me.heap.top();
        me.heap.pop();
        const int64_t h = ev.host;
        pending[h]--;
        me.events++;
        hops[h]++;
        // PHOLD hop: exponential delay + uniform destination.
        const int64_t c = draw_ctr[h]++;
        const int64_t delay =
            exponential_ns(rng_bits(key, R_PHOLD_DELAY, h, c), mean_delay);
        const int32_t dst = randint(rng_bits(key, R_PHOLD_DST, h, c),
                                    static_cast<uint64_t>(n_hosts));
        const int64_t t_next = ev.time + delay;
        if (dst == h) {
          if (pending[h] >= ev_cap) { me.ev_overflow++; continue; }
          pending[h]++;
          me.heap.push({t_next, self_ctr[h]++, static_cast<int32_t>(h)});
        } else {
          // outbox accounting per (src, window of `now`)
          const int64_t cur_win = ev.time / window_ns;
          if (ob_win[h] != cur_win) { ob_win[h] = cur_win; ob_used[h] = 0; }
          if (ob_used[h] >= ob_cap) { me.ob_overflow++; continue; }
          ob_used[h]++;
          const int64_t pc = pkt_ctr[h]++;
          me.pkts_sent++;
          // loss_vv == 0 on the bench config; loss draw elided (the Python
          // oracle draws lazily per packet only when loss > 0... it draws
          // always; counters unaffected since threshold 0 never fires)
          const int64_t arrival = t_next + lat;
          const int64_t tb = TB_PACKET_BASE + (h << 32) + (pc & 0xFFFFFFFF);
          Shard& dsts = shards[owner(dst)];
          if (&dsts == &me) {
            // same thread: deliver directly (arrival is next window —
            // conservative lookahead keeps this window-safe)
            if (pending[dst] >= ev_cap) { me.ev_overflow++; continue; }
            pending[dst]++;
            me.pkts_delivered++;
            me.heap.push({arrival, tb, dst});
          } else {
            std::lock_guard<std::mutex> g(dsts.mbox_mu);
            dsts.mailbox.push_back({arrival, tb, dst});
          }
        }
      }
      barrier();  // all threads done with [w*W, (w+1)*W)
      // drain my mailbox (ev_cap accounting on MY hosts — single writer)
      {
        std::lock_guard<std::mutex> g(me.mbox_mu);
        for (const Ev& ev : me.mailbox) {
          if (pending[ev.host] >= ev_cap) { me.ev_overflow++; continue; }
          pending[ev.host]++;
          me.pkts_delivered++;
          me.heap.push(ev);
        }
        me.mailbox.clear();
      }
      barrier();  // mailboxes drained before anyone enters the next window
    }
  };

  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  const double wall =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();

  int64_t events = 0, sent = 0, deliv = 0, ev_over = 0, ob_over = 0;
  for (const Shard& s : shards) {
    events += s.events; sent += s.pkts_sent; deliv += s.pkts_delivered;
    ev_over += s.ev_overflow; ob_over += s.ob_overflow;
  }
  (void)end_time;
  std::printf(
      "{\"events\": %lld, \"pkts_sent\": %lld, \"pkts_delivered\": %lld, "
      "\"ev_overflow\": %lld, \"ob_overflow\": %lld, \"wall_s\": %.6f, "
      "\"events_per_sec\": %.1f, \"n_threads\": %d}\n",
      static_cast<long long>(events), static_cast<long long>(sent),
      static_cast<long long>(deliv), static_cast<long long>(ev_over),
      static_cast<long long>(ob_over), wall, events / wall, n_threads);
  return 0;
}

}  // namespace

int main(int argc, char** argv) { return main_run(argc, argv); }
