// Thread-per-core NET-model comparator — the honest CPU baseline for the
// ladder's network rungs (filexfer / tgen / tor / bitcoin over virtual TCP).
//
// The PHOLD comparator gives no denominator on a net rung. This program
// is the same thread-per-core scheduler shape (reference:
// src/main/core/scheduler/scheduler-policy-host-steal.c — hosts partitioned
// across workers, conservative windows, barrier rounds, locked cross-thread
// packet push) carrying a full mirror of the framework's virtual TCP stack
// and model applications.
//
// Exact-parity contract: identical semantics to shadow1_tpu_torch/cpu_engine/
// (the Python oracle) and therefore to the batched engine — same
// splitmix64 counter RNG (Q32 log2 table loaded from the Python dump),
// same (time, tb) event order, same TCP state machine (Go-Back-N, Reno,
// RFC6298 integer RTT), same capacity gates. tests/test_native_comparator.py
// asserts counter equality, which is what makes this wall clock an honest
// baseline. Fidelity knobs NOT implemented (stop/cpu/qlen/aqm): the Python
// wrapper refuses configs that use them rather than diverging silently.
//
// Usage: net_comparator <table_file> <config_blob> <n_threads>
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

uint64_t LOG_TBL[(1 << LOG_BITS) + 1];
uint64_t LN2_Q32 = 0;

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
  uint64_t x = (1ull << 32) - static_cast<uint64_t>(b);
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
// mean_ns must be PRE-ROUNDED by the Python side (np.round is half-even;
// no C++ rounding happens here so no libm/rounding drift can enter).
inline int64_t exponential_ns(uint32_t b, uint64_t mean_ns) {
  uint64_t e = neg_log1m_q32(b);
  if (mean_ns > (1ull << 38)) mean_ns = 1ull << 38;
  uint64_t d = mean_ns * (e >> 32) + ((mean_ns * ((e & 0xFFFFFFFFull) >> 7)) >> 25);
  return d < 1 ? 1 : static_cast<int64_t>(d);
}
inline int32_t randint(uint32_t b, uint64_t n) {
  return static_cast<int32_t>((static_cast<uint64_t>(b) * n) >> 32);
}

// ------------------------------------------------------- shared consts ----
// Mirrors shadow1_tpu_torch/consts.py.
constexpr int K_PKT = 2, K_PKT_DELIVER = 3, K_TCP_TIMER = 4, K_TX_RESUME = 5,
              K_APP = 6;
constexpr int F_SYN = 1, F_ACK = 2, F_FIN = 4, F_DGRAM = 16;
constexpr int N_ESTABLISHED = 1, N_ACCEPTED = 2, N_MSG = 4, N_SPACE = 8,
              N_PEER_FIN = 16, N_CLOSED = 32, N_DGRAM = 64, N_DATA = 128;
constexpr int TCP_FREE = 0, TCP_LISTEN = 1, TCP_SYN_SENT = 2,
              TCP_SYN_RCVD = 3, TCP_ESTABLISHED = 4, TCP_FIN_WAIT_1 = 5,
              TCP_FIN_WAIT_2 = 6, TCP_CLOSE_WAIT = 7, TCP_LAST_ACK = 8,
              TCP_CLOSING = 9;
constexpr int64_t SSTHRESH_INIT = 1ll << 28, CWND_MAX = 1ll << 28;
constexpr int WIRE_OVERHEAD = 40;
constexpr int64_t TB_PACKET_BASE = 1ll << 62;
constexpr uint64_t R_LOSS = 3, R_APP = 4, R_TOR_PATH = 5, R_BTC = 6,
                   R_JITTER = 7;
constexpr int64_t SEC = 1000000000ll;

inline bool sendable(int st) {
  return st == TCP_SYN_SENT || st == TCP_SYN_RCVD || st == TCP_ESTABLISHED ||
         st == TCP_CLOSE_WAIT || st == TCP_FIN_WAIT_1 || st == TCP_LAST_ACK ||
         st == TCP_CLOSING;
}
inline bool conn_state(int st) {
  return st >= TCP_SYN_SENT && st <= TCP_CLOSING;  // SYN_SENT..CLOSING
}
inline bool rcv_state(int st) {
  return st == TCP_ESTABLISHED || st == TCP_FIN_WAIT_1 || st == TCP_FIN_WAIT_2;
}

// u32 wrapping sequence arithmetic (consts.py seq_*).
inline uint32_t seq_add(uint32_t a, int64_t n) {
  return static_cast<uint32_t>(a + static_cast<uint32_t>(n));
}
inline int32_t seq_sub(uint32_t a, uint32_t b) {
  return static_cast<int32_t>(a - b);
}
inline bool seq_lt(uint32_t a, uint32_t b) { return seq_sub(a, b) < 0; }
inline bool seq_le(uint32_t a, uint32_t b) { return seq_sub(a, b) <= 0; }

inline int64_t ser_delay(int64_t wire_bytes, int64_t bw_bits) {
  return (wire_bytes * 8 * SEC + bw_bits - 1) / bw_bits;
}

// ------------------------------------------------------------- config ----
struct Config {
  int64_t n_hosts, seed, window_ns, n_windows;
  int64_t ev_cap, outbox_cap, sockets_per_host, msgq_cap, send_burst;
  int64_t mss, init_cwnd_mss, sndbuf, rcvbuf, rto_min, rto_max, rto_init,
      dupack_thresh;
  int64_t V, has_jitter, app_id;
  std::vector<int64_t> lat_vv, jit_vv;
  std::vector<uint64_t> loss_thr;
  std::vector<int64_t> host_vertex, bw_up, bw_dn;
  // app arrays (meaning depends on app_id; all length n_hosts unless noted)
  std::vector<int64_t> a0, a1, a2, a3, a4;   // generic per-host columns
  std::vector<uint64_t> m0, m1;              // pre-rounded means
  int64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0;  // scalars
  // tor tables / bitcoin peers
  std::vector<int64_t> t_ids0, t_ids1, t_ids2, t_ids3;  // guard/exit/relay/dir
  std::vector<int64_t> t_cum0, t_cum1, t_cum2;
  std::vector<int64_t> peers;  // bitcoin [H*K] host-major
};

bool read_config(const char* path, Config* c) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  auto rd = [&](void* p, size_t n) { return std::fread(p, 1, n, f) == n; };
  auto rd_i64 = [&](int64_t* p) { return rd(p, 8); };
  auto rd_vec = [&](std::vector<int64_t>* v) {
    int64_t n;
    if (!rd_i64(&n)) return false;
    v->resize(n);
    return n == 0 || rd(v->data(), n * 8);
  };
  auto rd_uvec = [&](std::vector<uint64_t>* v) {
    int64_t n;
    if (!rd_i64(&n)) return false;
    v->resize(n);
    return n == 0 || rd(v->data(), n * 8);
  };
  uint64_t magic;
  bool ok = rd(&magic, 8) && magic == 0x53484457434D5032ull;
  int64_t* hdr[] = {&c->n_hosts, &c->seed, &c->window_ns, &c->n_windows,
                    &c->ev_cap, &c->outbox_cap, &c->sockets_per_host,
                    &c->msgq_cap, &c->send_burst, &c->mss, &c->init_cwnd_mss,
                    &c->sndbuf, &c->rcvbuf, &c->rto_min, &c->rto_max,
                    &c->rto_init, &c->dupack_thresh, &c->V, &c->has_jitter,
                    &c->app_id};
  for (auto* p : hdr) ok = ok && rd_i64(p);
  ok = ok && rd_vec(&c->lat_vv) && rd_vec(&c->jit_vv) &&
       rd_uvec(&c->loss_thr) && rd_vec(&c->host_vertex) &&
       rd_vec(&c->bw_up) && rd_vec(&c->bw_dn);
  ok = ok && rd_vec(&c->a0) && rd_vec(&c->a1) && rd_vec(&c->a2) &&
       rd_vec(&c->a3) && rd_vec(&c->a4) && rd_uvec(&c->m0) && rd_uvec(&c->m1);
  for (auto* p : {&c->s0, &c->s1, &c->s2, &c->s3, &c->s4}) ok = ok && rd_i64(p);
  ok = ok && rd_vec(&c->t_ids0) && rd_vec(&c->t_cum0) && rd_vec(&c->t_ids1) &&
       rd_vec(&c->t_cum1) && rd_vec(&c->t_ids2) && rd_vec(&c->t_cum2) &&
       rd_vec(&c->t_ids3) && rd_vec(&c->peers);
  std::fclose(f);
  return ok;
}

// -------------------------------------------------------------- engine ----
struct Ev {
  int64_t time, tb;
  int32_t host, kind;
  int32_t p[10];
  bool operator>(const Ev& o) const {
    if (time != o.time) return time > o.time;
    if (tb != o.tb) return tb > o.tb;
    return host > o.host;  // cross-host ties are order-independent
  }
};

struct Metrics {
  int64_t events = 0, pkts_sent = 0, pkts_delivered = 0, pkts_lost = 0;
  int64_t ev_overflow = 0, ob_overflow = 0;
  int64_t tcp_fast_rtx = 0, tcp_rto = 0, tcp_ooo_drops = 0;
  int64_t pops_deliver = 0, pops_timer = 0, pops_txr = 0, pops_app = 0;
};

struct Sock {
  int32_t st = TCP_FREE, peer_host = 0, peer_sock = 0;
  uint32_t snd_una = 0, snd_nxt = 0, snd_max = 0, rcv_nxt = 0, app_end = 0;
  int32_t fin_pend = 0;
  int64_t cwnd = 0, ssthresh = 0, peer_wnd = 0;
  int32_t dupacks = 0;
  uint32_t recover = 0, ts_seq = 0;
  int64_t srtt = 0, rttvar = 0, rto = 0, rtx_t = 0, ts_time = 0;
  bool timer_armed = false, ts_act = false;
  int32_t txr = 0;
  std::vector<std::pair<uint32_t, int32_t>> mq;  // (end_seq, meta)
};

struct Shard {
  std::priority_queue<Ev, std::vector<Ev>, std::greater<Ev>> heap;
  std::vector<Ev> mailbox;
  std::mutex mbox_mu;
  Metrics m;
  char pad[64];
};

struct Engine;

// App interface.
struct App {
  virtual ~App() = default;
  virtual void start(Engine& e) = 0;
  virtual void on_wakeup(Engine& e, int h, int64_t now, const int32_t* p) = 0;
  virtual void on_notify(Engine& e, int h, int sock, int flags, int32_t meta,
                         int32_t meta2, int32_t dlen, int64_t now) = 0;
  virtual void summary(char* buf, size_t n) = 0;
};

struct Engine {
  const Config& c;
  uint64_t key;
  int n_threads;
  std::vector<Shard> shards;
  // Per-host state (each host touched by exactly one thread).
  std::vector<int64_t> self_ctr, pkt_ctr, pending, ob_used, ob_win;
  std::vector<int64_t> tx_free, rx_free, tx_bytes, rx_bytes;
  std::vector<Sock> socks;  // [h * S + s]
  App* app = nullptr;

  explicit Engine(const Config& cfg, int nt)
      : c(cfg), key(base_key(cfg.seed)), n_threads(nt), shards(nt),
        self_ctr(cfg.n_hosts, 0), pkt_ctr(cfg.n_hosts, 0),
        pending(cfg.n_hosts, 0), ob_used(cfg.n_hosts, 0),
        ob_win(cfg.n_hosts, -1), tx_free(cfg.n_hosts, 0),
        rx_free(cfg.n_hosts, 0), tx_bytes(cfg.n_hosts, 0),
        rx_bytes(cfg.n_hosts, 0),
        socks(cfg.n_hosts * cfg.sockets_per_host) {}

  int owner(int64_t h) const {
    return static_cast<int>(h * n_threads / c.n_hosts);
  }
  Sock& sk(int h, int s) { return socks[h * c.sockets_per_host + s]; }
  Shard& shard_of(int h) { return shards[owner(h)]; }

  void schedule_local(int h, int64_t time, int kind, const int32_t* p,
                      int np_) {
    Shard& s = shard_of(h);
    if (pending[h] >= c.ev_cap) { s.m.ev_overflow++; return; }
    pending[h]++;
    Ev ev{time, self_ctr[h]++, h, kind, {0}};
    for (int i = 0; i < np_; ++i) ev.p[i] = p[i];
    s.heap.push(ev);
  }
  void schedule_local1(int h, int64_t t, int kind, int32_t p0) {
    int32_t p[1] = {p0};
    schedule_local(h, t, kind, p, 1);
  }

  int64_t outbox_space(int h, int64_t now) {
    int64_t w = now / c.window_ns;
    if (ob_win[h] != w) { ob_win[h] = w; ob_used[h] = 0; }
    return c.outbox_cap - ob_used[h];
  }

  // Route one packet (mirror of CpuEngine.send; no stop/cpu fidelity).
  void send(int src, int dst, int64_t depart, const int32_t* p, int64_t now) {
    Shard& me = shard_of(src);
    if (outbox_space(src, now) <= 0) { me.m.ob_overflow++; return; }
    ob_used[src]++;
    int64_t ctr = pkt_ctr[src]++;
    me.m.pkts_sent++;
    int64_t vs = c.host_vertex[src], vd = c.host_vertex[dst];
    uint64_t thr = c.loss_thr[vs * c.V + vd];
    if (static_cast<uint64_t>(rng_bits(key, R_LOSS, src, ctr)) < thr) {
      me.m.pkts_lost++;
      return;
    }
    int64_t arrival = depart + c.lat_vv[vs * c.V + vd];
    if (c.has_jitter) {
      int64_t jit = c.jit_vv[vs * c.V + vd];
      if (jit)
        arrival += randint(rng_bits(key, R_JITTER, src, ctr), 2 * jit + 1) - jit;
    }
    Ev ev{arrival, TB_PACKET_BASE + (static_cast<int64_t>(src) << 32) +
                       (ctr & 0xFFFFFFFFll),
          dst, K_PKT, {0}};
    for (int i = 0; i < 10; ++i) ev.p[i] = p[i];
    Shard& ds = shard_of(dst);
    if (&ds == &me) {
      if (pending[dst] >= c.ev_cap) { me.m.ev_overflow++; return; }
      pending[dst]++;
      me.m.pkts_delivered++;
      me.heap.push(ev);
    } else {
      std::lock_guard<std::mutex> g(ds.mbox_mu);
      ds.mailbox.push_back(ev);
    }
  }

  // ---- NIC + emission (mirror of CpuNetModel) ----
  void rx_convert(int h, int64_t time, int64_t tb, const int32_t* p) {
    // pop freed a slot; capacity cannot overflow (schedule_packet contract)
    int64_t wire = p[4] + WIRE_OVERHEAD;
    int64_t ready = time > rx_free[h] ? time : rx_free[h];
    rx_free[h] = ready + ser_delay(wire, c.bw_dn[h]);
    rx_bytes[h] += wire;
    pending[h]++;
    Ev ev{ready, tb, h, K_PKT_DELIVER, {0}};
    for (int i = 0; i < 10; ++i) ev.p[i] = p[i];
    shard_of(h).heap.push(ev);
  }

  int64_t tx_reserve(int h, int64_t wire, int64_t now) {
    // No aqm / drop-tail fidelity (wrapper refuses such configs).
    int64_t depart = now > tx_free[h] ? now : tx_free[h];
    tx_free[h] = depart + ser_delay(wire, c.bw_up[h]);
    tx_bytes[h] += wire;
    return depart;
  }

  void emit(int h, int s, int flags, uint32_t seq, int32_t length,
            int32_t mend, int32_t mmeta, int64_t now) {
    Sock& k = sk(h, s);
    int32_t p[10] = {h,
                     s | (k.peer_sock << 8) | (flags << 16),
                     static_cast<int32_t>(seq),
                     static_cast<int32_t>(k.rcv_nxt),
                     length,
                     static_cast<int32_t>(c.rcvbuf),
                     mend,
                     mmeta,
                     0,
                     0};
    int64_t depart = tx_reserve(h, length + WIRE_OVERHEAD, now);
    send(h, k.peer_host, depart, p, now);
  }

  void udp_send(int h, int dst_host, int dst_sock, int32_t length,
                int32_t meta, int32_t meta2, int64_t now) {
    int32_t p[10] = {h, (dst_sock << 8) | (F_DGRAM << 16), 0, 0, length,
                     0, 0, meta, meta2, 0};
    int64_t depart = tx_reserve(h, length + WIRE_OVERHEAD, now);
    send(h, dst_host, depart, p, now);
  }

  // ---- TCP sender (mirror of CpuNetModel.flush / ack_now) ----
  void flush(int h, int s, int64_t now) {
    Sock& k = sk(h, s);
    for (int64_t i = 0; i < c.send_burst; ++i) {
      uint32_t total_end = seq_add(k.app_end, k.fin_pend);
      bool pend = seq_lt(k.snd_nxt, total_end);
      int64_t flight = seq_sub(k.snd_nxt, k.snd_una);
      int64_t limit = k.cwnd < k.peer_wnd ? k.cwnd : k.peer_wnd;
      if (!(sendable(k.st) && pend && flight < limit &&
            outbox_space(h, now) > 0))
        break;
      int flags;
      int32_t length;
      bool seg_syn = false, seg_fin = false;
      if (k.snd_nxt == 0) {
        flags = k.st == TCP_SYN_RCVD ? (F_SYN | F_ACK) : F_SYN;
        length = 0;
        seg_syn = true;
      } else if (k.snd_nxt == k.app_end && k.fin_pend) {
        flags = F_FIN | F_ACK;
        length = 0;
        seg_fin = true;
      } else {
        flags = F_ACK;
        int64_t l = c.mss;
        int64_t rem = seq_sub(k.app_end, k.snd_nxt);
        if (rem < l) l = rem;
        if (limit - flight < l) l = limit - flight;
        length = static_cast<int32_t>(l);
      }
      int32_t mend = 0, mmeta = 0;
      if (!seg_syn && !seg_fin) {
        uint32_t seg_hi = seq_add(k.snd_nxt, length);
        bool have = false;
        int32_t best_d = 0;
        for (const auto& em : k.mq) {
          if (seq_lt(k.snd_nxt, em.first) && seq_le(em.first, seg_hi)) {
            int32_t d = seq_sub(em.first, k.snd_nxt);
            if (!have || d < best_d) {
              have = true;
              best_d = d;
              mend = static_cast<int32_t>(em.first);
              mmeta = em.second;
            }
          }
        }
        if (have) length = best_d;
      }
      emit(h, s, flags, k.snd_nxt, length, mend, mmeta, now);
      k.snd_nxt = seq_add(k.snd_nxt, length + ((seg_syn || seg_fin) ? 1 : 0));
      if (seq_lt(k.snd_max, k.snd_nxt)) k.snd_max = k.snd_nxt;
      if (!k.ts_act) {
        k.ts_act = true;
        k.ts_seq = k.snd_nxt;
        k.ts_time = now;
      }
      if (k.rtx_t == 0) {
        k.rtx_t = now + k.rto;
        if (!k.timer_armed) {
          k.timer_armed = true;
          schedule_local1(h, now + k.rto, K_TCP_TIMER, s);
        }
      }
    }
    uint32_t total_end = seq_add(k.app_end, k.fin_pend);
    bool pend = seq_lt(k.snd_nxt, total_end);
    int64_t limit = k.cwnd < k.peer_wnd ? k.cwnd : k.peer_wnd;
    bool wnd_ok = seq_sub(k.snd_nxt, k.snd_una) < limit;
    bool blocked = outbox_space(h, now) <= 0;
    if (sendable(k.st) && pend && wnd_ok && !k.txr) {
      k.txr = 1;
      int64_t t_resume =
          blocked ? (now / c.window_ns + 1) * c.window_ns : now;
      schedule_local1(h, t_resume, K_TX_RESUME, s);
    }
  }

  void ack_now(int h, int s, int64_t now) {
    if (outbox_space(h, now) > 0) {
      Sock& k = sk(h, s);
      emit(h, s, F_ACK, k.snd_nxt, 0, 0, 0, now);
    }
  }

  // ---- App-facing TCP API ----
  void listen(int h, int s) { sk(h, s).st = TCP_LISTEN; }

  void init_conn(Sock& k, int peer_host, int peer_sock, int state,
                 uint32_t rcv_nxt) {
    k.st = state;
    k.peer_host = peer_host;
    k.peer_sock = peer_sock;
    k.snd_una = k.snd_nxt = k.snd_max = 0;
    k.rcv_nxt = rcv_nxt;
    k.app_end = 1;
    k.fin_pend = 0;
    k.cwnd = c.init_cwnd_mss * c.mss;
    k.ssthresh = SSTHRESH_INIT;
    k.peer_wnd = c.mss;
    k.srtt = k.rttvar = 0;
    k.rto = c.rto_init;
    k.rtx_t = 0;
    k.dupacks = 0;
    k.recover = 0;
    k.ts_act = false;
    k.txr = 0;
    k.mq.clear();
  }

  void connect(int h, int s, int dst_host, int dst_sock, int64_t now) {
    init_conn(sk(h, s), dst_host, dst_sock, TCP_SYN_SENT, 0);
    flush(h, s, now);
  }

  int64_t tcp_send(int h, int s, int64_t nbytes, int32_t meta, int64_t now) {
    Sock& k = sk(h, s);
    int64_t buffered = seq_sub(k.app_end, k.snd_una) - (k.snd_una == 0 ? 1 : 0);
    int64_t space = c.sndbuf - buffered;
    if (space < 0) space = 0;
    int64_t accepted = nbytes < space ? nbytes : space;
    if (accepted < 0) accepted = 0;
    if (accepted > 0) {
      k.app_end = seq_add(k.app_end, accepted);
      if (accepted == nbytes && meta != 0 &&
          static_cast<int64_t>(k.mq.size()) < c.msgq_cap)
        k.mq.emplace_back(k.app_end, meta);
      flush(h, s, now);
    }
    return accepted;
  }

  void close(int h, int s, int64_t now) {
    Sock& k = sk(h, s);
    if (k.st == TCP_ESTABLISHED) k.st = TCP_FIN_WAIT_1;
    else if (k.st == TCP_CLOSE_WAIT) k.st = TCP_LAST_ACK;
    else return;
    k.fin_pend = 1;
    flush(h, s, now);
  }

  // ---- TCP receive (mirror of CpuNetModel.tcp_rx, same sequencing) ----
  void tcp_rx(int h, const int32_t* p, int64_t now) {
    Metrics& m = shard_of(h).m;
    int src = p[0];
    int packed = p[1];
    uint32_t seq = static_cast<uint32_t>(p[2]);
    uint32_t ackno = static_cast<uint32_t>(p[3]);
    int32_t length = p[4];
    int64_t wnd = p[5];
    int32_t mend = p[6], mmeta = p[7];
    int ss = packed & 0xFF, ds = (packed >> 8) & 0xFF;
    int flags = (packed >> 16) & 0xFF;
    bool is_syn = flags & F_SYN, is_ack = flags & F_ACK, is_fin = flags & F_FIN;
    Sock& k = sk(h, ds);
    int notifs = 0;
    int32_t n_meta = 0, n_dlen = 0;

    if (is_syn && !is_ack && k.st == TCP_LISTEN) {
      bool dup = false;
      for (int i = 0; i < c.sockets_per_host; ++i) {
        Sock& ck = sk(h, i);
        if (ck.peer_host == src && ck.peer_sock == ss &&
            ck.st != TCP_FREE && ck.st != TCP_LISTEN) { dup = true; break; }
      }
      int child = -1;
      for (int i = static_cast<int>(c.sockets_per_host) - 1; i >= 0; --i)
        if (sk(h, i).st == TCP_FREE) { child = i; break; }
      if (!dup && child >= 0) {
        Sock& ck = sk(h, child);
        init_conn(ck, src, ss, TCP_SYN_RCVD, 1);
        ck.peer_wnd = wnd;
        flush(h, child, now);
      }
      return;
    }

    bool learn_peer = k.st == TCP_SYN_SENT && is_syn && is_ack;
    bool v = conn_state(k.st) && k.peer_host == src &&
             (k.peer_sock == ss || learn_peer);
    if (!v) return;
    if (learn_peer) k.peer_sock = ss;
    if (is_ack) k.peer_wnd = wnd > 1 ? wnd : 1;

    int state = k.st;
    uint32_t snd_una0 = k.snd_una, snd_nxt0 = k.snd_nxt;
    uint32_t snd_max0 = k.snd_max;
    // ACK acceptance tests against snd_max (highest ever sent), not the
    // possibly-rewound snd_nxt — mirror of tcp.py (outage deadlock fix).
    bool new_ack = is_ack && seq_lt(snd_una0, ackno) && seq_le(ackno, snd_max0);
    bool est_ss = is_ack && is_syn && state == TCP_SYN_SENT && ackno == 1;
    bool frx = false;
    bool closed_by_ack = false;
    if (new_ack) {
      if (k.ts_act && seq_le(k.ts_seq, ackno)) {
        int64_t rtt = now - k.ts_time;
        if (rtt < 1) rtt = 1;
        if (k.srtt == 0) { k.srtt = rtt; k.rttvar = rtt / 2; }
        else {
          int64_t err = rtt - k.srtt;
          k.srtt += err >> 3;
          int64_t ae = err < 0 ? -err : err;
          k.rttvar += (ae - k.rttvar) >> 2;
        }
        int64_t var4 = 4 * k.rttvar;
        if (var4 < 1000000) var4 = 1000000;
        int64_t rto = k.srtt + var4;
        if (rto < c.rto_min) rto = c.rto_min;
        if (rto > c.rto_max) rto = c.rto_max;
        k.rto = rto;
        k.ts_act = false;
      }
      int64_t grow = k.cwnd < k.ssthresh
                         ? c.mss
                         : std::max<int64_t>((c.mss * c.mss) /
                                                 std::max<int64_t>(k.cwnd, 1),
                                             1);
      k.cwnd = std::min<int64_t>(k.cwnd + grow, CWND_MAX);
      k.snd_una = ackno;
      if (seq_lt(k.snd_nxt, ackno)) k.snd_nxt = ackno;
      k.dupacks = 0;
      {
        size_t w = 0;
        for (size_t i = 0; i < k.mq.size(); ++i)
          if (seq_lt(ackno, k.mq[i].first)) k.mq[w++] = k.mq[i];
        k.mq.resize(w);
      }
      bool outstanding = seq_lt(ackno, snd_max0);
      k.rtx_t = outstanding ? now + k.rto : 0;
      if (state == TCP_SYN_RCVD) { k.st = TCP_ESTABLISHED; notifs |= N_ACCEPTED; }
    }
    if (est_ss) { k.st = TCP_ESTABLISHED; k.rcv_nxt = 1; notifs |= N_ESTABLISHED; }
    if (new_ack) {
      uint32_t total_end = seq_add(k.app_end, k.fin_pend);
      bool fin_acked = k.fin_pend == 1 && ackno == total_end;
      if (fin_acked && state == TCP_FIN_WAIT_1) k.st = TCP_FIN_WAIT_2;
      if (fin_acked && (state == TCP_CLOSING || state == TCP_LAST_ACK)) {
        closed_by_ack = true;
        notifs |= N_CLOSED;
      }
      if ((state == TCP_ESTABLISHED || state == TCP_CLOSE_WAIT) &&
          !closed_by_ack)
        notifs |= N_SPACE;
    }
    bool dup_a = is_ack && !new_ack && ackno == snd_una0 &&
                 seq_lt(ackno, snd_max0) && length == 0 && !is_syn && !is_fin;
    if (dup_a) {
      k.dupacks++;
      if (k.dupacks == c.dupack_thresh && seq_le(k.recover, snd_una0)) {
        frx = true;
        int64_t flight = seq_sub(snd_nxt0, snd_una0);
        k.ssthresh = std::max<int64_t>(flight / 2, 2 * c.mss);
        k.cwnd = k.ssthresh;
        k.recover = snd_nxt0;
        k.snd_nxt = snd_una0;
        k.ts_act = false;
        m.tcp_fast_rtx++;
      }
    }
    if (new_ack || frx) flush(h, ds, now);

    int state2 = k.st;
    bool can_rcv = rcv_state(state2);
    bool has_data = can_rcv && length > 0;
    bool in_order = has_data && seq == k.rcv_nxt;
    if (in_order) {
      k.rcv_nxt = seq_add(k.rcv_nxt, length);
      notifs |= N_DATA;
      n_dlen = length;
      if (mend != 0) { notifs |= N_MSG; n_meta = mmeta; }
    } else if (has_data) {
      m.tcp_ooo_drops++;
    }
    bool fin_here = is_fin && seq_add(seq, length) == k.rcv_nxt &&
                    (state2 == TCP_ESTABLISHED || state2 == TCP_FIN_WAIT_1 ||
                     state2 == TCP_FIN_WAIT_2);
    bool closed_by_fin = false;
    if (fin_here) {
      k.rcv_nxt = seq_add(k.rcv_nxt, 1);
      if (state2 == TCP_ESTABLISHED) { k.st = TCP_CLOSE_WAIT; notifs |= N_PEER_FIN; }
      else if (state2 == TCP_FIN_WAIT_1) k.st = TCP_CLOSING;
      else if (state2 == TCP_FIN_WAIT_2) { closed_by_fin = true; notifs |= N_CLOSED; }
    }
    if (closed_by_ack || closed_by_fin) { k.st = TCP_FREE; k.rtx_t = 0; }
    if (has_data || is_fin || est_ss) ack_now(h, ds, now);
    if (notifs) app->on_notify(*this, h, ds, notifs, n_meta, 0, n_dlen, now);
  }

  void tcp_timer(int h, int s, int64_t now) {
    Sock& k = sk(h, s);
    k.timer_armed = false;
    if (k.rtx_t == 0) return;
    if (now < k.rtx_t) {
      k.timer_armed = true;
      schedule_local1(h, k.rtx_t, K_TCP_TIMER, s);
      return;
    }
    bool outstanding = seq_lt(k.snd_una, k.snd_max);
    if (outstanding && sendable(k.st)) {
      int64_t flight = seq_sub(k.snd_nxt, k.snd_una);
      k.ssthresh = std::max<int64_t>(flight / 2, 2 * c.mss);
      k.cwnd = c.mss;
      k.rto = std::min<int64_t>(k.rto * 2, c.rto_max);
      k.snd_nxt = k.snd_una;
      k.ts_act = false;
      k.dupacks = 0;
      k.recover = k.snd_una;
      k.rtx_t = now + k.rto;
      k.timer_armed = true;
      shard_of(h).m.tcp_rto++;
      schedule_local1(h, k.rtx_t, K_TCP_TIMER, s);
      flush(h, s, now);
    } else {
      k.rtx_t = 0;
    }
  }

  void handle(int h, int64_t time, int kind, const int32_t* p) {
    Metrics& m = shard_of(h).m;
    if (kind == K_PKT_DELIVER) {
      m.pops_deliver++;
      int flags = (p[1] >> 16) & 0xFF;
      if (flags & F_DGRAM)
        app->on_notify(*this, h, (p[1] >> 8) & 0xFF, N_DGRAM, p[7], p[8],
                       p[4], time);
      else
        tcp_rx(h, p, time);
    } else if (kind == K_TCP_TIMER) {
      m.pops_timer++;
      tcp_timer(h, p[0], time);
    } else if (kind == K_TX_RESUME) {
      m.pops_txr++;
      sk(h, p[0]).txr = 0;
      flush(h, p[0], time);
    } else if (kind == K_APP) {
      m.pops_app++;
      app->on_wakeup(*this, h, time, p);
    }
  }
};

// ---------------------------------------------------------------- apps ----
// filexfer: a0=role a1=server a2=flow_bytes a3=start_time a4=flow_count
struct Filexfer : App {
  std::vector<int64_t> remaining, flows_left;
  std::vector<char> closed_sent;
  std::vector<int64_t> rx_bytes_, flows_done, done_time;
  static constexpr int FLOW_DONE = 1, OP_START = 1;

  void start(Engine& e) override {
    int64_t n = e.c.n_hosts;
    remaining.assign(n, 0);
    flows_left.assign(e.c.a4.begin(), e.c.a4.end());
    closed_sent.assign(n, 0);
    rx_bytes_.assign(n, 0);
    flows_done.assign(n, 0);
    done_time.assign(n, 0);
    for (int64_t h = 0; h < n; ++h) {
      if (e.c.a0[h] == 0) e.listen(h, 0);
      else if (e.c.a0[h] == 1)
        e.schedule_local1(h, e.c.a3[h], K_APP, OP_START);
    }
  }
  void client_start(Engine& e, int h, int64_t now) {
    remaining[h] = e.c.a2[h];
    closed_sent[h] = 0;
    e.connect(h, 0, static_cast<int>(e.c.a1[h]), 0, now);
  }
  void client_pump(Engine& e, int h, int64_t now) {
    if (remaining[h] > 0)
      remaining[h] -= e.tcp_send(h, 0, remaining[h], FLOW_DONE, now);
    if (remaining[h] == 0 && !closed_sent[h]) {
      closed_sent[h] = 1;
      e.close(h, 0, now);
    }
  }
  void on_wakeup(Engine& e, int h, int64_t now, const int32_t* p) override {
    if (p[0] == OP_START) client_start(e, h, now);
  }
  void on_notify(Engine& e, int h, int sock, int flags, int32_t meta,
                 int32_t, int32_t dlen, int64_t now) override {
    if (e.c.a0[h] == 1 && (flags & (N_ESTABLISHED | N_SPACE)))
      client_pump(e, h, now);
    if (e.c.a0[h] == 0) {
      if (flags & N_DATA) rx_bytes_[h] += dlen;
      if ((flags & N_MSG) && meta == FLOW_DONE) flows_done[h]++;
      if (flags & N_PEER_FIN) e.close(h, sock, now);
    }
    if (e.c.a0[h] == 1 && (flags & N_CLOSED)) {
      if (--flows_left[h] > 0) client_start(e, h, now);
      else done_time[h] = now;
    }
  }
  void summary(char* buf, size_t n) override {
    int64_t fd = 0, rb = 0;
    for (auto v : flows_done) fd += v;
    for (auto v : rx_bytes_) rb += v;
    std::snprintf(buf, n, "\"total_flows_done\": %lld, \"total_rx_bytes\": %lld",
                  (long long)fd, (long long)rb);
  }
};

// tgen: a0=active a1=streams a3=start_time m0=mean_bytes m1=mean_think
//       s0=fixed_size s1=fixed_bytes (trunc(mean), >=1)
struct Tgen : App {
  static constexpr int STREAM_DONE = 1, OP_START = 1;
  static constexpr int64_t SIZE_MAX_ = 1ll << 30;
  std::vector<int64_t> streams_left, remaining, ctr;
  std::vector<char> closed_sent;
  std::vector<int64_t> rx_bytes_, streams_served, streams_done, done_time;

  void start(Engine& e) override {
    int64_t n = e.c.n_hosts;
    streams_left.assign(e.c.a1.begin(), e.c.a1.end());
    remaining.assign(n, 0);
    ctr.assign(n, 0);
    closed_sent.assign(n, 0);
    rx_bytes_.assign(n, 0);
    streams_served.assign(n, 0);
    streams_done.assign(n, 0);
    done_time.assign(n, 0);
    for (int64_t h = 0; h < n; ++h) {
      e.listen(h, 0);
      if (e.c.a0[h] == 1 && streams_left[h] > 0)
        e.schedule_local1(h, e.c.a3[h], K_APP, OP_START);
    }
  }
  void start_stream(Engine& e, int h, int64_t now) {
    int64_t cc = ctr[h];
    int32_t raw = randint(rng_bits(e.key, R_APP, h, 3 * cc + 0),
                          e.c.n_hosts - 1);
    int dst = raw + (raw >= h ? 1 : 0);
    int64_t size;
    if (e.c.s0) {
      size = e.c.a4[h];  // fixed_size: pre-truncated max(int(mean), 1)
    } else {
      size = exponential_ns(rng_bits(e.key, R_APP, h, 3 * cc + 1), e.c.m0[h]);
      if (size < 1) size = 1;
      if (size > SIZE_MAX_) size = SIZE_MAX_;
    }
    remaining[h] = size;
    closed_sent[h] = 0;
    ctr[h]++;
    e.connect(h, 1, dst, 0, now);
  }
  void client_pump(Engine& e, int h, int64_t now) {
    if (remaining[h] > 0)
      remaining[h] -= e.tcp_send(h, 1, remaining[h], STREAM_DONE, now);
    if (remaining[h] == 0 && !closed_sent[h]) {
      closed_sent[h] = 1;
      e.close(h, 1, now);
    }
  }
  void on_wakeup(Engine& e, int h, int64_t now, const int32_t* p) override {
    if (p[0] == OP_START) start_stream(e, h, now);
  }
  void on_notify(Engine& e, int h, int sock, int flags, int32_t meta,
                 int32_t, int32_t dlen, int64_t now) override {
    if (sock == 1) {
      if (flags & (N_ESTABLISHED | N_SPACE)) client_pump(e, h, now);
      if (flags & N_CLOSED) {
        streams_left[h]--;
        streams_done[h]++;
        int64_t cc = ctr[h] - 1;
        if (streams_left[h] > 0) {
          int64_t think =
              exponential_ns(rng_bits(e.key, R_APP, h, 3 * cc + 2), e.c.m1[h]);
          e.schedule_local1(h, now + think, K_APP, OP_START);
        } else {
          done_time[h] = now;
        }
      }
    } else {
      if (flags & N_DATA) rx_bytes_[h] += dlen;
      if ((flags & N_MSG) && meta == STREAM_DONE) streams_served[h]++;
      if (flags & N_PEER_FIN) e.close(h, sock, now);
    }
  }
  void summary(char* buf, size_t n) override {
    int64_t sd = 0, rb = 0, sv = 0;
    for (auto v : streams_done) sd += v;
    for (auto v : rx_bytes_) rb += v;
    for (auto v : streams_served) sv += v;
    std::snprintf(buf, n,
                  "\"total_streams_done\": %lld, \"total_rx_bytes\": %lld, "
                  "\"total_streams_served\": %lld",
                  (long long)sd, (long long)rb, (long long)sv);
  }
};

// tor: a0=role a1=n_circuits a2=n_streams a3=start_time
//      m0=mean_cells m1=mean_think
//      s0=consensus_bytes s1=cells_max s2=ct_cap
//      t_ids0/cum0=guard t_ids1/cum1=exit t_ids2/cum2=relay t_ids3=dir
struct Tor : App {
  static constexpr int CELL = 512;
  static constexpr int C_CREATE = 1, C_CREATED = 2, C_EXTEND = 3,
                       C_EXTENDED = 4, C_BEGIN = 5, C_DATA = 6, C_END = 7,
                       C_DIRREQ = 8, C_DIRRESP = 9;
  static constexpr int OP_START = 1, OP_TX_CELL = 2, OP_CONNECT_RELAY = 3,
                       OP_DRAIN = 4, OP_THINK = 5;
  static constexpr int CL_DIR_CONN = 1, CL_DIR_FETCH = 2, CL_GUARD_CONN = 3,
                       CL_BUILDING = 4, CL_STREAM = 5, CL_DONE = 7;
  int64_t ct_cap = 0;
  std::vector<int32_t> cl_state, cl_guard, cl_circ, cl_hop, cl_mid, cl_exit,
      cl_circs_left, cl_streams_left, cl_cells_want;
  std::vector<int64_t> ctr, streams_done, cells_rx, bootstrap_time, done_time,
      cells_fwd, ct_overflow, cell_retries;
  // relay tables [h * cap + i]
  std::vector<int32_t> rc_peer, rc_next_circ;
  std::vector<char> ct_used, ct_pend;
  std::vector<int32_t> ct_in_sock, ct_in_circ, ct_out_sock, ct_out_circ;

  static int32_t meta_of(int64_t circ, int64_t aux, int cmd) {
    return static_cast<int32_t>((circ << 18) | (aux << 4) | cmd);
  }
  int64_t draw(int h) { return ctr[h]++; }
  int pick_weighted(Engine& e, int h, const std::vector<int64_t>& ids,
                    const std::vector<int64_t>& cum) {
    int32_t u = randint(rng_bits(e.key, R_TOR_PATH, h, draw(h)),
                        static_cast<uint64_t>(cum.back()));
    // searchsorted(cum, u, side="right"): first idx with cum[idx] > u
    size_t lo = 0, hi = cum.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (cum[mid] <= u) lo = mid + 1;
      else hi = mid;
    }
    size_t idx = lo < ids.size() ? lo : ids.size() - 1;
    return static_cast<int>(ids[idx]);
  }
  void push_cell(Engine& e, int h, int sock, int32_t meta, int32_t nbytes,
                 int64_t now) {
    int32_t p[4] = {OP_TX_CELL, sock, meta, nbytes};
    e.schedule_local(h, now, K_APP, p, 4);
  }
  void begin_circuit(Engine& e, int h, int64_t now) {
    cl_mid[h] = pick_weighted(e, h, e.c.t_ids2, e.c.t_cum2);
    cl_exit[h] = pick_weighted(e, h, e.c.t_ids1, e.c.t_cum1);
    cl_circ[h]++;
    cl_hop[h] = 1;
    cl_state[h] = CL_BUILDING;
    cl_streams_left[h] = static_cast<int32_t>(e.c.a2[h]);
    push_cell(e, h, 1, meta_of(cl_circ[h], 0, C_CREATE), CELL, now);
  }
  void begin_stream(Engine& e, int h, int64_t now) {
    int64_t want =
        exponential_ns(rng_bits(e.key, R_TOR_PATH, h, draw(h)), e.c.m0[h]);
    if (want < 1) want = 1;
    if (want > e.c.s1) want = e.c.s1;
    cl_cells_want[h] = static_cast<int32_t>(want);
    cl_state[h] = CL_STREAM;
    push_cell(e, h, 1, meta_of(cl_circ[h], want, C_BEGIN), CELL, now);
  }
  void think(Engine& e, int h, int64_t now) {
    int64_t t =
        exponential_ns(rng_bits(e.key, R_TOR_PATH, h, draw(h)), e.c.m1[h]);
    e.schedule_local1(h, now + t, K_APP, OP_THINK);
  }

  void start(Engine& e) override {
    int64_t n = e.c.n_hosts;
    int64_t s = e.c.sockets_per_host;
    ct_cap = e.c.s2;
    cl_state.assign(n, 0); cl_guard.assign(n, -1); cl_circ.assign(n, 0);
    cl_hop.assign(n, 0); cl_mid.assign(n, 0); cl_exit.assign(n, 0);
    cl_circs_left.assign(n, 0); cl_streams_left.assign(n, 0);
    cl_cells_want.assign(n, 0);
    for (int64_t h = 0; h < n; ++h)
      cl_circs_left[h] = static_cast<int32_t>(e.c.a1[h]);
    ctr.assign(n, 0); streams_done.assign(n, 0); cells_rx.assign(n, 0);
    bootstrap_time.assign(n, 0); done_time.assign(n, 0); cells_fwd.assign(n, 0);
    ct_overflow.assign(n, 0); cell_retries.assign(n, 0);
    rc_peer.assign(n * s, -1); rc_next_circ.assign(n * s, 1);
    ct_used.assign(n * ct_cap, 0); ct_pend.assign(n * ct_cap, 0);
    ct_in_sock.assign(n * ct_cap, 0); ct_in_circ.assign(n * ct_cap, 0);
    ct_out_sock.assign(n * ct_cap, -1); ct_out_circ.assign(n * ct_cap, 0);
    for (int64_t h = 0; h < n; ++h) {
      if (e.c.a0[h] == 0 || e.c.a0[h] == 2) e.listen(h, 0);
      if (e.c.a0[h] == 1 && cl_circs_left[h] > 0)
        e.schedule_local1(h, e.c.a3[h], K_APP, OP_START);
    }
  }
  void on_wakeup(Engine& e, int h, int64_t now, const int32_t* p) override {
    if (p[0] == OP_START) {
      int d_idx = randint(rng_bits(e.key, R_TOR_PATH, h, draw(h)),
                          e.c.t_ids3.size());
      cl_state[h] = CL_DIR_CONN;
      e.connect(h, 2, static_cast<int>(e.c.t_ids3[d_idx]), 0, now);
    } else if (p[0] == OP_TX_CELL) {
      int sock = p[1];
      int32_t meta = p[2], nbytes = p[3];
      Sock& k = e.sk(h, sock);
      int64_t buffered =
          seq_sub(k.app_end, k.snd_una) - (k.snd_una == 0 ? 1 : 0);
      bool fits = (e.c.sndbuf - buffered) >= nbytes;
      bool mq_ok = static_cast<int64_t>(k.mq.size()) < e.c.msgq_cap;
      if (fits && mq_ok) {
        e.tcp_send(h, sock, nbytes, meta, now);
      } else {
        cell_retries[h]++;
        int64_t t_retry = (now / e.c.window_ns + 1) * e.c.window_ns;
        int32_t pp[4] = {OP_TX_CELL, sock, meta, nbytes};
        e.schedule_local(h, t_retry, K_APP, pp, 4);
      }
    } else if (p[0] == OP_CONNECT_RELAY) {
      e.connect(h, p[1], p[2], 0, now);
    } else if (p[0] == OP_DRAIN) {
      int sock = p[1];
      int64_t base = static_cast<int64_t>(h) * ct_cap;
      int first = -1, count = 0;
      for (int64_t i = 0; i < ct_cap; ++i)
        if (ct_used[base + i] && ct_pend[base + i] &&
            ct_out_sock[base + i] == sock) {
          if (first < 0) first = static_cast<int>(i);
          count++;
        }
      if (first >= 0) {
        ct_pend[base + first] = 0;
        push_cell(e, h, sock, meta_of(ct_out_circ[base + first], 0, C_CREATE),
                  CELL, now);
        if (count > 1) {
          int32_t pp[2] = {OP_DRAIN, sock};
          e.schedule_local(h, now, K_APP, pp, 2);
        }
      }
    } else if (p[0] == OP_THINK) {
      if (cl_streams_left[h] > 0) begin_stream(e, h, now);
      else if (cl_circs_left[h] > 0) begin_circuit(e, h, now);
    }
  }
  void on_notify(Engine& e, int h, int sock, int flags, int32_t meta,
                 int32_t, int32_t, int64_t now) override {
    int role = static_cast<int>(e.c.a0[h]);
    bool est = flags & N_ESTABLISHED, msg = flags & N_MSG;
    int64_t circ = meta >> 18, aux = (meta >> 4) & 0x3FFF;
    int cmd = meta & 0xF;
    if (role == 1) {
      if (est && sock == 2 && cl_state[h] == CL_DIR_CONN) {
        cl_state[h] = CL_DIR_FETCH;
        push_cell(e, h, 2, meta_of(0, 0, C_DIRREQ), CELL, now);
      }
      if (msg && sock == 2 && cmd == C_DIRRESP && cl_state[h] == CL_DIR_FETCH) {
        cl_guard[h] = pick_weighted(e, h, e.c.t_ids0, e.c.t_cum0);
        bootstrap_time[h] = now;
        cl_state[h] = CL_GUARD_CONN;
        e.close(h, 2, now);
        e.connect(h, 1, cl_guard[h], 0, now);
      }
      if (est && sock == 1 && cl_state[h] == CL_GUARD_CONN)
        begin_circuit(e, h, now);
      if (msg && sock == 1 && circ == cl_circ[h]) {
        if (cmd == C_CREATED && cl_hop[h] == 1) {
          cl_hop[h] = 2;
          push_cell(e, h, 1, meta_of(circ, cl_mid[h], C_EXTEND), CELL, now);
        } else if (cmd == C_EXTENDED && cl_hop[h] == 2) {
          cl_hop[h] = 3;
          push_cell(e, h, 1, meta_of(circ, cl_exit[h], C_EXTEND), CELL, now);
        } else if (cmd == C_EXTENDED && cl_hop[h] == 3) {
          begin_stream(e, h, now);
        } else if (cmd == C_DATA && cl_state[h] == CL_STREAM) {
          cells_rx[h] += aux;
        } else if (cmd == C_END && cl_state[h] == CL_STREAM) {
          streams_done[h]++;
          if (--cl_streams_left[h] == 0) {
            if (--cl_circs_left[h] == 0) {
              done_time[h] = now;
              cl_state[h] = CL_DONE;
              return;
            }
          }
          think(e, h, now);
        }
      }
      return;
    }
    if (role == 2) {
      if (msg && cmd == C_DIRREQ)
        push_cell(e, h, sock, meta_of(0, 0, C_DIRRESP),
                  static_cast<int32_t>(e.c.s0), now);
      if (flags & N_PEER_FIN) e.close(h, sock, now);
      return;
    }
    if (role != 0) return;
    int64_t sbase = static_cast<int64_t>(h) * e.c.sockets_per_host;
    if (est && rc_peer[sbase + sock] >= 0) {
      int32_t pp[2] = {OP_DRAIN, sock};
      e.schedule_local(h, now, K_APP, pp, 2);
    }
    if (!msg) return;
    relay_on_cell(e, h, sock, meta, now);
  }
  void relay_on_cell(Engine& e, int h, int sock, int32_t meta, int64_t now) {
    int64_t circ = meta >> 18, aux = (meta >> 4) & 0x3FFF;
    int cmd = meta & 0xF;
    int64_t base = static_cast<int64_t>(h) * ct_cap;
    int64_t sbase = static_cast<int64_t>(h) * e.c.sockets_per_host;
    if (cmd == C_CREATE) {
      int slot = -1;
      for (int64_t i = 0; i < ct_cap; ++i)
        if (!ct_used[base + i]) { slot = static_cast<int>(i); break; }
      if (slot < 0) { ct_overflow[h]++; return; }
      ct_used[base + slot] = 1;
      ct_in_sock[base + slot] = sock;
      ct_in_circ[base + slot] = static_cast<int32_t>(circ);
      ct_out_sock[base + slot] = -1;
      ct_pend[base + slot] = 0;
      push_cell(e, h, sock, meta_of(circ, 0, C_CREATED), CELL, now);
      return;
    }
    int idx = -1;
    bool from_in = false, from_out = false;
    for (int64_t i = 0; i < ct_cap; ++i)
      if (ct_used[base + i] && ct_in_sock[base + i] == sock &&
          ct_in_circ[base + i] == circ) { idx = static_cast<int>(i); from_in = true; break; }
    if (idx < 0)
      for (int64_t i = 0; i < ct_cap; ++i)
        if (ct_used[base + i] && ct_out_sock[base + i] == sock &&
            ct_out_circ[base + i] == circ) { idx = static_cast<int>(i); from_out = true; break; }
    if (idx < 0) return;

    if (from_in && cmd == C_EXTEND && ct_out_sock[base + idx] < 0) {
      int target = static_cast<int>(aux);
      int r_sock = -1;
      for (int64_t s = 0; s < e.c.sockets_per_host; ++s)
        if (rc_peer[sbase + s] == target) { r_sock = static_cast<int>(s); break; }
      int osock;
      if (r_sock >= 0) {
        osock = r_sock;
      } else {
        osock = -1;
        for (int64_t s = 1; s < e.c.sockets_per_host; ++s)
          if (e.sk(h, static_cast<int>(s)).st == TCP_FREE) { osock = static_cast<int>(s); break; }
        if (osock < 0) { ct_overflow[h]++; return; }
      }
      int32_t ocirc = rc_next_circ[sbase + osock]++;
      if (r_sock < 0) rc_peer[sbase + osock] = target;
      ct_out_sock[base + idx] = osock;
      ct_out_circ[base + idx] = ocirc;
      bool conn_up = r_sock >= 0 && e.sk(h, osock).st == TCP_ESTABLISHED;
      ct_pend[base + idx] = conn_up ? 0 : 1;
      if (conn_up)
        push_cell(e, h, osock, meta_of(ocirc, 0, C_CREATE), CELL, now);
      if (r_sock < 0) {
        int32_t pp[3] = {OP_CONNECT_RELAY, osock, target};
        e.schedule_local(h, now, K_APP, pp, 3);
      }
      return;
    }
    if (from_out && cmd == C_CREATED) {
      push_cell(e, h, ct_in_sock[base + idx],
                meta_of(ct_in_circ[base + idx], 0, C_EXTENDED), CELL, now);
      return;
    }
    if (from_in && cmd == C_BEGIN && ct_out_sock[base + idx] < 0) {
      push_cell(e, h, sock, meta_of(circ, aux, C_DATA),
                static_cast<int32_t>(aux * CELL), now);
      push_cell(e, h, sock, meta_of(circ, 0, C_END), CELL, now);
      return;
    }
    int32_t nbytes = cmd == C_DATA ? static_cast<int32_t>(aux * CELL) : CELL;
    if (from_in && cmd != C_CREATED && ct_out_sock[base + idx] >= 0) {
      cells_fwd[h]++;
      push_cell(e, h, ct_out_sock[base + idx],
                meta_of(ct_out_circ[base + idx], aux, cmd), nbytes, now);
    } else if (from_out && cmd != C_CREATED) {
      cells_fwd[h]++;
      push_cell(e, h, ct_in_sock[base + idx],
                meta_of(ct_in_circ[base + idx], aux, cmd), nbytes, now);
    }
  }
  void summary(char* buf, size_t n) override {
    int64_t sd = 0, cf = 0, cr = 0, done = 0, over = 0;
    for (auto v : streams_done) sd += v;
    for (auto v : cells_fwd) cf += v;
    for (auto v : cells_rx) cr += v;
    for (auto v : done_time) done += v > 0 ? 1 : 0;
    for (auto v : ct_overflow) over += v;
    std::snprintf(buf, n,
                  "\"total_streams_done\": %lld, \"total_cells_fwd\": %lld, "
                  "\"total_cells_rx\": %lld, \"clients_done\": %lld, "
                  "\"total_ct_overflow\": %lld",
                  (long long)sd, (long long)cf, (long long)cr,
                  (long long)done, (long long)over);
  }
};

// bitcoin: peers=[H*K] a0=tx_origin(n_tx) a1=tx_time(n_tx)
//          s0=tx_size s1=inv_size s2=connect_time s3=K s4=n_tx
struct Bitcoin : App {
  static constexpr int OP_CONNECT_ONE = 1, OP_TX_CREATE = 2, OP_TX_MSG = 3;
  static constexpr int CMD_INV = 1, CMD_GET = 2, CMD_TX = 3;
  static constexpr int TXID_BITS = 20;
  int64_t K = 0, n_tx = 0;
  std::vector<int32_t> nbr_sock;       // [h*K + j]
  std::vector<char> seen, req;         // [h*n_tx + t]
  std::vector<int64_t> tx_rx, msg_retries;

  static int32_t meta_of(int cmd, int64_t txid) {
    return static_cast<int32_t>((static_cast<int64_t>(cmd) << TXID_BITS) | txid);
  }
  void push_msg(Engine& e, int h, int sock, int32_t meta, int32_t nbytes,
                int64_t now) {
    int32_t p[4] = {OP_TX_MSG, sock, meta, nbytes};
    e.schedule_local(h, now, K_APP, p, 4);
  }
  void announce(Engine& e, int h, int64_t txid, int skip_sock, int64_t now) {
    for (int64_t j = 0; j < K; ++j) {
      int ns = nbr_sock[h * K + j];
      if (ns >= 0 && ns != skip_sock)
        push_msg(e, h, ns, meta_of(CMD_INV, txid),
                 static_cast<int32_t>(e.c.s1), now);
    }
  }
  bool mark_seen(int h, int64_t txid) {
    if (seen[h * n_tx + txid]) return false;
    seen[h * n_tx + txid] = 1;
    return true;
  }
  void start(Engine& e) override {
    int64_t n = e.c.n_hosts;
    K = e.c.s3;
    n_tx = e.c.s4;
    nbr_sock.assign(n * K, -1);
    seen.assign(n * n_tx, 0);
    req.assign(n * n_tx, 0);
    tx_rx.assign(n, 0);
    msg_retries.assign(n, 0);
    for (int64_t h = 0; h < n; ++h) e.listen(h, 0);
    for (int64_t j = 0; j < K; ++j)
      for (int64_t h = 0; h < n; ++h)
        if (e.c.peers[h * K + j] > h) {
          int32_t p[2] = {OP_CONNECT_ONE, static_cast<int32_t>(j)};
          e.schedule_local(h, e.c.s2, K_APP, p, 2);
        }
    for (int64_t t = 0; t < n_tx; ++t) {
      int32_t p[2] = {OP_TX_CREATE, static_cast<int32_t>(t)};
      e.schedule_local(static_cast<int>(e.c.a0[t]), e.c.a1[t], K_APP, p, 2);
    }
  }
  void on_wakeup(Engine& e, int h, int64_t now, const int32_t* p) override {
    if (p[0] == OP_CONNECT_ONE) {
      int j = p[1];
      nbr_sock[h * K + j] = 1 + j;
      e.connect(h, 1 + j, static_cast<int>(e.c.peers[h * K + j]), 0, now);
    } else if (p[0] == OP_TX_CREATE) {
      if (mark_seen(h, p[1])) announce(e, h, p[1], -1, now);
    } else if (p[0] == OP_TX_MSG) {
      int sock = p[1];
      int32_t meta = p[2], nbytes = p[3];
      Sock& k = e.sk(h, sock);
      int64_t buffered =
          seq_sub(k.app_end, k.snd_una) - (k.snd_una == 0 ? 1 : 0);
      bool fits = (e.c.sndbuf - buffered) >= nbytes;
      bool mq_ok = static_cast<int64_t>(k.mq.size()) < e.c.msgq_cap;
      if (fits && mq_ok) {
        e.tcp_send(h, sock, nbytes, meta, now);
      } else {
        msg_retries[h]++;
        int64_t t_retry = (now / e.c.window_ns + 1) * e.c.window_ns;
        int32_t pp[4] = {OP_TX_MSG, sock, meta, nbytes};
        e.schedule_local(h, t_retry, K_APP, pp, 4);
      }
    }
  }
  void on_notify(Engine& e, int h, int sock, int flags, int32_t meta,
                 int32_t, int32_t, int64_t now) override {
    if (flags & N_ACCEPTED) {
      int peer = e.sk(h, sock).peer_host;
      for (int64_t j = 0; j < K; ++j)
        if (e.c.peers[h * K + j] == peer && nbr_sock[h * K + j] < 0)
          nbr_sock[h * K + j] = sock;
    }
    if (flags & N_MSG) {
      int cmd = meta >> TXID_BITS;
      int64_t txid = meta & ((1 << TXID_BITS) - 1);
      if (cmd == CMD_INV && !seen[h * n_tx + txid] && !req[h * n_tx + txid]) {
        req[h * n_tx + txid] = 1;
        push_msg(e, h, sock, meta_of(CMD_GET, txid),
                 static_cast<int32_t>(e.c.s1), now);
      } else if (cmd == CMD_GET && seen[h * n_tx + txid]) {
        push_msg(e, h, sock, meta_of(CMD_TX, txid),
                 static_cast<int32_t>(e.c.s0), now);
      } else if (cmd == CMD_TX) {
        tx_rx[h]++;
        if (mark_seen(h, txid)) announce(e, h, txid, sock, now);
      }
    }
  }
  void summary(char* buf, size_t n) override {
    int64_t ts = 0, tr = 0;
    for (auto v : seen) ts += v;
    for (auto v : tx_rx) tr += v;
    std::snprintf(buf, n, "\"total_seen\": %lld, \"total_tx_rx\": %lld",
                  (long long)ts, (long long)tr);
  }
};

// ---------------------------------------------------------------- main ----
int main_run(int argc, char** argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: net_comparator <table> <config> <threads>\n");
    return 2;
  }
  {
    std::FILE* f = std::fopen(argv[1], "rb");
    if (!f) { std::fprintf(stderr, "no table\n"); return 2; }
    size_t want = (1 << LOG_BITS) + 1;
    if (std::fread(LOG_TBL, 8, want, f) != want ||
        std::fread(&LN2_Q32, 8, 1, f) != 1) {
      std::fclose(f);
      std::fprintf(stderr, "bad table\n");
      return 2;
    }
    std::fclose(f);
  }
  Config cfg;
  if (!read_config(argv[2], &cfg)) {
    std::fprintf(stderr, "bad config blob\n");
    return 2;
  }
  int n_threads = std::atoi(argv[3]);
  if (n_threads < 1) n_threads = 1;

  Engine eng(cfg, n_threads);
  Filexfer fx;
  Tgen tg;
  Tor tor;
  Bitcoin btc;
  switch (cfg.app_id) {
    case 1: eng.app = &fx; break;
    case 2: eng.app = &tg; break;
    case 3: eng.app = &tor; break;
    case 4: eng.app = &btc; break;
    default: std::fprintf(stderr, "bad app id\n"); return 2;
  }
  eng.app->start(eng);

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
    Shard& me = eng.shards[t];
    for (int64_t w = 0; w < cfg.n_windows; ++w) {
      const int64_t win_end = (w + 1) * cfg.window_ns;
      while (!me.heap.empty() && me.heap.top().time < win_end) {
        Ev ev = me.heap.top();
        me.heap.pop();
        eng.pending[ev.host]--;
        if (ev.kind == K_PKT) {
          // rx fast path: plumbing, not an event (rx_batch contract)
          eng.rx_convert(ev.host, ev.time, ev.tb, ev.p);
          continue;
        }
        me.m.events++;
        eng.handle(ev.host, ev.time, ev.kind, ev.p);
      }
      barrier();
      {
        std::lock_guard<std::mutex> g(me.mbox_mu);
        for (const Ev& ev : me.mailbox) {
          if (eng.pending[ev.host] >= cfg.ev_cap) { me.m.ev_overflow++; continue; }
          eng.pending[ev.host]++;
          me.m.pkts_delivered++;
          me.heap.push(ev);
        }
        me.mailbox.clear();
      }
      barrier();
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

  Metrics tot;
  for (const Shard& s : eng.shards) {
    tot.events += s.m.events;
    tot.pkts_sent += s.m.pkts_sent;
    tot.pkts_delivered += s.m.pkts_delivered;
    tot.pkts_lost += s.m.pkts_lost;
    tot.ev_overflow += s.m.ev_overflow;
    tot.ob_overflow += s.m.ob_overflow;
    tot.tcp_fast_rtx += s.m.tcp_fast_rtx;
    tot.tcp_rto += s.m.tcp_rto;
    tot.tcp_ooo_drops += s.m.tcp_ooo_drops;
    tot.pops_deliver += s.m.pops_deliver;
    tot.pops_timer += s.m.pops_timer;
    tot.pops_txr += s.m.pops_txr;
    tot.pops_app += s.m.pops_app;
  }
  char sum[512];
  eng.app->summary(sum, sizeof sum);
  std::printf(
      "{\"events\": %lld, \"pkts_sent\": %lld, \"pkts_delivered\": %lld, "
      "\"pkts_lost\": %lld, \"ev_overflow\": %lld, \"ob_overflow\": %lld, "
      "\"tcp_fast_rtx\": %lld, \"tcp_rto\": %lld, \"tcp_ooo_drops\": %lld, "
      "\"pops_deliver\": %lld, \"pops_timer\": %lld, \"pops_txr\": %lld, "
      "\"pops_app\": %lld, %s, \"wall_s\": %.6f, \"events_per_sec\": %.1f, "
      "\"n_threads\": %d}\n",
      (long long)tot.events, (long long)tot.pkts_sent,
      (long long)tot.pkts_delivered, (long long)tot.pkts_lost,
      (long long)tot.ev_overflow, (long long)tot.ob_overflow,
      (long long)tot.tcp_fast_rtx, (long long)tot.tcp_rto,
      (long long)tot.tcp_ooo_drops, (long long)tot.pops_deliver,
      (long long)tot.pops_timer, (long long)tot.pops_txr,
      (long long)tot.pops_app, sum, wall, tot.events / (wall > 0 ? wall : 1),
      n_threads);
  return 0;
}

}  // namespace

int main(int argc, char** argv) { return main_run(argc, argv); }
