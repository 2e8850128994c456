// The NANOS task-runtime simulator's event loop for Hopper (sm_90a): one
// thread runs one sweep cell (a workload under a scheduler, an execution
// context, a fault plan and a seed) from ignition to its last event, and
// every cell of a batch runs at once.
//
// Replaces: src/repro/core/sim/_csim.c:743 `sim_run_batch` (the JAX
// package's C engine: a pthread pool over cells, each cell the untraced
// loop of _csim_core.h). This file is a transcription of that loop and
// matches it bit for bit: every field of dout (6) and iout (7) and the
// three always-on aggregates. What makes that hold:
//
//   * float contraction: the C engine is built with -ffp-contract=off, so
//     this source alone is built with `--fmad=false` (kernels/_build.py
//     gives it that flag and no other source): every double add and
//     multiply rounds on its own, in the C order. No libm function is
//     called in the loop, and double division is IEEE round-to-nearest;
//   * MT19937 as numpy's legacy RandomState, `rk_interval`'s masked
//     rejection (shuffle, randint) and `rk_double`'s two-draw recipe;
//   * the CPython set that parks idle threads (linear probes + perturb,
//     fill*5 >= mask*3 resize, the pop finger), since which thread a
//     spawn wakes is the set's pop order;
//   * the (time, seq) binary heap of events.
//
// Memory. The C engine callocs per-task state and grows its heap, rings
// and set with realloc. Here every cell gets one preallocated workspace,
// sized on the host from the task count n and the thread count T
// (kernels/sim.py `workspace_bytes` mirrors `cell_layout` below, and the
// kernel refuses a workspace smaller than its layout):
//   * heap: 2T + 8 events, as the C engine's first allocation. Every
//     thread has at most one event queued (ignition gives each one; a
//     popped event pushes at most its thread's next one; a parked thread
//     has none until a wake pops it from the set), so T suffice;
//   * set: two tables of the largest size CPython's resize rule can reach
//     with at most T keys (the smallest power of two above 4T, 8 at
//     least), one being rebuilt into while the other is read;
//   * the task deques (T local ones and the shared FIFO): doubly linked
//     lists threaded through two int32 arrays of n entries. A task id is
//     in at most one deque at a time (it is queued when spawned, leaves
//     when taken, and is queued again only from a thread's hand when a
//     fault takes the thread offline), so n links hold every deque at
//     any moment, and push_back / pop_back / pop_front keep the ring
//     buffer's order exactly;
//   * per task: pending (int32), exec_node (int32), phase (uint8).
// A cell whose structures would overflow stops with a negative return
// code (never truncates); the wrapper puts an error naming the cell in
// that cell's result slot. Status 1
// (the step watchdog) and 2 (stranded work) are results, in iout[6].
//
// Per-cell arguments: `cores` is a per-cell copy (migration mutates it);
// the task table, the topology's arrays, victim plans and fault plans are
// shared read-only by every cell that uses them (the wrapper uploads each
// once). The wrapper sorts cells by workload, so a warp's threads read
// one table.
//
// What bounds it: each cell is one serial chain of dependent events
// (heap pop, deque and set updates, a few table reads each). The bytes
// bound, as accounting, is the batch's distinct inputs read once (each
// table and plan once, however many cells share it) and each cell's task
// state (9 B a task) and outputs written once, over 3.35 TB/s; the
// kernel runs hundreds of times above it, because the chains, not the
// bytes, decide the time. PERF.md has both.
//
// Two flags make four instantiations of the loop (template parameters of
// `sim_cell`, as _csim.c:617-632 includes _csim_core.h twice):
//   * kTraced — the counterpart of _csim.c's `sim_run_traced`: the cell
//     writes every committed execution, successful steal and thread
//     migration (core/sim/trace.py has the semantics) into its own slice
//     of flat device columns, in commit order. The slices are sized on the
//     host from bounds the loop cannot pass (exec <= n, steals <= pushes
//     onto a deque <= n - 1 + W, migrations <= attempts <= n + W, W the
//     fault plan's windows: each window takes a thread offline once), so
//     nothing grows in the kernel and no event is dropped; a cell that
//     would still pass its slice stops with kTraceOverflow (never a
//     truncated trace). The untraced instantiation keeps no per-event
//     bookkeeping at all: every recording site is `if constexpr`.
//   * kTimed — a per-cell wall-clock deadline: the thread reads
//     %globaltimer when *its* cell starts (cells start at different times:
//     not every cell of a batch is resident at once) and every
//     kDeadlineEvery events, the first included; past the deadline the
//     cell stops with kTimedOut and its siblings run on.
// The main path's untraced, untimed instantiation is the loop as it was.
//
// Built as host C++ (no __CUDACC__), the same loop runs on the CPU
// through `sim_run_batch_host` (every instantiation, as sim_run_batch
// chooses one) and the `*_selftest_host` entries: the tests compile it
// that way to hold the transcription to the plain version where there is
// no card.

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <chrono>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SIM_DEV __host__ __device__
#else
#define SIM_DEV static inline
#endif

namespace {

// --------------------------------------------------------------------
// The per-cell descriptor: int64 offsets into the packed buffers, in the
// order kernels/sim.py writes them.
// --------------------------------------------------------------------

enum Desc {
  kOut = 0,        // the cell's slot in dout / iout / rc
  kDpar,           // dbuf: 11 cost-model doubles
  kIpar,           // ibuf: 11 integer parameters
  kWp, kWpo, kFr, kFp,                 // dbuf: the task table's scalars
  kFc, kNc, kFpw, kNpw, kPar,          // ibuf: its CSR arrays
  kCoreNode, kNodeDist,                // ibuf: the topology
  kRootDist,                           // dbuf
  kCores,                              // ibuf: per-cell, written
  kGoff, kUoff, kVoff, kVictims,       // ibuf: the victim plan
  kFspeed,                             // dbuf: the fault plan
  kFwoff,                              // ibuf
  kFwstart, kFwend,                    // dbuf
  kHops, kNodeTasks,                   // aggi: the aggregates
  kNodeRemote,                         // aggd
  kWs,                                 // workspace byte offset
  kWsBytes,                            // workspace bytes given
  kExOff, kExCap,                      // trace columns: the cell's slice
  kStOff, kStCap,                      //   (offset, capacity) of each
  kMgOff, kMgCap,                      //   event family, in events
  kDescLen
};

// return codes of a cell (0 = ran; its status is in iout[6])
constexpr int64_t kHeapOverflow = -2;
constexpr int64_t kSetOverflow = -3;
constexpr int64_t kWorkspaceShort = -4;
constexpr int64_t kTraceOverflow = -5;
constexpr int64_t kTimedOut = -6;

// events between two reads of the clock (core/sim/_engine_py.py
// DEADLINE_EVERY)
constexpr int64_t kDeadlineEvery = 4096;

// The trace columns of a wave (traced instantiation): per event family
// one int64 block and one double block, column-major with the family's
// total capacity as stride (exec: task, thread, core, node, qlen | start,
// end; steal: thief, victim, task, dist | time; migration: thread, from,
// to | time), and 3 counts per cell slot.
struct TraceCols {
  int64_t* ex_i;
  double* ex_d;
  int64_t* st_i;
  double* st_d;
  int64_t* mg_i;
  double* mg_d;
  int64_t ex_len, st_len, mg_len;
  int64_t* counts;
};

// One cell's slice of them.
struct TraceSlot {
  int64_t* ei;
  double* ed;
  int64_t ecap, es;
  int64_t* si;
  double* sd;
  int64_t scap, ss;
  int64_t* mi;
  double* md;
  int64_t mcap, ms;
  int64_t* counts;
};

// nanoseconds on a clock that only moves forward
SIM_DEV uint64_t clock_ns() {
#ifdef __CUDA_ARCH__
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#else
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
#endif
}

// --------------------------------------------------------------------
// MT19937 — numpy legacy RandomState bitstream replica (_csim.c:47-108)
// --------------------------------------------------------------------

constexpr int kMtN = 624;
constexpr int kMtM = 397;

struct RkState {
  uint32_t mt[kMtN];
  int32_t mti;
};

SIM_DEV void rk_seed(RkState* st, uint32_t s) {
  st->mt[0] = s;
  for (int i = 1; i < kMtN; i++)
    st->mt[i] = 1812433253U * (st->mt[i - 1] ^ (st->mt[i - 1] >> 30)) +
                (uint32_t)i;
  st->mti = kMtN;
}

SIM_DEV uint32_t rk_random(RkState* st) {
  uint32_t y;
  if (st->mti >= kMtN) {
    const uint32_t mag = 0x9908b0dfU;
    int kk;
    for (kk = 0; kk < kMtN - kMtM; kk++) {
      y = (st->mt[kk] & 0x80000000U) | (st->mt[kk + 1] & 0x7fffffffU);
      st->mt[kk] = st->mt[kk + kMtM] ^ (y >> 1) ^ ((y & 1U) ? mag : 0U);
    }
    for (; kk < kMtN - 1; kk++) {
      y = (st->mt[kk] & 0x80000000U) | (st->mt[kk + 1] & 0x7fffffffU);
      st->mt[kk] =
          st->mt[kk + (kMtM - kMtN)] ^ (y >> 1) ^ ((y & 1U) ? mag : 0U);
    }
    y = (st->mt[kMtN - 1] & 0x80000000U) | (st->mt[0] & 0x7fffffffU);
    st->mt[kMtN - 1] = st->mt[kMtM - 1] ^ (y >> 1) ^ ((y & 1U) ? mag : 0U);
    st->mti = 0;
  }
  y = st->mt[st->mti++];
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680U;
  y ^= (y << 15) & 0xefc60000U;
  y ^= y >> 18;
  return y;
}

// bounded draw in [0, max] by masked rejection (RandomState.shuffle and
// scalar randint)
SIM_DEV uint32_t rk_interval(RkState* st, uint32_t max) {
  uint32_t mask = max, v;
  mask |= mask >> 1;
  mask |= mask >> 2;
  mask |= mask >> 4;
  mask |= mask >> 8;
  mask |= mask >> 16;
  do {
    v = rk_random(st) & mask;
  } while (v > max);
  return v;
}

SIM_DEV double rk_double(RkState* st) {
  uint32_t a = rk_random(st) >> 5, b = rk_random(st) >> 6;
  return (a * 67108864.0 + b) / 9007199254740992.0;
}

// Fisher-Yates as RandomState.shuffle on a Python list
SIM_DEV void rk_shuffle(RkState* st, int64_t* x, int64_t n) {
  for (int64_t i = n - 1; i > 0; i--) {
    uint32_t j = rk_interval(st, (uint32_t)i);
    int64_t tmp = x[i];
    x[i] = x[j];
    x[j] = tmp;
  }
}

// --------------------------------------------------------------------
// CPython 3.10 set replica, int keys >= 0, add + pop (_csim.c:114-228),
// over two preallocated tables of `cap` slots
// --------------------------------------------------------------------

constexpr uint64_t kSetMinSize = 8;
constexpr uint64_t kLinearProbes = 9;
constexpr int kPerturbShift = 5;
constexpr uint8_t kEmpty = 0, kActive = 1, kDummy = 2;

struct PySet {
  int64_t* key[2];
  uint8_t* state[2];
  int cur;
  uint64_t cap, mask, fill, used, finger;
};

SIM_DEV void pyset_init(PySet* s) {
  s->cur = 0;
  s->mask = kSetMinSize - 1;
  s->fill = s->used = s->finger = 0;
  for (uint64_t j = 0; j <= s->mask; j++) s->state[0][j] = kEmpty;
}

SIM_DEV void pyset_insert_clean(int64_t* keyt, uint8_t* statet, uint64_t mask,
                                int64_t key) {
  uint64_t perturb = (uint64_t)key;
  uint64_t i = (uint64_t)key & mask;
  while (1) {
    uint64_t j = i;
    uint64_t probes = (i + kLinearProbes <= mask) ? kLinearProbes : 0;
    do {
      if (statet[j] == kEmpty) {
        keyt[j] = key;
        statet[j] = kActive;
        return;
      }
      j++;
    } while (probes--);
    perturb >>= kPerturbShift;
    i = (i * 5 + 1 + perturb) & mask;
  }
}

SIM_DEV int pyset_resize(PySet* s, uint64_t minused) {
  uint64_t newsize = kSetMinSize;
  while (newsize <= minused) newsize <<= 1;
  if (newsize > s->cap) return -1;
  const int nxt = 1 - s->cur;
  int64_t* nk = s->key[nxt];
  uint8_t* ns = s->state[nxt];
  for (uint64_t j = 0; j < newsize; j++) ns[j] = kEmpty;
  for (uint64_t j = 0; j <= s->mask; j++)
    if (s->state[s->cur][j] == kActive)
      pyset_insert_clean(nk, ns, newsize - 1, s->key[s->cur][j]);
  s->cur = nxt;
  s->mask = newsize - 1;
  s->fill = s->used;
  return 0;
}

SIM_DEV int pyset_add(PySet* s, int64_t key) {
  int64_t* keyt = s->key[s->cur];
  uint8_t* statet = s->state[s->cur];
  uint64_t perturb = (uint64_t)key;
  const uint64_t mask = s->mask;
  uint64_t i = (uint64_t)key & mask;
  uint64_t freeslot = ~(uint64_t)0;
  while (1) {
    uint64_t j = i;
    uint64_t probes = (i + kLinearProbes <= mask) ? kLinearProbes : 0;
    do {
      if (statet[j] == kEmpty) {
        if (freeslot != ~(uint64_t)0) {
          s->used++;
          keyt[freeslot] = key;
          statet[freeslot] = kActive;
          return 0;
        }
        s->fill++;
        s->used++;
        keyt[j] = key;
        statet[j] = kActive;
        if (s->fill * 5 < mask * 3) return 0;
        return pyset_resize(s, s->used > 50000 ? s->used * 2 : s->used * 4);
      }
      if (statet[j] == kActive && keyt[j] == key) return 0;
      if (statet[j] == kDummy) freeslot = j;
      j++;
    } while (probes--);
    perturb >>= kPerturbShift;
    i = (i * 5 + 1 + perturb) & mask;
  }
}

SIM_DEV int64_t pyset_pop(PySet* s) {
  uint8_t* statet = s->state[s->cur];
  uint64_t i = s->finger & s->mask;
  while (statet[i] != kActive) {
    i++;
    if (i > s->mask) i = 0;
  }
  const int64_t key = s->key[s->cur][i];
  statet[i] = kDummy;
  s->used--;
  s->finger = i + 1;
  return key;
}

// --------------------------------------------------------------------
// The (time, seq) event heap (_csim.c:234-297), fixed capacity
// --------------------------------------------------------------------

struct Ev {
  double t;
  uint64_t seq;
  int64_t th;
  int64_t task;  // -1 = acquire from the pool
};

struct Heap {
  Ev* e;
  uint64_t len, cap;
};

SIM_DEV bool ev_lt(const Ev& a, const Ev& b) {
  return a.t < b.t || (a.t == b.t && a.seq < b.seq);
}

SIM_DEV int heap_push(Heap* h, double t, uint64_t seq, int64_t th,
                      int64_t task) {
  if (h->len == h->cap) return -1;
  uint64_t i = h->len++;
  Ev v = {t, seq, th, task};
  while (i > 0) {
    uint64_t p = (i - 1) >> 1;
    if (!ev_lt(v, h->e[p])) break;
    h->e[i] = h->e[p];
    i = p;
  }
  h->e[i] = v;
  return 0;
}

SIM_DEV Ev heap_pop(Heap* h) {
  Ev top = h->e[0];
  Ev last = h->e[--h->len];
  uint64_t n = h->len, i = 0;
  while (1) {
    uint64_t c = 2 * i + 1;
    if (c >= n) break;
    if (c + 1 < n && ev_lt(h->e[c + 1], h->e[c])) c++;
    if (!ev_lt(h->e[c], last)) break;
    h->e[i] = h->e[c];
    i = c;
  }
  if (n) h->e[i] = last;
  return top;
}

// --------------------------------------------------------------------
// Task deques: doubly linked lists through per-task links (see the top);
// deque q < T is thread q's local pool, q == T the shared FIFO
// --------------------------------------------------------------------

struct Deques {
  int32_t* next;  // n
  int32_t* prev;  // n
  int32_t* head;  // T + 1
  int32_t* tail;  // T + 1
  int64_t* len;   // T + 1
};

SIM_DEV void dq_push_back(Deques* d, int64_t q, int64_t v) {
  const int32_t t = d->tail[q];
  d->prev[v] = t;
  d->next[v] = -1;
  if (d->len[q] == 0)
    d->head[q] = (int32_t)v;
  else
    d->next[t] = (int32_t)v;
  d->tail[q] = (int32_t)v;
  d->len[q]++;
}

SIM_DEV int64_t dq_pop_back(Deques* d, int64_t q) {
  const int32_t v = d->tail[q];
  const int32_t p = d->prev[v];
  d->tail[q] = p;
  if (--d->len[q] == 0)
    d->head[q] = -1;
  else
    d->next[p] = -1;
  return v;
}

SIM_DEV int64_t dq_pop_front(Deques* d, int64_t q) {
  const int32_t v = d->head[q];
  const int32_t nx = d->next[v];
  d->head[q] = nx;
  if (--d->len[q] == 0)
    d->tail[q] = -1;
  else
    d->prev[nx] = -1;
  return v;
}

// --------------------------------------------------------------------
// The per-cell workspace layout (kernels/sim.py `workspace_bytes`)
// --------------------------------------------------------------------

SIM_DEV uint64_t align8(uint64_t x) { return (x + 7) & ~(uint64_t)7; }

// largest set table CPython's resize rule reaches with at most T keys
SIM_DEV uint64_t set_cap(int64_t T) {
  uint64_t minused = (uint64_t)T > 50000 ? 2 * (uint64_t)T : 4 * (uint64_t)T;
  uint64_t size = kSetMinSize;
  while (size <= minused) size <<= 1;
  return size;
}

struct Layout {
  uint64_t rng, heap, set_key0, set_key1, set_state0, set_state1, dl_free,
      wcur, order, uidx, head, tail, len, pending, exec_node, next, prev,
      phase, end;
};

SIM_DEV Layout cell_layout(int64_t n, int64_t T) {
  Layout L;
  const uint64_t t1 = (uint64_t)(T > 1 ? T : 1);
  const uint64_t sc = set_cap(T);
  uint64_t o = 0;
  L.rng = o;        o = align8(o + sizeof(RkState));
  L.heap = o;       o = align8(o + (2 * (uint64_t)T + 8) * sizeof(Ev));
  L.set_key0 = o;   o = align8(o + sc * 8);
  L.set_key1 = o;   o = align8(o + sc * 8);
  L.set_state0 = o; o = align8(o + sc);
  L.set_state1 = o; o = align8(o + sc);
  L.dl_free = o;    o = align8(o + t1 * 8);
  L.wcur = o;       o = align8(o + t1 * 8);
  L.order = o;      o = align8(o + t1 * 8);
  L.uidx = o;       o = align8(o + t1 * 8);
  L.head = o;       o = align8(o + (t1 + 1) * 4);
  L.tail = o;       o = align8(o + (t1 + 1) * 4);
  L.len = o;        o = align8(o + (t1 + 1) * 8);
  L.pending = o;    o = align8(o + (uint64_t)n * 4);
  L.exec_node = o;  o = align8(o + (uint64_t)n * 4);
  L.next = o;       o = align8(o + (uint64_t)n * 4);
  L.prev = o;       o = align8(o + (uint64_t)n * 4);
  L.phase = o;      o = align8(o + (uint64_t)n);
  L.end = o;
  return L;
}

// --------------------------------------------------------------------
// Fault handling (_csim.c:366-405)
// --------------------------------------------------------------------

struct FaultEnv {
  Heap* evq;
  PySet* parked;
  Deques* dq;
  int64_t shared_q;
  const double* fwend;
  double wake_latency;
  int depth_first;
  uint64_t* seq;
  int64_t* reclaimed;
};

// Thread `th` hits offline window `cidx` at `now`, carrying `task` if
// >= 0: the in-hand task is re-queued, one thief is woken per queued
// task, and a finite window resumes the thread at its end; an infinite
// one never does, and an empty-handed dead thread passes a wake on.
SIM_DEV int go_offline(FaultEnv* env, double now, int64_t th, int64_t task,
                       int64_t cidx) {
  int64_t nq = env->depth_first ? env->dq->len[th] : 0;
  if (task >= 0) {
    nq++;
    dq_push_back(env->dq, env->depth_first ? th : env->shared_q, task);
  }
  *env->reclaimed += nq;
  while (nq > 0 && env->parked->used) {
    ++*env->seq;
    if (heap_push(env->evq, now + env->wake_latency, *env->seq,
                  pyset_pop(env->parked), -1))
      return -1;
    nq--;
  }
  if (env->fwend[cidx] != (double)INFINITY) {
    ++*env->seq;
    if (heap_push(env->evq, env->fwend[cidx], *env->seq, th, -1)) return -1;
  } else if (task < 0 && env->parked->used) {
    ++*env->seq;
    if (heap_push(env->evq, now, *env->seq, pyset_pop(env->parked), -1))
      return -1;
  }
  return 0;
}

// --------------------------------------------------------------------
// One cell: the loop of _csim_core.h, line for line (see the top for the
// two flags)
// --------------------------------------------------------------------

template <bool kTraced, bool kTimed>
SIM_DEV int64_t sim_cell(const double* dpar, const int64_t* ipar,
                         const double* wp, const double* wpo,
                         const double* fr, const double* fp,
                         const int64_t* fc, const int64_t* nc,
                         const int64_t* fpw, const int64_t* npw,
                         const int64_t* par, const int64_t* core_node,
                         const int64_t* node_dist, const double* root_dist,
                         int64_t* cores, const int64_t* vp_group_off,
                         const int64_t* vp_unit_off,
                         const int64_t* vp_victim_off,
                         const int64_t* vp_victims, const double* fspeed,
                         const int64_t* fwoff, const double* fwstart,
                         const double* fwend, double* dout, int64_t* iout,
                         int64_t* agg_steal_hops, int64_t* agg_node_tasks,
                         double* agg_node_remote, uint8_t* ws,
                         int64_t ws_bytes, const TraceSlot& tr,
                         int64_t deadline_ns) {
  uint64_t t_start = 0;
  if constexpr (kTimed) t_start = clock_ns();
  int64_t n_ex = 0, n_st = 0, n_mg = 0;
  (void)n_ex;
  (void)n_st;
  (void)n_mg;
  (void)t_start;
  const double hop_lambda = dpar[0], hop_lambda_steal = dpar[1];
  const double lock_time = dpar[2], deque_lock_time = dpar[3];
  const double steal_time = dpar[4], spawn_time = dpar[5];
  const double wake_latency = dpar[6], qop_time = dpar[7];
  const double cache_refill = dpar[8], mem_intensity = dpar[9];
  const double migration_rate = dpar[10];
  const int64_t T = ipar[0], num_cores = ipar[1], NN = ipar[2];
  const int64_t n_tasks = ipar[3];
  const int depth_first = !ipar[4];
  const int wf_like = (int)ipar[5];
  const uint32_t seed = (uint32_t)ipar[6];
  const int64_t rdn = ipar[7];
  const int64_t rnode0 = ipar[8];
  const int has_faults = (int)ipar[9];
  int64_t max_steps = ipar[10];
  const double mu_lam = mem_intensity * hop_lambda;
  if (max_steps <= 0) max_steps = INT64_MAX;

  const Layout L = cell_layout(n_tasks, T);
  if ((int64_t)L.end > ws_bytes) return kWorkspaceShort;

  RkState& rng = *reinterpret_cast<RkState*>(ws + L.rng);
  rk_seed(&rng, seed);
  int32_t* pending = reinterpret_cast<int32_t*>(ws + L.pending);
  int32_t* exec_node = reinterpret_cast<int32_t*>(ws + L.exec_node);
  uint8_t* phase = ws + L.phase;
  int64_t* order = reinterpret_cast<int64_t*>(ws + L.order);
  int64_t* uidx = reinterpret_cast<int64_t*>(ws + L.uidx);
  double* dl_free = reinterpret_cast<double*>(ws + L.dl_free);
  int64_t* wcur = reinterpret_cast<int64_t*>(ws + L.wcur);
  // pending, exec_node, phase and dl_free start at zero: the workspace
  // arrives zeroed (sim_run_batch clears it before the launch), as the C
  // engine callocs them
  if (has_faults)
    for (int64_t i = 0; i < T; i++) wcur[i] = fwoff[i];
  Deques dq;
  dq.next = reinterpret_cast<int32_t*>(ws + L.next);
  dq.prev = reinterpret_cast<int32_t*>(ws + L.prev);
  dq.head = reinterpret_cast<int32_t*>(ws + L.head);
  dq.tail = reinterpret_cast<int32_t*>(ws + L.tail);
  dq.len = reinterpret_cast<int64_t*>(ws + L.len);
  for (int64_t q = 0; q <= T; q++) {
    dq.head[q] = dq.tail[q] = -1;
    dq.len[q] = 0;
  }
  const int64_t SH = T;  // the shared FIFO
  Heap evq;
  evq.e = reinterpret_cast<Ev*>(ws + L.heap);
  evq.len = 0;
  evq.cap = 2 * (uint64_t)T + 8;
  PySet parked;
  parked.key[0] = reinterpret_cast<int64_t*>(ws + L.set_key0);
  parked.key[1] = reinterpret_cast<int64_t*>(ws + L.set_key1);
  parked.state[0] = ws + L.set_state0;
  parked.state[1] = ws + L.set_state1;
  parked.cap = set_cap(T);
  pyset_init(&parked);

  double sl_free = 0.0, sl_waited = 0.0;
  double remote = 0.0, total_exec = 0.0, makespan = 0.0;
  int64_t steals = 0, failed = 0, live = 1;
  int64_t reclaimed = 0, reexec = 0, executed = 0, steps = 0, status = 0;
  double fault_lost = 0.0, last_t = 0.0;
  uint64_t seq = 0;
  FaultEnv fenv = {&evq, &parked, &dq, SH, fwend, wake_latency,
                   depth_first, &seq, &reclaimed};

#define SIM_PUSH(t_, th_, task_)                             \
  do {                                                        \
    seq++;                                                    \
    if (heap_push(&evq, (t_), seq, (th_), (task_)))           \
      return kHeapOverflow;                                   \
  } while (0)
#define SIM_PARK(th_)                                         \
  do {                                                        \
    if (live > 0 && pyset_add(&parked, (th_)))                \
      return kSetOverflow;                                    \
  } while (0)
#define SIM_OFFLINE(now_, th_, task_, c_)                     \
  do {                                                        \
    if (go_offline(&fenv, (now_), (th_), (task_), (c_)))      \
      return kHeapOverflow;                                   \
  } while (0)

  // ignition: master runs the root, workers go hunting
  SIM_PUSH(0.0, 0, 0);
  for (int64_t th = 1; th < T; th++) SIM_PUSH(0.0, th, -1);

  while (evq.len) {
    const Ev ev = heap_pop(&evq);
    double t = ev.t;
    const int64_t th = ev.th;
    int64_t task = ev.task;

    if (++steps > max_steps) {
      status = 1;
      last_t = t;
      break;
    }
    if constexpr (kTimed) {
      if ((steps & (kDeadlineEvery - 1)) == 1 &&
          clock_ns() - t_start >= (uint64_t)deadline_ns)
        return kTimedOut;
    }
    if (has_faults) {
      int64_t c = wcur[th];
      const int64_t lim = fwoff[th + 1];
      while (c < lim && fwend[c] <= t) c++;
      wcur[th] = c;
      if (c < lim && fwstart[c] <= t) {
        SIM_OFFLINE(t, th, task, c);
        continue;
      }
    }

    if (task < 0) {
      // ---- acquire: local pop / steal sweep / shared FIFO ----
      if (depth_first) {
        if (dq.len[th]) {
          task = dq_pop_back(&dq, th);
          if (rdn < 0)
            t += qop_time;
          else
            t += qop_time *
                 (1.0 + hop_lambda_steal *
                            (double)node_dist[core_node[cores[th]] * NN + rdn]);
        } else {
          // materialize one sweep from the compiled plan
          int64_t n_order = 0;
          for (int64_t g = vp_group_off[th]; g < vp_group_off[th + 1]; g++) {
            const int64_t u0 = vp_unit_off[g];
            const int64_t u1 = vp_unit_off[g + 1];
            const int64_t nu = u1 - u0;
            if (nu > 1) {
              for (int64_t k = 0; k < nu; k++) uidx[k] = u0 + k;
              rk_shuffle(&rng, uidx, nu);
              for (int64_t k = 0; k < nu; k++)
                for (int64_t j = vp_victim_off[uidx[k]];
                     j < vp_victim_off[uidx[k] + 1]; j++)
                  order[n_order++] = vp_victims[j];
            } else {
              for (int64_t j = vp_victim_off[u0]; j < vp_victim_off[u1]; j++)
                order[n_order++] = vp_victims[j];
            }
          }
          task = -1;
          const int64_t tn = core_node[cores[th]];
          for (int64_t k = 0; k < n_order; k++) {
            const int64_t v = order[k];
            const double d = (rdn < 0)
                                 ? (double)node_dist[tn * NN +
                                                     core_node[cores[v]]]
                                 : (double)node_dist[tn * NN + rdn];
            t += steal_time * (1.0 + hop_lambda_steal * d);
            if (dq.len[v]) {
              const double start = t > dl_free[v] ? t : dl_free[v];
              t = start + deque_lock_time;
              dl_free[v] = t;
              steals++;
              task = dq_pop_front(&dq, v);
              // hop distance thief core -> victim core (the stolen
              // task's data locality)
              const int64_t sd = node_dist[tn * NN + core_node[cores[v]]];
              agg_steal_hops[sd]++;
              if constexpr (kTraced) {
                if (n_st >= tr.scap) return kTraceOverflow;
                tr.sd[n_st] = t;
                tr.si[n_st] = th;
                tr.si[n_st + tr.ss] = v;
                tr.si[n_st + 2 * tr.ss] = task;
                tr.si[n_st + 3 * tr.ss] = sd;
                n_st++;
              }
              break;
            }
            failed++;
          }
          if (task < 0) {
            SIM_PARK(th);
            continue;
          }
        }
      } else {
        // breadth-first shared FIFO behind one lock
        if (!dq.len[SH]) {
          SIM_PARK(th);
          continue;
        }
        const double start = t > sl_free ? t : sl_free;
        sl_waited += start - t;
        t = start + lock_time;
        sl_free = t;
        if (!dq.len[SH]) {
          SIM_PARK(th);
          continue;
        }
        task = dq_pop_front(&dq, SH);
      }
    }

    // ---- run `task` on thread th at time t ----
    if (migration_rate > 0.0 && rk_double(&rng) < migration_rate) {
      const int64_t mig_from = cores[th];
      (void)mig_from;
      // randint(1) is special-cased by numpy: no draw consumed
      cores[th] = (num_cores > 1)
                      ? (int64_t)rk_interval(&rng, (uint32_t)(num_cores - 1))
                      : 0;
      t += cache_refill;
      if constexpr (kTraced) {
        if (n_mg >= tr.mcap) return kTraceOverflow;
        tr.md[n_mg] = t;
        tr.mi[n_mg] = th;
        tr.mi[n_mg + tr.ms] = mig_from;
        tr.mi[n_mg + 2 * tr.ms] = cores[th];
        n_mg++;
      }
    }
    const int64_t core = cores[th];
    const int64_t n = core_node[core];
    exec_node[task] = (int32_t)n;
    const int64_t pr = par[task];
    const int64_t pn = pr >= 0 ? (int64_t)exec_node[pr] : rnode0;
    const double pen = mu_lam * (fr[task] * root_dist[n] +
                                 fp[task] * (double)node_dist[n * NN + pn]);
    const double w = wp[task];
    double cost = w * (1.0 + pen);
    if (has_faults) {
      cost = cost * fspeed[core];
      int64_t c = wcur[th];
      const int64_t lim = fwoff[th + 1];
      // t advanced during acquire: windows may have closed or opened
      while (c < lim && fwend[c] <= t) c++;
      wcur[th] = c;
      if (c < lim && fwstart[c] < t + cost) {
        // preempted mid-execution: partial work is lost, the task
        // re-executes
        double s = fwstart[c];
        if (s < t) s = t;
        fault_lost += s - t;
        reexec++;
        SIM_OFFLINE(s, th, task, c);
        continue;
      }
    }
    remote += w * pen;
    total_exec += cost;
    agg_node_tasks[n]++;
    agg_node_remote[n] += w * pen;
    if constexpr (kTraced) {
      // the commit point: queue depth sampled now, [t, t + cost)
      if (n_ex >= tr.ecap) return kTraceOverflow;
      tr.ei[n_ex] = task;
      tr.ei[n_ex + tr.es] = th;
      tr.ei[n_ex + 2 * tr.es] = core;
      tr.ei[n_ex + 3 * tr.es] = n;
      tr.ei[n_ex + 4 * tr.es] = depth_first ? dq.len[th] : dq.len[SH];
      tr.ed[n_ex] = t;
      tr.ed[n_ex + tr.es] = t + cost;
      n_ex++;
    }
    t += cost;
    executed++;

    const int64_t nk = nc[task];
    if (nk) {
      const int64_t base = fc[task];
      pending[task] = (int32_t)nk;
      live += nk;
      t += spawn_time * (double)nk;
      const double qc =
          (rdn < 0) ? qop_time
                    : qop_time * (1.0 + hop_lambda_steal *
                                            (double)node_dist[n * NN + rdn]);
      if (wf_like) {
        // dive into the first child; queue the rest newest-first
        for (int64_t k = base + nk - 1; k > base; k--) {
          t += qc;
          dq_push_back(&dq, th, k);
          if (parked.used) SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
        }
        SIM_PUSH(t, th, base);
        continue;
      }
      if (depth_first) {  // cilk: queue all, re-acquire own front
        for (int64_t k = base + nk - 1; k >= base; k--) {
          t += qc;
          dq_push_back(&dq, th, k);
          if (parked.used) SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
        }
      } else {  // bf: shared FIFO in spawn order
        for (int64_t k = base; k < base + nk; k++) {
          const double start = t > sl_free ? t : sl_free;
          sl_waited += start - t;
          t = start + lock_time;
          sl_free = t;
          dq_push_back(&dq, SH, k);
          if (parked.used) SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
        }
      }
      SIM_PUSH(t, th, -1);
      continue;
    }

    // ---- leaf: propagate completion up the tree ----
    live--;
    int64_t node = task;
    while (1) {
      const int64_t parent = par[node];
      if (parent < 0) break;
      const int32_t pd = --pending[parent];
      if (pd > 0) break;
      if (phase[parent] == 0 && npw[parent]) {
        // taskwait passed: spawn the parallel combine wave
        phase[parent] = 1;
        const int64_t k = npw[parent];
        const int64_t fp0 = fpw[parent];
        pending[parent] = (int32_t)k;
        live += k;
        t += spawn_time * (double)k;
        if (depth_first) {
          const double qc =
              (rdn < 0)
                  ? qop_time
                  : qop_time *
                        (1.0 + hop_lambda_steal *
                                   (double)node_dist[core_node[cores[th]] * NN +
                                                     rdn]);
          for (int64_t j = fp0 + k - 1; j >= fp0; j--) {
            t += qc;
            dq_push_back(&dq, th, j);
            if (parked.used)
              SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
          }
        } else {
          for (int64_t j = fp0 + k - 1; j >= fp0; j--) {
            const double start = t > sl_free ? t : sl_free;
            sl_waited += start - t;
            t = start + lock_time;
            sl_free = t;
            dq_push_back(&dq, SH, j);
            if (parked.used)
              SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
          }
        }
        break;
      }
      const double w2 = wpo[parent];
      if (w2 > 0.0) {
        // join continuation with the parent's locality profile
        const int64_t pn2 = exec_node[parent];
        const double pen2 =
            mu_lam * (fr[parent] * root_dist[n] +
                      fp[parent] * (double)node_dist[n * NN + pn2]);
        double c2 = w2 * (1.0 + pen2);
        if (has_faults) c2 = c2 * fspeed[core];
        remote += w2 * pen2;
        total_exec += c2;
        agg_node_remote[n] += w2 * pen2;
        t += c2;
      }
      node = parent;
    }
    if (t > makespan) makespan = t;
    SIM_PUSH(t, th, -1);
  }
#undef SIM_PUSH
#undef SIM_PARK
#undef SIM_OFFLINE

  if (status == 0 && executed != n_tasks) status = 2;  // stranded work
  if (status != 1) last_t = makespan;
  dout[0] = makespan;
  dout[1] = remote;
  dout[2] = total_exec;
  dout[3] = sl_waited;
  dout[4] = fault_lost;
  dout[5] = last_t;
  iout[0] = steals;
  iout[1] = failed;
  iout[2] = reclaimed;
  iout[3] = reexec;
  iout[4] = executed;
  iout[5] = steps;
  iout[6] = status;
  if constexpr (kTraced) {
    tr.counts[0] = n_ex;
    tr.counts[1] = n_st;
    tr.counts[2] = n_mg;
  }
  return 0;
}

// One cell of a batch from its descriptor row.
template <bool kTraced, bool kTimed>
SIM_DEV void run_one(const int64_t* d, const double* dbuf, int64_t* ibuf,
                     uint8_t* ws, double* dout, int64_t* iout, int64_t* aggi,
                     double* aggd, int64_t* rc, const TraceCols& tc,
                     int64_t deadline_ns) {
  const int64_t out = d[kOut];
  TraceSlot tr = {};
  if constexpr (kTraced) {
    tr.ei = tc.ex_i + d[kExOff];
    tr.ed = tc.ex_d + d[kExOff];
    tr.ecap = d[kExCap];
    tr.es = tc.ex_len;
    tr.si = tc.st_i + d[kStOff];
    tr.sd = tc.st_d + d[kStOff];
    tr.scap = d[kStCap];
    tr.ss = tc.st_len;
    tr.mi = tc.mg_i + d[kMgOff];
    tr.md = tc.mg_d + d[kMgOff];
    tr.mcap = d[kMgCap];
    tr.ms = tc.mg_len;
    tr.counts = tc.counts + 3 * out;
  }
  rc[out] = sim_cell<kTraced, kTimed>(
      dbuf + d[kDpar], ibuf + d[kIpar], dbuf + d[kWp], dbuf + d[kWpo],
      dbuf + d[kFr], dbuf + d[kFp], ibuf + d[kFc], ibuf + d[kNc],
      ibuf + d[kFpw], ibuf + d[kNpw], ibuf + d[kPar], ibuf + d[kCoreNode],
      ibuf + d[kNodeDist], dbuf + d[kRootDist], ibuf + d[kCores],
      ibuf + d[kGoff], ibuf + d[kUoff], ibuf + d[kVoff], ibuf + d[kVictims],
      dbuf + d[kFspeed], ibuf + d[kFwoff], dbuf + d[kFwstart],
      dbuf + d[kFwend], dout + 6 * out, iout + 7 * out, aggi + d[kHops],
      aggi + d[kNodeTasks], aggd + d[kNodeRemote], ws + d[kWs], d[kWsBytes],
      tr, deadline_ns);
}

// The self-tests' bodies (_csim.c:816-855), run by one thread.
SIM_DEV void mt_body(uint32_t seed, int64_t n, uint32_t* out, RkState* st) {
  rk_seed(st, seed);
  for (int64_t i = 0; i < n; i++) out[i] = rk_random(st);
}

SIM_DEV void shuffle_body(uint32_t seed, int64_t n, int64_t reps,
                          int64_t* out, RkState* st) {
  rk_seed(st, seed);
  for (int64_t r = 0; r < reps; r++) {
    int64_t* row = out + r * n;
    for (int64_t i = 0; i < n; i++) row[i] = i;
    rk_shuffle(st, row, n);
  }
}

// ops[i] >= 0 adds ops[i], -1 pops; popped keys go to out. Keys must be
// below `max_key` (the set is sized for max_key distinct keys). Returns
// the number of pops, or -1 when the set would outgrow its tables.
SIM_DEV int64_t set_body(int64_t nops, const int64_t* ops, int64_t max_key,
                         int64_t* out, uint8_t* ws) {
  PySet s;
  const uint64_t cap = set_cap(max_key);
  s.key[0] = reinterpret_cast<int64_t*>(ws);
  s.key[1] = s.key[0] + cap;
  s.state[0] = ws + 16 * cap;
  s.state[1] = s.state[0] + cap;
  s.cap = cap;
  pyset_init(&s);
  int64_t npop = 0;
  for (int64_t i = 0; i < nops; i++) {
    if (ops[i] >= 0) {
      if (pyset_add(&s, ops[i])) return -1;
    } else if (s.used) {
      out[npop++] = pyset_pop(&s);
    }
  }
  return npop;
}

#ifdef __CUDACC__

// cells_per_warp cells share a warp: the block's threads are taken in
// runs of 32 / cells_per_warp, the first of each run runs a cell.
template <bool kTraced, bool kTimed>
__global__ void sim_batch_kernel(int64_t n_cells, const int64_t* desc,
                                 const double* dbuf, int64_t* ibuf,
                                 uint8_t* ws, double* dout, int64_t* iout,
                                 int64_t* aggi, double* aggd, int64_t* rc,
                                 int spread, TraceCols tc,
                                 int64_t deadline_ns) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g % spread) return;
  const int64_t k = g / spread;
  if (k >= n_cells) return;
  run_one<kTraced, kTimed>(desc + k * kDescLen, dbuf, ibuf, ws, dout, iout,
                           aggi, aggd, rc, tc, deadline_ns);
}

__global__ void mt_kernel(uint32_t seed, int64_t n, uint32_t* out,
                          RkState* st) {
  mt_body(seed, n, out, st);
}

__global__ void shuffle_kernel(uint32_t seed, int64_t n, int64_t reps,
                               int64_t* out, RkState* st) {
  shuffle_body(seed, n, reps, out, st);
}

__global__ void set_kernel(int64_t nops, const int64_t* ops, int64_t max_key,
                           int64_t* out, int64_t* npop, uint8_t* ws) {
  *npop = set_body(nops, ops, max_key, out, ws);
}

#endif  // __CUDACC__

// The trace columns from the wrappers' ten int64 arguments: the six
// column pointers, the three family lengths and the counts pointer.
TraceCols trace_cols(const int64_t* a) {
  TraceCols tc = {};
  if (!a) return tc;
  tc.ex_i = reinterpret_cast<int64_t*>(a[0]);
  tc.ex_d = reinterpret_cast<double*>(a[1]);
  tc.st_i = reinterpret_cast<int64_t*>(a[2]);
  tc.st_d = reinterpret_cast<double*>(a[3]);
  tc.mg_i = reinterpret_cast<int64_t*>(a[4]);
  tc.mg_d = reinterpret_cast<double*>(a[5]);
  tc.ex_len = a[6];
  tc.st_len = a[7];
  tc.mg_len = a[8];
  tc.counts = reinterpret_cast<int64_t*>(a[9]);
  return tc;
}

}  // namespace

// Bytes of one cell's workspace for n tasks on T threads.
extern "C" int64_t sim_workspace_bytes(int64_t n, int64_t T) {
  return (int64_t)cell_layout(n, T).end;
}

// Bytes of the set self-test's workspace for keys below max_key.
extern "C" int64_t sim_set_workspace_bytes(int64_t max_key) {
  return (int64_t)(18 * set_cap(max_key));
}

#ifdef __CUDACC__

namespace {

template <bool kTraced, bool kTimed>
void launch_batch(unsigned blocks, int threads, cudaStream_t s,
                  int64_t n_cells, const void* desc, const void* dbuf,
                  void* ibuf, void* ws, void* dout, void* iout, void* aggi,
                  void* aggd, void* rc, int spread, const TraceCols& tc,
                  int64_t deadline_ns) {
  sim_batch_kernel<kTraced, kTimed><<<blocks, threads, 0, s>>>(
      n_cells, static_cast<const int64_t*>(desc),
      static_cast<const double*>(dbuf), static_cast<int64_t*>(ibuf),
      static_cast<uint8_t*>(ws), static_cast<double*>(dout),
      static_cast<int64_t*>(iout), static_cast<int64_t*>(aggi),
      static_cast<double*>(aggd), static_cast<int64_t*>(rc), spread, tc,
      deadline_ns);
}

}  // namespace

// One wave of a batch: cells [0, n_cells) of `desc` (kDescLen int64
// each), every pointer on the device, `ws` the wave's workspace
// (`ws_bytes` of it, zeroed here). dout (6), iout (7) and rc (1) are
// indexed by each cell's kOut slot. cells_per_warp in {1, 2, 4, ..., 32}.
// `traced` launches the traced instantiation, writing into the columns
// that `trace_args` (host memory, ten int64: see trace_cols) names; a
// `deadline_ns` >= 0 launches the timed one (< 0: no deadline).
// Returns a cudaError_t (0 = ok).
extern "C" int sim_run_batch(int64_t n_cells, const void* desc,
                             const void* dbuf, void* ibuf, void* ws,
                             int64_t ws_bytes, void* dout, void* iout,
                             void* aggi, void* aggd, void* rc,
                             int cells_per_warp, int traced,
                             int64_t deadline_ns, const int64_t* trace_args,
                             void* stream) {
  if (n_cells <= 0 || cells_per_warp < 1 || cells_per_warp > 32 ||
      32 % cells_per_warp || (traced && !trace_args))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(ws, 0, (size_t)ws_bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int spread = 32 / cells_per_warp;
  const int threads = 128;
  const int64_t total = n_cells * spread;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const TraceCols tc = trace_cols(traced ? trace_args : nullptr);
  const bool timed = deadline_ns >= 0;
  if (traced && timed)
    launch_batch<true, true>(blocks, threads, s, n_cells, desc, dbuf, ibuf,
                             ws, dout, iout, aggi, aggd, rc, spread, tc,
                             deadline_ns);
  else if (traced)
    launch_batch<true, false>(blocks, threads, s, n_cells, desc, dbuf, ibuf,
                              ws, dout, iout, aggi, aggd, rc, spread, tc,
                              deadline_ns);
  else if (timed)
    launch_batch<false, true>(blocks, threads, s, n_cells, desc, dbuf, ibuf,
                              ws, dout, iout, aggi, aggd, rc, spread, tc,
                              deadline_ns);
  else
    launch_batch<false, false>(blocks, threads, s, n_cells, desc, dbuf, ibuf,
                               ws, dout, iout, aggi, aggd, rc, spread, tc,
                               deadline_ns);
  return static_cast<int>(cudaGetLastError());
}

// Raw MT draws: out (n uint32) on the device; st a device RkState.
extern "C" int sim_mt_selftest(uint32_t seed, int64_t n, void* out, void* st,
                               void* stream) {
  mt_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, n, static_cast<uint32_t*>(out), static_cast<RkState*>(st));
  return static_cast<int>(cudaGetLastError());
}

// Shuffles of arange(n), reps times: out (reps x n int64) on the device.
extern "C" int sim_shuffle_selftest(uint32_t seed, int64_t n, int64_t reps,
                                    void* out, void* st, void* stream) {
  shuffle_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, n, reps, static_cast<int64_t*>(out), static_cast<RkState*>(st));
  return static_cast<int>(cudaGetLastError());
}

// The set replica over `ops` (nops int64 on the device); pops to out,
// their count to *npop (-1: the keys outgrew max_key's tables); ws of
// sim_set_workspace_bytes(max_key) bytes.
extern "C" int sim_set_selftest(int64_t nops, const void* ops,
                                int64_t max_key, void* out, void* npop,
                                void* ws, void* stream) {
  set_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      nops, static_cast<const int64_t*>(ops), max_key,
      static_cast<int64_t*>(out), static_cast<int64_t*>(npop),
      static_cast<uint8_t*>(ws));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the RkState the MT and shuffle self-tests need.
extern "C" int64_t sim_rng_state_bytes(void) { return sizeof(RkState); }

extern "C" const char* sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#else  // host build: the same loop on the CPU, for the tests

namespace {

template <bool kTraced, bool kTimed>
void host_batch(int64_t n_cells, const int64_t* desc, const double* dbuf,
                int64_t* ibuf, uint8_t* ws, double* dout, int64_t* iout,
                int64_t* aggi, double* aggd, int64_t* rc, const TraceCols& tc,
                int64_t deadline_ns) {
  for (int64_t k = 0; k < n_cells; k++)
    run_one<kTraced, kTimed>(desc + k * kDescLen, dbuf, ibuf, ws, dout, iout,
                             aggi, aggd, rc, tc, deadline_ns);
}

}  // namespace

// One wave of a batch on the CPU, as sim_run_batch runs it on the card:
// `ws` (`ws_bytes` of it) zeroed here, the cells one after another, the
// instantiation chosen by `traced` and `deadline_ns` (< 0: no deadline),
// the trace columns in host memory.
extern "C" void sim_run_batch_host(int64_t n_cells, const int64_t* desc,
                                   const double* dbuf, int64_t* ibuf,
                                   uint8_t* ws, int64_t ws_bytes,
                                   double* dout, int64_t* iout,
                                   int64_t* aggi, double* aggd, int64_t* rc,
                                   int traced, int64_t deadline_ns,
                                   const int64_t* trace_args) {
  memset(ws, 0, (size_t)ws_bytes);
  const TraceCols tc = trace_cols(traced ? trace_args : nullptr);
  if (traced && deadline_ns >= 0)
    host_batch<true, true>(n_cells, desc, dbuf, ibuf, ws, dout, iout, aggi,
                           aggd, rc, tc, deadline_ns);
  else if (traced)
    host_batch<true, false>(n_cells, desc, dbuf, ibuf, ws, dout, iout, aggi,
                            aggd, rc, tc, deadline_ns);
  else if (deadline_ns >= 0)
    host_batch<false, true>(n_cells, desc, dbuf, ibuf, ws, dout, iout, aggi,
                            aggd, rc, tc, deadline_ns);
  else
    host_batch<false, false>(n_cells, desc, dbuf, ibuf, ws, dout, iout, aggi,
                             aggd, rc, tc, deadline_ns);
}

extern "C" void sim_mt_selftest_host(uint32_t seed, int64_t n, uint32_t* out) {
  RkState st;
  mt_body(seed, n, out, &st);
}

extern "C" void sim_shuffle_selftest_host(uint32_t seed, int64_t n,
                                          int64_t reps, int64_t* out) {
  RkState st;
  shuffle_body(seed, n, reps, out, &st);
}

extern "C" int64_t sim_set_selftest_host(int64_t nops, const int64_t* ops,
                                         int64_t max_key, int64_t* out,
                                         uint8_t* ws) {
  return set_body(nops, ops, max_key, out, ws);
}

#endif  // __CUDACC__
