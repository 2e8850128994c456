// The NANOS task-runtime simulator's event loop for Hopper (sm_90a): one
// thread runs one sweep cell (a workload under a scheduler, an execution
// context, a fault plan and a seed) from ignition to its last event, and
// every cell of a batch runs at once.
//
// Replaces: src/repro/core/sim/_csim.c:743 `sim_run_batch` (the JAX
// package's C engine: a pthread pool over cells, each cell the untraced
// loop of _csim_core.h). The loop matches it bit for bit: every field of
// dout (6) and iout (7) and the three always-on aggregates. What makes
// that hold:
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
// Integers are narrower than the C engine's (task, thread, core and node
// ids, offsets and set keys are int32, a task's node int16, seq uint32),
// and every one is widened where the C code widens: a set key hashes as
// (uint64_t)key, whose low 32 bits are all the probe sequence keeps under
// a mask below 2^32; rk_interval takes uint32_t; distances enter the
// doubles as exact integer conversions. kernels/sim.py refuses a table of
// 2^31 tasks or more, and a cell whose pushes would pass 2^32 - 1 stops
// with kSeqOverflow rather than wrap its (time, seq) order.
//
// What bounded this file's first version, a line-for-line transcription,
// was each event's chain of dependent loads from device memory: the heap, the set, the deque ends, the RNG and the per-thread
// arrays all lived in a per-cell workspace, a task's state in five arrays
// and its table row in nine, every index int64 (234 registers, 8 warps an
// SM). This design does three things about it:
//   * a cell's hot state lives in shared memory: the MT19937 state, the
//     heap, both set tables, the deque heads, tails and lengths, dl_free,
//     wcur, order, uidx, the cell's copy of `cores` and its three
//     aggregates (`hot_layout`). The block's dynamic shared memory is cut
//     into one slice a cell; a wave's slices are sized from its largest
//     (T, nodes, hop bins). Nothing there arrives initialised: the cell
//     sets every field before it reads it, and copies `cores` and the
//     aggregates out once, when it ends;
//   * each task's mutable state is one 16-byte record (deque links,
//     pending, node, its parent's node until it commits and its phase
//     after: one sector a touch), in the cell's device workspace, which
//     the launch zeroes. A parent writes its node into each child's
//     record when it queues it, so running a task reads its own record
//     and not its parent's. The read-only table is one 64-byte record a
//     task (five int32 ids, four doubles), packed once a batch and read
//     through the read-only path;
//   * the heap holds (time, seq, thread) in 16 bytes, and each thread's
//     queued task sits beside it (a thread has at most one event queued,
//     which the push checks), so a sift moves half the bytes.
// Each cell is still one serial chain of events; what bounds the kernel
// now is that chain's latency, and the number of cells the card keeps
// resident (`sim_resident_cells`: 3 blocks of 128 threads an SM, the main
// route's launch bounds holding it to 168 registers), which
// kernels/sim.py reads to choose the launch shape. On an H100 an event
// takes a few thousand cycles (compare_sim --profile, PERF.md §6): the
// heap, running a task (its records, read from the L2 or device memory)
// and the steal sweep take about a quarter each, the completion walk
// most of the rest. Each thread's node sits in shared memory beside its
// core, and a task's table row is prefetched once the task is known, a
// few dependent loads before it runs. The bytes bound, as accounting, is the batch's distinct inputs
// read once and each cell's task state and outputs written once, over
// 3.35 TB/s: the kernel runs far above it, because the chains, not the
// bytes, decide the time. PERF.md has both.
//
// A cell whose hot state does not fit a block's shared memory (a thread
// count far above the paper's 16) runs the same loop with its hot state
// at the front of its device workspace: the same code through the same
// pointers, launched with `hot_in_ws`, counted by the wrapper as its own
// route. The placement is the loop's third template flag (kShared), so
// that on the main route the compiler sees every hot pointer derived
// from the block's shared memory and addresses it as shared memory.
//
// A cell whose structures would overflow stops with a negative return
// code (never truncates); the wrapper puts an error naming the cell in
// that cell's result slot. Status 1 (the step watchdog) and 2 (stranded
// work) are results, in iout[6].
//
// Two more flags make four instantiations of each placement (template
// parameters of `sim_cell`, as _csim.c:617-632 includes _csim_core.h
// twice); every flag acts through `if constexpr` on the one loop:
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
//     %globaltimer when *its* cell starts and every kDeadlineEvery events,
//     the first included; past the deadline the cell stops with kTimedOut
//     and its siblings run on.
//
// Built with -DSIM_PROFILE (only kernels/compare_sim.py does), each cell
// also sums clock64() cycles by part of the loop (`Prof`) into a device
// array that `sim_profile_read` copies out; the main path's build has no
// such code.
//
// Built as host C++ (no __CUDACC__), the same loop runs on the CPU
// through `sim_run_batch_host` (every instantiation and both placements,
// the shared slice a host buffer of the same layout filled with garbage
// before each cell) and the `*_selftest_host` entries: the tests compile
// it that way to hold the loop to the plain version where there is no
// card.

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <chrono>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SIM_DEV __host__ __device__
#define SIM_MEMBER __host__ __device__
#else
#define SIM_DEV static inline
#define SIM_MEMBER inline
#endif

#ifdef __CUDA_ARCH__
#define SIM_LDG(p) __ldg(p)
#else
#define SIM_LDG(p) (*(p))
#endif

namespace {

// --------------------------------------------------------------------
// The per-cell descriptor: int64 offsets into the packed buffers, in the
// order kernels/sim.py writes them.
// --------------------------------------------------------------------

enum Desc {
  kOut = 0,        // the cell's slot in dout / iout / rc
  kDpar,           // dbuf: 11 cost-model doubles
  kIpar,           // ibuf: kIparLen int32 parameters
  kTab,            // tab: the task table's first record
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

// the int32 parameters of a cell (kernels/sim.py `_ipar`)
enum Ipar {
  kT = 0, kNumCores, kNodes, kTasks, kQueueShared, kChildFirst, kSeed,
  kRdn, kRootNode0, kHasFaults, kMaxStepsLo, kMaxStepsHi, kHopBins,
  kIparLen
};

// return codes of a cell (0 = ran; its status is in iout[6])
constexpr int32_t kHeapOverflow = -2;
constexpr int32_t kSetOverflow = -3;
constexpr int32_t kWorkspaceShort = -4;
constexpr int32_t kTraceOverflow = -5;
constexpr int32_t kTimedOut = -6;
constexpr int32_t kSeqOverflow = -7;

// events between two reads of the clock (core/sim/_engine_py.py
// DEADLINE_EVERY)
constexpr int64_t kDeadlineEvery = 4096;

// threads of a block (4 warps); a block holds 4 x cells_per_warp cells,
// fewer where their shared slices do not fit
constexpr int kThreads = 128;
// blocks an SM should hold at once: __launch_bounds__ caps a thread's
// registers at 65536 / (kThreads x blocks). The main route (untraced,
// shared) holds 3, which caps it at 168 registers: at 171 it held 2 and
// the [sim] grid ran 1.2x longer (compare_sim --min-blocks, PERF.md §6);
// the traced and workspace instantiations need more than 168 registers
// and are held to 2 so that none spills.
#ifndef SIM_MIN_BLOCKS
#define SIM_MIN_BLOCKS 3
#endif
constexpr int min_blocks(bool traced, bool shared) {
  return !traced && shared ? SIM_MIN_BLOCKS : 2;
}

// One task's read-only row, packed once a batch (kernels/sim.py
// `TASK_RECORD`): one 64-byte record, two sectors of one line.
struct TaskRO {
  double wp, wpo, fr, fp;
  int32_t par, fc, nc, fpw, npw, pad0, pad1, pad2;
};
static_assert(sizeof(TaskRO) == 64, "TaskRO is 64 bytes");

// One task's mutable state in one cell: 16 bytes, one sector. Until the
// task commits, `pnode` is its parent's node (written when the parent
// spawns it, so that running it reads no other task's record); once it
// has committed, the same field is its `phase` (1 once its post wave was
// spawned), which the completion walk reads.
struct TaskState {
  int32_t next, prev;  // deque links
  int32_t pending;     // children (or post-wave tasks) not yet done
  int16_t exec_node;   // the node its latest attempt ran on
  union {
    int16_t pnode;
    int16_t phase;
  };
};
static_assert(sizeof(TaskState) == 16, "TaskState is 16 bytes");

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
// Where an event's cycles go (-DSIM_PROFILE only): every cycle of a cell
// is charged to the part that is current; `enter` / `leave` charge a
// nested call (a heap operation, an RNG draw) to its own part.
// --------------------------------------------------------------------

enum ProfPart {
  kPHeap = 0, kPAcquire, kPRng, kPExec, kPSpawn, kPWalk, kPInit, kPOther,
  kProfParts
};

#ifdef SIM_PROFILE
constexpr int64_t kProfCells = 16384;

SIM_DEV uint64_t prof_clock() {
#ifdef __CUDA_ARCH__
  return (uint64_t)clock64();
#else
  return clock_ns();
#endif
}

struct Prof {
  uint64_t c[kProfParts];
  uint64_t t;
  int cur;
  SIM_MEMBER void start() {
    for (int i = 0; i < kProfParts; i++) c[i] = 0;
    cur = kPInit;
    t = prof_clock();
  }
  SIM_MEMBER void to(int p) {
    const uint64_t now = prof_clock();
    c[cur] += now - t;
    t = now;
    cur = p;
  }
  SIM_MEMBER int enter(int p) {
    const int s = cur;
    to(p);
    return s;
  }
  SIM_MEMBER void leave(int s) { to(s); }
};

#ifdef __CUDACC__
__device__ unsigned long long g_sim_prof[kProfCells * kProfParts];
#else
unsigned long long g_sim_prof[kProfCells * kProfParts];
#endif

SIM_DEV void prof_store(Prof& p, int64_t out) {
  p.to(kPOther);
  if (out < kProfCells)
    for (int i = 0; i < kProfParts; i++)
      g_sim_prof[out * kProfParts + i] = p.c[i];
}
#else
struct Prof {
  SIM_MEMBER void start() {}
  SIM_MEMBER void to(int) {}
  SIM_MEMBER int enter(int) { return 0; }
  SIM_MEMBER void leave(int) {}
};
SIM_DEV void prof_store(Prof&, int64_t) {}
#endif

// Ask for a task's table row while other work goes on: a task is known
// (from a deque's end or an event) a few dependent loads before it runs.
SIM_DEV void prefetch_row(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#else
  (void)p;
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
template <typename I>
SIM_DEV void rk_shuffle(RkState* st, I* x, int64_t n) {
  for (int64_t i = n - 1; i > 0; i--) {
    uint32_t j = rk_interval(st, (uint32_t)i);
    I tmp = x[i];
    x[i] = x[j];
    x[j] = tmp;
  }
}

// --------------------------------------------------------------------
// CPython 3.10 set replica, int keys >= 0, add + pop (_csim.c:114-228),
// over two preallocated tables of `cap` int32 slots: a slot's key is the
// entry, kEmptyKey or kDummyKey (CPython's two markers), so a probe reads
// one word
// --------------------------------------------------------------------

constexpr uint32_t kSetMinSize = 8;
constexpr uint32_t kLinearProbes = 9;
constexpr int kPerturbShift = 5;
constexpr int32_t kEmptyKey = -1, kDummyKey = -2;

// the two tables sit back to back from `key`; `cur` (0 or 1) says which
// one is read (an index into an array of two pointers would put the
// struct in local memory)
struct PySet {
  int32_t* key;
  uint32_t cur, cap, mask, fill, used, finger;
};

SIM_DEV int32_t* pyset_table(const PySet* s, uint32_t which) {
  return s->key + which * s->cap;
}

SIM_DEV void pyset_init(PySet* s) {
  s->cur = 0;
  s->mask = kSetMinSize - 1;
  s->fill = s->used = s->finger = 0;
  for (uint32_t j = 0; j <= s->mask; j++) s->key[j] = kEmptyKey;
}

// The probe sequence in 32 bits: CPython's perturb starts from the key
// widened to 64 bits, but a key below 2^31 has no high bits to shift
// down, and `& mask` keeps only low bits of the sum.
SIM_DEV void pyset_insert_clean(int32_t* keyt, uint32_t mask, int32_t key) {
  uint32_t perturb = (uint32_t)key;
  uint32_t i = (uint32_t)key & mask;
  while (1) {
    uint32_t j = i;
    uint32_t probes = (i + kLinearProbes <= mask) ? kLinearProbes : 0;
    do {
      if (keyt[j] == kEmptyKey) {
        keyt[j] = key;
        return;
      }
      j++;
    } while (probes--);
    perturb >>= kPerturbShift;
    i = (i * 5 + 1 + perturb) & mask;
  }
}

SIM_DEV int pyset_resize(PySet* s, uint32_t minused) {
  uint32_t newsize = kSetMinSize;
  while (newsize <= minused) newsize <<= 1;
  if (newsize > s->cap) return -1;
  const uint32_t nxt = 1 - s->cur;
  int32_t* nk = pyset_table(s, nxt);
  const int32_t* ok = pyset_table(s, s->cur);
  for (uint32_t j = 0; j < newsize; j++) nk[j] = kEmptyKey;
  for (uint32_t j = 0; j <= s->mask; j++)
    if (ok[j] >= 0) pyset_insert_clean(nk, newsize - 1, ok[j]);
  s->cur = nxt;
  s->mask = newsize - 1;
  s->fill = s->used;
  return 0;
}

SIM_DEV int pyset_add(PySet* s, int32_t key) {
  int32_t* keyt = pyset_table(s, s->cur);
  uint32_t perturb = (uint32_t)key;
  const uint32_t mask = s->mask;
  uint32_t i = (uint32_t)key & mask;
  uint32_t freeslot = ~(uint32_t)0;
  while (1) {
    uint32_t j = i;
    uint32_t probes = (i + kLinearProbes <= mask) ? kLinearProbes : 0;
    do {
      const int32_t kj = keyt[j];
      if (kj == kEmptyKey) {
        if (freeslot != ~(uint32_t)0) {
          s->used++;
          keyt[freeslot] = key;
          return 0;
        }
        s->fill++;
        s->used++;
        keyt[j] = key;
        if (s->fill * 5 < mask * 3) return 0;
        return pyset_resize(s, s->used > 50000 ? s->used * 2 : s->used * 4);
      }
      if (kj == key) return 0;
      if (kj == kDummyKey) freeslot = j;
      j++;
    } while (probes--);
    perturb >>= kPerturbShift;
    i = (i * 5 + 1 + perturb) & mask;
  }
}

SIM_DEV int32_t pyset_pop(PySet* s) {
  int32_t* keyt = pyset_table(s, s->cur);
  uint32_t i = s->finger & s->mask;
  while (keyt[i] < 0) {
    i++;
    if (i > s->mask) i = 0;
  }
  const int32_t key = keyt[i];
  keyt[i] = kDummyKey;
  s->used--;
  s->finger = i + 1;
  return key;
}

// --------------------------------------------------------------------
// The (time, seq) event heap (_csim.c:234-297), fixed capacity. A thread
// has at most one event queued: ignition gives each one, a popped event
// pushes at most its thread's next one, and a parked thread has none
// until a wake pops it from the set. So an entry is (t, seq, thread), 16
// bytes, the thread's queued task waits in task[thread] (kNoEvent: none
// queued), a second push for a thread is refused, and T entries suffice.
// --------------------------------------------------------------------

constexpr int32_t kNoEvent = INT32_MIN;

struct alignas(16) Ev {
  double t;
  uint32_t seq;
  int32_t th;
};
static_assert(sizeof(Ev) == 16, "an event is 16 bytes");

struct Heap {
  Ev* e;
  int32_t* task;  // per thread
  uint32_t len, cap;
};

SIM_DEV bool ev_lt(const Ev& a, const Ev& b) {
  return a.t < b.t || (a.t == b.t && a.seq < b.seq);
}

SIM_DEV void heap_init(Heap* h, Ev* e, int32_t* task, int32_t T) {
  h->e = e;
  h->task = task;
  h->len = 0;
  h->cap = (uint32_t)(T > 1 ? T : 1);
  for (uint32_t i = 0; i < h->cap; i++) task[i] = kNoEvent;
}

SIM_DEV int heap_push(Heap* h, double t, uint32_t seq, int32_t th,
                      int32_t task) {
  if (h->len == h->cap || h->task[th] != kNoEvent) return -1;
  h->task[th] = task;
  const Ev v = {t, seq, th};
  uint32_t i = h->len++;
  while (i > 0) {
    uint32_t p = (i - 1) >> 1;
    const Ev ep = h->e[p];
    if (!ev_lt(v, ep)) break;
    h->e[i] = ep;
    i = p;
  }
  h->e[i] = v;
  return 0;
}

// the earliest event; its task in *task
SIM_DEV Ev heap_pop(Heap* h, int32_t* task) {
  const Ev top = h->e[0];
  const Ev last = h->e[--h->len];
  const uint32_t n = h->len;
  uint32_t i = 0;
  while (1) {
    uint32_t c = 2 * i + 1;
    if (c >= n) break;
    Ev ec = h->e[c];
    if (c + 1 < n) {
      const Ev ec1 = h->e[c + 1];
      if (ev_lt(ec1, ec)) {
        c++;
        ec = ec1;
      }
    }
    if (!ev_lt(ec, last)) break;
    h->e[i] = ec;
    i = c;
  }
  if (n) h->e[i] = last;
  *task = h->task[top.th];
  h->task[top.th] = kNoEvent;
  return top;
}

// --------------------------------------------------------------------
// Task deques: doubly linked lists through the tasks' records; deque
// q < T is thread q's local pool, q == T the shared FIFO. A task id is in
// at most one deque at a time (it is queued when spawned, leaves when
// taken, and is queued again only from a thread's hand when a fault takes
// the thread offline), so the links hold every deque at any moment, and
// push_back / pop_back / pop_front keep the C engine's ring order.
// --------------------------------------------------------------------

struct Deques {
  TaskState* ts;  // n, device memory
  int32_t* head;  // T + 1, the hot state
  int32_t* tail;  // T + 1
  int32_t* len;   // T + 1
};

SIM_DEV void dq_push_back(Deques* d, int32_t q, int32_t v) {
  const int32_t t = d->tail[q];
  d->ts[v].prev = t;
  d->ts[v].next = -1;
  if (d->len[q] == 0)
    d->head[q] = v;
  else
    d->ts[t].next = v;
  d->tail[q] = v;
  d->len[q]++;
}

SIM_DEV int32_t dq_pop_back(Deques* d, int32_t q) {
  const int32_t v = d->tail[q];
  const int32_t p = d->ts[v].prev;
  d->tail[q] = p;
  if (--d->len[q] == 0)
    d->head[q] = -1;
  else
    d->ts[p].next = -1;
  return v;
}

SIM_DEV int32_t dq_pop_front(Deques* d, int32_t q) {
  const int32_t v = d->head[q];
  const int32_t nx = d->ts[v].next;
  d->head[q] = nx;
  if (--d->len[q] == 0)
    d->tail[q] = -1;
  else
    d->ts[nx].prev = -1;
  return v;
}

// --------------------------------------------------------------------
// The layouts (kernels/sim.py `hot_bytes` and `workspace_bytes`)
// --------------------------------------------------------------------

SIM_DEV uint64_t align8(uint64_t x) { return (x + 7) & ~(uint64_t)7; }
SIM_DEV uint64_t align16(uint64_t x) { return (x + 15) & ~(uint64_t)15; }

// largest set table CPython's resize rule reaches with at most T keys: a
// resize asks for 4 x used slots up to 50 000 keys, 2 x used above
SIM_DEV uint64_t set_cap(int64_t T) {
  const uint64_t t = (uint64_t)(T > 0 ? T : 0);
  uint64_t minused = 4 * (t < 50000 ? t : 50000);
  if (t > 50000 && 2 * t > minused) minused = 2 * t;
  uint64_t size = kSetMinSize;
  while (size <= minused) size <<= 1;
  return size;
}

// A cell's hot state: byte offsets into its slice (T threads, NN nodes,
// H hop bins), doubles and events first.
struct HotLayout {
  uint64_t heap, dl_free, node_remote, rng, evtask, keys, head, tail, len,
      wcur, order, uidx, cores, tnode, hops, node_tasks, end;
};

SIM_DEV HotLayout hot_layout(int64_t T, int64_t NN, int64_t H) {
  HotLayout L;
  const uint64_t t1 = (uint64_t)(T > 1 ? T : 1);
  const uint64_t sc = set_cap(T);
  uint64_t o = 0;
  L.heap = o;        o = align16(o + t1 * sizeof(Ev));
  L.dl_free = o;     o = align8(o + t1 * 8);
  L.node_remote = o; o = align8(o + (uint64_t)NN * 8);
  L.rng = o;         o = align8(o + sizeof(RkState));
  L.evtask = o;      o = align8(o + t1 * 4);
  L.keys = o;        o = align8(o + 2 * sc * 4);
  L.head = o;        o = align8(o + (t1 + 1) * 4);
  L.tail = o;        o = align8(o + (t1 + 1) * 4);
  L.len = o;         o = align8(o + (t1 + 1) * 4);
  L.wcur = o;        o = align8(o + t1 * 4);
  L.order = o;       o = align8(o + t1 * 4);
  L.uidx = o;        o = align8(o + t1 * 4);
  L.cores = o;       o = align8(o + t1 * 4);
  L.tnode = o;       o = align8(o + t1 * 4);
  L.hops = o;        o = align8(o + (uint64_t)H * 4);
  L.node_tasks = o;  o = align8(o + (uint64_t)NN * 4);
  L.end = align16(o);
  return L;
}

// A cell's device workspace: its hot state first when it lives there,
// then one TaskState a task.
SIM_DEV uint64_t cell_ws_bytes(int64_t n, uint64_t hot_in_ws) {
  return align16(hot_in_ws) + align16((uint64_t)n * sizeof(TaskState));
}

// --------------------------------------------------------------------
// One cell: the loop of _csim_core.h (see the top for the two flags and
// the placement). `hot` is the cell's shared slice of `hot_cap` bytes, or
// null: the hot state then sits at the front of the cell's workspace.
// --------------------------------------------------------------------

template <bool kTraced, bool kTimed, bool kShared>
SIM_DEV int32_t sim_cell(const int64_t* __restrict__ d,
                         const double* __restrict__ dbuf, int32_t* ibuf,
                         const TaskRO* __restrict__ tab0, uint8_t* ws,
                         uint8_t* hot, int64_t hot_cap, double* dout,
                         int64_t* iout, int64_t* aggi, double* aggd,
                         const TraceSlot& tr, int64_t deadline_ns,
                         Prof& prof) {
  uint64_t t_start = 0;
  if constexpr (kTimed) t_start = clock_ns();
  int64_t n_ex = 0, n_st = 0, n_mg = 0;
  (void)n_ex;
  (void)n_st;
  (void)n_mg;
  (void)t_start;
  const double* dpar = dbuf + d[kDpar];
  const int32_t* ip = ibuf + d[kIpar];
  const double hop_lambda = dpar[0], hop_lambda_steal = dpar[1];
  const double lock_time = dpar[2], deque_lock_time = dpar[3];
  const double steal_time = dpar[4], spawn_time = dpar[5];
  const double wake_latency = dpar[6], qop_time = dpar[7];
  const double cache_refill = dpar[8], mem_intensity = dpar[9];
  const double migration_rate = dpar[10];
  const int32_t T = ip[kT], num_cores = ip[kNumCores], NN = ip[kNodes];
  const int32_t n_tasks = ip[kTasks];
  const bool depth_first = !ip[kQueueShared];
  const bool wf_like = ip[kChildFirst] != 0;
  const uint32_t seed = (uint32_t)ip[kSeed];
  const int32_t rdn = ip[kRdn];
  const int32_t rnode0 = ip[kRootNode0];
  const bool has_faults = ip[kHasFaults] != 0;
  const int32_t H = ip[kHopBins];
  int64_t max_steps = (int64_t)(((uint64_t)(uint32_t)ip[kMaxStepsHi] << 32) |
                                (uint32_t)ip[kMaxStepsLo]);
  const double mu_lam = mem_intensity * hop_lambda;
  if (max_steps <= 0) max_steps = INT64_MAX;

  const TaskRO* __restrict__ tab = tab0 + d[kTab];
  const int32_t* __restrict__ core_node = ibuf + d[kCoreNode];
  const int32_t* __restrict__ node_dist = ibuf + d[kNodeDist];
  const double* __restrict__ root_dist = dbuf + d[kRootDist];
  const double* __restrict__ fspeed = dbuf + d[kFspeed];
  const int32_t* __restrict__ fwoff = ibuf + d[kFwoff];
  const double* __restrict__ fwstart = dbuf + d[kFwstart];
  const double* __restrict__ fwend = dbuf + d[kFwend];

  // the placement: a shared slice, or the front of the workspace
  const HotLayout L = hot_layout(T, NN, H);
  uint8_t* cell_ws = ws + d[kWs];
  uint64_t cold = 0;
  if constexpr (kShared) {
    if (L.end > (uint64_t)hot_cap) return kWorkspaceShort;
  } else {
    hot = cell_ws;
    cold = L.end;
  }
  if (cell_ws_bytes(n_tasks, cold) > (uint64_t)d[kWsBytes])
    return kWorkspaceShort;

  // the hot state, every field set here: none of it arrives zeroed
  RkState* rng = reinterpret_cast<RkState*>(hot + L.rng);
  rk_seed(rng, seed);
  double* dl_free = reinterpret_cast<double*>(hot + L.dl_free);
  double* node_remote = reinterpret_cast<double*>(hot + L.node_remote);
  int32_t* wcur = reinterpret_cast<int32_t*>(hot + L.wcur);
  int32_t* order = reinterpret_cast<int32_t*>(hot + L.order);
  int32_t* uidx = reinterpret_cast<int32_t*>(hot + L.uidx);
  int32_t* cores = reinterpret_cast<int32_t*>(hot + L.cores);
  // each thread's node, core_node[cores[th]], kept beside cores
  int32_t* tnode = reinterpret_cast<int32_t*>(hot + L.tnode);
  int32_t* hops = reinterpret_cast<int32_t*>(hot + L.hops);
  int32_t* node_tasks = reinterpret_cast<int32_t*>(hot + L.node_tasks);
  int32_t* cores_out = ibuf + d[kCores];
  Heap evq;
  heap_init(&evq, reinterpret_cast<Ev*>(hot + L.heap),
            reinterpret_cast<int32_t*>(hot + L.evtask), T);
  for (int32_t i = 0; i < T; i++) {
    dl_free[i] = 0.0;
    cores[i] = cores_out[i];
    tnode[i] = SIM_LDG(core_node + cores[i]);
    if (has_faults) wcur[i] = fwoff[i];
  }
  for (int32_t i = 0; i < NN; i++) {
    node_remote[i] = 0.0;
    node_tasks[i] = 0;
  }
  for (int32_t i = 0; i < H; i++) hops[i] = 0;
  // pending, exec_node and phase start at zero in the task records: the
  // workspace arrives zeroed (the launch clears it), as the C engine
  // callocs them; the links are written before they are read
  Deques dq;
  dq.ts = reinterpret_cast<TaskState*>(cell_ws + cold);
  dq.head = reinterpret_cast<int32_t*>(hot + L.head);
  dq.tail = reinterpret_cast<int32_t*>(hot + L.tail);
  dq.len = reinterpret_cast<int32_t*>(hot + L.len);
  for (int32_t q = 0; q <= T; q++) {
    dq.head[q] = dq.tail[q] = -1;
    dq.len[q] = 0;
  }
  TaskState* ts = dq.ts;
  ts[0].pnode = (int16_t)rnode0;  // the root's "parent" holds the data
  const int32_t SH = T;  // the shared FIFO
  PySet parked;
  parked.key = reinterpret_cast<int32_t*>(hot + L.keys);
  parked.cap = (uint32_t)set_cap(T);
  pyset_init(&parked);

  double sl_free = 0.0, sl_waited = 0.0;
  double remote = 0.0, total_exec = 0.0, makespan = 0.0;
  // each of these is at most n + W (the fault windows) or n: int32;
  // the probes and the events are counted in int64
  int32_t steals = 0, live = 1, reexec = 0, executed = 0;
  int64_t failed = 0, reclaimed = 0, steps = 0;
  int32_t status = 0;
  double fault_lost = 0.0, last_t = 0.0;
  uint32_t seq = 0;

  auto push = [&](double t_, int32_t th_, int32_t task_) -> int32_t {
    if (seq == UINT32_MAX) return kSeqOverflow;
    seq++;
    const int s = prof.enter(kPHeap);
    const int e = heap_push(&evq, t_, seq, th_, task_);
    prof.leave(s);
    return e ? kHeapOverflow : 0;
  };
  // thread `oth` hits offline window `cidx` at `now`, carrying `otask` if
  // >= 0 (_csim.c:366-405): the in-hand task is re-queued, one thief is
  // woken per queued task, and a finite window resumes the thread at its
  // end; an infinite one never does, and an empty-handed dead thread
  // passes a wake on
  auto offline = [&](double now, int32_t oth, int32_t otask,
                     int32_t cidx) -> int32_t {
    int64_t nq = depth_first ? dq.len[oth] : 0;
    if (otask >= 0) {
      nq++;
      dq_push_back(&dq, depth_first ? oth : SH, otask);
    }
    reclaimed += nq;
    while (nq > 0 && parked.used) {
      if (int32_t e = push(now + wake_latency, pyset_pop(&parked), -1))
        return e;
      nq--;
    }
    if (fwend[cidx] != (double)INFINITY) {
      if (int32_t e = push(fwend[cidx], oth, -1)) return e;
    } else if (otask < 0 && parked.used) {
      if (int32_t e = push(now, pyset_pop(&parked), -1)) return e;
    }
    return 0;
  };

#define SIM_PUSH(t_, th_, task_)                                   \
  do {                                                             \
    if (int32_t e_ = push((t_), (th_), (task_))) return e_;        \
  } while (0)
#define SIM_PARK(th_)                                              \
  do {                                                             \
    if (live > 0 && pyset_add(&parked, (th_))) return kSetOverflow; \
  } while (0)
#define SIM_OFFLINE(now_, th_, task_, c_)                          \
  do {                                                             \
    if (int32_t e_ = offline((now_), (th_), (task_), (c_))) return e_; \
  } while (0)

  // ignition: master runs the root, workers go hunting
  SIM_PUSH(0.0, 0, 0);
  for (int32_t th = 1; th < T; th++) SIM_PUSH(0.0, th, -1);

  while (evq.len) {
    prof.to(kPHeap);
    int32_t task;
    const Ev ev = heap_pop(&evq, &task);
    if (task >= 0) prefetch_row(tab + task);
    prof.to(kPOther);
    double t = ev.t;
    const int32_t th = ev.th;

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
      int32_t c = wcur[th];
      const int32_t lim = fwoff[th + 1];
      while (c < lim && fwend[c] <= t) c++;
      wcur[th] = c;
      if (c < lim && fwstart[c] <= t) {
        SIM_OFFLINE(t, th, task, c);
        continue;
      }
    }

    if (task < 0) {
      // ---- acquire: local pop / steal sweep / shared FIFO ----
      prof.to(kPAcquire);
      if (depth_first) {
        if (dq.len[th]) {
          prefetch_row(tab + dq.tail[th]);
          task = dq_pop_back(&dq, th);
          if (rdn < 0)
            t += qop_time;
          else
            t += qop_time *
                 (1.0 + hop_lambda_steal *
                            (double)SIM_LDG(node_dist + tnode[th] * NN +
                                            rdn));
        } else {
          // materialize one sweep from the compiled plan
          const int32_t* __restrict__ goff = ibuf + d[kGoff];
          const int32_t* __restrict__ uoff = ibuf + d[kUoff];
          const int32_t* __restrict__ voff = ibuf + d[kVoff];
          const int32_t* __restrict__ victims = ibuf + d[kVictims];
          int32_t n_order = 0;
          const int32_t g1 = SIM_LDG(goff + th + 1);
          for (int32_t g = SIM_LDG(goff + th); g < g1; g++) {
            const int32_t u0 = SIM_LDG(uoff + g);
            const int32_t u1 = SIM_LDG(uoff + g + 1);
            const int32_t nu = u1 - u0;
            if (nu > 1) {
              for (int32_t k = 0; k < nu; k++) uidx[k] = u0 + k;
              const int s = prof.enter(kPRng);
              rk_shuffle(rng, uidx, nu);
              prof.leave(s);
              for (int32_t k = 0; k < nu; k++) {
                const int32_t j1 = SIM_LDG(voff + uidx[k] + 1);
                for (int32_t j = SIM_LDG(voff + uidx[k]); j < j1; j++)
                  order[n_order++] = SIM_LDG(victims + j);
              }
            } else {
              const int32_t j1 = SIM_LDG(voff + u1);
              for (int32_t j = SIM_LDG(voff + u0); j < j1; j++)
                order[n_order++] = SIM_LDG(victims + j);
            }
          }
          task = -1;
          const int32_t* __restrict__ tn_dist = node_dist + tnode[th] * NN;
          for (int32_t k = 0; k < n_order; k++) {
            const int32_t v = order[k];
            const double dv =
                (rdn < 0)
                    ? (double)SIM_LDG(tn_dist + tnode[v])
                    : (double)SIM_LDG(tn_dist + rdn);
            t += steal_time * (1.0 + hop_lambda_steal * dv);
            if (dq.len[v]) {
              const double start = t > dl_free[v] ? t : dl_free[v];
              t = start + deque_lock_time;
              dl_free[v] = t;
              steals++;
              prefetch_row(tab + dq.head[v]);
              task = dq_pop_front(&dq, v);
              // hop distance thief core -> victim core (the stolen
              // task's data locality)
              const int32_t sd = SIM_LDG(tn_dist + tnode[v]);
              hops[sd]++;
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
        prefetch_row(tab + dq.head[SH]);
        task = dq_pop_front(&dq, SH);
      }
    }

    // ---- run `task` on thread th at time t ----
    prof.to(kPExec);
    if (migration_rate > 0.0) {
      int s = prof.enter(kPRng);
      const double u = rk_double(rng);
      prof.leave(s);
      if (u < migration_rate) {
        const int32_t mig_from = cores[th];
        (void)mig_from;
        // randint(1) is special-cased by numpy: no draw consumed
        s = prof.enter(kPRng);
        cores[th] = (num_cores > 1)
                        ? (int32_t)rk_interval(rng, (uint32_t)(num_cores - 1))
                        : 0;
        prof.leave(s);
        tnode[th] = SIM_LDG(core_node + cores[th]);
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
    }
    const int32_t core = cores[th];
    const int32_t n = tnode[th];
    const int32_t* __restrict__ n_dist = node_dist + n * NN;
    const double rd_n = SIM_LDG(root_dist + n);
    const TaskRO* rec = tab + task;
    TaskState& tsk = ts[task];
    // the parent's node (the data's root's), read before the record is
    // written
    const int32_t pn = tsk.pnode;
    tsk.exec_node = (int16_t)n;
    const double pen = mu_lam * (SIM_LDG(&rec->fr) * rd_n +
                                 SIM_LDG(&rec->fp) *
                                     (double)SIM_LDG(n_dist + pn));
    const double w = SIM_LDG(&rec->wp);
    double cost = w * (1.0 + pen);
    if (has_faults) {
      cost = cost * SIM_LDG(fspeed + core);
      int32_t c = wcur[th];
      const int32_t lim = fwoff[th + 1];
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
    tsk.phase = 0;  // committed: pnode is read no more
    remote += w * pen;
    total_exec += cost;
    node_tasks[n]++;
    node_remote[n] += w * pen;
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

    const int32_t nk = SIM_LDG(&rec->nc);
    if (nk) {
      prof.to(kPSpawn);
      const int32_t base = SIM_LDG(&rec->fc);
      ts[task].pending = nk;
      live += nk;
      t += spawn_time * (double)nk;
      const double qc =
          (rdn < 0) ? qop_time
                    : qop_time * (1.0 + hop_lambda_steal *
                                            (double)SIM_LDG(n_dist + rdn));
      if (wf_like) {
        // dive into the first child; queue the rest newest-first
        for (int32_t k = base + nk - 1; k > base; k--) {
          t += qc;
          ts[k].pnode = (int16_t)n;
          dq_push_back(&dq, th, k);
          if (parked.used) SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
        }
        ts[base].pnode = (int16_t)n;
        SIM_PUSH(t, th, base);
        continue;
      }
      if (depth_first) {  // cilk: queue all, re-acquire own front
        for (int32_t k = base + nk - 1; k >= base; k--) {
          t += qc;
          ts[k].pnode = (int16_t)n;
          dq_push_back(&dq, th, k);
          if (parked.used) SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
        }
      } else {  // bf: shared FIFO in spawn order
        for (int32_t k = base; k < base + nk; k++) {
          const double start = t > sl_free ? t : sl_free;
          sl_waited += start - t;
          t = start + lock_time;
          sl_free = t;
          ts[k].pnode = (int16_t)n;
          dq_push_back(&dq, SH, k);
          if (parked.used) SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
        }
      }
      SIM_PUSH(t, th, -1);
      continue;
    }

    // ---- leaf: propagate completion up the tree ----
    prof.to(kPWalk);
    live--;
    int32_t node = task;
    while (1) {
      const int32_t parent = SIM_LDG(&tab[node].par);
      if (parent < 0) break;
      // the parent's record in one read, then its count down
      const TaskState pst = ts[parent];
      TaskState& ps = ts[parent];
      const TaskRO* prec = tab + parent;
      const int32_t pd = pst.pending - 1;
      ps.pending = pd;
      if (pd > 0) break;
      const int32_t k = SIM_LDG(&prec->npw);
      if (pst.phase == 0 && k) {
        // taskwait passed: spawn the parallel combine wave
        ps.phase = 1;
        const int32_t fp0 = SIM_LDG(&prec->fpw);
        ps.pending = k;
        live += k;
        t += spawn_time * (double)k;
        if (depth_first) {
          const double qc =
              (rdn < 0)
                  ? qop_time
                  : qop_time *
                        (1.0 + hop_lambda_steal *
                                   (double)SIM_LDG(node_dist +
                                                   tnode[th] * NN + rdn));
          for (int32_t j = fp0 + k - 1; j >= fp0; j--) {
            t += qc;
            ts[j].pnode = pst.exec_node;
            dq_push_back(&dq, th, j);
            if (parked.used)
              SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
          }
        } else {
          for (int32_t j = fp0 + k - 1; j >= fp0; j--) {
            const double start = t > sl_free ? t : sl_free;
            sl_waited += start - t;
            t = start + lock_time;
            sl_free = t;
            ts[j].pnode = pst.exec_node;
            dq_push_back(&dq, SH, j);
            if (parked.used)
              SIM_PUSH(t + wake_latency, pyset_pop(&parked), -1);
          }
        }
        break;
      }
      const double w2 = SIM_LDG(&prec->wpo);
      if (w2 > 0.0) {
        // join continuation with the parent's locality profile
        const int32_t pn2 = pst.exec_node;
        const double pen2 =
            mu_lam * (SIM_LDG(&prec->fr) * rd_n +
                      SIM_LDG(&prec->fp) * (double)SIM_LDG(n_dist + pn2));
        double c2 = w2 * (1.0 + pen2);
        if (has_faults) c2 = c2 * SIM_LDG(fspeed + core);
        remote += w2 * pen2;
        total_exec += c2;
        node_remote[n] += w2 * pen2;
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
  // the hot state's results, out once
  for (int32_t i = 0; i < T; i++) cores_out[i] = cores[i];
  int64_t* agg_hops = aggi + d[kHops];
  int64_t* agg_tasks = aggi + d[kNodeTasks];
  double* agg_remote = aggd + d[kNodeRemote];
  for (int32_t i = 0; i < H; i++) agg_hops[i] = hops[i];
  for (int32_t i = 0; i < NN; i++) {
    agg_tasks[i] = node_tasks[i];
    agg_remote[i] = node_remote[i];
  }
  if constexpr (kTraced) {
    tr.counts[0] = n_ex;
    tr.counts[1] = n_st;
    tr.counts[2] = n_mg;
  }
  return 0;
}

// One cell of a batch from its descriptor row.
template <bool kTraced, bool kTimed, bool kShared>
SIM_DEV void run_one(const int64_t* d, const double* dbuf, int32_t* ibuf,
                     const TaskRO* tab, uint8_t* ws, uint8_t* hot,
                     int64_t hot_cap, double* dout, int64_t* iout,
                     int64_t* aggi, double* aggd, int64_t* rc,
                     const TraceCols& tc, int64_t deadline_ns) {
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
  Prof prof;
  prof.start();
  rc[out] = sim_cell<kTraced, kTimed, kShared>(
      d, dbuf, ibuf, tab, ws, hot, hot_cap, dout + 6 * out, iout + 7 * out,
      aggi, aggd, tr, deadline_ns, prof);
  prof_store(prof, out);
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
  s.key = reinterpret_cast<int32_t*>(ws);
  s.cap = (uint32_t)set_cap(max_key);
  pyset_init(&s);
  int64_t npop = 0;
  for (int64_t i = 0; i < nops; i++) {
    if (ops[i] >= 0) {
      if (pyset_add(&s, (int32_t)ops[i])) return -1;
    } else if (s.used) {
      out[npop++] = pyset_pop(&s);
    }
  }
  return npop;
}

#ifdef __CUDACC__

// cells_per_warp cells share a warp: the block's threads are taken in
// runs of `spread` = 32 / cells_per_warp, the first of each run runs a
// cell, and with kShared the cell's shared slice is the run's index in
// the block (the compiler then sees the hot state in shared memory and
// addresses it so); without, its hot state is in its workspace.
template <bool kTraced, bool kTimed, bool kShared>
__global__ void __launch_bounds__(kThreads, min_blocks(kTraced, kShared))
    sim_batch_kernel(int64_t n_cells, const int64_t* __restrict__ desc,
                     const double* __restrict__ dbuf, int32_t* ibuf,
                     const TaskRO* __restrict__ tab, uint8_t* ws,
                     double* dout, int64_t* iout, int64_t* aggi,
                     double* aggd, int64_t* rc, int spread,
                     int64_t hot_bytes, TraceCols tc, int64_t deadline_ns) {
  extern __shared__ __align__(16) uint8_t sim_smem[];
  if (threadIdx.x % spread) return;
  const int local = threadIdx.x / spread;
  const int64_t k =
      (int64_t)blockIdx.x * (blockDim.x / spread) + local;
  if (k >= n_cells) return;
  uint8_t* hot = nullptr;
  if constexpr (kShared) hot = sim_smem + (int64_t)local * hot_bytes;
  run_one<kTraced, kTimed, kShared>(desc + k * kDescLen, dbuf, ibuf, tab, ws,
                                    hot, hot_bytes, dout, iout, aggi, aggd,
                                    rc, tc, deadline_ns);
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

// f(traced, timed, shared) with each flag as a std::bool_constant: the
// instantiation for the runtime flags.
template <typename F>
auto with_flags(bool traced, bool timed, bool shared, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (traced) {
    if (timed) return shared ? f(Y{}, Y{}, Y{}) : f(Y{}, Y{}, N{});
    return shared ? f(Y{}, N{}, Y{}) : f(Y{}, N{}, N{});
  }
  if (timed) return shared ? f(N{}, Y{}, Y{}) : f(N{}, Y{}, N{});
  return shared ? f(N{}, N{}, Y{}) : f(N{}, N{}, N{});
}

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

// Bytes of one cell's hot state for T threads, NN nodes and H hop bins
// (a multiple of 16).
extern "C" int64_t sim_hot_bytes(int64_t T, int64_t NN, int64_t H) {
  return (int64_t)hot_layout(T, NN, H).end;
}

// Bytes of one cell's device workspace for n tasks: its task records,
// after its hot state when `hot_in_ws`.
extern "C" int64_t sim_workspace_bytes(int64_t n, int64_t T, int64_t NN,
                                       int64_t H, int hot_in_ws) {
  return (int64_t)cell_ws_bytes(n, hot_in_ws ? hot_layout(T, NN, H).end : 0);
}

// Bytes of the set self-test's workspace for keys below max_key.
extern "C" int64_t sim_set_workspace_bytes(int64_t max_key) {
  return (int64_t)(8 * set_cap(max_key));
}

// Bytes of a task's read-only record and of its mutable one.
extern "C" int64_t sim_task_record_bytes(void) { return sizeof(TaskRO); }
extern "C" int64_t sim_task_state_bytes(void) { return sizeof(TaskState); }

#ifdef __CUDACC__

namespace {

// How a launch lays cells onto blocks.
struct Geometry {
  int threads, cells_per_block;
  size_t smem;
};

cudaError_t shared_limit(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

cudaError_t geometry(int cells_per_warp, int64_t hot_bytes, int hot_in_ws,
                     Geometry* g) {
  if (cells_per_warp < 1 || cells_per_warp > 32 || 32 % cells_per_warp)
    return cudaErrorInvalidValue;
  const int spread = 32 / cells_per_warp;
  int64_t cpb = (kThreads / 32) * cells_per_warp;
  if (!hot_in_ws) {
    int limit = 0;
    cudaError_t e = shared_limit(&limit);
    if (e != cudaSuccess) return e;
    if (hot_bytes <= 0 || hot_bytes > limit) return cudaErrorInvalidValue;
    if (cpb > limit / hot_bytes) cpb = limit / hot_bytes;
  }
  g->cells_per_block = (int)cpb;
  g->threads = (int)cpb * spread;
  g->smem = hot_in_ws ? 0 : (size_t)(cpb * hot_bytes);
  return cudaSuccess;
}

template <bool kTraced, bool kTimed, bool kShared>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(sim_batch_kernel<kTraced, kTimed, kShared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool kTraced, bool kTimed, bool kShared>
cudaError_t launch_batch(const Geometry& g, cudaStream_t s, int64_t n_cells,
                         const void* desc, const void* dbuf, void* ibuf,
                         const void* tab, void* ws, void* dout, void* iout,
                         void* aggi, void* aggd, void* rc, int spread,
                         int64_t hot_bytes, const TraceCols& tc,
                         int64_t deadline_ns) {
  cudaError_t e = prepare<kTraced, kTimed, kShared>(g.smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks =
      (unsigned)((n_cells + g.cells_per_block - 1) / g.cells_per_block);
  sim_batch_kernel<kTraced, kTimed, kShared><<<blocks, g.threads, g.smem, s>>>(
      n_cells, static_cast<const int64_t*>(desc),
      static_cast<const double*>(dbuf), static_cast<int32_t*>(ibuf),
      static_cast<const TaskRO*>(tab), static_cast<uint8_t*>(ws),
      static_cast<double*>(dout), static_cast<int64_t*>(iout),
      static_cast<int64_t*>(aggi), static_cast<double*>(aggd),
      static_cast<int64_t*>(rc), spread, hot_bytes, tc, deadline_ns);
  return cudaGetLastError();
}

template <bool kTraced, bool kTimed, bool kShared>
cudaError_t resident(const Geometry& g, int* blocks) {
  cudaError_t e = prepare<kTraced, kTimed, kShared>(g.smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sim_batch_kernel<kTraced, kTimed, kShared>, g.threads, g.smem);
}

}  // namespace

// The largest dynamic shared memory a block may ask for (bytes): a cell
// whose hot state is larger runs with it in its workspace.
extern "C" int sim_shared_limit(int64_t* bytes) {
  int limit = 0;
  cudaError_t e = shared_limit(&limit);
  *bytes = limit;
  return static_cast<int>(e);
}

// Cells the device keeps resident at once for a launch of the given
// instantiation and shape (the occupancy of its blocks, times their
// cells, times the SMs), into *cells.
extern "C" int sim_resident_cells(int traced, int timed, int cells_per_warp,
                                  int64_t hot_bytes, int hot_in_ws,
                                  int64_t* cells) {
  Geometry g;
  cudaError_t e = geometry(cells_per_warp, hot_bytes, hot_in_ws, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = with_flags(traced, timed, !hot_in_ws, [&](auto tr, auto ti, auto sh) {
    return resident<decltype(tr)::value, decltype(ti)::value,
                    decltype(sh)::value>(g, &blocks);
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *cells = (int64_t)blocks * g.cells_per_block * sms;
  return static_cast<int>(e);
}

// One wave of a batch: cells [0, n_cells) of `desc` (kDescLen int64
// each), every pointer on the device, `tab` the task records, `ws` the
// wave's workspace (`ws_bytes` of it, zeroed here). dout (6), iout (7)
// and rc (1) are indexed by each cell's kOut slot. cells_per_warp in
// {1, 2, 4, ..., 32}. Each cell's hot state takes a `hot_bytes` slice of
// its block's shared memory, or with `hot_in_ws` the front of its
// workspace. `traced` launches the traced instantiation, writing into the
// columns that `trace_args` (host memory, ten int64: see trace_cols)
// names; a `deadline_ns` >= 0 launches the timed one (< 0: no deadline).
// Returns a cudaError_t (0 = ok): a shape the device refuses is an error,
// never a launch that silently does not run.
extern "C" int sim_run_batch(int64_t n_cells, const void* desc,
                             const void* dbuf, void* ibuf, const void* tab,
                             void* ws, int64_t ws_bytes, void* dout,
                             void* iout, void* aggi, void* aggd, void* rc,
                             int cells_per_warp, int64_t hot_bytes,
                             int hot_in_ws, int traced, int64_t deadline_ns,
                             const int64_t* trace_args, void* stream) {
  if (n_cells <= 0 || (traced && !trace_args))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  cudaError_t e = geometry(cells_per_warp, hot_bytes, hot_in_ws, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(ws, 0, (size_t)ws_bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int spread = 32 / cells_per_warp;
  const TraceCols tc = trace_cols(traced ? trace_args : nullptr);
  e = with_flags(traced, deadline_ns >= 0, !hot_in_ws,
                 [&](auto tr, auto ti, auto sh) {
                   return launch_batch<decltype(tr)::value,
                                       decltype(ti)::value,
                                       decltype(sh)::value>(
                       g, s, n_cells, desc, dbuf, ibuf, tab, ws, dout, iout,
                       aggi, aggd, rc, spread, hot_bytes, tc, deadline_ns);
                 });
  return static_cast<int>(e);
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

#ifdef SIM_PROFILE
// The cycle counts of cells [0, n_cells) by part (kProfParts a cell, in
// `ProfPart` order) into host memory; `n_cells` at most kProfCells.
extern "C" int sim_profile_read(void* host, int64_t n_cells) {
  if (n_cells > kProfCells) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_sim_prof, (size_t)n_cells * kProfParts * sizeof(uint64_t)));
}
#endif

extern "C" const char* sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#else  // host build: the same loop on the CPU, for the tests

namespace {

template <bool kTraced, bool kTimed, bool kShared>
void host_batch(int64_t n_cells, const int64_t* desc, const double* dbuf,
                int32_t* ibuf, const TaskRO* tab, uint8_t* ws, uint8_t* slice,
                int64_t hot_bytes, double* dout, int64_t* iout, int64_t* aggi,
                double* aggd, int64_t* rc, const TraceCols& tc,
                int64_t deadline_ns) {
  for (int64_t k = 0; k < n_cells; k++) {
    // shared memory arrives holding whatever the last block left there
    if (kShared) memset(slice, 0xA5, (size_t)hot_bytes);
    run_one<kTraced, kTimed, kShared>(desc + k * kDescLen, dbuf, ibuf, tab,
                                      ws, slice, hot_bytes, dout, iout, aggi,
                                      aggd, rc, tc, deadline_ns);
  }
}

}  // namespace

// One wave of a batch on the CPU, as sim_run_batch runs it on the card:
// `ws` (`ws_bytes` of it) zeroed here, the cells one after another, each
// with its hot state in a `hot_bytes` host slice of the card's layout
// (filled with garbage first, as shared memory arrives) or, with
// `hot_in_ws`, at the front of its workspace; the instantiation chosen by
// `traced` and `deadline_ns` (< 0: no deadline), the trace columns in host
// memory.
extern "C" void sim_run_batch_host(int64_t n_cells, const int64_t* desc,
                                   const double* dbuf, int32_t* ibuf,
                                   const void* tab, uint8_t* ws,
                                   int64_t ws_bytes, double* dout,
                                   int64_t* iout, int64_t* aggi, double* aggd,
                                   int64_t* rc, int64_t hot_bytes,
                                   int hot_in_ws, int traced,
                                   int64_t deadline_ns,
                                   const int64_t* trace_args) {
  memset(ws, 0, (size_t)ws_bytes);
  uint8_t* slice = nullptr;
  if (!hot_in_ws)
    slice = static_cast<uint8_t*>(
        aligned_alloc(16, (size_t)align16((uint64_t)hot_bytes)));
  const TaskRO* t = static_cast<const TaskRO*>(tab);
  const TraceCols tc = trace_cols(traced ? trace_args : nullptr);
  with_flags(traced, deadline_ns >= 0, !hot_in_ws,
             [&](auto tr, auto ti, auto sh) {
               host_batch<decltype(tr)::value, decltype(ti)::value,
                          decltype(sh)::value>(n_cells, desc, dbuf, ibuf, t,
                                               ws, slice, hot_bytes, dout,
                                               iout, aggi, aggd, rc, tc,
                                               deadline_ns);
             });
  free(slice);
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

#ifdef SIM_PROFILE
extern "C" void sim_profile_read_host(uint64_t* host, int64_t n_cells) {
  memcpy(host, g_sim_prof,
         (size_t)(n_cells < kProfCells ? n_cells : kProfCells) * kProfParts *
             sizeof(uint64_t));
}
#endif

#endif  // __CUDACC__
