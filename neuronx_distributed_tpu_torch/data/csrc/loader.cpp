// nxd_data: memory-mapped token-dataset reader with background prefetch.
//
// The PyTorch port's own copy of the data pipeline's native library, built
// at first use by data/loader.py (g++ -O3 -shared -fPIC -std=c++17
// -pthread).  One flat token file is chunked into fixed (seq_len+1)-token
// samples, the chunk order is shuffled per epoch with a seed-deterministic
// Fisher-Yates (splitmix64, mirrored bit for bit by the Python fallback),
// chunks are round-robin partitioned across data-parallel ranks, and a
// small thread pool copies upcoming batches into a ring of host buffers so
// the train loop never blocks on page faults.  nxd_pack_assign is the
// window-bounded first-fit row assignment of data/packing.py.
//
// File format ("NXDT"): magic u32 'NXDT' LE, u32 version=1,
// u32 dtype (2=int32, 1=uint16), u64 num_tokens, then the tokens.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x5444584e;  // "NXDT" little-endian
constexpr uint32_t kVersion = 1;
constexpr uint32_t kDtypeU16 = 1;
constexpr uint32_t kDtypeI32 = 2;

struct Header {
  uint32_t magic;
  uint32_t version;
  uint32_t dtype;
  uint32_t reserved;
  uint64_t num_tokens;
};

// splitmix64: tiny, seedable, and trivially reproducible from Python.
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

struct NxdDataset {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t map_len = 0;
  uint32_t dtype = 0;
  uint64_t num_tokens = 0;
  const uint8_t* tokens = nullptr;
};

NxdDataset* nxd_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* h = reinterpret_cast<const Header*>(mem);
  if (h->magic != kMagic || h->version != kVersion ||
      (h->dtype != kDtypeU16 && h->dtype != kDtypeI32)) {
    munmap(mem, st.st_size);
    ::close(fd);
    return nullptr;
  }
  size_t tok_bytes = h->num_tokens * (h->dtype == kDtypeU16 ? 2 : 4);
  if (sizeof(Header) + tok_bytes > (size_t)st.st_size) {
    munmap(mem, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* ds = new NxdDataset();
  ds->fd = fd;
  ds->base = reinterpret_cast<const uint8_t*>(mem);
  ds->map_len = st.st_size;
  ds->dtype = h->dtype;
  ds->num_tokens = h->num_tokens;
  ds->tokens = ds->base + sizeof(Header);
  return ds;
}

void nxd_close(NxdDataset* ds) {
  if (!ds) return;
  if (ds->base) munmap(const_cast<uint8_t*>(ds->base), ds->map_len);
  if (ds->fd >= 0) ::close(ds->fd);
  delete ds;
}

uint64_t nxd_num_tokens(NxdDataset* ds) { return ds ? ds->num_tokens : 0; }

uint64_t nxd_num_chunks(NxdDataset* ds, uint32_t seq_len) {
  if (!ds || seq_len == 0) return 0;
  // each chunk needs seq_len+1 tokens (input + shifted label); chunks are
  // laid out back-to-back on a seq_len stride so every token is a label once
  if (ds->num_tokens < (uint64_t)seq_len + 1) return 0;
  return (ds->num_tokens - 1) / seq_len;
}

struct Slot {
  std::vector<int32_t> buf;
  int64_t batch_id = -1;  // which global batch fills this slot
  bool ready = false;
};

struct NxdLoader {
  NxdDataset* ds = nullptr;
  uint32_t batch = 0, seq_len = 0, dp_rank = 0, dp_size = 1;
  uint64_t seed = 0, epoch = 0;
  uint32_t num_threads = 1;
  std::vector<uint64_t> order;     // shuffled chunk ids for THIS rank
  uint64_t num_batches = 0;        // per epoch for this rank
  // prefetch machinery
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits on
  std::condition_variable cv_free;    // producers wait on
  std::atomic<int64_t> next_fill{0};  // next batch id to be claimed by a worker
  int64_t next_consume = 0;           // next batch id the consumer expects
  bool shutdown = false;

  size_t sample_tokens() const { return (size_t)seq_len + 1; }
  size_t batch_tokens() const { return (size_t)batch * sample_tokens(); }
};

namespace {

void build_order(NxdLoader* L) {
  uint64_t total = nxd_num_chunks(L->ds, L->seq_len);
  std::vector<uint64_t> all(total);
  for (uint64_t i = 0; i < total; ++i) all[i] = i;
  // Fisher-Yates with splitmix64 — mirrored in the Python fallback
  uint64_t state = L->seed + 0x51ed2700 * (L->epoch + 1);
  for (uint64_t i = total; i > 1; --i) {
    uint64_t j = splitmix64(state) % i;
    std::swap(all[i - 1], all[j]);
  }
  // round-robin DP partition, truncated to a globally uniform batch count:
  // every rank must yield the same number of batches or the longer ranks
  // block forever in the first collective after a short rank's loader is
  // exhausted (the reference's DistributedSampler pads/truncates likewise)
  L->order.clear();
  for (uint64_t i = L->dp_rank; i < total; i += L->dp_size)
    L->order.push_back(all[i]);
  uint64_t per_rank = total / L->dp_size;  // min share across ranks
  L->num_batches = per_rank / L->batch;
  L->order.resize(L->num_batches * L->batch);
}

void copy_chunk(NxdLoader* L, uint64_t chunk, int32_t* out) {
  const size_t n = L->sample_tokens();
  const uint64_t start = chunk * (uint64_t)L->seq_len;
  if (L->ds->dtype == kDtypeI32) {
    std::memcpy(out, L->ds->tokens + start * 4, n * 4);
  } else {
    auto* src = reinterpret_cast<const uint16_t*>(L->ds->tokens) + start;
    for (size_t i = 0; i < n; ++i) out[i] = src[i];
  }
}

void fill_batch(NxdLoader* L, int64_t batch_id, int32_t* out) {
  for (uint32_t s = 0; s < L->batch; ++s) {
    uint64_t chunk = L->order[(uint64_t)batch_id * L->batch + s];
    copy_chunk(L, chunk, out + (size_t)s * L->sample_tokens());
  }
}

void worker_loop(NxdLoader* L) {
  for (;;) {
    int64_t id = L->next_fill.fetch_add(1);
    if (id >= (int64_t)L->num_batches) return;
    Slot& slot = L->slots[id % L->slots.size()];
    {
      std::unique_lock<std::mutex> lk(L->mu);
      // wait until the consumer has drained the slot's previous occupant
      L->cv_free.wait(lk, [&] {
        return L->shutdown || (!slot.ready && L->next_consume > id - (int64_t)L->slots.size());
      });
      if (L->shutdown) return;
    }
    fill_batch(L, id, slot.buf.data());
    {
      std::lock_guard<std::mutex> lk(L->mu);
      slot.batch_id = id;
      slot.ready = true;
    }
    L->cv_ready.notify_all();
  }
}

void start_workers(NxdLoader* L, uint32_t num_threads) {
  for (uint32_t i = 0; i < num_threads; ++i)
    L->workers.emplace_back(worker_loop, L);
}

void stop_workers(NxdLoader* L) {
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->shutdown = true;
  }
  L->cv_free.notify_all();
  for (auto& t : L->workers) t.join();
  L->workers.clear();
  L->shutdown = false;
}

}  // namespace

NxdLoader* nxd_loader_create(NxdDataset* ds, uint32_t batch, uint32_t seq_len,
                             uint32_t dp_rank, uint32_t dp_size, uint64_t seed,
                             uint32_t prefetch_depth, uint32_t num_threads) {
  if (!ds || batch == 0 || seq_len == 0 || dp_size == 0 || dp_rank >= dp_size)
    return nullptr;
  auto* L = new NxdLoader();
  L->ds = ds;
  L->batch = batch;
  L->seq_len = seq_len;
  L->dp_rank = dp_rank;
  L->dp_size = dp_size;
  L->seed = seed;
  build_order(L);
  if (prefetch_depth == 0) prefetch_depth = 2;
  if (num_threads == 0) num_threads = 1;
  L->num_threads = num_threads;
  L->slots.resize(prefetch_depth);
  for (auto& s : L->slots) s.buf.resize(L->batch_tokens());
  start_workers(L, num_threads);
  return L;
}

void nxd_loader_destroy(NxdLoader* L) {
  if (!L) return;
  stop_workers(L);
  delete L;
}

uint64_t nxd_loader_num_batches(NxdLoader* L) { return L ? L->num_batches : 0; }

// Reshuffle for a new epoch and restart the prefetchers, optionally skipping
// the first `skip_batches` (checkpoint-resume semantics: the reference skips
// already-consumed batches, run_llama_nxd.py:233-244).
void nxd_loader_set_epoch(NxdLoader* L, uint64_t epoch, uint64_t skip_batches) {
  if (!L) return;
  stop_workers(L);
  L->epoch = epoch;
  build_order(L);
  for (auto& s : L->slots) {
    s.ready = false;
    s.batch_id = -1;
  }
  L->next_fill.store((int64_t)skip_batches);
  L->next_consume = (int64_t)skip_batches;
  start_workers(L, L->num_threads);
}

// Blocking: fills out[batch*(seq_len+1)] with the next batch; returns the
// batch index within the epoch, or -1 when the epoch is exhausted.
int64_t nxd_loader_next(NxdLoader* L, int32_t* out) {
  if (!L) return -1;
  if (L->next_consume >= (int64_t)L->num_batches) return -1;
  const int64_t want = L->next_consume;
  Slot& slot = L->slots[want % L->slots.size()];
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return slot.ready && slot.batch_id == want; });
    std::memcpy(out, slot.buf.data(), slot.buf.size() * sizeof(int32_t));
    slot.ready = false;
    slot.batch_id = -1;
    L->next_consume = want + 1;
  }
  L->cv_free.notify_all();
  return want;
}


// First-fit row assignment for sequence packing — the placement loop of
// data/packing.pack_documents, bit-identical to its Python form: each piece
// (length <= seq_len) goes into the first row with room among the last
// `window` opened rows, else opens a new row.  lengths[n] -> out_rows[n]
// (row index per piece); returns the number of rows, or -1 on a bad length.
// Pure integer bookkeeping, but Python-loop-bound at corpus scale (millions
// of documents): this native form removes the interpreter from the only
// O(pieces * window) part while the numpy row assembly stays in Python.
int64_t nxd_pack_assign(const int32_t* lengths, int64_t n, int32_t seq_len,
                        int32_t window, int32_t* out_rows) {
  if (!lengths || !out_rows || seq_len <= 0 || window < 0) return -1;
  std::vector<int32_t> space;
  space.reserve(4096);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t need = lengths[i];
    if (need < 0 || need > seq_len) return -1;
    bool placed = false;
    const int64_t sz = (int64_t)space.size();
    const int64_t lo = sz > window ? sz - window : 0;
    for (int64_t r = lo; r < sz; ++r) {
      if (space[r] >= need) {
        out_rows[i] = (int32_t)r;
        space[r] -= need;
        placed = true;
        break;
      }
    }
    if (!placed) {
      out_rows[i] = (int32_t)space.size();
      space.push_back(seq_len - need);
    }
  }
  return (int64_t)space.size();
}

}  // extern "C"
