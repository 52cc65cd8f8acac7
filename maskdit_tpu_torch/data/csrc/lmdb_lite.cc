// lmdb_lite.cc — native read path for the LMDB on-disk format.
//
// The port's copy of native/lmdb_lite.cc, the C++ twin of
// maskdit_tpu_torch/data/lmdb_lite.py (same format notes there; reference
// consumer: train_utils/datasets.py:240-304). This is the data loader's
// hot path: zero-copy mmap lookups, no GIL while walking the B-tree,
// thread-safe (read-only, stateless after open).
//
// C ABI (ctypes-friendly):
//   mdbl_open(path)            -> handle | NULL       (env dir or data.mdb)
//   mdbl_close(h)
//   mdbl_entries(h)            -> entry count
//   mdbl_get(h, key, klen, &val, &vlen) -> 0 found / 1 missing / -1 error
//       val points INTO the mmap — valid until mdbl_close; copy on the
//       Python side.
//
// Build: maskdit_tpu_torch/data/native_io.py compiles it at first use
// (g++ -O2 -std=c++17 -shared -fPIC) into build/native/.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kDataVersion = 1;
constexpr uint16_t kPBranch = 0x01;
constexpr uint16_t kPLeaf = 0x02;
constexpr uint16_t kPMeta = 0x08;
constexpr uint16_t kFBigdata = 0x01;
constexpr size_t kPageHdr = 16;
constexpr uint64_t kPInvalid = ~0ULL;

inline uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

struct Env {
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  uint32_t psize = 4096;
  uint16_t depth = 0;
  uint64_t entries = 0;
  uint64_t root = kPInvalid;
};

// memcmp key order (LMDB default comparator)
inline int key_cmp(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
  int c = std::memcmp(a, b, alen < blen ? alen : blen);
  if (c) return c;
  return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

struct Node {
  const uint8_t* ptr;
  uint16_t lo() const { return rd16(ptr); }
  uint16_t hi() const { return rd16(ptr + 2); }
  uint16_t flags() const { return rd16(ptr + 4); }
  uint16_t ksize() const { return rd16(ptr + 6); }
  const uint8_t* key() const { return ptr + 8; }
  uint64_t branch_pgno() const {
    return uint64_t(lo()) | (uint64_t(hi()) << 16) | (uint64_t(flags()) << 32);
  }
  uint32_t data_size() const { return uint32_t(lo()) | (uint32_t(hi()) << 16); }
  const uint8_t* data() const { return ptr + 8 + ksize(); }
};

struct Page {
  const uint8_t* base;
  uint16_t flags() const { return rd16(base + 10); }
  uint16_t lower() const { return rd16(base + 12); }
  int nkeys() const { return int(lower() - kPageHdr) / 2; }
  Node node(int i) const {
    return Node{base + rd16(base + kPageHdr + 2 * size_t(i))};
  }
};

bool read_meta(const Env& env, uint64_t pgno, uint64_t* txnid, Env* out) {
  const uint8_t* p = env.map + pgno * 4096;  // metas live in the first 2 x 4K
  if (!(rd16(p + 10) & kPMeta)) return false;
  const uint8_t* m = p + kPageHdr;
  if (rd32(m) != kMagic || rd32(m + 4) != kDataVersion) return false;
  const uint8_t* dbs = m + 24;       // after magic,version,address,mapsize
  out->psize = rd32(dbs);            // dbs[0].md_pad
  const uint8_t* main_db = dbs + 48;
  out->depth = rd16(main_db + 6);
  out->entries = rd64(main_db + 32);
  out->root = rd64(main_db + 40);
  *txnid = rd64(dbs + 96 + 8);       // after dbs[2], last_pg
  return true;
}

}  // namespace

extern "C" {

void* mdbl_open(const char* path) {
  std::string p(path);
  struct stat st;
  if (stat(p.c_str(), &st) != 0) return nullptr;
  if (S_ISDIR(st.st_mode)) p += "/data.mdb";
  int fd = open(p.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  if (fstat(fd, &st) != 0 || st.st_size < 8192) { close(fd); return nullptr; }
  void* map = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;

  Env probe;
  probe.map = static_cast<const uint8_t*>(map);
  probe.map_size = size_t(st.st_size);

  Env best = probe;
  uint64_t best_txn = 0;
  bool found = false;
  for (uint64_t pg = 0; pg < 2; ++pg) {
    Env cand = probe;
    uint64_t txn = 0;
    if (read_meta(probe, pg, &txn, &cand) && (!found || txn >= best_txn)) {
      best = cand;
      best_txn = txn;
      found = true;
    }
  }
  if (!found) { munmap(map, probe.map_size); return nullptr; }
  Env* env = new Env(best);
  env->map = probe.map;
  env->map_size = probe.map_size;
  return env;
}

void mdbl_close(void* h) {
  Env* env = static_cast<Env*>(h);
  if (!env) return;
  munmap(const_cast<uint8_t*>(env->map), env->map_size);
  delete env;
}

int64_t mdbl_entries(void* h) {
  return int64_t(static_cast<Env*>(h)->entries);
}

int mdbl_get(void* h, const uint8_t* key, size_t klen,
             const uint8_t** val, size_t* vlen) {
  const Env* env = static_cast<Env*>(h);
  if (!env || env->root == kPInvalid) return 1;
  uint64_t pgno = env->root;
  for (int level = 0; level < env->depth; ++level) {
    if ((pgno + 1) * env->psize > env->map_size) return -1;
    Page page{env->map + pgno * env->psize};
    int n = page.nkeys();
    if (page.flags() & kPLeaf) {
      int lo = 0, hi = n - 1;
      while (lo <= hi) {
        int mid = (lo + hi) / 2;
        Node node = page.node(mid);
        int c = key_cmp(node.key(), node.ksize(), key, klen);
        if (c == 0) {
          if (node.flags() & kFBigdata) {
            uint64_t ovf = rd64(node.data());
            *val = env->map + ovf * env->psize + kPageHdr;
          } else {
            *val = node.data();
          }
          *vlen = node.data_size();
          return 0;
        }
        if (c < 0) lo = mid + 1; else hi = mid - 1;
      }
      return 1;
    }
    if (!(page.flags() & kPBranch)) return -1;
    // rightmost child whose key <= target (node 0 == -inf)
    int lo = 1, hi = n - 1, pick = 0;
    while (lo <= hi) {
      int mid = (lo + hi) / 2;
      Node node = page.node(mid);
      if (key_cmp(node.key(), node.ksize(), key, klen) <= 0) {
        pick = mid;
        lo = mid + 1;
      } else {
        hi = mid - 1;
      }
    }
    pgno = page.node(pick).branch_pgno();
  }
  return 1;
}

}  // extern "C"
