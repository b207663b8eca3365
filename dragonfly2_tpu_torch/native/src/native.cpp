// dragonfly2_tpu native runtime: columnar record engine + piece store.
//
// The reference's data plane is compiled Go (client/daemon/storage/
// storage_manager.go, local_storage.go: per-task metadata+data files,
// piece-granular writes, crash reload; scheduler/storage/storage.go:
// buffered record files).  This is the C++ equivalent for the rebuild:
//
//  * record engine — appends fixed-width float32 rows to DFC1 columnar
//    files (the format spec lives in records/columnar.py); append is a
//    single buffered write, no serialization.
//  * piece store  — per-task {meta,data} file pairs. Piece writes land at
//    piece_number*piece_size offsets; each commit appends a fixed-size
//    metadata record (number, offset, length, crc32, flags) fsync-ordered
//    after the data write, so a crash can lose at most the in-flight
//    piece; reload scans metadata and re-validates lengths.
//
// Exposed as a C ABI for the ctypes bindings in ../__init__.py.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <deque>
#include <dirent.h>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string>
#include <sys/sendfile.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <thread>
#include <type_traits>
#include <unistd.h>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Shared ABI constants (DESIGN.md §30).  Every `kName` below is declared
// once more in records/abi_contracts.py; dflint DF020 cross-checks the two
// texts and the df_abi_manifest() witness re-emits the COMPILED values —
// change either side alone and tier-1 fails by constant name.
// ---------------------------------------------------------------------------

constexpr char kMagic[] = "DFC1";      // columnar record file magic
constexpr char kTaskMagic[] = "DFPS";  // piece-store task header magic

// Batched submission / pipelining caps.  The server coalesces up to
// kBatchMax pipelined piece GETs into one gather-write burst, byte-capped
// at kBatchBytesMax (the batch's whole scratch RSS cost: a foreign client
// pipelining 16 x 4 MiB GETs must not make every connection thread stage
// 64 MiB or throw bad_alloc).  The client's fetch workers pipeline up to
// kFetchBurstMax GETs under the SAME byte cap — a burst serializes its
// responses on one connection, so big pieces spread across workers
// instead.  kMaxFetchBody bounds any single body allocation when the
// caller doesn't know the piece length (16x the common 4 MiB piece): a
// hostile parent advertising `Content-Length: 9e15` must be a protocol
// error, not a bad_alloc.
constexpr size_t kBatchMax = 16;
constexpr int64_t kBatchBytesMax = 512 * 1024;
constexpr size_t kFetchBurstMax = 8;
constexpr int64_t kMaxFetchBody = 64LL * 1024 * 1024;

// Worker / slot / serving caps shared with the bindings' docstrings and
// the Python server's wire behavior (long-poll bound).
constexpr int kFetchWorkersDefault = 4;
constexpr int kFetchWorkersMax = 64;
constexpr int kParentSlotMax = 255;
constexpr int kServeLimitDefault = 64;
constexpr int64_t kLongPollMaxMs = 30000;

// FetchDone.status codes: 0 ok, >0 raw HTTP status, negatives local.
constexpr int32_t kFetchStatusOk = 0;
constexpr int32_t kFetchStatusConn = -1;    // dial/socket error; queued jobs discarded on close
constexpr int32_t kFetchStatusProto = -2;   // protocol / length mismatch / oversized body
constexpr int32_t kFetchStatusCommit = -3;  // local ps_write_piece failure

// Catch-all containment sentinel (DF021): an extern "C" accessor that
// swallows an exception returns this instead of letting it escape the C
// ABI — an escaping exception would std::terminate the embedding daemon.
constexpr int32_t kAbiTrap = -125;

// PieceMeta.flags bits.
constexpr uint32_t kPieceFlagCommitted = 1;
constexpr uint32_t kPieceFlagVerified = 2;  // CRC checked on first serve

// ---------------------------------------------------------------------------
// crc32 (IEEE).  Slice-by-8: processes 8 bytes per step through 8 derived
// tables — ~8x the single-table byte loop (which measured ~400 MB/s and
// made native piece reads 10x slower than Python's SIMD zlib.crc32).
// Same polynomial/init/final-xor as zlib, so stored CRCs stay valid.
// ---------------------------------------------------------------------------

uint32_t crc32_tab8[8][256];
std::once_flag crc_once;

void crc32_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_tab8[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc32_tab8[t][i] =
          crc32_tab8[0][crc32_tab8[t - 1][i] & 0xFF] ^ (crc32_tab8[t - 1][i] >> 8);
}

uint32_t crc32(const uint8_t* data, size_t len) {
  std::call_once(crc_once, crc32_init);
  uint32_t c = 0xFFFFFFFFu;
  while (len >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, data, 4);
    memcpy(&hi, data + 4, 4);
    lo ^= c;
    c = crc32_tab8[7][lo & 0xFF] ^ crc32_tab8[6][(lo >> 8) & 0xFF] ^
        crc32_tab8[5][(lo >> 16) & 0xFF] ^ crc32_tab8[4][lo >> 24] ^
        crc32_tab8[3][hi & 0xFF] ^ crc32_tab8[2][(hi >> 8) & 0xFF] ^
        crc32_tab8[1][(hi >> 16) & 0xFF] ^ crc32_tab8[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  for (size_t i = 0; i < len; i++)
    c = crc32_tab8[0][(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Columnar record engine (DFC1; spec: records/columnar.py)
// ---------------------------------------------------------------------------

struct RecordFile {
  FILE* f = nullptr;
  uint32_t width = 0;       // columns
  int64_t data_offset = 0;
  std::mutex mu;
  bool closed = false;  // re_close sets it; in-flight appends must bail
};

using RecordPtr = std::shared_ptr<RecordFile>;

std::mutex g_records_mu;
std::map<int64_t, RecordPtr> g_records;
std::atomic<int64_t> g_next_handle{1};

// ---------------------------------------------------------------------------
// Piece store
// ---------------------------------------------------------------------------

#pragma pack(push, 1)
struct PieceMeta {
  uint32_t number;
  uint32_t length;
  int64_t offset;
  uint32_t crc;
  uint32_t flags;  // kPieceFlagCommitted | kPieceFlagVerified
};

struct TaskHeader {
  char magic[4];          // "DFPS"
  uint32_t piece_size;
  int64_t content_length;
};
#pragma pack(pop)

struct TaskStore {
  std::string dir;
  FILE* data = nullptr;
  FILE* meta = nullptr;
  TaskHeader header{};
  std::map<uint32_t, PieceMeta> pieces;
  std::mutex mu;
  bool closed = false;  // set by delete/close; late readers must bail
};

using TaskPtr = std::shared_ptr<TaskStore>;

struct PieceStore {
  std::string root;
  std::map<std::string, TaskPtr> tasks;
  std::mutex mu;
};

std::mutex g_stores_mu;
std::map<int64_t, PieceStore*> g_stores;

std::string task_dir(const PieceStore* ps, const char* task_id) {
  return ps->root + "/" + task_id;
}

bool load_task(TaskStore* ts) {
  // Re-read committed piece metadata; tolerate a torn trailing record.
  fseeko(ts->meta, 0, SEEK_END);
  off_t size = ftello(ts->meta);
  if (size < (off_t)sizeof(TaskHeader)) return false;
  fseeko(ts->meta, 0, SEEK_SET);
  if (fread(&ts->header, sizeof(TaskHeader), 1, ts->meta) != 1) return false;
  if (memcmp(ts->header.magic, kTaskMagic, 4) != 0) return false;
  size_t n = (size - sizeof(TaskHeader)) / sizeof(PieceMeta);
  for (size_t i = 0; i < n; i++) {
    PieceMeta pm;
    if (fread(&pm, sizeof(PieceMeta), 1, ts->meta) != 1) break;
    if (pm.flags & kPieceFlagCommitted) ts->pieces[pm.number] = pm;
  }
  fseeko(ts->meta, 0, SEEK_END);
  return true;
}

TaskPtr open_task(PieceStore* ps, const char* task_id, uint32_t piece_size,
                  int64_t content_length, bool create) {
  std::lock_guard<std::mutex> lk(ps->mu);
  auto it = ps->tasks.find(task_id);
  if (it != ps->tasks.end()) return it->second;

  std::string dir = task_dir(ps, task_id);
  std::string meta_path = dir + "/meta";
  std::string data_path = dir + "/data";
  struct stat st;
  bool exists = stat(meta_path.c_str(), &st) == 0;
  if (!exists && !create) return nullptr;
  if (!exists) {
    if (mkdir(dir.c_str(), 0755) != 0 && errno != EEXIST) return nullptr;
  }

  TaskPtr ts = std::make_shared<TaskStore>();
  ts->dir = dir;
  ts->meta = fopen(meta_path.c_str(), exists ? "r+b" : "w+b");
  ts->data = fopen(data_path.c_str(), exists ? "r+b" : "w+b");
  if (!ts->meta || !ts->data) {
    if (ts->meta) fclose(ts->meta);
    if (ts->data) fclose(ts->data);
    return nullptr;
  }
  if (exists) {
    if (!load_task(ts.get())) {
      fclose(ts->meta);
      fclose(ts->data);
      return nullptr;
    }
  } else {
    memcpy(ts->header.magic, kTaskMagic, 4);
    ts->header.piece_size = piece_size;
    ts->header.content_length = content_length;
    fwrite(&ts->header, sizeof(TaskHeader), 1, ts->meta);
    fflush(ts->meta);
  }
  ps->tasks[task_id] = ts;
  return ts;
}

int remove_tree(const std::string& dir) {
  DIR* d = opendir(dir.c_str());
  if (!d) return -1;
  struct dirent* e;
  while ((e = readdir(d)) != nullptr) {
    if (strcmp(e->d_name, ".") == 0 || strcmp(e->d_name, "..") == 0) continue;
    std::string path = dir + "/" + e->d_name;
    unlink(path.c_str());
  }
  closedir(d);
  return rmdir(dir.c_str());
}

}  // namespace

extern "C" {

// -- record engine ----------------------------------------------------------

int64_t re_open(const char* path, const char* header_json, uint32_t width) try {
  struct stat st;
  bool exists = stat(path, &st) == 0 && st.st_size > 0;
  FILE* f = fopen(path, exists ? "r+b" : "w+b");
  if (!f) return -1;
  RecordPtr rf = std::make_shared<RecordFile>();
  rf->f = f;
  rf->width = width;
  if (exists) {
    char magic[4];
    uint32_t hlen = 0;
    if (fread(magic, 4, 1, f) != 1 || memcmp(magic, kMagic, 4) != 0 ||
        fread(&hlen, 4, 1, f) != 1) {
      fclose(f);
      return -2;
    }
    rf->data_offset = 8 + hlen;
    // Width consistency against the existing payload: the data section
    // must be a whole number of rows at the claimed width, else appends
    // would land misaligned (the bindings also validate the header JSON).
    fseeko(f, 0, SEEK_END);
    off_t payload = ftello(f) - rf->data_offset;
    if (payload % (off_t)(sizeof(float) * width) != 0) {
      fclose(f);
      return -3;
    }
  } else {
    uint32_t hlen = (uint32_t)strlen(header_json);
    fwrite(kMagic, 4, 1, f);
    fwrite(&hlen, 4, 1, f);
    fwrite(header_json, 1, hlen, f);
    rf->data_offset = 8 + hlen;
    fflush(f);
  }
  std::lock_guard<std::mutex> lk(g_records_mu);
  int64_t h = g_next_handle++;
  g_records[h] = rf;
  return h;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t re_append(int64_t handle, const float* rows, int64_t n_rows) try {
  RecordPtr rf;
  {
    std::lock_guard<std::mutex> lk(g_records_mu);
    auto it = g_records.find(handle);
    if (it == g_records.end()) return -1;
    rf = it->second;  // shared_ptr outlives a concurrent re_close
  }
  std::lock_guard<std::mutex> lk(rf->mu);
  if (rf->closed) return -2;
  size_t wrote = fwrite(rows, sizeof(float) * rf->width, n_rows, rf->f);
  return (int64_t)wrote;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int re_flush(int64_t handle) try {
  RecordPtr rf;
  {
    std::lock_guard<std::mutex> lk(g_records_mu);
    auto it = g_records.find(handle);
    if (it == g_records.end()) return -1;
    rf = it->second;
  }
  std::lock_guard<std::mutex> lk2(rf->mu);
  if (rf->closed) return -2;
  fflush(rf->f);
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t re_rows(int64_t handle) try {
  RecordPtr rf;
  {
    std::lock_guard<std::mutex> lk(g_records_mu);
    auto it = g_records.find(handle);
    if (it == g_records.end()) return -1;
    rf = it->second;
  }
  std::lock_guard<std::mutex> lk2(rf->mu);
  if (rf->closed) return -2;
  fflush(rf->f);
  off_t end = ftello(rf->f);
  return (end - rf->data_offset) / (sizeof(float) * rf->width);
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int re_close(int64_t handle) try {
  RecordPtr rf;
  {
    std::lock_guard<std::mutex> lk(g_records_mu);
    auto it = g_records.find(handle);
    if (it == g_records.end()) return -1;
    rf = it->second;
    g_records.erase(it);
  }
  std::lock_guard<std::mutex> lk(rf->mu);
  if (!rf->closed) {
    fclose(rf->f);
    rf->closed = true;
  }
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// -- piece store ------------------------------------------------------------

int64_t ps_open(const char* root) try {
  if (mkdir(root, 0755) != 0 && errno != EEXIST) return -1;
  PieceStore* ps = new PieceStore();
  ps->root = root;
  std::lock_guard<std::mutex> lk(g_stores_mu);
  int64_t h = g_next_handle++;
  g_stores[h] = ps;
  return h;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

static PieceStore* get_store(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_stores_mu);
  auto it = g_stores.find(handle);
  return it == g_stores.end() ? nullptr : it->second;
}

int ps_create_task(int64_t handle, const char* task_id, uint32_t piece_size,
                   int64_t content_length) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, piece_size, content_length, true);
  return ts ? 0 : -2;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int ps_load_task(int64_t handle, const char* task_id) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, 0, 0, false);
  return ts ? 0 : -2;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t ps_write_piece(int64_t handle, const char* task_id, uint32_t number,
                       const uint8_t* data, uint32_t length) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, 0, 0, false);
  if (!ts) return -2;
  std::lock_guard<std::mutex> lk(ts->mu);
  if (ts->closed) return -7;
  int64_t offset = (int64_t)number * ts->header.piece_size;
  fseeko(ts->data, offset, SEEK_SET);
  if (fwrite(data, 1, length, ts->data) != length) return -3;
  fflush(ts->data);
  // Data durable before metadata commit: a crash between the two leaves an
  // uncommitted piece that reload simply redownloads.
  fsync(fileno(ts->data));
  PieceMeta pm{number, length, offset, crc32(data, length),
               kPieceFlagCommitted};
  fseeko(ts->meta, 0, SEEK_END);
  if (fwrite(&pm, sizeof(PieceMeta), 1, ts->meta) != 1) return -4;
  fflush(ts->meta);
  fsync(fileno(ts->meta));
  ts->pieces[number] = pm;
  return (int64_t)length;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t ps_read_piece(int64_t handle, const char* task_id, uint32_t number,
                      uint8_t* buf, uint32_t buf_len, int verify) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, 0, 0, false);
  if (!ts) return -2;
  std::lock_guard<std::mutex> lk(ts->mu);
  if (ts->closed) return -7;
  auto it = ts->pieces.find(number);
  if (it == ts->pieces.end()) return -3;
  const PieceMeta& pm = it->second;
  if (pm.length > buf_len) return -4;
  fseeko(ts->data, pm.offset, SEEK_SET);
  if (fread(buf, 1, pm.length, ts->data) != pm.length) return -5;
  if (verify && crc32(buf, pm.length) != pm.crc) return -6;
  return (int64_t)pm.length;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t ps_piece_count(int64_t handle, const char* task_id) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, 0, 0, false);
  if (!ts) return -2;
  std::lock_guard<std::mutex> lk(ts->mu);
  return (int64_t)ts->pieces.size();
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Fill `bitmap` (caller-allocated, n_pieces bytes) with 1 per present piece.
int ps_piece_bitmap(int64_t handle, const char* task_id, uint8_t* bitmap,
                    uint32_t n_pieces) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, 0, 0, false);
  if (!ts) return -2;
  std::lock_guard<std::mutex> lk(ts->mu);
  memset(bitmap, 0, n_pieces);
  for (auto& kv : ts->pieces)
    if (kv.first < n_pieces) bitmap[kv.first] = 1;
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t ps_task_bytes(int64_t handle, const char* task_id) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, 0, 0, false);
  if (!ts) return -2;
  std::lock_guard<std::mutex> lk(ts->mu);
  int64_t total = 0;
  for (auto& kv : ts->pieces) total += kv.second.length;
  return total;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t ps_content_length(int64_t handle, const char* task_id) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, 0, 0, false);
  if (!ts) return -2;
  return ts->header.content_length;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t ps_piece_size(int64_t handle, const char* task_id) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts = open_task(ps, task_id, 0, 0, false);
  if (!ts) return -2;
  return (int64_t)ts->header.piece_size;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int ps_delete_task(int64_t handle, const char* task_id) try {
  PieceStore* ps = get_store(handle);
  if (!ps) return -1;
  TaskPtr ts;
  {
    std::lock_guard<std::mutex> lk(ps->mu);
    auto it = ps->tasks.find(task_id);
    if (it != ps->tasks.end()) {
      ts = it->second;  // shared_ptr keeps the struct alive for in-flight readers
      ps->tasks.erase(it);
    }
  }
  if (ts) {
    std::lock_guard<std::mutex> tlk(ts->mu);
    fclose(ts->meta);
    fclose(ts->data);
    ts->closed = true;
  }
  return remove_tree(task_dir(ps, task_id));
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

}  // extern "C"

// ---------------------------------------------------------------------------
// HTTP piece server (the perf-critical serving hot path).
//
// Reference: client/daemon/upload/upload_manager.go:59-76 — compiled-Go
// HTTP serving of piece ranges.  The Python stand-in topped out at
// 0.45 GB/s aggregate (per-request setup + GIL); this serves the SAME
// wire contract (piece_transport.py):
//
//   GET /pieces/<task>/<n>      → 200 piece bytes (503 over the cap)
//   GET /tasks/<task>/pieces    → 200 piece bitmap (1 byte per piece)
//   GET /tasks/<task>  + Range  → 206 assembled byte range
//
// Thread-per-connection with keep-alive; piece/range bodies go through
// sendfile(2), so payload bytes never cross user space.  Piece integrity:
// CRC is verified ON FIRST SERVE of each piece (flags bit 2 caches the
// result) — per-request re-hashing is what kept the Python path slow,
// and the client still digest-verifies every piece on its side.
// ---------------------------------------------------------------------------

extern "C" int ps_serve_stop(int64_t handle);

namespace {

struct HttpServer {
  int lfd = -1;
  std::atomic<bool> stopping{false};
  std::atomic<int> active{0};       // DATA requests being served (503 cap)
  std::atomic<int> meta_active{0};  // parked bitmap long-polls (degrade cap)
  std::atomic<int> conn_count{0};   // live connection threads
  std::atomic<int64_t> pieces_served{0};
  std::atomic<int64_t> bytes_served{0};
  std::atomic<int64_t> batched_pieces{0};  // pieces served via burst path
  int limit = kServeLimitDefault;
  int64_t store_handle = 0;
  std::thread accept_th;
  uint16_t port = 0;
  std::mutex conns_mu;
  std::map<int, int> conns;         // live connection fds (for stop wakeup)
};

std::mutex g_servers_mu;
std::map<int64_t, HttpServer*> g_servers;  // keyed by store handle

// Wedged-shutdown accounting (ps_serve_stop past the 5 s grace): the
// struct is intentionally leaked rather than freed under live threads,
// but the *fact* must be observable — bench/test teardowns assert these
// stay zero instead of grepping stderr.
std::atomic<int64_t> g_leaked_servers{0};
std::atomic<int64_t> g_leaked_conns{0};

// Append more bytes until `acc` holds at least one full request head.
// Residual bytes from a previous read stay in `acc` — pipelined or
// coalesced requests must not be discarded.
bool read_request(int fd, std::string& acc) {
  char buf[4096];
  while (acc.size() < 65536) {
    if (acc.find("\r\n\r\n") != std::string::npos) return true;
    ssize_t n = recv(fd, buf, sizeof(buf), 0);
    if (n <= 0) return false;
    acc.append(buf, (size_t)n);
  }
  return false;
}

bool send_all(int fd, const char* data, size_t len) {
  while (len > 0) {
    ssize_t n = send(fd, data, len, MSG_NOSIGNAL);
    if (n <= 0) return false;
    data += n;
    len -= (size_t)n;
  }
  return true;
}

bool send_head(int fd, int code, const char* reason, int64_t content_length) {
  char head[256];
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 %d %s\r\n"
                   "Content-Type: application/octet-stream\r\n"
                   "Content-Length: %lld\r\n\r\n",
                   code, reason, (long long)content_length);
  return send_all(fd, head, (size_t)n);
}

bool send_error_http(int fd, int code, const char* reason) {
  return send_head(fd, code, reason, 0);
}

bool sendfile_all(int out_fd, int in_fd, int64_t offset, int64_t count) {
  off_t off = (off_t)offset;
  while (count > 0) {
    ssize_t n = sendfile(out_fd, in_fd, &off, (size_t)count);
    if (n <= 0) return false;
    count -= n;
  }
  return true;
}

// Strict digit parse (atoll accepts garbage as 0 — "bytes=zz-5" must 416,
// matching the Python server's ValueError path).
bool parse_i64(const std::string& s, int64_t* out) {
  if (s.empty()) return false;
  int64_t v = 0;
  for (char c : s) {
    if (c < '0' || c > '9') return false;
    int d = c - '0';
    if (v > (INT64_MAX - d) / 10) return false;  // overflow → reject, not wrap
    v = v * 10 + d;
  }
  *out = v;
  return true;
}

// Verify a piece's CRC once; afterwards flags bit 2 short-circuits.
bool piece_verified(TaskStore* ts, PieceMeta& pm) {
  if (pm.flags & kPieceFlagVerified) return true;
  std::vector<uint8_t> buf(pm.length);
  {
    std::lock_guard<std::mutex> lk(ts->mu);
    if (ts->closed) return false;
    fseeko(ts->data, pm.offset, SEEK_SET);
    if (fread(buf.data(), 1, pm.length, ts->data) != pm.length) return false;
  }
  if (crc32(buf.data(), pm.length) != pm.crc) return false;
  std::lock_guard<std::mutex> lk(ts->mu);
  auto it = ts->pieces.find(pm.number);
  if (it != ts->pieces.end()) it->second.flags |= kPieceFlagVerified;
  pm.flags |= kPieceFlagVerified;
  return true;
}

// "key=value" lookup in a raw query string; leaves *out untouched when
// the key is absent or non-numeric.
void parse_query_i64(const std::string& query, const char* key, int64_t* out) {
  std::string needle = std::string(key) + "=";
  size_t pos = 0;
  while (pos < query.size()) {
    size_t amp = query.find('&', pos);
    std::string pair = query.substr(pos, amp == std::string::npos
                                             ? std::string::npos
                                             : amp - pos);
    if (pair.rfind(needle, 0) == 0) {
      int64_t v = 0;
      if (parse_i64(pair.substr(needle.size()), &v)) *out = v;
      return;
    }
    if (amp == std::string::npos) break;
    pos = amp + 1;
  }
}

// Network-supplied task components must stay inside the store root:
// reject empty, '.', '..', and path separators before open_task — a bare
// "GET /pieces/../N" would otherwise open <root>/../meta and cache the
// foreign entry in ps->tasks.
bool valid_task_id(const std::string& id) {
  if (id.empty() || id == "." || id == "..") return false;
  return id.find('/') == std::string::npos &&
         id.find('\\') == std::string::npos;
}

// Serve-safe data fd: dup() under the task lock so ps_delete_task's
// fclose cannot invalidate the descriptor mid-sendfile.  -1 when the
// task is closed.  Caller close()s it.
int dup_data_fd(TaskStore* ts) {
  std::lock_guard<std::mutex> lk(ts->mu);
  if (ts->closed) return -1;
  return dup(fileno(ts->data));
}

// Gather-write a full iovec array.  sendmsg (not writev) so MSG_NOSIGNAL
// holds — a peer that hangs up mid-burst must surface as an error, not a
// process-killing SIGPIPE (native_test runs without Python's handler).
bool sendv_all(int fd, iovec* iov, size_t n) {
  size_t i = 0;
  while (i < n) {
    msghdr msg{};
    msg.msg_iov = iov + i;
    msg.msg_iovlen = std::min(n - i, (size_t)64);
    ssize_t w = sendmsg(fd, &msg, MSG_NOSIGNAL);
    if (w <= 0) return false;
    while (i < n && (size_t)w >= iov[i].iov_len) {
      w -= (ssize_t)iov[i].iov_len;
      i++;
    }
    if (i < n && w > 0) {
      iov[i].iov_base = (char*)iov[i].iov_base + w;
      iov[i].iov_len -= (size_t)w;
    }
  }
  return true;
}

// Batched submission (DESIGN.md §28): a pipelined run of piece GETs
// already buffered in `acc` is served as ONE gather-write burst —
// headers and bodies interleaved in a single sendmsg — instead of a
// head+sendfile syscall pair per piece.  Only the happy path batches:
// any request that is not a plain keep-alive piece GET, or any piece
// that is missing/unverified, sends the whole run back to the
// per-request path so error semantics (404/500/503 ordering) stay
// byte-identical with the Python server.  Returns the number of
// requests consumed, 0 when the normal path should take over, -1 on a
// send failure (caller drops the connection).
int try_piece_batch(HttpServer* srv, int fd, std::string& acc) {
  // kBatchMax/kBatchBytesMax caps: see the shared-constants block.
  // Pieces past the byte cap stay in `acc` for the next iteration —
  // they re-batch or ride the per-request sendfile path.
  struct PieceReq {
    std::string task;
    uint32_t number;
    size_t head_len;
  };
  std::vector<PieceReq> reqs;
  size_t pos = 0;
  while (reqs.size() < kBatchMax) {
    size_t head_end = acc.find("\r\n\r\n", pos);
    if (head_end == std::string::npos) break;
    size_t head_len = head_end + 4 - pos;
    size_t line_end = acc.find("\r\n", pos);
    std::string line = acc.substr(pos, line_end - pos);
    std::string lower = acc.substr(pos, head_len);
    for (auto& c : lower) c = (char)tolower(c);
    if (lower.find("connection: close") != std::string::npos) break;
    if (line.rfind("GET /pieces/", 0) != 0) break;
    size_t sp = line.find(' ', 4);
    if (sp == std::string::npos) break;
    std::string path = line.substr(4, sp - 4);
    if (path.find('?') != std::string::npos) break;
    std::string rest = path.substr(8);
    size_t slash = rest.find('/');
    int64_t number = -1;
    if (slash == std::string::npos ||
        !parse_i64(rest.substr(slash + 1), &number) ||
        !valid_task_id(rest.substr(0, slash)))
      break;
    reqs.push_back({rest.substr(0, slash), (uint32_t)number, head_len});
    pos += head_len;
  }
  if (reqs.size() < 2) return 0;
  PieceStore* ps = get_store(srv->store_handle);
  if (!ps) return 0;
  // A burst occupies ONE data-plane slot (it is one continuous write on
  // one connection); over the cap the per-request path owns the 503s.
  if (srv->active.fetch_add(1) >= srv->limit) {
    srv->active.fetch_sub(1);
    return 0;
  }
  struct Entry {
    PieceMeta pm;
    TaskPtr ts;
  };
  std::vector<Entry> entries;
  for (auto& r : reqs) {
    TaskPtr ts = open_task(ps, r.task.c_str(), 0, 0, false);
    PieceMeta pm{};
    bool found = false;
    if (ts) {
      std::lock_guard<std::mutex> lk(ts->mu);
      auto it = ts->pieces.find(r.number);
      if (it != ts->pieces.end() && !ts->closed) {
        pm = it->second;
        found = true;
      }
    }
    if (!found || !piece_verified(ts.get(), pm)) {
      srv->active.fetch_sub(1);
      return 0;
    }
    entries.push_back({pm, ts});
  }
  // Trim to the longest prefix under the byte cap (sizes are only known
  // after the meta lookups above); under 2 the batch gains nothing.
  size_t keep = 0;
  int64_t total = 0;
  while (keep < entries.size() &&
         total + (int64_t)entries[keep].pm.length <= kBatchBytesMax) {
    total += entries[keep].pm.length;
    keep++;
  }
  if (keep < 2) {
    srv->active.fetch_sub(1);
    return 0;
  }
  entries.resize(keep);
  reqs.resize(keep);
  std::vector<uint8_t> scratch((size_t)total);
  std::vector<std::string> heads(entries.size());
  size_t off = 0;
  for (size_t i = 0; i < entries.size(); i++) {
    int dfd = dup_data_fd(entries[i].ts.get());
    bool ok = dfd >= 0;
    if (ok) {
      int64_t got = 0;
      while (got < (int64_t)entries[i].pm.length) {
        ssize_t n = pread(dfd, scratch.data() + off + got,
                          (size_t)(entries[i].pm.length - got),
                          (off_t)(entries[i].pm.offset + got));
        if (n <= 0) {
          ok = false;
          break;
        }
        got += n;
      }
      close(dfd);
    }
    if (!ok) {
      srv->active.fetch_sub(1);
      return 0;
    }
    char h[256];
    int n = snprintf(h, sizeof(h),
                     "HTTP/1.1 200 OK\r\n"
                     "Content-Type: application/octet-stream\r\n"
                     "Content-Length: %u\r\n\r\n",
                     entries[i].pm.length);
    heads[i].assign(h, (size_t)n);
    off += entries[i].pm.length;
  }
  std::vector<iovec> iov(entries.size() * 2);
  off = 0;
  for (size_t i = 0; i < entries.size(); i++) {
    iov[2 * i].iov_base = (void*)heads[i].data();
    iov[2 * i].iov_len = heads[i].size();
    iov[2 * i + 1].iov_base = scratch.data() + off;
    iov[2 * i + 1].iov_len = entries[i].pm.length;
    off += entries[i].pm.length;
  }
  bool sent = sendv_all(fd, iov.data(), iov.size());
  srv->active.fetch_sub(1);
  if (!sent) return -1;
  srv->pieces_served.fetch_add((int64_t)entries.size());
  srv->bytes_served.fetch_add(total);
  srv->batched_pieces.fetch_add((int64_t)entries.size());
  size_t consumed = 0;
  for (auto& r : reqs) consumed += r.head_len;
  acc.erase(0, consumed);
  return (int)entries.size();
}

void handle_conn(HttpServer* srv, int fd) {
  // Whole serving loop inside a catch-all (DF021): one hostile request
  // that lands a bad_alloc (oversized batch staging, header churn) must
  // cost THIS connection, never std::terminate the embedding daemon.
  // The shared cleanup below the try runs on every exit path, so the
  // conns map / conn_count accounting that ps_serve_stop joins on stays
  // exact.
  try {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::string acc;
  while (!srv->stopping.load() && read_request(fd, acc)) {
    // Batched-submission fast path first: a pipelined run of piece GETs
    // goes out as one gather-write burst.
    int batched = try_piece_batch(srv, fd, acc);
    if (batched < 0) break;
    if (batched > 0) continue;
    // Consume exactly one request head (GETs carry no body); residual
    // bytes stay in `acc` for the next iteration (pipelining).
    size_t head_end = acc.find("\r\n\r\n");
    std::string req = acc.substr(0, head_end + 4);
    acc.erase(0, head_end + 4);

    size_t line_end = req.find("\r\n");
    std::string line = req.substr(0, line_end);
    bool keep_alive = true;
    std::string range;
    {
      size_t pos = line_end + 2;
      while (pos < req.size()) {
        size_t e = req.find("\r\n", pos);
        if (e == std::string::npos || e == pos) break;
        std::string h = req.substr(pos, e - pos);
        for (size_t i = 0; i < h.size() && h[i] != ':'; i++)
          h[i] = (char)tolower(h[i]);
        if (h.rfind("range:", 0) == 0) {
          range = h.substr(6);
          while (!range.empty() && range.front() == ' ') range.erase(0, 1);
        } else if (h.rfind("connection:", 0) == 0 &&
                   h.find("close") != std::string::npos) {
          keep_alive = false;
        }
        pos = e + 2;
      }
    }
    if (line.rfind("GET ", 0) != 0) {
      send_error_http(fd, 405, "Method Not Allowed");
      break;
    }
    size_t sp = line.find(' ', 4);
    std::string path = line.substr(4, sp - 4);
    std::string query;
    size_t qpos = path.find('?');
    if (qpos != std::string::npos) {
      query = path.substr(qpos + 1);
      path = path.substr(0, qpos);
    }

    PieceStore* ps = get_store(srv->store_handle);
    // The 503 cap protects the DATA plane (sendfile piece/range bodies).
    // Bitmap requests — including long-poll subscriptions that PARK for
    // up to 30 s — do not count: a swarm of starved children parked on a
    // busy seed must not consume its piece-serving slots (they are still
    // bounded by the per-connection threads).
    bool metadata = path.rfind("/tasks/", 0) == 0 &&
                    path.size() >= 7 &&
                    path.rfind("/pieces") == path.size() - 7;
    if (!ps || (!metadata && srv->active.fetch_add(1) >= srv->limit)) {
      if (ps && !metadata) srv->active.fetch_sub(1);
      send_error_http(fd, 503, "Busy");
      if (!keep_alive || !ps) break;
      continue;
    }

    bool ok_conn = true;
    if (path.rfind("/pieces/", 0) == 0) {
      // /pieces/<task>/<n>
      std::string rest = path.substr(8);
      size_t slash = rest.find('/');
      int64_t number = -1;
      if (slash == std::string::npos ||
          !parse_i64(rest.substr(slash + 1), &number) ||
          !valid_task_id(rest.substr(0, slash))) {
        ok_conn = send_error_http(fd, 404, "Not Found");
      } else {
        std::string task = rest.substr(0, slash);
        TaskPtr ts = open_task(ps, task.c_str(), 0, 0, false);
        PieceMeta pm{};
        bool found = false;
        if (ts) {
          std::lock_guard<std::mutex> lk(ts->mu);
          auto it = ts->pieces.find((uint32_t)number);
          if (it != ts->pieces.end() && !ts->closed) {
            pm = it->second;
            found = true;
          }
        }
        int dfd = -1;
        if (!found) {
          ok_conn = send_error_http(fd, 404, "Not Found");
        } else if (!piece_verified(ts.get(), pm)) {
          ok_conn = send_error_http(fd, 500, "Corrupt");
        } else if ((dfd = dup_data_fd(ts.get())) < 0) {
          ok_conn = send_error_http(fd, 404, "Gone");
        } else {
          ok_conn = send_head(fd, 200, "OK", pm.length) &&
                    sendfile_all(fd, dfd, pm.offset, pm.length);
          if (ok_conn) {
            srv->pieces_served.fetch_add(1);
            srv->bytes_served.fetch_add(pm.length);
          }
        }
        if (dfd >= 0) close(dfd);
      }
    } else if (path.rfind("/tasks/", 0) == 0) {
      std::string rest = path.substr(7);
      size_t slash = rest.find('/');
      if (slash != std::string::npos && rest.substr(slash) == "/pieces") {
        std::string task = rest.substr(0, slash);
        // Long-poll subscription (?have=N&wait_ms=M, Python-server wire
        // parity — peertask_piecetask_synchronizer semantics): defer the
        // bitmap until this store holds MORE than N committed pieces, so
        // a child following a mid-download parent sees new pieces as
        // they land.  Bounded at 30 s; re-opens the task each tick so a
        // not-yet-registered task can appear during the window.
        int64_t have = -1, wait_ms = 0;
        parse_query_i64(query, "have", &have);
        parse_query_i64(query, "wait_ms", &wait_ms);
        if (wait_ms > kLongPollMaxMs) wait_ms = kLongPollMaxMs;
        // Long-polls don't consume data-plane slots, but they are not
        // unbounded either: past 4x the serving cap of PARKED pollers,
        // the subscription degrades to an immediate snapshot (clients
        // fall back to interval polling) instead of stacking threads.
        bool parked = false;
        if (wait_ms > 0) {
          parked = true;
          if (srv->meta_active.fetch_add(1) >= srv->limit * 4) wait_ms = 0;
        }
        TaskPtr ts;
        int64_t waited_ms = 0;
        for (;;) {
          ts = valid_task_id(task) ? open_task(ps, task.c_str(), 0, 0, false)
                                   : nullptr;
          int64_t held = 0;
          if (ts) {
            std::lock_guard<std::mutex> lk(ts->mu);
            held = (int64_t)ts->pieces.size();
          }
          if ((ts && held > have) || waited_ms >= wait_ms ||
              srv->stopping.load())
            break;
          usleep(20 * 1000);
          waited_ms += 20;
        }
        if (parked) srv->meta_active.fetch_sub(1);
        int64_t n_pieces =
            (!ts || ts->header.piece_size == 0)
                ? 0
                : (ts->header.content_length + ts->header.piece_size - 1) /
                      (int64_t)ts->header.piece_size;
        if (n_pieces <= 0) {
          // Python-server parity: unknown AND zero-length tasks both 404.
          ok_conn = send_error_http(fd, 404, "Not Found");
        } else {
          std::vector<uint8_t> bm((size_t)n_pieces, 0);
          {
            std::lock_guard<std::mutex> lk(ts->mu);
            for (auto& kv : ts->pieces)
              if (kv.first < n_pieces) bm[kv.first] = 1;
          }
          ok_conn = send_head(fd, 200, "OK", (int64_t)bm.size()) &&
                    send_all(fd, (const char*)bm.data(), bm.size());
        }
      } else if (slash == std::string::npos) {
        // /tasks/<task> with Range (bytes=S-E / S- / -N)
        TaskPtr ts = valid_task_id(rest)
                         ? open_task(ps, rest.c_str(), 0, 0, false)
                         : nullptr;
        int64_t total = ts ? ts->header.content_length : -1;
        uint32_t psz = ts ? ts->header.piece_size : 0;
        int64_t start = -1, end = -1;
        if (ts && total >= 0 && psz > 0 && range.rfind("bytes=", 0) == 0) {
          std::string spec = range.substr(6);
          size_t dash = spec.find('-');
          if (dash != std::string::npos) {
            std::string s = spec.substr(0, dash), e = spec.substr(dash + 1);
            int64_t sv = 0, ev = 0;
            if (s.empty() && parse_i64(e, &ev)) {  // suffix: bytes=-N
              start = total - ev < 0 ? 0 : total - ev;
              end = total - 1;
            } else if (parse_i64(s, &sv)) {
              if (e.empty()) {                     // open end: bytes=S-
                start = sv;
                end = total - 1;
              } else if (parse_i64(e, &ev)) {
                start = sv;
                end = ev;
              }
            }
          }
        }
        // Clamp BEFORE the start/end sanity check: bytes=100-200 on a
        // 10-byte task must 416, not send a negative Content-Length.
        if (end > total - 1) end = total - 1;
        if (start < 0 || end < start) {
          ok_conn = send_error_http(fd, 416, "Range Not Satisfiable");
        } else {
          // Writer invariant: piece n lives at offset n*piece_size, so a
          // byte range maps directly onto the data file — IF every
          // covering piece is committed.
          bool covered = true;
          {
            std::lock_guard<std::mutex> lk(ts->mu);
            if (ts->closed) covered = false;
            for (int64_t n = start / psz; covered && n <= end / psz; n++)
              if (ts->pieces.find((uint32_t)n) == ts->pieces.end())
                covered = false;
          }
          int dfd = -1;
          if (!covered || (dfd = dup_data_fd(ts.get())) < 0) {
            ok_conn = send_error_http(fd, 404, "Not Found");
          } else {
            ok_conn = send_head(fd, 206, "Partial Content", end - start + 1) &&
                      sendfile_all(fd, dfd, start, end - start + 1);
            if (ok_conn) srv->bytes_served.fetch_add(end - start + 1);
          }
          if (dfd >= 0) close(dfd);
        }
      } else {
        ok_conn = send_error_http(fd, 404, "Not Found");
      }
    } else {
      ok_conn = send_error_http(fd, 404, "Not Found");
    }
    if (!metadata) srv->active.fetch_sub(1);
    if (!ok_conn || !keep_alive) break;
  }
  } catch (...) {
    // Contained: the request that threw gets no response (the client
    // sees a dropped connection and retries); the data-plane slot was
    // already released on the normal paths above, and a throw between
    // fetch_add and fetch_sub cannot happen (no allocation in between).
  }
  {
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    srv->conns.erase(fd);
  }
  close(fd);
  srv->conn_count.fetch_sub(1);
}

void accept_loop(HttpServer* srv) try {
  while (!srv->stopping.load()) {
    int fd = accept(srv->lfd, nullptr, nullptr);
    if (fd < 0) {
      if (srv->stopping.load()) return;
      // EMFILE/transient errors: back off instead of pinning a core.
      usleep(10 * 1000);
      continue;
    }
    {
      std::lock_guard<std::mutex> lk(srv->conns_mu);
      srv->conns[fd] = 1;
    }
    srv->conn_count.fetch_add(1);
    std::thread(handle_conn, srv, fd).detach();
  }
} catch (...) {
  // DF021 containment: a std::thread construction failure (EAGAIN under
  // fd/thread pressure) must stop accepting, not terminate the process.
  // ps_serve_stop still joins this thread and closes the listener; the
  // one connection that failed to spawn leaks its fd accounting into
  // conn_count, which stop's bounded grace tolerates.
}

}  // namespace

extern "C" {

// Start serving the store's pieces on host:port (port 0 = ephemeral).
// Returns the bound port, or <0 on error.  One server per store handle.
int64_t ps_serve(int64_t handle, const char* host, uint16_t port, int limit) try {
  // Serialize whole-call: two concurrent ps_serve on one handle must not
  // both pass the duplicate check and leak the loser's live server.
  static std::mutex serve_setup_mu;
  std::lock_guard<std::mutex> setup_lk(serve_setup_mu);
  if (!get_store(handle)) return -1;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    if (g_servers.count(handle)) return -2;
  }
  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return -3;
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(lfd);
    return -4;
  }
  if (bind(lfd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(lfd, 128) != 0) {
    close(lfd);
    return -5;
  }
  socklen_t alen = sizeof(addr);
  getsockname(lfd, (sockaddr*)&addr, &alen);
  HttpServer* srv = new HttpServer();
  srv->lfd = lfd;
  srv->limit = limit > 0 ? limit : kServeLimitDefault;
  srv->store_handle = handle;
  srv->port = ntohs(addr.sin_port);
  srv->accept_th = std::thread(accept_loop, srv);
  std::lock_guard<std::mutex> lk(g_servers_mu);
  g_servers[handle] = srv;
  return (int64_t)srv->port;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int ps_serve_stop(int64_t handle) try {
  HttpServer* srv;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    auto it = g_servers.find(handle);
    if (it == g_servers.end()) return -1;
    srv = it->second;
    g_servers.erase(it);
  }
  srv->stopping.store(true);
  // shutdown alone wakes the blocked accept(); close only AFTER the join
  // or the fd number can be reused by another thread and accept() would
  // then operate on an unrelated descriptor.
  shutdown(srv->lfd, SHUT_RDWR);
  if (srv->accept_th.joinable()) srv->accept_th.join();
  close(srv->lfd);
  // Wake every connection thread (idle keep-alive recv()s included) and
  // wait for ALL of them to exit — deleting srv with live detached
  // threads is a use-after-free, and ps_close right after would free the
  // store under an in-flight request.
  {
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    for (auto& kv : srv->conns) shutdown(kv.first, SHUT_RDWR);
  }
  for (int i = 0; i < 500 && srv->conn_count.load() > 0; i++)
    usleep(10 * 1000);
  if (srv->conn_count.load() > 0) {
    // A thread is wedged past the 5 s grace: leak the server struct
    // rather than free memory it still references — and COUNT it, so
    // teardowns can assert the condition never happened (ps_leak_stats)
    // instead of scraping stderr.
    g_leaked_servers.fetch_add(1);
    g_leaked_conns.fetch_add(srv->conn_count.load());
    return 1;
  }
  delete srv;
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Extended serving counters: adds the batched-burst piece count and the
// live connection-thread count to ps_serve_stats.
int ps_serve_stats2(int64_t handle, int64_t* pieces, int64_t* bytes,
                    int64_t* batched, int64_t* conns) try {
  std::lock_guard<std::mutex> lk(g_servers_mu);
  auto it = g_servers.find(handle);
  if (it == g_servers.end()) return -1;
  *pieces = it->second->pieces_served.load();
  *bytes = it->second->bytes_served.load();
  *batched = it->second->batched_pieces.load();
  *conns = (int64_t)it->second->conn_count.load();
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Process-wide wedged-shutdown counters (never reset): servers leaked by
// ps_serve_stop past the stop grace, and the stuck connection threads
// they held.  Zero on a healthy run — test/bench teardowns assert it.
int ps_leak_stats(int64_t* servers, int64_t* conns) try {
  *servers = g_leaked_servers.load();
  *conns = g_leaked_conns.load();
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int ps_close(int64_t handle) try {
  // A wedged server (ps_serve_stop → 1: connection threads alive past the
  // grace) still references the store's TaskStore FILE*s — freeing it here
  // would be a use-after-free.  Leak the store alongside the leaked server
  // and report a distinct code; the handle is dead either way.
  if (ps_serve_stop(handle) == 1) {  // no-op (-1) when no server attached
    std::lock_guard<std::mutex> lk(g_stores_mu);
    auto it = g_stores.find(handle);
    if (it != g_stores.end()) g_stores.erase(it);  // counted via ps_leak_stats
    return -2;
  }
  PieceStore* ps;
  {
    std::lock_guard<std::mutex> lk(g_stores_mu);
    auto it = g_stores.find(handle);
    if (it == g_stores.end()) return -1;
    ps = it->second;
    g_stores.erase(it);
  }
  {
    // Scope the guard: deleting ps while holding ps->mu would unlock a
    // destroyed mutex in the guard's destructor (found by `make tsan`).
    std::lock_guard<std::mutex> lk(ps->mu);
    for (auto& kv : ps->tasks) {
      std::lock_guard<std::mutex> tlk(kv.second->mu);
      if (!kv.second->closed) {
        fclose(kv.second->meta);
        fclose(kv.second->data);
        kv.second->closed = true;
      }
    }
    ps->tasks.clear();
  }
  delete ps;
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

}  // extern "C"

// ---------------------------------------------------------------------------
// In-engine piece fetch loop (pf_*): the CLIENT half of the native data
// plane (DESIGN.md §28).  The Python per-piece loop (conductor fetch_one →
// HTTPPieceFetcher → CommitPipeline) is the semantic spec and stays as the
// byte-identical fallback arm; this engine drains a piece *window* with
// zero Python per-piece overhead:
//
//   worker thread:  pooled keep-alive socket per parent slot → pipelined
//   GET burst (up to 8 pieces; triggers the server's batched-submission
//   path) → length-check → ps_write_piece (crc + fsync-ordered commit,
//   the same durability contract as every other write) → completion.
//
// Python keeps scheduling OWNERSHIP: it picks parents (slots), submits
// pieces, and drains a bounded completion queue — any non-zero status
// simply puts the piece back into the ordinary Python retry/hedge path.
// Completion records are fixed 24-byte structs so the ctypes drain is one
// memcpy + struct.iter_unpack, not a per-field FFI round-trip.
// ---------------------------------------------------------------------------

namespace {

struct FetchJob {
  std::string task;
  uint32_t number = 0;
  int32_t slot = 0;
  uint32_t expected_len = 0;
};

#pragma pack(push, 1)
struct FetchDone {        // 24 bytes; mirrored by NativePieceFetcher.RECORD
  uint32_t number;
  int32_t status;         // kFetchStatusOk / >0 HTTP / kFetchStatus{Conn,Proto,Commit}
  uint32_t length;
  int32_t slot;
  int64_t cost_ns;
};
#pragma pack(pop)

struct PieceFetcher {
  int64_t store_handle = 0;
  std::string tenant;
  std::mutex mu;
  std::condition_variable cv_jobs, cv_done;
  std::deque<FetchJob> jobs;
  std::deque<FetchDone> done;
  std::vector<std::pair<std::string, uint16_t>> parents;  // slot-indexed
  bool closing = false;
  std::vector<std::thread> workers;
};

// shared_ptr holders (the TaskPtr discipline): a caller blocked inside
// pf_complete's cv_done wait keeps the fetcher alive across a concurrent
// pf_close — close erases the handle, wakes waiters, joins workers, and
// the LAST reference frees.  The conductor happens to use the handle
// single-threaded, but the extern-C ABI makes no such promise.
using FetcherPtr = std::shared_ptr<PieceFetcher>;

std::mutex g_fetchers_mu;
std::map<int64_t, FetcherPtr> g_fetchers;

FetcherPtr get_fetcher(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_fetchers_mu);
  auto it = g_fetchers.find(handle);
  return it == g_fetchers.end() ? nullptr : it->second;
}

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

int connect_parent(const std::string& ip, uint16_t port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, ip.c_str(), &addr.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  // Non-blocking connect with a bounded poll: a black-holed parent must
  // cost a worker at most this dial timeout, not the kernel's minutes-
  // long SYN retry ladder — pf_close joins workers, so an unbounded
  // connect here would stall the conductor's `finally: fetcher.close()`
  // long past piece_wait_timeout_s.
  int flags = fcntl(fd, F_GETFL, 0);
  if (flags < 0 || fcntl(fd, F_SETFL, flags | O_NONBLOCK) != 0) {
    close(fd);
    return -1;
  }
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    if (errno != EINPROGRESS) {
      close(fd);
      return -1;
    }
    pollfd pfd{fd, POLLOUT, 0};
    int err = 0;
    socklen_t elen = sizeof(err);
    if (poll(&pfd, 1, 5000) != 1 ||
        getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) != 0 || err != 0) {
      close(fd);
      return -1;
    }
  }
  fcntl(fd, F_SETFL, flags);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // A wedged parent must park a worker for at most the recv timeout —
  // Python owns rescheduling, it just needs the error completion.
  timeval tv{30, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  return fd;
}

// One HTTP response (head + Content-Length body) off a keep-alive client
// socket.  Residual bytes persist in `acc` across calls so pipelined
// responses are never dropped.  Returns the HTTP status with the body in
// *body, or <0 on socket/protocol error.  `expected_len` (when > 0)
// bounds the body allocation up front; error bodies still get a small
// floor so a verbose 404/503 page doesn't masquerade as -2.
int read_response(int fd, std::string& acc, std::string* body,
                  uint32_t expected_len) {
  char buf[65536];
  size_t head_end;
  while ((head_end = acc.find("\r\n\r\n")) == std::string::npos) {
    if (acc.size() > 65536) return kFetchStatusProto;
    ssize_t n = recv(fd, buf, sizeof(buf), 0);
    if (n <= 0) return kFetchStatusConn;
    acc.append(buf, (size_t)n);
  }
  std::string head = acc.substr(0, head_end + 4);
  acc.erase(0, head_end + 4);
  if (head.rfind("HTTP/1.", 0) != 0 || head.size() < 12)
    return kFetchStatusProto;
  int status = atoi(head.c_str() + 9);
  if (status < 100) return kFetchStatusProto;
  std::string lower = head;
  for (auto& c : lower) c = (char)tolower(c);
  size_t p = lower.find("content-length:");
  int64_t clen = -1;
  if (p != std::string::npos) {
    size_t e = lower.find("\r\n", p);
    std::string v = head.substr(p + 15, e - p - 15);
    while (!v.empty() && v.front() == ' ') v.erase(0, 1);
    if (!parse_i64(v, &clen)) return kFetchStatusProto;
  }
  if (clen < 0) return kFetchStatusProto;
  int64_t cap = expected_len > 0
                    ? std::max<int64_t>(expected_len, 64 * 1024)
                    : kMaxFetchBody;
  if (clen > cap) return kFetchStatusProto;
  // Bulk path: splice whatever body bytes already rode in with the head,
  // then recv the remainder straight into the body buffer — one copy per
  // byte instead of append+assign, and length-capped reads never overshoot
  // into the next pipelined response (overshoot stays in the socket).
  size_t have = acc.size() > (size_t)clen ? (size_t)clen : acc.size();
  body->resize((size_t)clen);
  if (have) memcpy(&(*body)[0], acc.data(), have);
  acc.erase(0, have);
  size_t got = have;
  while ((int64_t)got < clen) {
    ssize_t n = recv(fd, &(*body)[got], (size_t)clen - got, 0);
    if (n <= 0) return kFetchStatusConn;
    got += (size_t)n;
  }
  return status;
}

void fetch_worker(PieceFetcher* pf) {
  // Worker-local keep-alive sockets, one per parent slot — the pooled
  // reuse that makes a piece fetch cost ~one syscall pair, plus the
  // residual-byte accumulator that makes pipelining safe.
  std::map<int32_t, int> socks;
  std::map<int32_t, std::string> residual;
  // Whole drain loop inside a catch-all (DF021): the per-burst handler
  // below already converts a throwing burst into error completions, so
  // this outer net only catches allocation failure in the loop plumbing
  // itself — the worker exits (sockets still closed below) and pf_close
  // discards its queued jobs as kFetchStatusConn completions.
  try {
  for (;;) {
    std::vector<FetchJob> burst;
    {
      std::unique_lock<std::mutex> lk(pf->mu);
      pf->cv_jobs.wait(lk, [&] { return pf->closing || !pf->jobs.empty(); });
      if (pf->closing) {
        // Close DISCARDS the queue: each queued job becomes a -1
        // completion (Python's submitted-minus-drained ledger stays
        // balanced for any concurrent pf_complete) and only in-flight
        // bursts finish — pf_close joins workers, so fetching a whole
        // backlog from a wedged parent here would stall the conductor's
        // `finally: fetcher.close()` for minutes after the window's
        // deadline already fired.
        while (!pf->jobs.empty()) {
          FetchJob& j = pf->jobs.front();
          pf->done.push_back({j.number, kFetchStatusConn, 0, j.slot, 0});
          pf->jobs.pop_front();
        }
        pf->cv_done.notify_all();
        break;
      }
      burst.push_back(std::move(pf->jobs.front()));
      pf->jobs.pop_front();
      // Opportunistic pipelining: pull queued jobs bound for the SAME
      // parent+task into one request burst (up to kFetchBurstMax) —
      // back-to-back GETs on one socket are what trigger the server's
      // batched submission.  Byte-capped at kBatchBytesMax: a burst
      // serializes its responses on ONE connection, so big pieces must
      // spread across workers instead (an 8 x 4 MiB burst on one socket
      // idles the other workers and LOSES to the parallel Python arm);
      // unknown-size pieces never pipeline.
      int64_t burst_bytes = burst[0].expected_len;
      for (auto it = pf->jobs.begin();
           it != pf->jobs.end() && burst.size() < kFetchBurstMax &&
           burst[0].expected_len > 0 && burst_bytes < kBatchBytesMax;) {
        if (it->slot == burst[0].slot && it->task == burst[0].task &&
            it->expected_len > 0 &&
            burst_bytes + it->expected_len <= kBatchBytesMax) {
          burst_bytes += it->expected_len;
          burst.push_back(std::move(*it));
          it = pf->jobs.erase(it);
        } else {
          ++it;
        }
      }
    }
    int32_t slot = burst[0].slot;
    int64_t t0 = now_ns();
    size_t completed = 0;  // completions already pushed for this burst
    auto fail_rest = [&](int32_t status) {
      std::lock_guard<std::mutex> lk(pf->mu);
      while (completed < burst.size()) {
        pf->done.push_back(
            {burst[completed].number, status, 0, slot, now_ns() - t0});
        completed++;
      }
    };
    // Every job in the burst completes exactly once, even on a C++
    // exception: an exception escaping a std::thread entry would
    // std::terminate the whole daemon, so one bad peer response must
    // cost error completions (Python reschedules), never the process.
    try {
      std::string ip;
      uint16_t port = 0;
      {
        std::lock_guard<std::mutex> lk(pf->mu);
        if (slot >= 0 && (size_t)slot < pf->parents.size()) {
          ip = pf->parents[slot].first;
          port = pf->parents[slot].second;
        }
      }
      if (ip.empty() || port == 0) {
        fail_rest(kFetchStatusConn);
        pf->cv_done.notify_all();
        continue;
      }
      // Send the whole burst; one reconnect retry covers a parent having
      // dropped the idle pooled socket between windows (same shape as the
      // Python pool's retry_call(attempts=2)).
      bool sent = false;
      for (int attempt = 0; attempt < 2 && !sent; attempt++) {
        auto it = socks.find(slot);
        if (it == socks.end() || it->second < 0) {
          int nfd = connect_parent(ip, port);
          socks[slot] = nfd;
          residual[slot].clear();
          if (nfd < 0) break;
        }
        std::string reqs;
        for (auto& b : burst) {
          char req[512];
          int n = snprintf(req, sizeof(req),
                           "GET /pieces/%s/%u HTTP/1.1\r\n"
                           "Host: %s:%u\r\n"
                           "X-Dragonfly-Tenant: %s\r\n\r\n",
                           b.task.c_str(), b.number, ip.c_str(),
                           (unsigned)port, pf->tenant.c_str());
          reqs.append(req, (size_t)n);
        }
        if (send_all(socks[slot], reqs.data(), reqs.size())) {
          sent = true;
        } else {
          close(socks[slot]);
          socks[slot] = -1;
        }
      }
      if (!sent) {
        fail_rest(kFetchStatusConn);
        pf->cv_done.notify_all();
        continue;
      }
      // Read responses in order; commit each good body through the same
      // crc+fsync write path every other commit uses.
      for (size_t i = 0; i < burst.size(); i++) {
        std::string body;
        int status = read_response(socks[slot], residual[slot], &body,
                                   burst[i].expected_len);
        if (status < 0) {
          close(socks[slot]);
          socks[slot] = -1;
          fail_rest(status);
          break;
        }
        FetchDone d{burst[i].number, kFetchStatusOk, 0, slot, 0};
        if (status != 200) {
          d.status = status;
        } else if (burst[i].expected_len > 0 &&
                   body.size() != burst[i].expected_len) {
          d.status = kFetchStatusProto;
        } else {
          int64_t wrote = ps_write_piece(
              pf->store_handle, burst[i].task.c_str(), burst[i].number,
              (const uint8_t*)body.data(), (uint32_t)body.size());
          d.status = wrote < 0 ? kFetchStatusCommit : kFetchStatusOk;
          d.length = (uint32_t)body.size();
        }
        d.cost_ns = now_ns() - t0;
        {
          std::lock_guard<std::mutex> lk(pf->mu);
          pf->done.push_back(d);
        }
        completed++;
      }
      pf->cv_done.notify_all();
    } catch (...) {
      // The socket's stream position is unknown mid-exception: drop it
      // so the next burst starts on a clean connection.
      auto it = socks.find(slot);
      if (it != socks.end() && it->second >= 0) {
        close(it->second);
        it->second = -1;
      }
      fail_rest(kFetchStatusProto);
      pf->cv_done.notify_all();
    }
  }
  } catch (...) {
    // Last-resort containment; see the comment above the loop.
  }
  for (auto& kv : socks)
    if (kv.second >= 0) close(kv.second);
}

}  // namespace

extern "C" {

// Open a fetch engine bound to a local piece store.  `workers` threads
// drain the submit queue; `tenant` rides every request as the
// X-Dragonfly-Tenant header (requester-pays upload accounting, §26/§28).
int64_t pf_open(int64_t store_handle, int workers, const char* tenant) try {
  if (!get_store(store_handle)) return -1;
  if (workers <= 0) workers = kFetchWorkersDefault;
  if (workers > kFetchWorkersMax) workers = kFetchWorkersMax;
  FetcherPtr pf = std::make_shared<PieceFetcher>();
  pf->store_handle = store_handle;
  pf->tenant = tenant ? tenant : "";
  // Raw pointer is safe: pf_close joins the workers while still holding
  // a reference, so the object outlives every worker thread.
  for (int i = 0; i < workers; i++)
    pf->workers.emplace_back(fetch_worker, pf.get());
  std::lock_guard<std::mutex> lk(g_fetchers_mu);
  int64_t h = g_next_handle++;
  g_fetchers[h] = pf;
  return h;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Register/replace the parent endpoint behind `slot` (Python owns parent
// selection; slots keep the per-piece submit free of string churn).
int pf_parent(int64_t fh, int slot, const char* ip, uint16_t port) try {
  FetcherPtr pf = get_fetcher(fh);
  if (!pf || slot < 0 || slot > kParentSlotMax || !ip) return -1;
  std::lock_guard<std::mutex> lk(pf->mu);
  if ((size_t)slot >= pf->parents.size()) pf->parents.resize((size_t)slot + 1);
  pf->parents[(size_t)slot] = {ip, port};
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int pf_submit(int64_t fh, const char* task_id, int slot, uint32_t number,
              uint32_t expected_len) try {
  FetcherPtr pf = get_fetcher(fh);
  if (!pf || !task_id) return -1;
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    if (pf->closing) return -2;
    pf->jobs.push_back({task_id, number, slot, expected_len});
  }
  pf->cv_jobs.notify_one();
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Drain up to `max_records` completions into `out` (packed FetchDone
// records).  Blocks up to timeout_ms for the first one; 0 on timeout.
int pf_complete(int64_t fh, uint8_t* out, int max_records, int timeout_ms) try {
  FetcherPtr pf = get_fetcher(fh);
  if (!pf || !out || max_records <= 0) return -1;
  std::unique_lock<std::mutex> lk(pf->mu);
  // `closing` in the predicate: a concurrent pf_close wakes this waiter
  // immediately (it drains whatever landed) instead of parking it for
  // the full timeout on an object about to go away.
  //
  // system_clock wait_until, NOT wait_for: libstdc++'s steady-clock
  // timed waits compile to pthread_cond_clockwait, which this
  // toolchain's libtsan does not intercept — TSAN then misses the
  // unlock inside the wait and every later report in the run is
  // poisoned (spurious double-lock/data-race).  The system-clock path
  // uses the intercepted pthread_cond_timedwait; a wall-clock jump can
  // only stretch/cut one bounded drain timeout, which callers retry.
  pf->cv_done.wait_until(
      lk,
      std::chrono::system_clock::now() +
          std::chrono::milliseconds(timeout_ms),
      [&] { return pf->closing || !pf->done.empty(); });
  if (pf->done.empty()) return 0;
  int n = 0;
  while (n < max_records && !pf->done.empty()) {
    memcpy(out + (size_t)n * sizeof(FetchDone), &pf->done.front(),
           sizeof(FetchDone));
    pf->done.pop_front();
    n++;
  }
  return n;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Jobs not yet completed (queued + in flight is Python's submitted-minus-
// drained count; this exposes just the queue for diagnostics).
int64_t pf_pending(int64_t fh) try {
  FetcherPtr pf = get_fetcher(fh);
  if (!pf) return -1;
  std::lock_guard<std::mutex> lk(pf->mu);
  return (int64_t)pf->jobs.size();
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Discard queued jobs (each becomes a -1 completion; in-flight bursts
// finish), join workers, release the handle.  The object itself is
// freed by the last shared_ptr holder — a racing pf_complete keeps it
// alive past this return.
int pf_close(int64_t fh) try {
  FetcherPtr pf;
  {
    std::lock_guard<std::mutex> lk(g_fetchers_mu);
    auto it = g_fetchers.find(fh);
    if (it == g_fetchers.end()) return -1;
    pf = it->second;
    g_fetchers.erase(it);
  }
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->closing = true;
  }
  pf->cv_jobs.notify_all();
  pf->cv_done.notify_all();
  for (auto& t : pf->workers)
    if (t.joinable()) t.join();
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Online ingest engine (oi_*): the wire→trainer hot path of the online graph
// trainer.  Semantics mirror trainer/online_graph.py WireIngestAdapter — that
// Python class is the spec (bucket→dense-id first-come mapping, TTL eviction
// + id recycling, host-feature accumulation, bounded edge ring with
// backpressure) — but the whole per-chunk pass runs here without the GIL:
// the measured ceiling of the composed wire-fed loop was the single Python
// consumer process (BENCHMARKS.md bottleneck ledger), not any one stage.
//
// Parity notes (asserted in tests/test_native_ingest.py):
//  * id assignment is per-chunk sorted-unique over BOTH endpoint columns in
//    one call — byte-identical mappings to the Python adapter for the same
//    arrival order;
//  * feature accumulation credits parent cols [2+H, 2+2H) to src and child
//    cols [2, 2+H) to dst (records.features.accumulate_host_feature_sums);
//    unlike Python's sampled fold it accumulates EVERY kept row (C++ can
//    afford it; means only converge harder);
//  * eviction runs under the engine lock with the caller-supplied clock, so
//    injectable-clock tests drive both implementations identically.
// ---------------------------------------------------------------------------

namespace {

struct OnlineIngest {
  int32_t num_nodes = 0;
  int64_t n_buckets = 0;
  int32_t feat_dim = 0;
  int32_t row_width = 0;
  double ttl = 0.0;

  std::mutex mu;
  std::condition_variable cv_space;  // feeders wait for ring room
  std::condition_variable cv_data;   // taker waits for enough edges

  std::vector<int32_t> id_table;   // [n_buckets]  -2 unseen, -1 overflow
  std::vector<int64_t> bucket_of;  // [num_nodes]  -1 free
  std::vector<double> last_seen;   // [num_nodes]
  std::vector<int32_t> free_ids;   // recycled ids, pop from back
  int32_t next_id = 0;
  double last_scan = -1e300;
  int64_t overflow_edges = 0;
  int64_t evicted_nodes = 0;
  int64_t rows_in = 0;
  std::vector<int32_t> pending_recycle;

  // double internally: the engine folds EVERY kept row (no sampling),
  // so a hot node passes float32's 2^24 integer ceiling within hours at
  // wire rate and `cnt += 1.0f` would silently freeze the mean.  The
  // ABI (export/node_features) stays float32 — the shared state format.
  std::vector<double> feat_sum;  // [num_nodes * feat_dim]
  std::vector<double> feat_cnt;  // [num_nodes]

  int64_t cap = 0;  // edge ring capacity
  std::vector<int32_t> ring_src, ring_dst;
  std::vector<float> ring_y;
  int64_t head = 0, size = 0;
  bool eof = false;
  bool closed = false;

  std::vector<int32_t> ids_scratch;
  std::vector<int64_t> new_scratch;
  // Per-chunk staging (reused; the engine mutex serializes feeders).
  std::vector<float> cols_scratch;
  std::vector<int32_t> st_src, st_dst;
  std::vector<float> st_y;
};

using IngestPtr = std::shared_ptr<OnlineIngest>;

std::mutex g_oi_mu;
std::map<int64_t, IngestPtr> g_oi;
int64_t g_oi_next = 1;

// shared_ptr copy: callers blocked inside the engine (cv waits) keep it
// alive across a concurrent oi_destroy — destroy unmaps + wakes, the
// last user frees (the TSAN gate caught the raw-pointer version).
IngestPtr oi_get(int64_t h) {
  std::lock_guard<std::mutex> lk(g_oi_mu);
  auto it = g_oi.find(h);
  return it == g_oi.end() ? nullptr : it->second;
}

// Reclaim ids silent past ttl (trainer/online_graph.py _evict_expired):
// throttled full scan; frees mapping + accumulators, queues the row reset.
// Caller holds e->mu.
int64_t oi_evict_locked(OnlineIngest* e, double now) {
  if (e->ttl <= 0 || now - e->last_scan < e->ttl * 0.25) return 0;
  e->last_scan = now;
  int64_t k = 0;
  for (int32_t id = 0; id < e->num_nodes; id++) {
    if (e->bucket_of[id] < 0 || now - e->last_seen[id] <= e->ttl) continue;
    e->id_table[e->bucket_of[id]] = -2;
    e->bucket_of[id] = -1;
    std::fill_n(&e->feat_sum[(int64_t)id * e->feat_dim], e->feat_dim, 0.0);
    e->feat_cnt[id] = 0.0;
    e->free_ids.push_back(id);
    e->pending_recycle.push_back(id);
    k++;
  }
  if (k) {
    e->evicted_nodes += k;
    // Un-memoize overflow buckets: dropped hosts may claim freed ids.
    for (int64_t b = 0; b < e->n_buckets; b++)
      if (e->id_table[b] == -1) e->id_table[b] = -2;
  }
  return k;
}

// bucket → dense id over one flat column (trainer/online_graph.py _map_ids):
// touch-before-evict, sorted-unique allocation, in-loop eviction retry.
// Out-of-range buckets map to -1 (hostile wire input must not fault).
// Caller holds e->mu.
void oi_map_locked(OnlineIngest* e, const float* buckets, int64_t n,
                   double now, int32_t* out) {
  bool any_unseen = false, any_dropped = false;
  for (int64_t i = 0; i < n; i++) {
    int64_t b = (int64_t)buckets[i];
    int32_t v = (b < 0 || b >= e->n_buckets) ? -1 : e->id_table[b];
    out[i] = v;
    if (v == -2) any_unseen = true;
    if (v == -1) any_dropped = true;
    if (e->ttl > 0 && v >= 0) e->last_seen[v] = now;
  }
  if (!any_unseen && !(e->ttl > 0 && any_dropped)) return;
  if (e->free_ids.empty() && e->next_id >= e->num_nodes) {
    if (oi_evict_locked(e, now) > 0) {
      for (int64_t i = 0; i < n; i++) {
        int64_t b = (int64_t)buckets[i];
        out[i] = (b < 0 || b >= e->n_buckets) ? -1 : e->id_table[b];
      }
    }
  }
  e->new_scratch.clear();
  for (int64_t i = 0; i < n; i++)
    if (out[i] == -2) e->new_scratch.push_back((int64_t)buckets[i]);
  std::sort(e->new_scratch.begin(), e->new_scratch.end());
  e->new_scratch.erase(
      std::unique(e->new_scratch.begin(), e->new_scratch.end()),
      e->new_scratch.end());
  for (int64_t nb : e->new_scratch) {
    if (e->id_table[nb] != -2) continue;
    if (e->free_ids.empty() && e->next_id >= e->num_nodes)
      oi_evict_locked(e, now);  // pool drained mid-chunk; throttled
    int32_t nid;
    if (!e->free_ids.empty()) {
      nid = e->free_ids.back();
      e->free_ids.pop_back();
    } else if (e->next_id < e->num_nodes) {
      nid = e->next_id++;
    } else {
      e->id_table[nb] = -1;
      continue;
    }
    e->id_table[nb] = nid;
    e->bucket_of[nid] = nb;
    e->last_seen[nid] = now;
  }
  for (int64_t i = 0; i < n; i++) {
    int64_t b = (int64_t)buckets[i];
    out[i] = (b < 0 || b >= e->n_buckets) ? -1 : e->id_table[b];
  }
}

}  // namespace

extern "C" {

int64_t oi_create(int32_t num_nodes, int64_t n_buckets, int32_t feat_dim,
                  int32_t row_width, double ttl, int64_t ring_cap) try {
  if (num_nodes <= 0 || n_buckets <= 0 || feat_dim <= 0 ||
      row_width < 2 + 2 * feat_dim + 1 || ring_cap <= 0)
    return -1;
  auto e = std::make_shared<OnlineIngest>();
  e->num_nodes = num_nodes;
  e->n_buckets = n_buckets;
  e->feat_dim = feat_dim;
  e->row_width = row_width;
  e->ttl = ttl;
  e->id_table.assign(n_buckets, -2);
  e->bucket_of.assign(num_nodes, -1);
  e->last_seen.assign(num_nodes, 0.0);
  e->feat_sum.assign((int64_t)num_nodes * feat_dim, 0.0);
  e->feat_cnt.assign(num_nodes, 0.0);
  e->cap = ring_cap;
  e->ring_src.resize(ring_cap);
  e->ring_dst.resize(ring_cap);
  e->ring_y.resize(ring_cap);
  std::lock_guard<std::mutex> lk(g_oi_mu);
  int64_t h = g_oi_next++;
  g_oi[h] = e;
  return h;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Map + accumulate + ring-append one chunk of download rows ([n, row_width]
// float32, src bucket col 0, dst col 1, target last col).  Blocks for ring
// space (backpressure) when block != 0.  Returns edges kept (overflow rows
// dropped+counted), -1 on bad handle / closed.
int64_t oi_feed_download_rows(int64_t h, const float* rows, int64_t n,
                              double now, int32_t block) try {
  IngestPtr e = oi_get(h);
  if (!e || n < 0) return -1;
  if (n == 0) return 0;
  std::unique_lock<std::mutex> lk(e->mu);
  if (e->closed) return -1;
  const int32_t w = e->row_width, H = e->feat_dim;
  e->ids_scratch.resize(2 * n);
  // ONE mapping pass over both endpoint columns (gathered strided →
  // flat), matching the Python adapter's combined call: every host in
  // the chunk is touched before any eviction can reclaim it.
  e->cols_scratch.resize(2 * n);
  float* cols = e->cols_scratch.data();
  for (int64_t i = 0; i < n; i++) {
    cols[i] = rows[i * w];
    cols[n + i] = rows[i * w + 1];
  }
  oi_map_locked(e.get(), cols, 2 * n, now, e->ids_scratch.data());
  // Pass 1 (atomic with the mapping — the Python spec's _mu scope):
  // feature credit + edge staging.  No cv waits happen in here, so a
  // concurrent eviction during backpressure can't recycle an id between
  // its mapping and its feature credit.
  auto& st_src = e->st_src;
  auto& st_dst = e->st_dst;
  auto& st_y = e->st_y;
  st_src.clear();
  st_dst.clear();
  st_y.clear();
  for (int64_t i = 0; i < n; i++) {
    int32_t s = e->ids_scratch[i], d = e->ids_scratch[n + i];
    if (s < 0 || d < 0) {
      e->overflow_edges++;
      continue;
    }
    const float* r = rows + i * w;
    e->feat_cnt[s] += 1.0;
    e->feat_cnt[d] += 1.0;
    double* fs = &e->feat_sum[(int64_t)s * H];
    double* fd = &e->feat_sum[(int64_t)d * H];
    for (int32_t j = 0; j < H; j++) {
      fs[j] += r[2 + H + j];  // parent cols credit src
      fd[j] += r[2 + j];      // child cols credit dst
    }
    st_src.push_back(s);
    st_dst.push_back(d);
    st_y.push_back(r[w - 1]);
  }
  e->rows_in += n;
  // Pass 2: ring append with backpressure.  Edges staged here may still
  // reference an id evicted while we wait — the documented aliasing
  // window, identical to the Python queue path.
  int64_t kept = 0;
  for (size_t i = 0; i < st_src.size(); i++) {
    while (e->size >= e->cap) {
      if (!block || e->closed) {
        // Staged edges that no longer fit are LOST (their features were
        // already credited; re-feeding would double-count) — account
        // them so kept + overflow == rows always holds.
        e->overflow_edges += (int64_t)(st_src.size() - i);
        e->cv_data.notify_all();
        return e->closed ? -1 : kept;
      }
      e->cv_space.wait(lk);
    }
    int64_t tail = (e->head + e->size) % e->cap;
    e->ring_src[tail] = st_src[i];
    e->ring_dst[tail] = st_dst[i];
    e->ring_y[tail] = st_y[i];
    e->size++;
    kept++;
    if ((kept & 0xFFF) == 0) e->cv_data.notify_all();
  }
  e->cv_data.notify_all();
  return kept;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Topology-path mapping (probe edges don't carry host features); same
// allocation/touch semantics as the download path.
int32_t oi_map_buckets(int64_t h, const float* buckets, int64_t n, double now,
                       int32_t* out) try {
  IngestPtr e = oi_get(h);
  if (!e) return -1;
  std::lock_guard<std::mutex> lk(e->mu);
  oi_map_locked(e.get(), buckets, n, now, out);
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Read-only probe (tests/diagnostics): current mapping, no allocation.
int32_t oi_lookup(int64_t h, const float* buckets, int64_t n, int32_t* out) try {
  IngestPtr e = oi_get(h);
  if (!e) return -1;
  std::lock_guard<std::mutex> lk(e->mu);
  for (int64_t i = 0; i < n; i++) {
    int64_t b = (int64_t)buckets[i];
    out[i] = (b < 0 || b >= e->n_buckets) ? -1 : e->id_table[b];
  }
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// All-or-nothing dispatch block: copies exactly `need` edges once enough
// have accumulated; 0 on timeout/eof-with-partial (the partial stays for
// a later taker — same leftover semantics as the Python queue path).
int64_t oi_take_edges(int64_t h, int64_t need, int32_t* src, int32_t* dst,
                      float* y, int64_t timeout_ms) try {
  IngestPtr e = oi_get(h);
  if (!e || need <= 0 || need > e->cap) return -1;
  std::unique_lock<std::mutex> lk(e->mu);
  // The timeout is an IDLE timeout (the Python queue path renews it per
  // arriving chunk): any progress since the last wake resets the clock,
  // so slow-but-steady ingest never ends the run mid-stream.
  // system_clock (not steady): keeps the wait on the TSAN-intercepted
  // pthread_cond_timedwait — see pf_complete for the full story.
  auto deadline = std::chrono::system_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  int64_t last_size = e->size;
  while (e->size < need && !e->eof && !e->closed) {
    if (e->size != last_size) {
      last_size = e->size;
      deadline = std::chrono::system_clock::now() +
                 std::chrono::milliseconds(timeout_ms);
    }
    if (e->cv_data.wait_until(lk, deadline) == std::cv_status::timeout) {
      if (e->size != last_size) continue;  // progress raced the timeout
      break;
    }
  }
  if (e->size < need) return 0;
  int64_t first = std::min(need, e->cap - e->head);
  memcpy(src, &e->ring_src[e->head], sizeof(int32_t) * first);
  memcpy(dst, &e->ring_dst[e->head], sizeof(int32_t) * first);
  memcpy(y, &e->ring_y[e->head], sizeof(float) * first);
  if (first < need) {
    memcpy(src + first, &e->ring_src[0], sizeof(int32_t) * (need - first));
    memcpy(dst + first, &e->ring_dst[0], sizeof(int32_t) * (need - first));
    memcpy(y + first, &e->ring_y[0], sizeof(float) * (need - first));
  }
  e->head = (e->head + need) % e->cap;
  e->size -= need;
  e->cv_space.notify_all();
  return need;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

void oi_eof(int64_t h) try {
  IngestPtr e = oi_get(h);
  if (!e) return;
  std::lock_guard<std::mutex> lk(e->mu);
  e->eof = true;
  e->cv_data.notify_all();
} catch (...) {
  // DF021: never unwind through the C boundary.
}

int32_t oi_node_features(int64_t h, float* out) try {
  IngestPtr e = oi_get(h);
  if (!e) return -1;
  std::lock_guard<std::mutex> lk(e->mu);
  for (int32_t id = 0; id < e->num_nodes; id++) {
    double c = e->feat_cnt[id] > 1.0 ? e->feat_cnt[id] : 1.0;
    const double* s = &e->feat_sum[(int64_t)id * e->feat_dim];
    float* o = out + (int64_t)id * e->feat_dim;
    for (int32_t j = 0; j < e->feat_dim; j++) o[j] = (float)(s[j] / c);
  }
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t oi_take_recycled(int64_t h, int32_t* out, int64_t cap) try {
  IngestPtr e = oi_get(h);
  if (!e) return -1;
  std::lock_guard<std::mutex> lk(e->mu);
  int64_t k = std::min<int64_t>(cap, e->pending_recycle.size());
  if (k > 0) memcpy(out, e->pending_recycle.data(), sizeof(int32_t) * k);
  e->pending_recycle.erase(e->pending_recycle.begin(),
                           e->pending_recycle.begin() + k);
  return k;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int64_t oi_pending_recycled(int64_t h) try {
  IngestPtr e = oi_get(h);
  if (!e) return -1;
  std::lock_guard<std::mutex> lk(e->mu);
  return (int64_t)e->pending_recycle.size();
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int32_t oi_stats(int64_t h, int64_t* overflow, int64_t* evicted,
                 int64_t* next_id, int64_t* rows_in) try {
  IngestPtr e = oi_get(h);
  if (!e) return -1;
  std::lock_guard<std::mutex> lk(e->mu);
  *overflow = e->overflow_edges;
  *evicted = e->evicted_nodes;
  *next_id = e->next_id;
  *rows_in = e->rows_in;
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

// Checkpoint export: refuses (-1) while recycled ids await their row reset
// — the trainer drains + applies, then retries, so a saved mapping can
// never outrun its embedding resets.  Returns the free-list length.
int64_t oi_export_state(int64_t h, int32_t* id_table, int64_t* bucket_of,
                        double* last_seen, int32_t* free_out, int64_t free_cap,
                        float* feat_sum, float* feat_cnt, int64_t* scalars) try {
  IngestPtr e = oi_get(h);
  if (!e) return -3;
  std::lock_guard<std::mutex> lk(e->mu);
  if (!e->pending_recycle.empty()) return -1;
  if ((int64_t)e->free_ids.size() > free_cap) return -2;
  memcpy(id_table, e->id_table.data(), sizeof(int32_t) * e->n_buckets);
  memcpy(bucket_of, e->bucket_of.data(), sizeof(int64_t) * e->num_nodes);
  memcpy(last_seen, e->last_seen.data(), sizeof(double) * e->num_nodes);
  if (!e->free_ids.empty())
    memcpy(free_out, e->free_ids.data(),
           sizeof(int32_t) * e->free_ids.size());
  for (int64_t i = 0; i < (int64_t)e->num_nodes * e->feat_dim; i++)
    feat_sum[i] = (float)e->feat_sum[i];
  for (int32_t i = 0; i < e->num_nodes; i++)
    feat_cnt[i] = (float)e->feat_cnt[i];
  scalars[0] = e->next_id;
  scalars[1] = e->overflow_edges;
  scalars[2] = e->evicted_nodes;
  return (int64_t)e->free_ids.size();
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int32_t oi_import_state(int64_t h, const int32_t* id_table,
                        const int64_t* bucket_of, const double* last_seen,
                        const int32_t* free_in, int64_t free_len,
                        const float* feat_sum, const float* feat_cnt,
                        int64_t next_id, int64_t overflow, int64_t evicted) try {
  IngestPtr e = oi_get(h);
  if (!e) return -1;
  std::lock_guard<std::mutex> lk(e->mu);
  // Value validation: restored ids become raw indices later — a corrupt
  // checkpoint must fail cleanly here, not heap-corrupt in the hot path.
  if (next_id < 0 || next_id > e->num_nodes || free_len > e->num_nodes)
    return -2;
  for (int64_t i = 0; i < free_len; i++)
    if (free_in[i] < 0 || free_in[i] >= e->num_nodes) return -2;
  for (int32_t i = 0; i < e->num_nodes; i++)
    if (bucket_of[i] < -1 || bucket_of[i] >= e->n_buckets) return -2;
  for (int64_t b = 0; b < e->n_buckets; b++)
    if (id_table[b] < -2 || id_table[b] >= e->num_nodes) return -2;
  memcpy(e->id_table.data(), id_table, sizeof(int32_t) * e->n_buckets);
  memcpy(e->bucket_of.data(), bucket_of, sizeof(int64_t) * e->num_nodes);
  memcpy(e->last_seen.data(), last_seen, sizeof(double) * e->num_nodes);
  e->free_ids.assign(free_in, free_in + (free_len > 0 ? free_len : 0));
  for (int64_t i = 0; i < (int64_t)e->num_nodes * e->feat_dim; i++)
    e->feat_sum[i] = feat_sum[i];
  for (int32_t i = 0; i < e->num_nodes; i++)
    e->feat_cnt[i] = feat_cnt[i];
  e->next_id = (int32_t)next_id;
  e->overflow_edges = overflow;
  e->evicted_nodes = evicted;
  e->pending_recycle.clear();
  e->last_scan = -1e300;
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

int32_t oi_destroy(int64_t h) try {
  IngestPtr e;
  {
    std::lock_guard<std::mutex> lk(g_oi_mu);
    auto it = g_oi.find(h);
    if (it == g_oi.end()) return -1;
    e = it->second;
    g_oi.erase(it);
  }
  {
    std::lock_guard<std::mutex> lk(e->mu);
    e->closed = true;
    e->cv_data.notify_all();
    e->cv_space.notify_all();
  }
  // Blocked feeders/takers hold their own shared_ptr; the engine frees
  // when the last of them returns.
  return 0;
} catch (...) {
  return kAbiTrap;  // DF021: never unwind through the C boundary
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ABI manifest witness (DESIGN.md §30).
//
// DF_ABI_EXPORTS is the X-macro table of every exported symbol in the
// canonical type vocabulary shared with records/abi_contracts.py
// (i32/i64/u16/u32/f64/cstr/u8p/f32p/i32p/i64p/f64p/void; const dropped).
// It is expanded twice:
//
//  * compile time — a static_assert per symbol pins the REAL prototype
//    (via decltype) to the table entry, so the table cannot drift from
//    the definitions it describes;
//  * df_abi_manifest() — emits canonical JSON (sorted keys, compact
//    separators, the exact bytes of Python's
//    json.dumps(..., sort_keys=True, separators=(",", ":"))) carrying
//    the prototype table, compiler-computed sizeof/offsetof of every
//    packed record, and the shared-constant values.  utils/dfabi.py
//    renders the same JSON from the registry; tests/test_zz_abiwitness
//    requires the two byte-equal, so a compiler/padding surprise fails
//    even when both source texts agree.
//
// df_abi_probe_fetchdone() additionally round-trips a sentinel FetchDone
// record through the real struct layout (memcpy of the compiled struct,
// not a re-statement of offsets).
// ---------------------------------------------------------------------------

#define DF_ABI_EXPORTS(X)                                                    \
  X(i64, re_open, cstr, cstr, u32)                                           \
  X(i64, re_append, i64, f32p, i64)                                          \
  X(i32, re_flush, i64)                                                      \
  X(i64, re_rows, i64)                                                       \
  X(i32, re_close, i64)                                                      \
  X(i64, ps_open, cstr)                                                      \
  X(i32, ps_create_task, i64, cstr, u32, i64)                                \
  X(i32, ps_load_task, i64, cstr)                                            \
  X(i64, ps_write_piece, i64, cstr, u32, u8p, u32)                           \
  X(i64, ps_read_piece, i64, cstr, u32, u8p, u32, i32)                       \
  X(i64, ps_piece_count, i64, cstr)                                          \
  X(i32, ps_piece_bitmap, i64, cstr, u8p, u32)                               \
  X(i64, ps_task_bytes, i64, cstr)                                           \
  X(i64, ps_content_length, i64, cstr)                                       \
  X(i64, ps_piece_size, i64, cstr)                                           \
  X(i32, ps_delete_task, i64, cstr)                                          \
  X(i64, ps_serve, i64, cstr, u16, i32)                                      \
  X(i32, ps_serve_stop, i64)                                                 \
  X(i32, ps_serve_stats2, i64, i64p, i64p, i64p, i64p)                       \
  X(i32, ps_leak_stats, i64p, i64p)                                          \
  X(i32, ps_close, i64)                                                      \
  X(i64, pf_open, i64, i32, cstr)                                            \
  X(i32, pf_parent, i64, i32, cstr, u16)                                     \
  X(i32, pf_submit, i64, cstr, i32, u32, u32)                                \
  X(i32, pf_complete, i64, u8p, i32, i32)                                    \
  X(i64, pf_pending, i64)                                                    \
  X(i32, pf_close, i64)                                                      \
  X(i64, oi_create, i32, i64, i32, i32, f64, i64)                            \
  X(i64, oi_feed_download_rows, i64, f32p, i64, f64, i32)                    \
  X(i32, oi_map_buckets, i64, f32p, i64, f64, i32p)                          \
  X(i32, oi_lookup, i64, f32p, i64, i32p)                                    \
  X(i64, oi_take_edges, i64, i64, i32p, i32p, f32p, i64)                     \
  X(void, oi_eof, i64)                                                       \
  X(i32, oi_node_features, i64, f32p)                                        \
  X(i64, oi_take_recycled, i64, i32p, i64)                                   \
  X(i64, oi_pending_recycled, i64)                                           \
  X(i32, oi_stats, i64, i64p, i64p, i64p, i64p)                              \
  X(i64, oi_export_state, i64, i32p, i64p, f64p, i32p, i64, f32p, f32p,      \
    i64p)                                                                    \
  X(i32, oi_import_state, i64, i32p, i64p, f64p, i32p, i64, f32p, f32p,      \
    i64, i64, i64)                                                           \
  X(i32, oi_destroy, i64)                                                    \
  X(cstr, df_abi_manifest)                                                   \
  X(i32, df_abi_probe_fetchdone, u8p, u32)

// Shared integer constants re-emitted by the manifest (the string magics
// kMagic/kTaskMagic are added by hand below — different JSON rendering).
#define DF_ABI_CONSTANTS(X)                                                  \
  X(kAbiTrap) X(kBatchBytesMax) X(kBatchMax) X(kFetchBurstMax)               \
  X(kFetchStatusCommit) X(kFetchStatusConn) X(kFetchStatusOk)                \
  X(kFetchStatusProto) X(kFetchWorkersDefault) X(kFetchWorkersMax)           \
  X(kLongPollMaxMs) X(kMaxFetchBody) X(kParentSlotMax)                       \
  X(kPieceFlagCommitted) X(kPieceFlagVerified) X(kServeLimitDefault)

namespace dfabi {

// Canonical type vocabulary.  Pointer aliases are spelled without const;
// norm_fn below drops const from the real prototypes before comparison,
// so `const float*` in a definition still matches f32p.
using i32 = int32_t;
using i64 = int64_t;
using u16 = uint16_t;
using u32 = uint32_t;
using f64 = double;
using cstr = const char*;
using u8p = uint8_t*;
using f32p = float*;
using i32p = int32_t*;
using i64p = int64_t*;
using f64p = double*;

template <typename T>
struct norm_t {
  using type = T;
};
template <typename T>
struct norm_t<const T*> {
  using type = T*;
};
template <typename F>
struct norm_fn;
template <typename R, typename... A>
struct norm_fn<R (*)(A...)> {
  using type = typename norm_t<R>::type (*)(typename norm_t<A>::type...);
};

// {"k":v,...} from pre-rendered JSON values; std::map iterates sorted,
// which IS the canonical key order.
inline std::string json_obj(const std::map<std::string, std::string>& m) {
  std::string s = "{";
  bool first = true;
  for (const auto& kv : m) {
    if (!first) s += ",";
    first = false;
    s += "\"";
    s += kv.first;
    s += "\":";
    s += kv.second;
  }
  s += "}";
  return s;
}

// ["ret","arg",...] from the stringified X-macro entry ("i64, cstr, u32").
inline std::string json_sig(const char* ret, const char* args) {
  std::string s = "[\"";
  s += ret;
  s += "\"";
  std::string a(args);
  size_t i = 0;
  while (i < a.size()) {
    while (i < a.size() && (a[i] == ' ' || a[i] == ',')) i++;
    size_t j = i;
    while (j < a.size() && a[j] != ',' && a[j] != ' ') j++;
    if (j > i) {
      s += ",\"";
      s.append(a, i, j - i);
      s += "\"";
    }
    i = j;
  }
  s += "]";
  return s;
}

struct FieldInfo {
  const char* name;
  long long off;
  long long size;
};

// {"fields":[["name",off,size],...],"size":N} — field order is layout
// order, NOT sorted; "fields" < "size" keeps the object keys canonical.
inline std::string json_record(const FieldInfo* f, size_t n,
                               long long total) {
  std::string s = "{\"fields\":[";
  for (size_t i = 0; i < n; i++) {
    if (i) s += ",";
    s += "[\"";
    s += f[i].name;
    s += "\",";
    s += std::to_string(f[i].off);
    s += ",";
    s += std::to_string(f[i].size);
    s += "]";
  }
  s += "],\"size\":";
  s += std::to_string(total);
  s += "}";
  return s;
}

#define DF_ABI_FIELD(rec_t, fld)                                   \
  {#fld, (long long)offsetof(rec_t, fld),                          \
   (long long)sizeof(((rec_t*)nullptr)->fld)}

inline const std::string& manifest_json() {
  static const std::string out = [] {
    std::map<std::string, std::string> exports;
#define DF_ABI_EXPORT_JSON(ret, name, ...) \
  exports[#name] = json_sig(#ret, "" #__VA_ARGS__);
    DF_ABI_EXPORTS(DF_ABI_EXPORT_JSON)
#undef DF_ABI_EXPORT_JSON

    std::map<std::string, std::string> constants;
#define DF_ABI_CONST_JSON(name) \
  constants[#name] = std::to_string((long long)(name));
    DF_ABI_CONSTANTS(DF_ABI_CONST_JSON)
#undef DF_ABI_CONST_JSON
    constants["kMagic"] = std::string("\"") + kMagic + "\"";
    constants["kTaskMagic"] = std::string("\"") + kTaskMagic + "\"";

    std::map<std::string, std::string> records;
    {
      const FieldInfo f[] = {
          DF_ABI_FIELD(FetchDone, number), DF_ABI_FIELD(FetchDone, status),
          DF_ABI_FIELD(FetchDone, length), DF_ABI_FIELD(FetchDone, slot),
          DF_ABI_FIELD(FetchDone, cost_ns),
      };
      records["FetchDone"] = json_record(f, 5, (long long)sizeof(FetchDone));
    }
    {
      const FieldInfo f[] = {
          DF_ABI_FIELD(PieceMeta, number), DF_ABI_FIELD(PieceMeta, length),
          DF_ABI_FIELD(PieceMeta, offset), DF_ABI_FIELD(PieceMeta, crc),
          DF_ABI_FIELD(PieceMeta, flags),
      };
      records["PieceMeta"] = json_record(f, 5, (long long)sizeof(PieceMeta));
    }
    {
      const FieldInfo f[] = {
          DF_ABI_FIELD(TaskHeader, magic),
          DF_ABI_FIELD(TaskHeader, piece_size),
          DF_ABI_FIELD(TaskHeader, content_length),
      };
      records["TaskHeader"] =
          json_record(f, 3, (long long)sizeof(TaskHeader));
    }

    std::string s = "{\"constants\":";
    s += json_obj(constants);
    s += ",\"exports\":";
    s += json_obj(exports);
    s += ",\"records\":";
    s += json_obj(records);
    s += ",\"version\":1}";
    return s;
  }();
  return out;
}

}  // namespace dfabi

extern "C" {

// Self-description of the compiled ABI surface (canonical JSON; see the
// section comment).  The string is owned by a function-local static —
// valid for the life of the process, never freed through the ABI.
const char* df_abi_manifest() try {
  return dfabi::manifest_json().c_str();
} catch (...) {
  return nullptr;
}

// Fill `out` with a sentinel FetchDone record (memcpy of the compiled
// struct): every field carries a distinguishable value so the ctypes
// side can prove its unpack format reads each field from the right
// bytes.  Returns sizeof(FetchDone), or -1 when out_len is short.
int32_t df_abi_probe_fetchdone(uint8_t* out, uint32_t out_len) try {
  if (!out || out_len < sizeof(FetchDone)) return -1;
  FetchDone d{};
  d.number = 0xA1B2C3D4u;
  d.status = kFetchStatusProto;  // a real status constant crosses too
  d.length = 0x00C0FFEEu;
  d.slot = -7;
  d.cost_ns = 0x0102030405060708LL;
  memcpy(out, &d, sizeof(FetchDone));
  return (int32_t)sizeof(FetchDone);
} catch (...) {
  return kAbiTrap;
}

}  // extern "C"

// Compile-time prototype pinning: the table cannot drift from the real
// definitions (a changed parameter type here is a build break naming the
// symbol, before any test runs).
namespace dfabi {
#define DF_ABI_ASSERT(ret, name, ...)                                    \
  static_assert(                                                         \
      std::is_same<norm_fn<decltype(&::name)>::type,                     \
                   norm_fn<ret (*)(__VA_ARGS__)>::type>::value,          \
      "ABI drift: " #name " does not match the DF_ABI_EXPORTS table");
DF_ABI_EXPORTS(DF_ABI_ASSERT)
#undef DF_ABI_ASSERT
}  // namespace dfabi
