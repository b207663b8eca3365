// Concurrency self-test for the native engine (run under TSAN/ASAN via
// `make tsan` / `make asan` — the SURVEY §5.2 sanitizer gate).
//
// Exercises the shared-state paths that matter under threads:
//   1. concurrent piece writers on distinct tasks + readers on the same
//      task (TaskStore mutex, PieceStore map);
//   2. the in-engine HTTP server under 8 concurrent fetchers while a
//      writer keeps committing new pieces (server threads vs writer);
//   3. delete-while-reading (shared_ptr lifetime + closed flag).
//
// The library source is #included so the sanitizers see one TU.

#include "native.cpp"

#include <cassert>
#include <cstdlib>
#include <functional>

namespace {

int http_get(uint16_t port, const std::string& path, std::string& body) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(fd);
    return -1;
  }
  std::string req = "GET " + path + " HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n";
  send_all(fd, req.data(), req.size());
  std::string resp;
  char buf[8192];
  ssize_t n;
  while ((n = recv(fd, buf, sizeof(buf), 0)) > 0) resp.append(buf, (size_t)n);
  close(fd);
  size_t hdr = resp.find("\r\n\r\n");
  if (hdr == std::string::npos) return -2;
  body = resp.substr(hdr + 4);
  return atoi(resp.c_str() + 9);
}

std::vector<uint8_t> piece_bytes(uint32_t task, uint32_t number, size_t len) {
  std::vector<uint8_t> v(len);
  for (size_t i = 0; i < len; i++) v[i] = (uint8_t)((task * 31 + number * 7 + i) & 0xFF);
  return v;
}

// Minimal hostile/slow parent for the pf_* robustness tests: listens on
// an ephemeral loopback port, accepts ONE connection, and answers every
// received request head per `reply` after `delay_us`.
int listen_local(uint16_t* port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = 0;
  inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 || listen(fd, 8) != 0) {
    close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &alen);
  *port = ntohs(addr.sin_port);
  return fd;
}

void fake_parent(int lfd, const std::string& reply, int delay_us) {
  int cfd = accept(lfd, nullptr, nullptr);
  if (cfd < 0) return;
  std::string acc;
  char buf[8192];
  for (;;) {
    ssize_t n = recv(cfd, buf, sizeof(buf), 0);
    if (n <= 0) break;
    acc.append(buf, (size_t)n);
    size_t nreq = 0, pos = 0;
    while ((pos = acc.find("\r\n\r\n")) != std::string::npos) {
      acc.erase(0, pos + 4);
      nreq++;
    }
    if (nreq == 0) continue;
    if (delay_us > 0) usleep(delay_us);
    for (size_t i = 0; i < nreq; i++)
      if (!send_all(cfd, reply.data(), reply.size())) break;
  }
  close(cfd);
}

}  // namespace

// Scratch directories go under $TMPDIR (default /tmp).
static std::string scratch_dir(const char* stem) {
  const char* base = getenv("TMPDIR");
  std::string tmpl = std::string(base && *base ? base : "/tmp") + "/" + stem + "_XXXXXX";
  std::vector<char> buf(tmpl.begin(), tmpl.end());
  buf.push_back('\0');
  const char* dir = mkdtemp(buf.data());
  assert(dir != nullptr);
  return std::string(dir);
}

int main() {
  std::string root = scratch_dir("native_test");
  int64_t h = ps_open(root.c_str());
  assert(h > 0);
  const uint32_t kPiece = 256 * 1024;

  // 1. Concurrent writers on distinct tasks + readers chasing them.
  {
    std::vector<std::thread> ts;
    std::atomic<int> errors{0};
    for (int t = 0; t < 4; t++) {
      ts.emplace_back([&, t] {
        std::string task = "task-" + std::to_string(t);
        if (ps_create_task(h, task.c_str(), kPiece, 8 * kPiece) != 0) {
          errors++;
          return;
        }
        for (uint32_t n = 0; n < 8; n++) {
          auto data = piece_bytes(t, n, kPiece);
          if (ps_write_piece(h, task.c_str(), n, data.data(), kPiece) < 0) errors++;
        }
      });
      ts.emplace_back([&, t] {
        std::string task = "task-" + std::to_string(t);
        std::vector<uint8_t> buf(kPiece);
        for (int spin = 0; spin < 200; spin++) {
          int64_t c = ps_piece_count(h, task.c_str());
          if (c >= 8) {
            for (uint32_t n = 0; n < 8; n++) {
              int64_t r = ps_read_piece(h, task.c_str(), n, buf.data(), kPiece, 1);
              if (r != (int64_t)kPiece) errors++;
            }
            return;
          }
          usleep(1000);
        }
      });
    }
    for (auto& t : ts) t.join();
    assert(errors.load() == 0);
  }

  // 2. HTTP server under concurrent fetchers while a writer commits.
  {
    int64_t port = ps_serve(h, "127.0.0.1", 0, 64);
    assert(port > 0);
    std::atomic<int> errors{0};
    std::thread writer([&] {
      ps_create_task(h, "live", kPiece, 16 * kPiece);
      for (uint32_t n = 0; n < 16; n++) {
        auto data = piece_bytes(99, n, kPiece);
        if (ps_write_piece(h, "live", n, data.data(), kPiece) < 0) errors++;
        usleep(2000);
      }
    });
    std::vector<std::thread> fetchers;
    for (int f = 0; f < 8; f++) {
      fetchers.emplace_back([&, f] {
        std::string body;
        for (int round = 0; round < 30; round++) {
          uint32_t n = (uint32_t)((f + round) % 8);
          std::string want_task = "task-" + std::to_string(f % 4);
          int code = http_get((uint16_t)port, "/pieces/" + want_task + "/" +
                              std::to_string(n), body);
          if (code != 200 || body.size() != kPiece) errors++;
          auto want = piece_bytes((uint32_t)(f % 4), n, kPiece);
          if (memcmp(body.data(), want.data(), kPiece) != 0) errors++;
          // bitmap + range while the live task is still being written
          http_get((uint16_t)port, "/tasks/live/pieces", body);
        }
      });
    }
    writer.join();
    for (auto& t : fetchers) t.join();
    std::string body;
    assert(http_get((uint16_t)port, "/tasks/task-0/pieces", body) == 200);
    assert(body.size() == 8);
    assert(http_get((uint16_t)port, "/pieces/ghost/0", body) == 404);
    assert(errors.load() == 0);
    assert(ps_serve_stop(h) == 0);
  }

  // 3. delete-while-reading.
  {
    std::thread reader([&] {
      std::vector<uint8_t> buf(kPiece);
      for (int i = 0; i < 200; i++)
        ps_read_piece(h, "task-1", (uint32_t)(i % 8), buf.data(), kPiece, 1);
    });
    usleep(1000);
    ps_delete_task(h, "task-1");
    reader.join();
  }

  assert(ps_close(h) == 0);

  // 4. Online ingest engine: concurrent feeders (mapping + eviction under
  //    the engine mutex) vs a taker draining dispatch blocks, with a
  //    topology mapper and a stats poller in the mix; then
  //    destroy-while-blocked (feeder waiting on a full ring must wake).
  {
    const int32_t kNodes = 64, kFeat = 12, kWidth = 2 + 2 * kFeat + 1;
    int64_t oh = oi_create(kNodes, 1 << 16, kFeat, kWidth, 5.0, 4096);
    assert(oh > 0);
    std::atomic<int> errors{0};
    std::atomic<bool> stop{false};
    std::vector<std::thread> feeders;
    for (int f = 0; f < 2; f++) {
      feeders.emplace_back([&, f] {
        std::vector<float> rows((size_t)256 * kWidth, 0.5f);
        for (int round = 0; round < 120; round++) {
          for (int i = 0; i < 256; i++) {
            // Churn through 3x capacity so eviction paths run.
            rows[(size_t)i * kWidth] =
                (float)((f * 7919 + round * 131 + i) % (3 * kNodes) + 100);
            rows[(size_t)i * kWidth + 1] =
                (float)((f * 104729 + round * 37 + i) % (3 * kNodes) + 100);
          }
          int64_t kept = oi_feed_download_rows(oh, rows.data(), 256,
                                               (double)round, 1);
          if (kept < 0) errors++;
        }
      });
    }
    std::thread taker([&] {
      std::vector<int32_t> src(512), dst(512);
      std::vector<float> y(512);
      while (!stop.load()) {
        oi_take_edges(oh, 512, src.data(), dst.data(), y.data(), 20);
      }
    });
    std::thread mapper([&] {
      std::vector<float> b(64);
      std::vector<int32_t> out(64);
      for (int round = 0; round < 200; round++) {
        for (int i = 0; i < 64; i++) b[i] = (float)(100 + (round + i) % 192);
        if (oi_map_buckets(oh, b.data(), 64, (double)(round % 120), out.data()) != 0)
          errors++;
        int64_t ov, ev, ni, ri;
        if (oi_stats(oh, &ov, &ev, &ni, &ri) != 0) errors++;
        std::vector<int32_t> rec(kNodes);
        oi_take_recycled(oh, rec.data(), kNodes);
      }
    });
    for (auto& t : feeders) t.join();
    mapper.join();
    stop.store(true);
    taker.join();
    assert(errors.load() == 0);
    // Consistent-export contract: drained pending → export succeeds.
    {
      std::vector<int32_t> rec(kNodes);
      while (oi_take_recycled(oh, rec.data(), kNodes) > 0) {}
      std::vector<int32_t> idt(1 << 16);
      std::vector<int64_t> bof(kNodes);
      std::vector<double> ls(kNodes);
      std::vector<int32_t> fr(kNodes);
      std::vector<float> fs((size_t)kNodes * kFeat), fc(kNodes);
      int64_t scalars[3];
      int64_t n = oi_export_state(oh, idt.data(), bof.data(), ls.data(),
                                  fr.data(), kNodes, fs.data(), fc.data(),
                                  scalars);
      assert(n >= 0);
      assert(oi_import_state(oh, idt.data(), bof.data(), ls.data(), fr.data(),
                             n, fs.data(), fc.data(), scalars[0], scalars[1],
                             scalars[2]) == 0);
    }
    // Destroy-while-blocked: fill the ring, park a feeder on cv_space,
    // then destroy — the feeder must wake with -1, not deadlock.
    std::thread blocked([&] {
      std::vector<float> rows((size_t)8192 * kWidth, 0.5f);
      for (int i = 0; i < 8192; i++) {
        rows[(size_t)i * kWidth] = (float)(100 + i % kNodes);
        rows[(size_t)i * kWidth + 1] = (float)(100 + (i + 1) % kNodes);
      }
      while (oi_feed_download_rows(oh, rows.data(), 8192, 1000.0, 1) >= 0) {}
    });
    usleep(50000);
    assert(oi_destroy(oh) == 0);
    blocked.join();
  }

  // 5. In-engine client fetch loop (pf_*, DESIGN.md §28) against the
  //    in-engine server: pipelined bursts must trigger the server's
  //    batched submission, commits must be byte-exact in the client
  //    store, error completions must carry the right status, and the
  //    process-wide leak counters must stay zero.
  {
    int64_t src = ps_open(scratch_dir("native_test_src").c_str());
    int64_t dst = ps_open(scratch_dir("native_test_dst").c_str());
    assert(src > 0 && dst > 0);
    const uint32_t kSmall = 16 * 1024;
    const uint32_t kN = 32;
    assert(ps_create_task(src, "pf-task", kSmall, kN * kSmall) == 0);
    for (uint32_t n = 0; n < kN; n++) {
      auto data = piece_bytes(5, n, kSmall);
      assert(ps_write_piece(src, "pf-task", n, data.data(), kSmall) ==
             (int64_t)kSmall);
    }
    int64_t port = ps_serve(src, "127.0.0.1", 0, 64);
    assert(port > 0);
    assert(ps_create_task(dst, "pf-task", kSmall, kN * kSmall) == 0);

    // One worker keeps the burst assembly deterministic: 32 queued
    // 16 KiB jobs form 8-deep bursts under the 512 KiB byte cap, and
    // each burst lands at the server as back-to-back GETs -> writev.
    int64_t fh = pf_open(dst, 1, "tenant-test");
    assert(fh > 0);
    assert(pf_parent(fh, 0, "127.0.0.1", (uint16_t)port) == 0);
    assert(pf_parent(fh, 1, "127.0.0.1", 1) == 0);  // dead parent slot
    for (uint32_t n = 0; n < kN; n++)
      assert(pf_submit(fh, "pf-task", 0, n, kSmall) == 0);
    assert(pf_submit(fh, "ghost", 0, 0, 0) == 0);          // server 404
    assert(pf_submit(fh, "pf-task", 0, 3, kSmall - 1) == 0);  // len mismatch
    assert(pf_submit(fh, "pf-task", 1, 0, kSmall) == 0);   // conn refused
    int ok = 0, st404 = 0, stlen = 0, stconn = 0, drained = 0;
    FetchDone recs[64];
    for (int spin = 0; spin < 200 && drained < (int)kN + 3; spin++) {
      int n = pf_complete(fh, (uint8_t*)recs, 64, 100);
      assert(n >= 0);
      for (int i = 0; i < n; i++) {
        drained++;
        if (recs[i].status == 0) {
          assert(recs[i].length == kSmall && recs[i].slot == 0);
          assert(recs[i].cost_ns > 0);
          ok++;
        } else if (recs[i].status == 404) {
          st404++;
        } else if (recs[i].status == -2) {
          stlen++;
        } else if (recs[i].status == -1) {
          assert(recs[i].slot == 1);
          stconn++;
        }
      }
    }
    assert(drained == (int)kN + 3);
    assert(ok == (int)kN && st404 == 1 && stlen == 1 && stconn == 1);
    assert(pf_pending(fh) == 0);
    std::vector<uint8_t> buf(kSmall);
    for (uint32_t n = 0; n < kN; n++) {
      assert(ps_read_piece(dst, "pf-task", n, buf.data(), kSmall, 1) ==
             (int64_t)kSmall);
      auto want = piece_bytes(5, n, kSmall);
      assert(memcmp(buf.data(), want.data(), kSmall) == 0);
    }
    int64_t pieces = 0, bytes = 0, batched = 0, conns = 0;
    assert(ps_serve_stats2(src, &pieces, &bytes, &batched, &conns) == 0);
    assert(pieces >= (int64_t)kN);
    assert(batched > 0);  // the §28 coalesced-writev evidence
    assert(pf_close(fh) == 0);
    assert(pf_submit(fh, "pf-task", 0, 0, kSmall) == -1);  // handle gone
    assert(ps_serve_stop(src) == 0);
    assert(ps_close(src) == 0);
    assert(ps_close(dst) == 0);
    int64_t leaked_servers = 0, leaked_conns = 0;
    assert(ps_leak_stats(&leaked_servers, &leaked_conns) == 0);
    assert(leaked_servers == 0 && leaked_conns == 0);
  }

  // 6. pf_* robustness against hostile/wedged parents (REVIEW fixes):
  //    a) an absurd Content-Length is a -2 completion, not a bad_alloc
  //       that std::terminates the daemon;
  //    b) pf_close DISCARDS the queued backlog (only in-flight bursts
  //       finish) and safely wakes a concurrently blocked pf_complete;
  //    c) a foreign client pipelining piece GETs past the server's
  //       512 KiB batch byte cap still gets byte-exact bodies, and the
  //       batched counter never covers the over-cap tail.
  {
    int64_t dst = ps_open(scratch_dir("native_test_rb").c_str());
    assert(dst > 0);
    const uint32_t kSmall = 16 * 1024;
    assert(ps_create_task(dst, "rb-task", kSmall, 64 * kSmall) == 0);

    // a) hostile Content-Length.
    {
      uint16_t port = 0;
      int lfd = listen_local(&port);
      assert(lfd >= 0);
      std::thread parent(fake_parent, lfd,
                         "HTTP/1.1 200 OK\r\n"
                         "Content-Length: 9000000000000000\r\n\r\n",
                         0);
      int64_t fh = pf_open(dst, 1, "tenant-test");
      assert(fh > 0);
      assert(pf_parent(fh, 0, "127.0.0.1", port) == 0);
      // expected_len 0: even the unknown-size path must cap the body.
      assert(pf_submit(fh, "rb-task", 0, 0, 0) == 0);
      FetchDone rec{};
      int drained = 0;
      for (int spin = 0; spin < 100 && drained == 0; spin++)
        drained = pf_complete(fh, (uint8_t*)&rec, 1, 100);
      assert(drained == 1 && rec.status == -2);
      assert(pf_close(fh) == 0);
      parent.join();
      close(lfd);
    }

    // b) close-discards-queue + concurrent pf_complete lifetime.
    {
      uint16_t port = 0;
      int lfd = listen_local(&port);
      assert(lfd >= 0);
      // 400 ms per burst: fetching the whole 64-job backlog (8 bursts on
      // 1 worker) would take >= 3.2 s; discard must close far sooner.
      std::thread parent(fake_parent, lfd,
                         "HTTP/1.1 404 Not Found\r\n"
                         "Content-Length: 0\r\n\r\n",
                         400 * 1000);
      int64_t fh = pf_open(dst, 1, "tenant-test");
      assert(fh > 0);
      assert(pf_parent(fh, 0, "127.0.0.1", port) == 0);
      for (uint32_t n = 0; n < 64; n++)
        assert(pf_submit(fh, "rb-task", 0, n, kSmall) == 0);
      // A waiter parked inside pf_complete across the close: the
      // shared_ptr holder + closing-wake must make this return cleanly
      // (ASAN would flag the old raw-pointer use-after-free here).
      std::thread waiter([&] {
        FetchDone recs[64];
        (void)pf_complete(fh, (uint8_t*)recs, 64, 10000);
      });
      usleep(50 * 1000);  // let the first burst go in-flight
      timespec c0, c1;
      clock_gettime(CLOCK_MONOTONIC, &c0);
      assert(pf_close(fh) == 0);
      clock_gettime(CLOCK_MONOTONIC, &c1);
      int64_t close_ms = (c1.tv_sec - c0.tv_sec) * 1000 +
                         (c1.tv_nsec - c0.tv_nsec) / 1000000;
      assert(close_ms < 2000);  // one in-flight burst, not the backlog
      waiter.join();
      parent.join();
      close(lfd);
    }

    // c) server batch byte cap under foreign pipelining.
    {
      int64_t src = ps_open(scratch_dir("native_test_cap").c_str());
      assert(src > 0);
      const uint32_t kBig = 200 * 1024;  // 3 pipelined > the 512 KiB cap
      assert(ps_create_task(src, "cap-task", kBig, 3 * kBig) == 0);
      for (uint32_t n = 0; n < 3; n++) {
        auto data = piece_bytes(9, n, kBig);
        assert(ps_write_piece(src, "cap-task", n, data.data(), kBig) ==
               (int64_t)kBig);
      }
      int64_t port = ps_serve(src, "127.0.0.1", 0, 16);
      assert(port > 0);
      int fd = socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_port = htons((uint16_t)port);
      inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
      assert(connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0);
      std::string reqs;
      for (int n = 0; n < 3; n++)
        reqs += "GET /pieces/cap-task/" + std::to_string(n) +
                " HTTP/1.1\r\nHost: x\r\n\r\n";
      assert(send_all(fd, reqs.data(), reqs.size()));  // one segment
      std::string acc;
      for (uint32_t n = 0; n < 3; n++) {
        std::string body;
        assert(read_response(fd, acc, &body, kBig) == 200);
        auto want = piece_bytes(9, n, kBig);
        assert(body.size() == kBig &&
               memcmp(body.data(), want.data(), kBig) == 0);
      }
      close(fd);
      // The conn thread bumps the counters AFTER the last body bytes
      // are already readable client-side — poll briefly.
      int64_t pieces = 0, bytes = 0, batched = 0, conns = 0;
      for (int spin = 0; spin < 200 && pieces < 3; spin++) {
        assert(ps_serve_stats2(src, &pieces, &bytes, &batched, &conns) == 0);
        if (pieces < 3) usleep(5000);
      }
      assert(pieces == 3 && bytes == 3 * (int64_t)kBig);
      assert(batched <= 2);  // the over-cap tail never rode the batch
      assert(ps_serve_stop(src) == 0);
      assert(ps_close(src) == 0);
    }
    assert(ps_close(dst) == 0);
  }

  // 7. ABI manifest witness (DESIGN.md §30): the compiled self-description
  // must exist and carry the layout facts the ctypes side depends on, and
  // the probe export must round-trip the sentinel through the REAL struct.
  {
    static_assert(sizeof(FetchDone) == 24, "FetchDone wire size");
    const char* m = df_abi_manifest();
    assert(m != nullptr);
    std::string mj(m);
    assert(mj.find("\"version\":1") != std::string::npos);
    assert(mj.find("\"df_abi_probe_fetchdone\"") != std::string::npos);
    assert(mj.find("\"kBatchBytesMax\":524288") != std::string::npos);
    assert(df_abi_manifest() == m);  // stable pointer, never freed

    uint8_t buf[sizeof(FetchDone)];
    assert(df_abi_probe_fetchdone(buf, sizeof(buf)) ==
           (int32_t)sizeof(FetchDone));
    FetchDone d;
    memcpy(&d, buf, sizeof(d));
    assert(d.number == 0xA1B2C3D4u && d.status == kFetchStatusProto &&
           d.length == 0x00C0FFEEu && d.slot == -7 &&
           d.cost_ns == 0x0102030405060708LL);
    assert(df_abi_probe_fetchdone(buf, sizeof(buf) - 1) == -1);
    assert(df_abi_probe_fetchdone(nullptr, 64) == -1);
  }

  printf("native_test: OK\n");
  return 0;
}
