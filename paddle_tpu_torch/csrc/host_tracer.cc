// Host span tracer: per-thread span buffers dumped as chrome-trace JSON
// (C ABI, loaded with ctypes).
//
// The port's own copy of the tracer part of the JAX package's native core
// (paddle_tpu/core/native/ptcore.cc, section 1: TraceEvent, the
// per-thread buffers and pt_trace_*), the same in what it does; the ring
// (csrc/shm_ring.cc) and the TCP store of that file are not part of it.
// Host code: no device, no kernel.
//
// Build (paddle_tpu_torch/core/__init__.py does it at first use):
//   g++ -std=c++17 -O2 -shared -fPIC -pthread host_tracer.cc \
//       -o libhost_tracer.so
//
// Timestamps are steady_clock nanoseconds (CLOCK_MONOTONIC on Linux, the
// clock of Python's time.perf_counter_ns), dumped as microseconds.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

extern "C" {

struct TraceEvent {
  char name[96];
  int64_t ts_ns;    // begin (steady clock)
  int64_t dur_ns;   // -1 => instant, -2 => counter (value in dur via union)
  int64_t value;    // counter value
  uint64_t tid;
};

namespace {

// Each thread owns a buffer with its own mutex: writers take only their
// (uncontended) buffer lock; dump/clear/count take the registry lock and
// every buffer lock, so a reader never races a concurrent push_back.
struct EventBuf {
  std::mutex mu;
  std::vector<TraceEvent> events;
};

std::mutex g_trace_mu;
std::vector<EventBuf*> g_all_buffers;
std::atomic<bool> g_trace_enabled{false};

struct ThreadBuf {
  EventBuf* buf;
  ThreadBuf() : buf(new EventBuf()) {
    buf->events.reserve(4096);
    std::lock_guard<std::mutex> lk(g_trace_mu);
    g_all_buffers.push_back(buf);
  }
  // leak on thread exit: dump() may run after thread death; entries are
  // owned by g_all_buffers once registered.
};

thread_local ThreadBuf t_buf;
thread_local std::vector<std::pair<std::string, int64_t>> t_span_stack;

int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

uint64_t this_tid() {
  return static_cast<uint64_t>(
      std::hash<std::thread::id>()(std::this_thread::get_id()) & 0xffffff);
}

}  // namespace

void pt_trace_enable(int on) { g_trace_enabled.store(on != 0); }
int pt_trace_enabled() { return g_trace_enabled.load() ? 1 : 0; }

void pt_trace_begin(const char* name) {
  if (!g_trace_enabled.load()) return;
  t_span_stack.emplace_back(name ? name : "?", now_ns());
}

void pt_trace_end() {
  if (t_span_stack.empty()) return;
  auto [name, t0] = t_span_stack.back();
  t_span_stack.pop_back();
  if (!g_trace_enabled.load()) return;
  TraceEvent e{};
  snprintf(e.name, sizeof(e.name), "%s", name.c_str());
  e.ts_ns = t0;
  e.dur_ns = now_ns() - t0;
  e.tid = this_tid();
  std::lock_guard<std::mutex> lk(t_buf.buf->mu);
  t_buf.buf->events.push_back(e);
}

void pt_trace_instant(const char* name) {
  if (!g_trace_enabled.load()) return;
  TraceEvent e{};
  snprintf(e.name, sizeof(e.name), "%s", name ? name : "?");
  e.ts_ns = now_ns();
  e.dur_ns = -1;
  e.tid = this_tid();
  std::lock_guard<std::mutex> lk(t_buf.buf->mu);
  t_buf.buf->events.push_back(e);
}

void pt_trace_counter(const char* name, int64_t value) {
  if (!g_trace_enabled.load()) return;
  TraceEvent e{};
  snprintf(e.name, sizeof(e.name), "%s", name ? name : "?");
  e.ts_ns = now_ns();
  e.dur_ns = -2;
  e.value = value;
  e.tid = this_tid();
  std::lock_guard<std::mutex> lk(t_buf.buf->mu);
  t_buf.buf->events.push_back(e);
}

int64_t pt_trace_event_count() {
  std::lock_guard<std::mutex> lk(g_trace_mu);
  int64_t n = 0;
  for (auto* b : g_all_buffers) {
    std::lock_guard<std::mutex> blk(b->mu);
    n += static_cast<int64_t>(b->events.size());
  }
  return n;
}

void pt_trace_clear() {
  std::lock_guard<std::mutex> lk(g_trace_mu);
  for (auto* b : g_all_buffers) {
    std::lock_guard<std::mutex> blk(b->mu);
    b->events.clear();
  }
}

// Dump all spans as chrome://tracing JSON. pid is caller-provided so
// multi-process traces can be merged by rank.
int pt_trace_dump(const char* path, int pid) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fputs("{\"traceEvents\":[", f);
  bool first = true;
  {
    std::lock_guard<std::mutex> lk(g_trace_mu);
    for (auto* b : g_all_buffers) {
      std::lock_guard<std::mutex> blk(b->mu);
      for (const auto& e : b->events) {
        if (!first) fputc(',', f);
        first = false;
        double ts_us = e.ts_ns / 1000.0;
        if (e.dur_ns == -1) {
          fprintf(f,
                  "{\"ph\":\"i\",\"name\":\"%s\",\"ts\":%.3f,"
                  "\"pid\":%d,\"tid\":%llu,\"s\":\"t\"}",
                  e.name, ts_us, pid, (unsigned long long)e.tid);
        } else if (e.dur_ns == -2) {
          fprintf(f,
                  "{\"ph\":\"C\",\"name\":\"%s\",\"ts\":%.3f,"
                  "\"pid\":%d,\"args\":{\"value\":%lld}}",
                  e.name, ts_us, pid, (long long)e.value);
        } else {
          fprintf(f,
                  "{\"ph\":\"X\",\"name\":\"%s\",\"ts\":%.3f,"
                  "\"dur\":%.3f,\"pid\":%d,\"tid\":%llu}",
                  e.name, ts_us, e.dur_ns / 1000.0, pid,
                  (unsigned long long)e.tid);
        }
      }
    }
  }
  fputs("]}", f);
  fclose(f);
  return 0;
}

}  // extern "C"
