// Comm watchdog: heartbeat/deadline monitor for collectives and barriers.
//
// Reference: paddle/phi/core/distributed/comm_task_manager.cc:152-168 —
// a loop thread checks every in-flight NCCL task's IsTimeout() and aborts
// the communicator. Here rendezvous, barriers and host-driven pipeline
// steps that can hang on a dead peer register a deadline; the watchdog
// surfaces a miss as a loud report + callback instead of a silent hang.
#include "export.h"

#include <atomic>
#include <chrono>
#include <cstdio>
#include <map>
#include <mutex>
#include <string>
#include <thread>

namespace {
using Clock = std::chrono::steady_clock;

struct Task {
  Clock::time_point start;
  Clock::time_point deadline;
};

struct Watchdog {
  std::mutex mu;
  std::map<std::string, Task> tasks;
  std::atomic<bool> running{true};
  std::thread thread;
  pt_abort_cb cb = nullptr;
  int poll_ms = 1000;

  void loop() {
    while (running) {
      std::this_thread::sleep_for(std::chrono::milliseconds(poll_ms));
      std::string expired_name;
      int64_t expired_ms = 0;
      {
        std::lock_guard<std::mutex> l(mu);
        auto now = Clock::now();
        for (auto& kv : tasks) {
          if (now > kv.second.deadline) {
            expired_name = kv.first;
            expired_ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                             now - kv.second.start)
                             .count();
            break;
          }
        }
        if (!expired_name.empty()) tasks.erase(expired_name);
      }
      if (!expired_name.empty()) {
        std::fprintf(stderr,
                     "[paddle_tpu_torch watchdog] task '%s' exceeded its deadline "
                     "(%lld ms elapsed) — a peer is likely dead or the "
                     "collective is wedged\n",
                     expired_name.c_str(),
                     static_cast<long long>(expired_ms));
        if (cb) cb(expired_name.c_str(), expired_ms);
      }
    }
  }
};
}  // namespace

PT_EXPORT pt_watchdog_t pt_watchdog_start(int poll_interval_ms,
                                          pt_abort_cb cb) {
  auto* w = new Watchdog();
  w->poll_ms = poll_interval_ms > 0 ? poll_interval_ms : 1000;
  w->cb = cb;
  w->thread = std::thread([w] { w->loop(); });
  return w;
}

PT_EXPORT void pt_watchdog_stop(pt_watchdog_t h) {
  auto* w = static_cast<Watchdog*>(h);
  w->running = false;
  if (w->thread.joinable()) w->thread.join();
  delete w;
}

PT_EXPORT int pt_watchdog_begin(pt_watchdog_t h, const char* task,
                                int timeout_ms) {
  auto* w = static_cast<Watchdog*>(h);
  std::lock_guard<std::mutex> l(w->mu);
  auto now = Clock::now();
  w->tasks[task] = {now, now + std::chrono::milliseconds(timeout_ms)};
  return 0;
}

PT_EXPORT int pt_watchdog_end(pt_watchdog_t h, const char* task) {
  auto* w = static_cast<Watchdog*>(h);
  std::lock_guard<std::mutex> l(w->mu);
  return w->tasks.erase(task) ? 0 : -1;
}
