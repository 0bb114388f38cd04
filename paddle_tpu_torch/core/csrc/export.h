// C ABI surface of the native runtime core (libpaddle_tpu_torch_core.so).
// Loaded from Python with ctypes (paddle_tpu_torch/core/native.py) — the
// counterpart of the reference's single pybind module libpaddle
// (paddle/fluid/pybind/pybind.cc), kept as a plain C ABI so no Python
// headers are needed at build time.
#pragma once

#include <cstdint>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

// ---- error handling (paddle/common/enforce.cc analogue) ----
// Functions returning int: 0 = ok, negative = error; the message is
// retrievable per-thread.
PT_EXPORT const char* pt_last_error();

// ---- TCPStore (paddle/phi/core/distributed/store/tcp_store.h) ----
typedef void* pt_store_t;
PT_EXPORT pt_store_t pt_store_create(const char* host, int port,
                                     int is_master, int world_size,
                                     int timeout_ms);
PT_EXPORT void pt_store_destroy(pt_store_t s);
PT_EXPORT int pt_store_set(pt_store_t s, const char* key,
                           const uint8_t* data, int64_t len);
// returns length (>=0) and copies into buf (up to cap); -1 on error/timeout
PT_EXPORT int64_t pt_store_get(pt_store_t s, const char* key, uint8_t* buf,
                               int64_t cap, int timeout_ms);
PT_EXPORT int64_t pt_store_add(pt_store_t s, const char* key, int64_t delta);
PT_EXPORT int pt_store_wait(pt_store_t s, const char* key, int timeout_ms);
PT_EXPORT int pt_store_barrier(pt_store_t s, const char* prefix, int rank,
                               int world_size, int timeout_ms);

// ---- flags registry (paddle/common/flags.cc analogue) ----
PT_EXPORT int pt_flags_set(const char* name, const char* value);
PT_EXPORT const char* pt_flags_get(const char* name);
PT_EXPORT const char* pt_flags_list();  // newline-separated "name=value"

// ---- comm watchdog (phi CommTaskManager, comm_task_manager.cc:152) ----
typedef void* pt_watchdog_t;
// on timeout the watchdog writes a report and calls abort_cb (may be null ->
// raises SIGABRT in-process after printing)
typedef void (*pt_abort_cb)(const char* task_name, int64_t elapsed_ms);
PT_EXPORT pt_watchdog_t pt_watchdog_start(int poll_interval_ms,
                                          pt_abort_cb cb);
PT_EXPORT void pt_watchdog_stop(pt_watchdog_t w);
// register/refresh a task heartbeat with a deadline
PT_EXPORT int pt_watchdog_begin(pt_watchdog_t w, const char* task,
                                int timeout_ms);
PT_EXPORT int pt_watchdog_end(pt_watchdog_t w, const char* task);
