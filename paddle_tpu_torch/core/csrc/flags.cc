// Global flag registry (reference: paddle/common/flags.cc — 184
// PHI_DEFINE_EXPORTED_* flags in one registry, surfaced to Python via
// paddle.get_flags/set_flags and FLAGS_* env at bootstrap).
//
// Flags are string-typed KV with env-var seeding; the Python bridge
// (paddle_tpu_torch/framework/flags.py) keeps its typed view and mirrors
// every set_flags into this registry, so native components see the same
// values.
#include "export.h"

#include <cstdlib>
#include <map>
#include <mutex>
#include <string>

namespace {
std::mutex g_mu;
std::map<std::string, std::string> g_flags;
thread_local std::string g_scratch;

void seed_from_env(const std::string& name) {
  std::string env = "FLAGS_" + name;
  if (const char* v = std::getenv(env.c_str())) {
    g_flags[name] = v;
  }
}
}  // namespace

PT_EXPORT int pt_flags_set(const char* name, const char* value) {
  std::lock_guard<std::mutex> l(g_mu);
  g_flags[name] = value ? value : "";
  return 0;
}

PT_EXPORT const char* pt_flags_get(const char* name) {
  std::lock_guard<std::mutex> l(g_mu);
  auto it = g_flags.find(name);
  if (it == g_flags.end()) {
    seed_from_env(name);
    it = g_flags.find(name);
    if (it == g_flags.end()) return nullptr;
  }
  g_scratch = it->second;
  return g_scratch.c_str();
}

PT_EXPORT const char* pt_flags_list() {
  std::lock_guard<std::mutex> l(g_mu);
  g_scratch.clear();
  for (auto& kv : g_flags) {
    g_scratch += kv.first + "=" + kv.second + "\n";
  }
  return g_scratch.c_str();
}
